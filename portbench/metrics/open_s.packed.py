"""Seconds of opening the index in set-up: the program's phases
``ecpfs.open.*`` (read and pad on the host, upload to the card), summed."""
from portbench import program


def read(run):
    return program.phase_s(run, "ecpfs.open.")
