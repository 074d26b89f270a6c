"""Seconds of the index build in set-up: the program's phases
``ecpfs.build.*`` (hierarchy, assignment, write of the fstore), summed."""
from portbench import program


def read(run):
    return program.phase_s(run, "ecpfs.build.")
