"""``build_s.file``, read the same way in the federation's cell."""
from portbench.harness import read_metric

read = read_metric("build_s.file")
