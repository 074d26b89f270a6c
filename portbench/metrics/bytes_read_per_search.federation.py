"""``bytes_read_per_search.file``, read the same way in the federation's cell."""
from portbench.harness import read_metric

read = read_metric("bytes_read_per_search.file")
