"""``cache_hit_share.file``, read the same way in the federation's cell."""
from portbench.harness import read_metric

read = read_metric("cache_hit_share.file")
