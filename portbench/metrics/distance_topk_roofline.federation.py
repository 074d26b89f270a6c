"""``distance_topk_roofline``, read the same way in the federation's cell:
every shard's leaf scorer is one ``distance_topk``."""
from portbench.harness import read_metric

read = read_metric("distance_topk_roofline")
