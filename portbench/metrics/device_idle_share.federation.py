"""``device_idle_share.file``, read the same way in the federation's cell."""
from portbench.harness import read_metric

read = read_metric("device_idle_share.file")
