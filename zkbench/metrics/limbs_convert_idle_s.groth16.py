"""`limbs_convert_idle_s` of the Groth16 cell, whose proof time is a
per-layer metric there (PERF.md, section 2): the same reading, under a name
of its own because it moves `setup_s` (the warm-up proof) in that cell."""
from zkbench.harness import metric_module

read = metric_module("limbs_convert_idle_s").read
