"""Seconds of the lookup argument a proof: its `PhaseClock` steps through
`lookup_argument`, the mean over the traced proofs."""
from zkbench.metrics._phases import mean_phase_seconds

PHASES = ("lookup_prepare", "lookup_to_host", "lookup_sort", "lookup_encode",
          "lookup_commit", "lookup_argument")


def read(run):
    return mean_phase_seconds(run, PHASES)
