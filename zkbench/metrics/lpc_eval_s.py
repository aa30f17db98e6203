"""Seconds of the LPC evaluation proof a proof: the sum of
`LPCScheme.proof_eval`'s phases in the program's `PhaseClock`, the mean
over the traced proofs."""
from zkbench.metrics._phases import mean_phase_seconds

PHASES = ("eval_polys", "combined_q", "q_precommit", "fri_commit_phase",
          "fri_query_phase")


def read(run):
    return mean_phase_seconds(run, PHASES)
