"""Seconds of the QAP witness map a Groth16 proof (the prover's own phase
seconds, `groth16.LAST_PROVE_SECONDS["witness_map"]`), the mean over the
traced proofs."""
from zkbench.metrics._phases import mean_phase_seconds


def read(run):
    return mean_phase_seconds(run, ("witness_map",))
