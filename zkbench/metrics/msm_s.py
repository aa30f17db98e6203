"""Seconds of the five MSMs a Groth16 proof (the prover's phase seconds
`msm_A`, `msm_B1`, `msm_B2`, `msm_H`, `msm_L`), the mean over the traced
proofs."""
from zkbench.metrics._phases import mean_phase_seconds

PHASES = ("msm_A", "msm_B1", "msm_B2", "msm_H", "msm_L")


def read(run):
    return mean_phase_seconds(run, PHASES)
