"""Shared by the readers of phase seconds: the mean over the traced proofs
of the seconds of the named phases."""
from __future__ import annotations


def mean_phase_seconds(run, names) -> float | None:
    if run.trace is None:
        return None
    per_proof = [sum(s for n, s in phases if n in names)
                 for phases in run.trace.phase_seconds
                 if any(n in names for n, _ in phases)]
    if not per_proof:
        return None
    return sum(per_proof) / len(per_proof)
