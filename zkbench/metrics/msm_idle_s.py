"""The card's idle seconds a proof under the five MSMs of a Groth16 proof
(`zk.groth16.msm.<query>`), inclusive, the mean over the span-traced
proofs (`span_tracing.py`: spans on, nothing drained)."""
from zkbench.span_tracing import idle_per_proof


def read(run):
    return idle_per_proof(run, ("zk.groth16.msm.*",))
