"""The card's idle seconds a proof under `zk.lpc.proof_eval` (LPC's
evaluation proof and FRI), inclusive, the mean over the span-traced proofs
(`span_tracing.py`: spans on, nothing drained)."""
from zkbench.span_tracing import idle_per_proof


def read(run):
    return idle_per_proof(run, ("zk.lpc.proof_eval",))
