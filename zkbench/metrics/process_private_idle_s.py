"""The card's idle seconds a proof under `zk.placeholder.process_private`
(the witness's host encode), inclusive, the mean over the span-traced
proofs (`span_tracing.py`: spans on, nothing drained)."""
from zkbench.span_tracing import idle_per_proof


def read(run):
    return idle_per_proof(run, ("zk.placeholder.process_private",))
