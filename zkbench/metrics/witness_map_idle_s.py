"""The card's idle seconds a proof under `zk.groth16.witness_map` (the QAP
witness map), inclusive, the mean over the span-traced proofs
(`span_tracing.py`: spans on, nothing drained)."""
from zkbench.span_tracing import idle_per_proof


def read(run):
    return idle_per_proof(run, ("zk.groth16.witness_map",))
