"""The card's idle seconds a proof under the host-card conversions
(`zk.limbs.encode`, `zk.limbs.decode`: Python ints to digit planes on the
card and back), inclusive, the mean over the span-traced proofs
(`span_tracing.py`: spans on, nothing drained)."""
from zkbench.span_tracing import idle_per_proof


def read(run):
    return idle_per_proof(run, ("zk.limbs.encode", "zk.limbs.decode"))
