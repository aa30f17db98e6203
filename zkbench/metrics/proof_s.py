"""Seconds a proof: from the window's start to the completion of its last
proof, over the proofs completed (host clock, each proof ending with the
proof object on the host). A failed proof is no completion."""


def read(run):
    if not run.proof_seconds:
        return None
    return run.window_s / len(run.proof_seconds)
