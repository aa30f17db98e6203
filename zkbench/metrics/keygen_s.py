"""Seconds of `groth16.generate` in set-up (host clock, device drained)."""


def read(run):
    return run.spans.get("keygen_s")
