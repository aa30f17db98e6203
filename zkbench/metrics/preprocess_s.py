"""Seconds of `preprocessor.process_public` in set-up (host clock, device
drained)."""


def read(run):
    return run.spans.get("preprocess_s")
