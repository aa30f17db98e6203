"""The 90th percentile of the window's per-proof wall times (host clock);
the count it was taken over goes to standard error."""
import statistics


def read(run):
    if len(run.proof_seconds) < 2:
        return None
    return statistics.quantiles(run.proof_seconds, n=10)[8]
