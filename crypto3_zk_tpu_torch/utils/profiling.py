"""Scoped profiling and parameter reporting.

Counterpart of `utils/profiling.py` of the JAX package:
- `profile_scope`, `PROFILE_PLACEHOLDER_SCOPE` /
  `placeholder_scoped_profiler` of the reference
  (`detail/placeholder_scoped_profiler.hpp:39-126`): wall-clock scopes with
  an aggregate call-stats registry, printed at exit; each scope is also a
  `torch.profiler.record_function` range, so that it shows in a
  `torch.profiler` trace;
- `placeholder_info` / `print_placeholder_params`
  (`detail/profiling.hpp:50-282`): proof-size and parameter reporters.

Enabled by ZK_TPU_PROFILING=1 (the reference gates on the
ZK_PLACEHOLDER_PROFILING_ENABLED compile flag). A scope's wall clock does
not wait for the card: a caller that times device work drains it inside
the scope.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import time

import torch

ENABLED = os.environ.get("ZK_TPU_PROFILING", "0") == "1"

_stats = collections.defaultdict(lambda: [0, 0.0])  # name -> [calls, total_s]


class profile_scope:
    """`PROFILE_PLACEHOLDER_SCOPE(name)`."""

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if ENABLED:
            self._t0 = time.perf_counter()
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if ENABLED:
            self._range.__exit__(*exc)
            dt = time.perf_counter() - self._t0
            _stats[self.name][0] += 1
            _stats[self.name][1] += dt
            print(f"[zk-tpu profile] {self.name}: {dt:.4f}s", flush=True)
        return False


@atexit.register
def _print_call_stats():
    """`placeholder_scoped_aggregate_profiler` exit dump."""
    if ENABLED and _stats:
        print("[zk-tpu profile] aggregate call stats:")
        for name, (calls, total) in sorted(_stats.items(),
                                           key=lambda kv: -kv[1][1]):
            print(f"  {name}: {calls} calls, {total:.4f}s total")


def placeholder_info(proof, common_data) -> dict:
    """Proof-size / parameter report (`profiling.hpp:50-282`)."""
    z = proof.eval_proof.eval_proof.z
    return {
        "rows_amount": common_data.desc.rows_amount,
        "usable_rows_amount": common_data.desc.usable_rows_amount,
        "columns": {
            "witness": common_data.desc.witness_columns,
            "public_input": common_data.desc.public_input_columns,
            "constant": common_data.desc.constant_columns,
            "selector": common_data.desc.selector_columns,
        },
        "max_gates_degree": common_data.max_gates_degree,
        "permutation_parts": common_data.permutation_parts,
        "lookup_parts": common_data.lookup_parts,
        "max_quotient_chunks": common_data.max_quotient_chunks,
        "batches": {str(k): len(z.z[k]) for k in z.batches()},
        "total_opened_values": sum(
            len(pts) for k in z.batches() for pts in z.z[k]),
    }


def print_placeholder_params(common_data, commitment_params) -> str:
    """The table's rows and the commitment's parameters as JSON."""
    out = {
        "table": {
            "rows": common_data.desc.rows_amount,
            "usable_rows": common_data.desc.usable_rows_amount,
        },
        "commitment": commitment_params.transcript_repr(),
    }
    return json.dumps(out, indent=2)
