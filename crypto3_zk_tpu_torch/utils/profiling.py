"""Spans of the proving paths, and parameter reporting.

Counterpart of `utils/profiling.py` of the JAX package:
- `span`, the port's form of `PROFILE_PLACEHOLDER_SCOPE`
  (`detail/placeholder_scoped_profiler.hpp:39-126`): a named range of the
  proving path, `zk.<layer>.<step>`, that lands among a `torch.profiler`
  trace's CPU events, on the same clock as the card's kernels; `spanned`
  puts a whole function under one. Spans are off unless a caller switches
  them on around the proofs it profiles (`spans_on`); off, a span is one
  check of a module-level flag. A span never waits for the card and reads
  no clock of its own: what it shows is read from the profiler's trace
  (PERF.md, section 3, lists the names);
- `placeholder_info` / `print_placeholder_params`
  (`detail/profiling.hpp:50-282`): proof-size and parameter reporters.
"""
from __future__ import annotations

import contextlib
import functools
import json

import torch

_ON = False
_OFF = contextlib.nullcontext()      # what `span` gives while spans are off


def span(name: str):
    """A context manager over one step of the proving path: while spans
    are on, a `torch.profiler.record_function` range named `name`."""
    if _ON:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """A decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def spans_on():
    """Spans on inside the block (for the proofs a profiler traces)."""
    global _ON
    before, _ON = _ON, True
    try:
        yield
    finally:
        _ON = before


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
