"""Counterpart of `utils/sparse_vector.py` of the JAX package.

Sparse and accumulation vectors for verification keys.

`container::sparse_vector` and `accumulation_vector` as used by the SNARK
verifiers' IC accumulation (`verifier.hpp (gg):156-158`): the vk stores
gamma_ABC as first + sparse rest; `accumulate_chunk` folds the primary
input into a single group element. The fold is a small MSM, on the device
(default the card) from `models/groth16._DEVICE_MSM_MIN` bases up, on the
host below (`models/groth16._msm_skip_inf`).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SparseVector:
    indices: list[int]
    values: list
    domain_size: int

    @classmethod
    def from_dense(cls, elems: list) -> "SparseVector":
        idx, vals = [], []
        for i, e in enumerate(elems):
            if e is not None:
                idx.append(i)
                vals.append(e)
        return cls(idx, vals, len(elems))

    def to_dense(self) -> list:
        out = [None] * self.domain_size
        for i, v in zip(self.indices, self.values):
            out[i] = v
        return out

    def is_valid(self) -> bool:
        return (len(self.indices) == len(self.values)
                and all(i < self.domain_size for i in self.indices)
                and self.indices == sorted(set(self.indices)))


@dataclasses.dataclass
class AccumulationVector:
    """first + sparse rest; `accumulate_chunk(begin, end, offset)` folds
    scalars against the rest and adds into first."""
    first: object
    rest: SparseVector

    @classmethod
    def from_dense(cls, elems: list) -> "AccumulationVector":
        return cls(elems[0], SparseVector.from_dense(elems[1:]))

    def size(self) -> int:
        return 1 + self.rest.domain_size

    def accumulate_chunk(self, curve, scalars: list[int],
                         offset: int = 0,
                         device=None) -> "AccumulationVector":
        from ..models.groth16 import _msm_skip_inf
        from ..fields import curves as CV
        pts, sc = [], []
        remaining_idx, remaining_vals = [], []
        window = range(offset, offset + len(scalars))
        for i, v in zip(self.rest.indices, self.rest.values):
            if i in window:
                pts.append(v)
                sc.append(scalars[i - offset])
            else:
                remaining_idx.append(i)
                remaining_vals.append(v)
        acc = self.first
        if pts:
            folded = _msm_skip_inf(curve, pts, sc, device=device)
            acc = CV.g1_add(curve, acc, folded)
        return AccumulationVector(
            acc, SparseVector(remaining_idx, remaining_vals,
                              self.rest.domain_size))


class SparseAccumulator:
    """Streaming sparse-vector accumulator.

    `commitments/polynomial/accumulators/sparse.hpp:60-160` (the
    boost.accumulators adapter): scalar chunks arrive with an offset;
    matching index blocks of the sparse vector are folded into a running
    group element by multiexp, the untouched entries stay sparse. Drives
    the same `accumulate_chunk` fold as `AccumulationVector`."""

    def __init__(self, curve, vector: "AccumulationVector", device=None):
        self.curve = curve
        self.state = vector
        self.device = device

    def __call__(self, scalars: list[int], offset: int = 0
                 ) -> "SparseAccumulator":
        self.state = self.state.accumulate_chunk(self.curve, scalars,
                                                 offset, self.device)
        return self

    def result(self):
        """(accumulated group element, remaining sparse rest)."""
        return self.state.first, self.state.rest
