"""Knowledge commitments: (g, h) group-element pairs and their multiexps.

Counterpart of `commitments/knowledge_commitment.py` of the JAX package
(`commitments/polynomial/knowledge_commitment.hpp:50`,
`detail/polynomial/element_knowledge_commitment.hpp:54` and
`knowledge_commitment_multiexp.hpp`: `kc_multiexp_with_mixed_addition`,
`kc_batch_exp`). Used by PGHR13's A/B/C queries (`models/pghr13.py`).

Both component multiexps run through the port's MSM path
(`models/groth16::_msm_skip_inf`: the batched-affine MSM on the device from
`_DEVICE_MSM_MIN` bases, the host below it and for a != 0 curves), and a
batch exponentiation of a fixed (g, h) pair is the fixed-base batch of
`ops/msm.py` on the device: the pair structure is bookkeeping.
"""
from __future__ import annotations

import dataclasses

from ..ops.msm import fixed_base_exp_batch


@dataclasses.dataclass
class KC:
    """knowledge_commitment element: g in the main group, h in G1."""
    g: tuple
    h: tuple


@dataclasses.dataclass
class KnowledgeCommitmentVector:
    """`knowledge_commitment_vector`: sparse storage of KC elements —
    (index, value) pairs over a conceptual dense domain."""
    indices: list[int]
    values: list[KC]
    domain_size: int

    @classmethod
    def from_dense(cls, elems: list[KC | None]) -> "KnowledgeCommitmentVector":
        idx, vals = [], []
        for i, e in enumerate(elems):
            if e is not None and not (e.g is None and e.h is None):
                idx.append(i)
                vals.append(e)
        return cls(idx, vals, len(elems))

    def to_dense(self) -> list[KC | None]:
        out: list[KC | None] = [None] * self.domain_size
        for i, v in zip(self.indices, self.values):
            out[i] = v
        return out


def kc_multiexp(curve, query: list[KC], scalars: list[int], g2_main=False,
                msm_skip_inf=None, device=None, **kw):
    """`kc_multiexp_with_mixed_addition`: component-wise multiexp of a KC
    query — returns the aggregate (sum s_i * g_i, sum s_i * h_i), on
    `device` (default: the card). `msm_skip_inf` defaults to Groth16's;
    further keywords go to it."""
    if msm_skip_inf is None:
        from ..models.groth16 import _msm_skip_inf as msm_skip_inf
    gs = msm_skip_inf(curve, [q.g for q in query], scalars,
                      group="g2" if g2_main else "g1", device=device, **kw)
    hs = msm_skip_inf(curve, [q.h for q in query], scalars, device=device,
                      **kw)
    return gs, hs


def kc_batch_exp(curve, g_base, h_base, scalars: list[int],
                 g2_main: bool = False, c: int = 8, device=None) -> list[KC]:
    """`kc_batch_exp`: [KC(s_i * g, s_i * h) for s_i], both component
    batches by the fixed-base batch on `device` (default: the card), which
    refuses a != 0 curves."""
    gs = fixed_base_exp_batch(curve, g_base, scalars, c=c,
                              group="g2" if g2_main else "g1", device=device)
    hs = fixed_base_exp_batch(curve, h_base, scalars, c=c, group="g1",
                              device=device)
    return [KC(g, h) for g, h in zip(gs, hs)]
