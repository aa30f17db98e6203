"""Counterpart of `utils/algebraic_engine.py` of the JAX package (host
only).

Seedable randomness for algebraic objects.

`random::algebraic_engine` as consumed by the generators
(`generator.hpp (gg):93-102`): a deterministic engine producing uniformly
distributed field elements and group points from a seed, so CRS/test
fixtures are reproducible. Host-side (key generation randomness is not a
hot path); rejection sampling keeps field draws unbiased.
"""
from __future__ import annotations

import hashlib
import random

from ..fields import curves as CV
from ..fields.params import FieldSpec


class AlgebraicEngine:
    def __init__(self, seed: int | bytes | None = None):
        if isinstance(seed, bytes):
            seed = int.from_bytes(hashlib.sha256(seed).digest(), "big")
        self._rng = random.Random(seed)

    def field_element(self, fs: FieldSpec) -> int:
        # rejection sampling over the next power of two: unbiased mod p
        bits = fs.bits
        while True:
            v = self._rng.getrandbits(bits)
            if v < fs.p:
                return v

    def nonzero_field_element(self, fs: FieldSpec) -> int:
        while True:
            v = self.field_element(fs)
            if v:
                return v

    def field_elements(self, fs: FieldSpec, n: int) -> list[int]:
        return [self.field_element(fs) for _ in range(n)]

    def g1(self, curve: CV.CurveSpec) -> tuple:
        return CV.g1_mul(curve, curve.g1,
                         self.nonzero_field_element(curve.fr))

    def g2(self, curve: CV.CurveSpec) -> tuple:
        return CV.g2_mul(curve, curve.g2,
                         self.nonzero_field_element(curve.fr))
