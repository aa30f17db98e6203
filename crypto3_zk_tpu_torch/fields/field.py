"""Host-side scalar field arithmetic (python ints).

This is the bit-exact oracle layer: the verifier and all transcript /
proof-assembly logic run here (they are tiny and sequential — reference:
`verifier.hpp:142-400` is all scalar work), while the prover's bulk math
runs on TPU via `ops/limbs.py`. Mirrors the `FieldType::value_type`
interface of crypto3-multiprecision (SURVEY.md §2.0).
"""
from __future__ import annotations

from .params import FieldSpec


class Fp:
    """An element of GF(p). Immutable, hashable."""

    __slots__ = ("fs", "v")

    def __init__(self, fs: FieldSpec, v: int):
        self.fs = fs
        self.v = v % fs.p

    # --- constructors ---
    @staticmethod
    def zero(fs: FieldSpec) -> "Fp":
        return Fp(fs, 0)

    @staticmethod
    def one(fs: FieldSpec) -> "Fp":
        return Fp(fs, 1)

    # --- arithmetic ---
    def __add__(self, o):
        return Fp(self.fs, self.v + _val(o))

    __radd__ = __add__

    def __sub__(self, o):
        return Fp(self.fs, self.v - _val(o))

    def __rsub__(self, o):
        return Fp(self.fs, _val(o) - self.v)

    def __mul__(self, o):
        return Fp(self.fs, self.v * _val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return Fp(self.fs, -self.v)

    def __pow__(self, e: int):
        if e < 0:
            return self.inversed() ** (-e)
        return Fp(self.fs, pow(self.v, e, self.fs.p))

    def __truediv__(self, o):
        o = o if isinstance(o, Fp) else Fp(self.fs, _val(o))
        return self * o.inversed()

    def inversed(self) -> "Fp":
        return Fp(self.fs, pow(self.v, -1, self.fs.p))

    def squared(self) -> "Fp":
        return self * self

    def doubled(self) -> "Fp":
        return self + self

    def is_zero(self) -> bool:
        return self.v == 0

    def is_one(self) -> bool:
        return self.v == 1

    def sqrt(self) -> "Fp":
        """Tonelli–Shanks; raises ValueError if not a QR."""
        p, v = self.fs.p, self.v
        if v == 0:
            return self
        if pow(v, (p - 1) // 2, p) != 1:
            raise ValueError("not a quadratic residue")
        if p % 4 == 3:
            return Fp(self.fs, pow(v, (p + 1) // 4, p))
        # general Tonelli–Shanks
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = self.fs.generator
        m, c, t, r = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return Fp(self.fs, r)

    # --- comparison / hashing ---
    def __eq__(self, o):
        if isinstance(o, Fp):
            return self.fs.p == o.fs.p and self.v == o.v
        if isinstance(o, int):
            return self.v == o % self.fs.p
        return NotImplemented

    def __hash__(self):
        return hash((self.fs.p, self.v))

    def __repr__(self):
        return f"Fp<{self.fs.name}>({hex(self.v)})"

    def __int__(self):
        return self.v


def _val(o) -> int:
    return o.v if isinstance(o, Fp) else int(o)
