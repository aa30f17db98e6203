"""Poseidon permutation: batched device permutation + host scalar oracle.

Counterpart of `ops/poseidon.py` of the JAX package. The reference consumes
Poseidon from crypto3-hash (nil/Mina flavors, `fiat_shamir.hpp:33-39`); the
sibling repo's constants are not vendored, so parameters are generated with
the ORIGINAL Poseidon reference method (Grain LFSR round constants + Cauchy
MDS matrix, as in the Poseidon paper's reference sage implementation):
deterministic, reproducible, and parameterized per field. Width t=3 (rate 2,
capacity 1), R_F=8 full rounds, R_P=57 partial (256-bit security margin for
~255-bit p).

The batched permutation runs over states of shape (NL, t, n), limb axis
first. It is ONE launch of kernel 5 (`ops/hopper_hash.py`,
`csrc/poseidon.cu`) on the card and that kernel's plain version on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import FieldSpec
from . import hopper_hash as HH
from . import limbs as L

# ---------------------------------------------------------------------------
# parameter generation (Grain LFSR, per the Poseidon reference implementation)
# ---------------------------------------------------------------------------

class _GrainLFSR:
    """80-bit Grain LFSR as one python int (bit 0 = s_0, oldest)."""

    def __init__(self, field_bits: int, t: int, r_f: int, r_p: int):
        bits = []
        bits += _int_bits(1, 2)          # field: GF(p)
        bits += _int_bits(0, 4)          # sbox: x^alpha
        bits += _int_bits(field_bits, 12)
        bits += _int_bits(t, 12)
        bits += _int_bits(r_f, 10)
        bits += _int_bits(r_p, 10)
        bits += [1] * 30
        assert len(bits) == 80
        v = 0
        for i, b in enumerate(bits):
            v |= b << i
        self.state = v
        for _ in range(160):
            self._next_bit()

    def _next_bit(self) -> int:
        s = self.state
        nb = ((s >> 62) ^ (s >> 51) ^ (s >> 38) ^ (s >> 23) ^ (s >> 13) ^ s) & 1
        self.state = (s >> 1) | (nb << 79)
        return nb

    def next_filtered_bit(self) -> int:
        while True:
            b1 = self._next_bit()
            b2 = self._next_bit()
            if b1:
                return b2

    def field_element(self, p: int, field_bits: int) -> int:
        while True:
            v = 0
            for _ in range(field_bits):
                v = (v << 1) | self.next_filtered_bit()
            if v < p:
                return v


def _int_bits(v: int, n: int) -> list[int]:
    return [(v >> (n - 1 - i)) & 1 for i in range(n)]


class PoseidonParams:
    def __init__(self, fs: FieldSpec, t: int = 3, r_f: int = 8, r_p: int = 57):
        self.fs = fs
        self.t = t
        self.r_f = r_f
        self.r_p = r_p
        # the schedule as kernel 5 reads it: add rc -> S-box -> MDS, the
        # middle r_p rounds partial
        self.rc_first = True
        self.partial_rounds = (r_f // 2, r_f // 2 + r_p)
        # smallest alpha with gcd(alpha, p-1) == 1
        for alpha in (5, 7, 11, 13, 17):
            if _gcd(alpha, fs.p - 1) == 1:
                self.alpha = alpha
                break
        else:
            raise ValueError("no suitable alpha")
        lfsr = _GrainLFSR(fs.bits, t, r_f, r_p)
        n_rounds = r_f + r_p
        self.round_constants = [
            [lfsr.field_element(fs.p, fs.bits) for _ in range(t)]
            for _ in range(n_rounds)
        ]
        # Cauchy MDS: M[i][j] = 1 / (x_i + y_j), x_i = i, y_j = t + j
        self.mds = [
            [pow((i + t + j) % fs.p, -1, fs.p) for j in range(t)]
            for i in range(t)
        ]

    # --- constant digit planes (numpy, Montgomery form; the kernel's own
    # table and its per-device copies are built in `hopper_hash`) ---
    @functools.cached_property
    def rc_dev(self):
        # (rounds, NL, t, 1); state layout is limb-first
        flat = [c * self.fs.R % self.fs.p
                for rc in self.round_constants for c in rc]
        arr = L.pack_ints(self.fs, flat)  # np (NL, rounds*t)
        r = arr.reshape(self.fs.nl, len(self.round_constants), self.t, 1)
        return np.ascontiguousarray(np.transpose(r, (1, 0, 2, 3)))

    @functools.cached_property
    def mds_dev(self):
        # (NL, t, t, 1)
        flat = [c * self.fs.R % self.fs.p for row in self.mds for c in row]
        arr = L.pack_ints(self.fs, flat)
        return arr.reshape(self.fs.nl, self.t, self.t, 1)


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a


@functools.lru_cache(maxsize=None)
def get_params(fs: FieldSpec, t: int = 3) -> PoseidonParams:
    return PoseidonParams(fs, t=t)


# ---------------------------------------------------------------------------
# host scalar permutation (oracle / transcript side)
# ---------------------------------------------------------------------------

def permute_host(pp: PoseidonParams, state: list[int]) -> list[int]:
    p, t = pp.fs.p, pp.t
    s = [x % p for x in state]
    half = pp.r_f // 2
    for r in range(pp.r_f + pp.r_p):
        s = [(x + c) % p for x, c in zip(s, pp.round_constants[r])]
        if half <= r < half + pp.r_p:
            s[0] = pow(s[0], pp.alpha, p)  # partial round
        else:
            s = [pow(x, pp.alpha, p) for x in s]
        s = [sum(pp.mds[i][j] * s[j] for j in range(t)) % p for i in range(t)]
    return s


def hash2_host(pp: PoseidonParams, a: int, b: int) -> int:
    """2-to-1 compression: state=[a,b,0] -> permute -> state[0]."""
    return permute_host(pp, [a, b, 0])[0]


# ---------------------------------------------------------------------------
# batched device permutation
# ---------------------------------------------------------------------------

def permute_batch(pp: PoseidonParams, state: torch.Tensor) -> torch.Tensor:
    """state: (NL, t, n) Montgomery form -> permuted state, one launch."""
    return HH.poseidon_permute_hopper(
        pp, (state[:, 0], state[:, 1], state[:, 2]))


def hash2_batch(pp: PoseidonParams, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Batched 2-to-1 compression. a, b: (NL, n) -> (NL, n): the state
    [a, b, 0] permuted, element 0 kept."""
    return HH.poseidon_permute_hopper(pp, (a, b, None), lane0_only=True)


# hashable, so that the constant tables cache per parameter set
PoseidonParams.__hash__ = lambda self: hash((self.fs, self.t, self.r_f, self.r_p))
PoseidonParams.__eq__ = lambda self, o: (
    isinstance(o, PoseidonParams)
    and (self.fs, self.t, self.r_f, self.r_p) == (o.fs, o.t, o.r_f, o.r_p))
