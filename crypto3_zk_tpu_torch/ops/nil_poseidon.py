"""NilFoundation-flavor Poseidon permutation (Pallas base field).

Counterpart of `ops/nil_poseidon.py` of the JAX package. The reference's
Poseidon transcript and zkLLVM circuits use crypto3-hash's
`mina_poseidon_policy` (`fiat_shamir.hpp:241-242`): width 3, 55 FULL rounds,
x^7 S-box, round = `state <- MDS @ sbox(state) + rc`: a kimchi-style
schedule, the other order from the original Poseidon (`ops/poseidon.py`:
rc-add first, partial rounds). The constant tables are recovered from the
reference's own artifact (see `nil_poseidon_constants.py`).

Host scalar permutation (transcript/Merkle oracle side) + the batched
permutation, which is ONE launch of kernel 5 (`ops/hopper_hash.py`) with the
schedule flag `rc_first` off.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import FieldSpec
from . import hopper_hash as HH
from . import limbs as L
from . import nil_poseidon_constants as NC

T = 3
N_ROUNDS = 55
ALPHA = 7


class NilPoseidonParams:
    """Duck-types the `PoseidonParams` surface the Merkle layer and kernel 5
    use. Hashable, so that the constant tables cache per parameter set."""

    def __init__(self, fs: FieldSpec):
        if fs.p != NC.P:
            raise ValueError("nil poseidon constants are Pallas-Fq only")
        self.fs = fs
        self.t = T
        self.mds = NC.MDS
        self.round_constants = NC.ROUND_CONSTANTS
        self.alpha = ALPHA
        self.rc_first = False           # S-box -> MDS -> add rc
        self.partial_rounds = (0, 0)    # every round is full

    def __hash__(self):
        return hash(("nil_poseidon", self.fs))

    def __eq__(self, o):
        return isinstance(o, NilPoseidonParams) and o.fs == self.fs

    @functools.cached_property
    def rc_dev(self):
        # (rounds, NL, t, 1) Montgomery-form numpy (see PoseidonParams)
        flat = [c * self.fs.R % self.fs.p
                for rc in self.round_constants for c in rc]
        arr = L.pack_ints(self.fs, flat)
        r = arr.reshape(self.fs.nl, N_ROUNDS, T, 1)
        return np.ascontiguousarray(np.transpose(r, (1, 0, 2, 3)))

    @functools.cached_property
    def mds_dev(self):
        flat = [c * self.fs.R % self.fs.p for row in self.mds for c in row]
        return L.pack_ints(self.fs, flat).reshape(self.fs.nl, T, T, 1)


@functools.lru_cache(maxsize=None)
def get_params(fs: FieldSpec) -> NilPoseidonParams:
    return NilPoseidonParams(fs)


def permute_host(pp: NilPoseidonParams, state: list[int]) -> list[int]:
    p = pp.fs.p
    s = [x % p for x in state]
    for rc in pp.round_constants:
        sb = [pow(x, ALPHA, p) for x in s]
        s = [(sum(pp.mds[i][j] * sb[j] for j in range(T)) + rc[i]) % p
             for i in range(T)]
    return s


def hash2_host(pp: NilPoseidonParams, a: int, b: int) -> int:
    return permute_host(pp, [a, b, 0])[0]


def permute_batch(pp: NilPoseidonParams, state: torch.Tensor) -> torch.Tensor:
    """state: (NL, t, n) Montgomery form -> permuted, one launch."""
    return HH.poseidon_permute_hopper(
        pp, (state[:, 0], state[:, 1], state[:, 2]))


def hash2_batch(pp: NilPoseidonParams, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    return HH.poseidon_permute_hopper(pp, (a, b, None), lane0_only=True)
