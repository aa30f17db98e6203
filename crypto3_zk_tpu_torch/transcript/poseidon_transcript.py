"""Poseidon sponge transcript (recursion-friendly). Host only.

Counterpart of `transcript/poseidon_transcript.py` of the JAX package.
`fiat_shamir.hpp:219-314` (the nil-Poseidon specialization): field elements
are absorbed natively into a rate-2 sponge; challenge = squeeze; a second
challenge without an intervening absorb re-permutes and squeezes again
(the documented second-squeeze semantics at `fiat_shamir.hpp:229-237`).
Byte inputs are packed into sub-field-size chunks and absorbed as elements.
"""
from __future__ import annotations

from ..fields.params import FieldSpec
from ..ops import poseidon as PO


class PoseidonSponge:
    def __init__(self, fs: FieldSpec, flavor: str = "original"):
        self.fs = fs
        if flavor == "nil":
            # NilFoundation's own permutation, recovered from the zkLLVM
            # circuit dump (`ops/nil_poseidon.py`); sponge scheduling stays
            # this module's (the crypto3-hash nil_poseidon_sponge absorb/
            # squeeze schedule has no in-repo oracle)
            from ..ops import nil_poseidon as NP
            self.pp = NP.get_params(fs)
        else:
            self.pp = PO.get_params(fs)
        self.state = [0, 0, 0]
        self.buffer: list[int] = []
        self._fresh_output = False

    @property
    def _po(self):
        # computed, not stored: a module attribute breaks deepcopy of
        # objects holding sponges
        from ..commitments.merkle import _po_mod
        return _po_mod(self.pp)

    def absorb(self, v: int):
        self.buffer.append(v % self.fs.p)
        self._fresh_output = False
        if len(self.buffer) == 2:
            self._flush()

    def _flush(self):
        p = self.fs.p
        if not self.buffer:
            return
        self.state[0] = (self.state[0] + self.buffer[0]) % p
        if len(self.buffer) > 1:
            self.state[1] = (self.state[1] + self.buffer[1]) % p
        self.buffer = []
        self.state = self._po.permute_host(self.pp, self.state)

    def squeeze(self) -> int:
        if self.buffer:
            self._flush()
            self._fresh_output = True
        elif not self._fresh_output:
            self.state = self._po.permute_host(self.pp, self.state)
            self._fresh_output = True
        out = self.state[0]
        self._fresh_output = False
        return out


class PoseidonTranscript:
    """API-compatible with `fiat_shamir.Transcript`."""

    def __init__(self, fs: FieldSpec, seed: bytes = b"",
                 flavor: str = "original"):
        self.fs = fs
        self.sponge = PoseidonSponge(fs, flavor)
        if seed:
            self.absorb(seed)

    def _bytes_to_elems(self, data: bytes) -> list[int]:
        chunk = (self.fs.bits - 1) // 8
        return [int.from_bytes(data[i:i + chunk], "big")
                for i in range(0, len(data), chunk)]

    def absorb(self, data: bytes) -> None:
        for v in self._bytes_to_elems(data):
            self.sponge.absorb(v)

    def absorb_field(self, fs: FieldSpec, v: int) -> None:
        assert fs.p == self.fs.p, "poseidon transcript is field-native"
        self.sponge.absorb(v)

    def absorb_fields(self, fs: FieldSpec, vs) -> None:
        for v in vs:
            self.absorb_field(fs, v)

    def challenge(self, fs: FieldSpec) -> int:
        return self.sponge.squeeze() % fs.p

    def challenges(self, fs: FieldSpec, n: int) -> list[int]:
        return [self.challenge(fs) for _ in range(n)]

    def int_challenge(self, bits: int = 64) -> int:
        return self.sponge.squeeze() & ((1 << bits) - 1)

    def fork(self) -> "PoseidonTranscript":
        t = PoseidonTranscript.__new__(PoseidonTranscript)
        t.fs = self.fs
        t.sponge = PoseidonSponge(self.fs)
        t.sponge.pp = self.sponge.pp
        t.sponge.state = list(self.sponge.state)
        t.sponge.buffer = list(self.sponge.buffer)
        t.sponge._fresh_output = self.sponge._fresh_output
        return t


def make_transcript(hash_name: str, fs: FieldSpec, seed: bytes = b""):
    """Factory selecting byte-hash chain vs Poseidon sponge."""
    if hash_name == "poseidon":
        return PoseidonTranscript(fs, seed)
    from .fiat_shamir import Transcript
    return Transcript(hash_name, seed)
