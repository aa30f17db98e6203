"""Fiat–Shamir transcript (sequential heuristic). Host only.

Counterpart of `transcript/fiat_shamir.py` of the JAX package. Re-implements the protocol-critical behavior of
`transcript/fiat_shamir.hpp:134-216` (fiat_shamir_heuristic_sequential):

- ctor:              state = H(seed_bytes)          (default seed = 0x00)
- absorb(r):         state = H(state || r)
- challenge<F>():    state = H(state); return int_be(state) mod p
- int_challenge<I>(): state = H(state); return int_be(state) & mask(I)

Field/curve elements are absorbed as big-endian byteblobs of
ceil(modulus_bits/8) bytes (`marshalling::pack` semantics, `kzg.hpp:335-346`).
The Poseidon-sponge specialization (`fiat_shamir.hpp:219-314`) is
`PoseidonTranscript` in `transcript/poseidon_transcript.py`.
"""
from __future__ import annotations

from ..fields.params import FieldSpec
from .hashes import get_hash


def field_bytes_len(fs: FieldSpec) -> int:
    return (fs.bits + 7) // 8


def field_to_bytes(fs: FieldSpec, v: int) -> bytes:
    return (v % fs.p).to_bytes(field_bytes_len(fs), "big")


class Transcript:
    """Byte-hash Fiat–Shamir chain."""

    def __init__(self, hash_name: str = "keccak_256", seed: bytes = b"\x00"):
        self.hash_name = hash_name
        self._h, self.digest_len = get_hash(hash_name)
        self.state = self._h(seed)

    def absorb(self, data: bytes) -> None:
        self.state = self._h(self.state + data)

    def absorb_field(self, fs: FieldSpec, v: int) -> None:
        self.absorb(field_to_bytes(fs, v))

    def absorb_fields(self, fs: FieldSpec, vs) -> None:
        for v in vs:
            self.absorb_field(fs, v)

    def challenge(self, fs: FieldSpec) -> int:
        self.state = self._h(self.state)
        return int.from_bytes(self.state, "big") % fs.p

    def challenges(self, fs: FieldSpec, n: int) -> list[int]:
        return [self.challenge(fs) for _ in range(n)]

    def int_challenge(self, bits: int = 64) -> int:
        self.state = self._h(self.state)
        return int.from_bytes(self.state, "big") & ((1 << bits) - 1)

    def fork(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t.hash_name, t._h, t.digest_len = self.hash_name, self._h, self.digest_len
        t.state = self.state
        return t


class AccumulativeTranscript:
    """Legacy `fiat_shamir_heuristic_accumulative` (`fiat_shamir.hpp:72-131`).

    Kept for API parity only: the reference variant accumulates absorbed
    bytes into a running hash but its `challenge` path degenerates to
    `field::one()` (the upstream code literally returns one — documented
    unused/broken there). Reproduced faithfully, with the accumulation
    observable via `digest()` so tests can pin the byte behavior."""

    def __init__(self, hash_name: str = "keccak_256"):
        self.hash_name = hash_name
        self._h, self.digest_len = get_hash(hash_name)
        self._acc = b""

    def absorb(self, data: bytes) -> None:
        self._acc = self._h(self._acc + data)

    def digest(self) -> bytes:
        return self._acc

    def challenge(self, fs: FieldSpec) -> int:
        return 1

    def int_challenge(self, bits: int = 64) -> int:
        return 1
