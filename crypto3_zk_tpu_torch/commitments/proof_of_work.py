"""Grinding proof-of-work (`detail/polynomial/proof_of_work.hpp:47-128`).

uint32 variant: find a 4-byte nonce such that the transcript's next 32-bit
int challenge masked by `mask` is zero. The reference seeds the search with
rand(); here the search starts at 0 for reproducibility — the protocol only
constrains the (nonce, challenge) relation, not the starting point.
"""
from __future__ import annotations

from ..fields.params import FieldSpec
from ..transcript.fiat_shamir import Transcript


def generate(transcript: Transcript, mask: int = 0xFFFF) -> int:
    nonce = 0
    while True:
        t = transcript.fork()
        t.absorb(nonce.to_bytes(4, "big"))
        if t.int_challenge(32) & mask == 0:
            break
        nonce += 1
    transcript.absorb(nonce.to_bytes(4, "big"))
    transcript.int_challenge(32)
    return nonce


def verify(transcript: Transcript, nonce: int, mask: int = 0xFFFF) -> bool:
    transcript.absorb((nonce & 0xFFFFFFFF).to_bytes(4, "big"))
    return transcript.int_challenge(32) & mask == 0


def field_generate(transcript: Transcript, fs: FieldSpec,
                   grinding_bits: int = 16) -> int:
    """field_proof_of_work (`proof_of_work.hpp:86-128`): mask applies to the
    HIGH bits of the field challenge."""
    mask = ((1 << grinding_bits) - 1) << (fs.bits - grinding_bits) \
        if grinding_bits > 0 else 0
    nonce = 0
    while True:
        t = transcript.fork()
        t.absorb_field(fs, nonce)
        if t.challenge(fs) & mask == 0:
            break
        nonce += 1
    transcript.absorb_field(fs, nonce)
    transcript.challenge(fs)
    return nonce


def field_verify(transcript: Transcript, fs: FieldSpec, nonce: int,
                 grinding_bits: int = 16) -> bool:
    mask = ((1 << grinding_bits) - 1) << (fs.bits - grinding_bits) \
        if grinding_bits > 0 else 0
    transcript.absorb_field(fs, nonce)
    return transcript.challenge(fs) & mask == 0
