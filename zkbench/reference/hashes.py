"""Keccak-256, the byte-hash Fiat-Shamir transcript, and Poseidon over a
prime field with its Merkle hashing, for the reference.

Plain Python integers. Keccak-256 is the original Keccak (padding 0x01 ..
0x80, rate 1088 bits), not SHA3-256. Poseidon is the reference
implementation's: Grain-LFSR round constants, a Cauchy MDS matrix
M[i][j] = 1 / (i + t + j), the smallest alpha prime to p - 1, rounds of
add-constants, S-box, mix, the middle R_P rounds partial. Merkle leaves
absorb their elements two a permutation into a width-3 state (element 0 is
the digest); a node hashes [left, right, 0].
"""
from __future__ import annotations

import functools

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _M64


def _keccak_f(state: list[int]) -> list[int]:
    a = [[state[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _RC:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y]
                                     & _M64)
        a[0][0] ^= rc
    return [a[x][y] for y in range(5) for x in range(5)]


def keccak_256(data: bytes) -> bytes:
    rate = 136
    state = [0] * 25
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 \
        else b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off:off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = _keccak_f(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


class Transcript:
    """The keccak-256 Fiat-Shamir chain: absorb replaces the state by the
    hash of state + data; a challenge hashes the state and reads it as a
    big-endian integer mod p."""

    def __init__(self, p: int, seed: bytes = b""):
        self.p = p
        self.nbytes = (p.bit_length() + 7) // 8
        self.state = keccak_256(seed)

    def absorb(self, data: bytes) -> None:
        self.state = keccak_256(self.state + data)

    def absorb_field(self, v: int) -> None:
        self.absorb((v % self.p).to_bytes(self.nbytes, "big"))

    def challenge(self) -> int:
        self.state = keccak_256(self.state)
        return int.from_bytes(self.state, "big") % self.p

    def challenges(self, n: int) -> list[int]:
        return [self.challenge() for _ in range(n)]


class _Grain:
    """The 80-bit Grain LFSR of the Poseidon reference's parameter script."""

    def __init__(self, field_bits: int, t: int, r_f: int, r_p: int):
        bits = []
        for v, n in ((1, 2), (0, 4), (field_bits, 12), (t, 12), (r_f, 10),
                     (r_p, 10)):
            bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        bits += [1] * 30
        self.state = sum(b << i for i, b in enumerate(bits))
        for _ in range(160):
            self._bit()

    def _bit(self) -> int:
        s = self.state
        nb = ((s >> 62) ^ (s >> 51) ^ (s >> 38) ^ (s >> 23) ^ (s >> 13) ^ s) & 1
        self.state = (s >> 1) | (nb << 79)
        return nb

    def _filtered(self) -> int:
        while True:
            b1, b2 = self._bit(), self._bit()
            if b1:
                return b2

    def element(self, p: int, bits: int) -> int:
        while True:
            v = 0
            for _ in range(bits):
                v = (v << 1) | self._filtered()
            if v < p:
                return v


class Poseidon:
    """Width 3 (the Merkle trees' and the port's)."""

    def __init__(self, p: int, r_f: int = 8, r_p: int = 57):
        t = 3
        self.p, self.t, self.r_f, self.r_p = p, t, r_f, r_p
        self.alpha = next(a for a in (5, 7, 11, 13, 17)
                          if (p - 1) % a != 0)
        grain = _Grain(p.bit_length(), t, r_f, r_p)
        self.rc = [[grain.element(p, p.bit_length()) for _ in range(t)]
                   for _ in range(r_f + r_p)]
        self.mds = [[pow(i + t + j, -1, p) for j in range(t)]
                    for i in range(t)]

    def permute(self, state: list[int]) -> list[int]:
        p, alpha = self.p, self.alpha
        (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = self.mds
        a, b, c = (x % p for x in state)
        half = self.r_f // 2
        for r, (c0, c1, c2) in enumerate(self.rc):
            a, b, c = a + c0, b + c1, c + c2
            if half <= r < half + self.r_p:
                a = pow(a, alpha, p)
            else:
                a, b, c = pow(a, alpha, p), pow(b, alpha, p), pow(c, alpha, p)
            a, b, c = ((m00 * a + m01 * b + m02 * c) % p,
                       (m10 * a + m11 * b + m12 * c) % p,
                       (m20 * a + m21 * b + m22 * c) % p)
        return [a, b, c]

    def leaf(self, elems: list[int]) -> int:
        """A Merkle leaf's digest: its elements absorbed two a permutation."""
        p = self.p
        state = [0, 0, 0]
        for i in range(0, len(elems), 2):
            state[0] = (state[0] + elems[i]) % p
            if i + 1 < len(elems):
                state[1] = (state[1] + elems[i + 1]) % p
            state = self.permute(state)
        return state[0]

    def node(self, left: int, right: int) -> int:
        return self.permute([left, right, 0])[0]


@functools.lru_cache(maxsize=None)
def poseidon(p: int) -> Poseidon:
    return Poseidon(p)
