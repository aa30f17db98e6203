"""SHA-256 of batches of equal-length messages: kernel 7 and its plain
version.

Counterpart of `ops/sha256.py` of the JAX package (`sha256_batch_blocks`, a
`lax.scan` of uint32 lane math, and `sha256_many`); used for the levels of
sha2 Merkle trees (`commitments/merkle.py`). Kernel 7 (`csrc/sha256.cu`)
runs one thread a message, in three forms:

- `sha256_blocks_hopper(words, length=None)`: padded messages as
  (nb * 16, n) big-endian 32-bit words, word planes first and messages
  innermost (word j of block b of message i at row b*16 + j, column i);
  given the messages' `length` in bytes, a multiple of 64, the last block
  (pure padding) is not read: its rounds take `padding_schedule(length)`;
- `sha256_nodes_hopper(level)`: a Merkle level's (8, 2m) digests read in
  place, the digest of the pair (2i, 2i + 1) into column i; the padding
  block of a 64-byte message from `padding_schedule(64)`;
- `sha256_field_rows_hopper(fs, rows)`: Merkle leaves of k field elements
  from their Montgomery rows (k, NL, n): one `from_mont` (kernel 1) to the
  canonical digit planes, which the kernel reads as the big-endian message
  words of `fiat_shamir.field_to_bytes`, padding in registers.

All return (8, n) digest words. Words are `torch.int32` holding the 32 bits
of the big-endian word (two's complement); torch on the CPU has no `uint32`
addition or right shift, so the plain versions compute in `int64` and mask.
A wrapper runs its plain version only for a tensor that lies on the CPU; on
a CUDA tensor it launches the kernel or raises. `LAUNCHES` counts launches
of each form and `ELEMENTS` the messages they hashed: measurement state
only, nothing in the port reads them.

`field_rows_to_bytes` turns Montgomery leaf rows that live on a device into
the canonical big-endian bytes of `transcript/fiat_shamir.py::
field_to_bytes`, on that device; `pad_messages` pads them into word planes
there (the leaf form's plain version, and `sha256_many`'s way in). So a
tree of device rows never goes through host ints.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels as K
from ..transcript.fiat_shamir import field_bytes_len
from . import limbs as L

LAUNCHES = {"sha256": 0, "sha256_nodes": 0, "sha256_field_rows": 0}
ELEMENTS = {"sha256": 0, "sha256_nodes": 0, "sha256_field_rows": 0}
# the leaf form's instances: an element's bytes / 2 (Goldilocks, the 255-bit
# fields, MNT4 / MNT6 Fr, bls12-381 Fq)
LEAF_HALVES = (4, 16, 19, 24)

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]
_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]
_M32 = 0xFFFFFFFF
NODE_PAD = [0x80000000] + [0] * 14 + [512]   # block 2 of a 64-byte message
# instructions of the shortest schedule with three-input LOP3 / IADD3 and
# funnel shifts: a round (Sigma1 3 SHF + 1 LOP3, ch 1, t1 2 IADD3, Sigma0 4,
# maj 1, e 1, a 1), a schedule step (sigma0 4, sigma1 4, the sum 2), and
# the 8 final additions
ROUND_INSTRUCTIONS = 14
SCHEDULE_INSTRUCTIONS = 10


def sha256_counts(data_blocks: int, padding_blocks: int = 0) -> dict:
    """Instructions a message issues at least: `data_blocks` compressions
    with a schedule (64 rounds, 48 steps, 8 additions: 1,384) and
    `padding_blocks` of pure padding whose K + W come from the host (64
    rounds, 8 additions: 904)."""
    data = 64 * ROUND_INSTRUCTIONS + 48 * SCHEDULE_INSTRUCTIONS + 8
    pad = 64 * ROUND_INSTRUCTIONS + 8
    return {"data_compression": data, "padding_compression": pad,
            "instructions": data_blocks * data + padding_blocks * pad}


# ---------------------------------------------------------------------------
# plain version (int64, masked to 32 bits)
# ---------------------------------------------------------------------------

def _to_u32(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.int64) & _M32


def _to_i32(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def _sigma0(x):
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)


def _sigma1(x):
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> 10)


@functools.lru_cache(maxsize=None)
def padding_schedule(length: int) -> tuple[int, ...]:
    """The 64 words K[r] + W[r] (mod 2^32, Python ints) of the last block of
    a message of `length` bytes, a multiple of 64: pure padding (0x80,
    zeros, the bit length), so its schedule depends on the length alone."""
    if length < 0 or length % 64:
        raise ValueError(f"sha256: a block of pure padding ends a message "
                         f"whose length is a multiple of 64, not {length}")
    bits = 8 * length
    w = [0x80000000] + [0] * 13 + [(bits >> 32) & _M32, bits & _M32]
    for r in range(16, 64):
        w.append((_sigma1(w[r - 2]) + w[r - 7] + _sigma0(w[r - 15])
                  + w[r - 16]) & _M32)
    return tuple((k + x) & _M32 for k, x in zip(_K, w))


@functools.lru_cache(maxsize=None)
def _padding_arg(length: int):
    """`padding_schedule(length)` as the C array the entry points copy into
    their 256-byte kernel argument (kept alive here)."""
    return (ctypes.c_uint32 * 64)(*padding_schedule(length))


def _compress_plain(st: list, w: list) -> list:
    """One compression of the 16 word rows `w` ((n,) int64 each) into the
    state rows `st`."""
    w = list(w)
    a, b, c, d, e, f, g, h = st
    for r in range(64):
        if r >= 16:
            w[r & 15] = (w[r & 15] + _sigma0(w[(r + 1) & 15])
                         + w[(r + 9) & 15] + _sigma1(w[(r + 14) & 15])) & _M32
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g & _M32)
        t1 = (h + s1 + ch + _K[r] + w[r & 15]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M32, c, b, a,
                                  (t1 + s0 + maj) & _M32)
    return [(x + y) & _M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def _init_plain(n: int, device) -> list:
    return [torch.full((n,), v, dtype=torch.int64, device=device)
            for v in _H0]


def sha256_blocks_plain(words: torch.Tensor) -> torch.Tensor:
    """Kernel 7's block form, whole-tensor: (nb * 16, n) -> (8, n)."""
    _check_blocks(words)
    w = _to_u32(words)
    st = _init_plain(w.shape[1], w.device)
    for b in range(w.shape[0] // 16):
        st = _compress_plain(st, list(w[16 * b:16 * b + 16]))
    return _to_i32(torch.stack(st))


def sha256_nodes_plain(level: torch.Tensor) -> torch.Tensor:
    """Kernel 7's node form, whole-tensor: (8, 2m) -> (8, m)."""
    _check_level(level)
    w = _to_u32(level)
    m = w.shape[1] // 2
    st = _compress_plain(_init_plain(m, w.device),
                         list(w[:, 0::2]) + list(w[:, 1::2]))
    pad = [torch.full((m,), v, dtype=torch.int64, device=w.device)
           for v in NODE_PAD]
    return _to_i32(torch.stack(_compress_plain(st, pad)))


# ---------------------------------------------------------------------------
# kernel 7
# ---------------------------------------------------------------------------

def sha256_field_rows_plain(fs, rows: torch.Tensor) -> torch.Tensor:
    """Kernel 7's leaf form, whole-tensor: (k, NL, n) Montgomery rows ->
    (8, n), through the canonical bytes and the padded word planes."""
    return sha256_blocks_plain(pad_messages(field_rows_to_bytes(fs, rows)))


def _check_blocks(words: torch.Tensor) -> None:
    if words.dim() != 2 or words.shape[0] % 16 or words.shape[0] == 0 \
            or words.shape[1] == 0 or words.dtype != torch.int32:
        raise ValueError(f"sha256: padded messages are (nb * 16, n) int32 "
                         f"words, not {tuple(words.shape)} {words.dtype}")


def _check_level(level: torch.Tensor) -> None:
    if level.dim() != 2 or level.shape[0] != 8 or level.shape[1] < 2 \
            or level.shape[1] % 2 or level.dtype != torch.int32:
        raise ValueError(f"sha256: a level is (8, 2m) int32 digest words, "
                         f"not {tuple(level.shape)} {level.dtype}")


def sha256_blocks_hopper(words: torch.Tensor,
                         length: int | None = None) -> torch.Tensor:
    """Kernel 7, block form: the digests (8, n) of n padded messages given
    as (nb * 16, n) big-endian words. With the messages' `length` in bytes
    and a multiple of 64 (nb = length / 64 + 1), the last block is pure
    padding: the kernel reads the nb - 1 blocks before it and runs that
    one from `padding_schedule(length)`. Any other length, or none, runs
    every block through the schedule."""
    _check_blocks(words)
    pad = length is not None and length % 64 == 0
    if pad and words.shape[0] != 16 * padded_blocks(length):
        raise ValueError(f"sha256: {words.shape[0] // 16} blocks are not "
                         f"the padded messages of {length} bytes")
    if not words.is_cuda:
        return sha256_blocks_plain(words)
    words = words.contiguous()
    n = words.shape[1]
    out = torch.empty((8, n), dtype=torch.int32, device=words.device)
    nblocks = words.shape[0] // 16 - pad
    kw = ctypes.addressof(_padding_arg(length)) if pad else None
    K.check(K.entry("zk_sha256_blocks")(words.data_ptr(), n, nblocks, kw,
                                        out.data_ptr(), K.stream_ptr()),
            "zk_sha256_blocks")
    LAUNCHES["sha256"] += 1
    ELEMENTS["sha256"] += n
    return out


def sha256_nodes_hopper(level: torch.Tensor) -> torch.Tensor:
    """Kernel 7, node form: the digests (8, m) of the m pairs of a level of
    (8, 2m) digests, read in place."""
    _check_level(level)
    if not level.is_cuda:
        return sha256_nodes_plain(level)
    level = level.contiguous()
    m = level.shape[1] // 2
    out = torch.empty((8, m), dtype=torch.int32, device=level.device)
    K.check(K.entry("zk_sha256_nodes")(level.data_ptr(), m,
                                       ctypes.addressof(_padding_arg(64)),
                                       out.data_ptr(), K.stream_ptr()),
            "zk_sha256_nodes")
    LAUNCHES["sha256_nodes"] += 1
    ELEMENTS["sha256_nodes"] += m
    return out


def leaf_half(fs) -> int:
    """An element's bytes / 2, the leaf form's instance; `ValueError` for a
    width it has none of."""
    nb = field_bytes_len(fs)
    if nb % 2 or nb // 2 not in LEAF_HALVES:
        raise ValueError(f"sha256: no leaf instance for {fs.name}'s {nb} "
                         f"bytes an element (instances: "
                         f"{[2 * h for h in LEAF_HALVES]})")
    return nb // 2


def sha256_field_digits_hopper(digits: torch.Tensor, k: int,
                               half: int) -> torch.Tensor:
    """Kernel 7, leaf form, on the card: (8, n) digests of n leaves of k
    elements of 2 * half bytes, from canonical 16-bit digit planes
    `digits` (NL, k, n) int32 (`L.from_mont` of the rows), NL >= half."""
    nl = digits.shape[0]
    if digits.dim() != 3 or digits.shape[1] != k or nl < half \
            or digits.dtype != torch.int32 or half not in LEAF_HALVES \
            or not digits.is_cuda:
        raise ValueError(f"sha256: leaf digits are (NL >= {half}, {k}, n) "
                         f"int32 on the card, not {tuple(digits.shape)} "
                         f"{digits.dtype} on {digits.device}")
    digits = digits.contiguous()
    n = digits.shape[2]
    if digits.numel() >= 1 << 31:
        raise ValueError(f"sha256: {digits.numel()} digits: the leaf form "
                         f"indexes below 2^31")
    length = 2 * half * k
    kw = ctypes.addressof(_padding_arg(length)) if length % 64 == 0 \
        else None
    out = torch.empty((8, n), dtype=torch.int32, device=digits.device)
    K.check(K.entry("zk_sha256_field_rows")(
        digits.data_ptr(), n, k, half, digits.stride(0), digits.stride(1),
        kw, out.data_ptr(), K.stream_ptr()), "zk_sha256_field_rows")
    LAUNCHES["sha256_field_rows"] += 1
    ELEMENTS["sha256_field_rows"] += n
    return out


def sha256_field_rows_hopper(fs, rows: torch.Tensor) -> torch.Tensor:
    """Kernel 7, leaf form: the digests (8, n) of n Merkle leaves, leaf i
    the `field_to_bytes` of elements rows[:, :, i] one after another, from
    (k, NL, n) Montgomery rows: `from_mont` (kernel 1) to the canonical
    digits, then the leaf kernel reads them as message words."""
    if rows.dim() != 3 or rows.shape[1] != fs.nl or rows.shape[2] == 0 \
            or rows.shape[0] == 0:
        raise ValueError(f"sha256: leaf rows are (k, {fs.nl}, n), not "
                         f"{tuple(rows.shape)}")
    half = leaf_half(fs)
    if not rows.is_cuda:
        return sha256_field_rows_plain(fs, rows)
    digits = L.from_mont(fs, rows.permute(1, 0, 2))         # (NL, k, n)
    return sha256_field_digits_hopper(digits, rows.shape[0], half)


# ---------------------------------------------------------------------------
# messages <-> word planes, on the messages' device
# ---------------------------------------------------------------------------

def padded_blocks(length: int) -> int:
    """64-byte blocks of a padded message of `length` bytes."""
    return (length + 8) // 64 + 1


def pad_messages(msgs: torch.Tensor) -> torch.Tensor:
    """(n, L) bytes (any integer dtype, values < 256) -> the padded
    messages' (nb * 16, n) big-endian int32 word planes, on msgs' device:
    0x80, zeros, and the bit length as a big-endian 64-bit integer."""
    n, length = msgs.shape
    nb = padded_blocks(length)
    buf = torch.zeros((n, 64 * nb), dtype=torch.int64, device=msgs.device)
    buf[:, :length] = msgs.to(torch.int64)
    buf[:, length] = 0x80
    bits = 8 * length
    buf[:, -8:] = torch.tensor([(bits >> (8 * (7 - i))) & 0xFF
                                for i in range(8)], dtype=torch.int64,
                               device=msgs.device)
    words = (buf[:, 0::4] << 24) | (buf[:, 1::4] << 16) \
        | (buf[:, 2::4] << 8) | buf[:, 3::4]
    return _to_i32(words.T.contiguous())


def field_rows_to_bytes(fs, rows: torch.Tensor) -> torch.Tensor:
    """(k, NL, n) Montgomery leaf rows -> (n, k * nb) bytes (int64 values),
    element after element, each the canonical value's `field_bytes_len`
    (nb) bytes, big-endian: `fiat_shamir.field_to_bytes` on the rows'
    device."""
    k, nl, n = rows.shape
    nb = field_bytes_len(fs)
    digits = L.from_mont(fs, rows.permute(1, 0, 2).reshape(nl, k * n))
    d = digits.to(torch.int64).reshape(nl, k, n)
    le = torch.stack([d & 0xFF, d >> 8], dim=1).reshape(2 * nl, k, n)
    be = le[:nb].flip(0)                                  # (nb, k, n)
    return be.permute(2, 1, 0).reshape(n, k * nb)


def digests_to_bytes(digests: torch.Tensor) -> list[bytes]:
    """(8, n) digest words -> n digests of 32 bytes; one transfer."""
    words = digests.T.contiguous().cpu().numpy().astype(np.uint32)
    raw = words.astype(">u4").tobytes()
    return [raw[32 * i:32 * (i + 1)] for i in range(words.shape[0])]


def bytes_to_digests(digests: list[bytes], device) -> torch.Tensor:
    """The inverse of `digests_to_bytes`."""
    words = np.frombuffer(b"".join(digests), dtype=">u4") \
        .reshape(len(digests), 8).astype(np.int64)
    return _to_i32(torch.from_numpy(np.ascontiguousarray(words.T))
                   .to(device))


def sha256_batch_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """The JAX package's contract: (N, n_blocks, 16) big-endian words of
    padded messages -> (N, 8) digest words (int32 bits), on blocks'
    device."""
    n = blocks.shape[0]
    return sha256_blocks_hopper(
        blocks.reshape(n, -1).T.contiguous()).T.contiguous()


def sha256_many(messages: list[bytes], device=None) -> list[bytes]:
    """SHA-256 of equal-length messages in one launch on `device` (default:
    the card)."""
    assert messages
    length = len(messages[0])
    assert all(len(m) == length for m in messages)
    device = L.resolve_device(device)
    raw = np.frombuffer(b"".join(messages), dtype=np.uint8) \
        .reshape(len(messages), length)
    msgs = torch.from_numpy(raw.astype(np.int64)).to(device)
    return digests_to_bytes(sha256_blocks_hopper(pad_messages(msgs), length))
