"""Host-side cryptographic hashes for transcripts and byte-Merkle trees.

Counterpart of `transcript/hashes.py` of the JAX package. The transcript is
inherently sequential and tiny, so these run on the host. sha2-256 / blake2b
come from hashlib; Keccak-1600 (the ORIGINAL Keccak-f[1600] with 0x01 domain
padding, as used by crypto3's `keccak_1600<256>`, distinct from NIST SHA-3's
0x06) is implemented here in Python, and taken from the repo's C source
`native/zk_native.c` where that can be compiled (`cc`, at first use, into
`build/crypto3_zk_tpu_torch/`; without a compiler or the source the Python
version does the work: host code, the same bytes). The in-field Poseidon
(the Merkle/transcript hash on the card) lives in `ops/poseidon.py`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_KECCAK_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _M64


def _keccak_f(state: list[int]) -> list[int]:
    a = [[state[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _KECCAK_RC:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _KECCAK_ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _M64)
        # iota
        a[0][0] ^= rc
    return [a[x][y] for y in range(5) for x in range(5)]


_native_keccak = None      # the C function; False once loading has failed


def _load_native_keccak():
    """`zk_keccak_256` of `native/zk_native.c` as a ctypes function, built at
    first use; False where the source or a C compiler is missing or the
    build fails."""
    global _native_keccak
    if _native_keccak is not None:
        return _native_keccak
    _native_keccak = False
    pkg = pathlib.Path(__file__).resolve().parent.parent
    src = pkg.parent / "native" / "zk_native.c"
    cc = shutil.which("cc")
    if not src.exists() or cc is None:
        return False
    out_dir = pkg.parent / "build" / pkg.name
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    lib = out_dir / f"libzk_native-{tag}.so"
    try:
        if not lib.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([cc, "-O3", "-shared", "-fPIC", "-o", str(tmp),
                            str(src)], check=True, capture_output=True)
            os.replace(tmp, lib)
        fn = ctypes.CDLL(str(lib)).zk_keccak_256
    except (OSError, subprocess.CalledProcessError, AttributeError):
        return False
    fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    fn.restype = None
    _native_keccak = fn
    return fn


def keccak_256(data: bytes) -> bytes:
    """Original Keccak-256 (pad 0x01 .. 0x80), rate 1088 bits."""
    fn = _load_native_keccak()
    if fn:
        out = ctypes.create_string_buffer(32)
        fn(bytes(data), len(data), out)
        return out.raw
    return _keccak_256_py(data)


def _keccak_256_py(data: bytes) -> bytes:
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
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


def sha2_256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def blake2b_512(data: bytes) -> bytes:
    return hashlib.blake2b(data).digest()


HASHES = {
    "keccak_256": (keccak_256, 32),
    "sha2_256": (sha2_256, 32),
    "blake2b_512": (blake2b_512, 64),
}


def get_hash(name: str):
    """-> (fn: bytes->bytes, digest_len_bytes)."""
    return HASHES[name]
