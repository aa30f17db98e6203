"""The NTT as 8-bit digit-plane matrix products, on the tensor cores.

Counterpart of `ops/mxu_ntt.py` of the JAX package, which maps the
transform onto the TPU's matrix unit; here the same algebra runs on the
H100's tensor cores:

- A length-M block transform is the matrix product W @ x with
  W[k, j] = w^(kj): one (M x M) field matrix against a batch of vectors.
- Field elements are split into digit planes, so the field product becomes
  many small-integer products with wide sums, plane s = sum over a + b = s
  of W_a @ x_b, and the planes are merged and reduced back to canonical
  Montgomery digits. W is pre-scaled so that the reduction's power of two
  cancels and Montgomery form is kept end to end.
- A transform of N = M_1 ... M_P points is a chain of P passes (the
  four-step applied P - 1 times): pass p transforms the slowest remaining
  index with side M_p, multiplies by the four-step twiddle w_(N_p)^(c k)
  and leaves the rest for the passes after it.

The JAX package's plan (7-bit signed digits, `MXUNttPlan.w_digits`, 37
digits for a 255-bit field) is kept with its plain arithmetic
(`block_ntt_plain`): the parity tests pin it. Kernel 8 (`csrc/mxu_ntt.cu`)
takes the card's unsigned 8-bit operands instead: 32 digits, a table
`MXUNttPlan.table_u8` laid out as `wgmma`'s B operand wants it, and the
scale 2^288 (nine 32-bit Montgomery rounds; the output is the same
canonical Montgomery form).

`mxu_pass(fs, geom, x, inverse)` is one pass (`PassGeom`): on a CUDA
tensor one launch of kernel 8, on a CPU tensor `pass_plain`, the same
contract by the plain pieces (`block_ntt_plain`,
`hopper_field.mont_mul_plain`, `pack_plain` / `unpack_plain`). Between two
passes of a transform the data travels packed (`pack_plain` gives the
layout): 32 bytes an element, the 8-bit digits K-major along the axis the
next pass transforms, in tiles of 64 vectors that are `wgmma`'s A operand
as they lie. Only the first pass reads the port's (NL, N) int32 layout and
only the last writes it. `LAUNCHES["mxu_ntt"]` counts the kernel's
launches.

`ntt_mxu` is not on any prover's path: `ops/ntt.py` stays the transform of
the port, and this module is the measured alternative to it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import kernels as K
from ..fields.params import MASK, FieldSpec
from . import hopper_field as HF
from . import limbs as L

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1

LAUNCHES = {"mxu_ntt": 0}

# the kernel's instance: bls12-381 Fr and the other 16-digit fields
KERNEL_DIGITS = (16,)

# ---- the kernel's own digits and layouts (csrc/mxu_ntt.cu) ----
U8_DIGITS = 32               # 8-bit digits of an element below 2^256
TABLE_WORDS = 9              # table scale 2^(32 * 9): nine word rounds
PAD = 7                      # zero digits on each side of a table slab
ROWS = 64                    # vectors a tile holds: wgmma's m
MAX_LOG_SIDE = 6             # sides 2^1 .. 2^6; packed only from 2^4
PACKED_MIN_SIDE = 16

GEOM_FIELDS = ("m", "c", "b", "tiles", "lsj", "lsk", "in_packed",
               "out_packed", "twiddle", "tw_split", "m2", "lsj2", "lsk2",
               "blocks", "log_b", "staged", "tw_one")


def _n_digits(fs: FieldSpec) -> int:
    return -(-(fs.nl * 16) // DIGIT_BITS)


def _digitize_int(v: int, nd: int) -> list[int]:
    return [(v >> (DIGIT_BITS * j)) & DIGIT_MASK for j in range(nd)]


def _table_side(m: int) -> int:
    """The kernel's table geometry for side m: sides below 16 use the
    side-16 layout with zero rows and columns."""
    return max(m, PACKED_MIN_SIDE)


class MXUNttPlan:
    """Digit-plane DFT matrix of one (field, M, direction): the JAX plan's
    7-bit table `w_digits` and the kernel's 8-bit table `table_u8`."""

    def __init__(self, fs: FieldSpec, log_m: int, inverse: bool):
        self.fs = fs
        self.log_m = log_m
        self.m = m = 1 << log_m
        self.inverse = inverse
        p = fs.p
        nd = _n_digits(fs)
        self.nd = nd
        self.rounds = fs.nl + 1          # Montgomery sweep depth
        omega = fs.root_of_unity(m)
        if inverse:
            omega = pow(omega, -1, p)
        self._omega = omega
        # W'[k, j] = omega^(kj) * 2^(16 rounds) mod p, base-128 digit planes
        ent = self._entries(pow(2, 16 * self.rounds, p))
        # bytes-vectorised digitisation (a python loop over M^2 * ND digit
        # extractions would dominate the build at M = 1024)
        nb = (fs.nl * 16) // 8 + 1
        raw = b"".join(int(v).to_bytes(nb, "little") for v in ent)
        u8 = np.frombuffer(raw, dtype=np.uint8).reshape(-1, nb)
        u8 = np.concatenate([u8, np.zeros((u8.shape[0], 1), np.uint8)],
                            axis=1)
        cols = np.empty((nd, m * m), dtype=np.int8)
        for j in range(nd):
            pos = DIGIT_BITS * j
            a, s = pos // 8, pos % 8
            d = (u8[:, a].astype(np.uint16) >> s) \
                | (u8[:, a + 1].astype(np.uint16) << (8 - s))
            cols[j] = (d & DIGIT_MASK).astype(np.int8)
        self.w_digits = cols.reshape(nd, m, m)
        self._table = None
        self._dev: dict[str, torch.Tensor] = {}

    def _entries(self, scale: int) -> np.ndarray:
        """(M*M,) python ints omega^(kj) * scale mod p, row-major (k, j)."""
        p, m = self.fs.p, self.m
        pows = np.empty(m, dtype=object)
        acc = 1
        for i in range(m):
            pows[i] = acc * scale % p
            acc = acc * self._omega % p
        kj = (np.outer(np.arange(m, dtype=np.int64),
                       np.arange(m, dtype=np.int64)) % m)
        return pows[kj].reshape(-1)

    @property
    def table_u8(self) -> np.ndarray:
        """The kernel's table: W''[k, j] = omega^(kj) 2^288 mod p cut into 32
        unsigned 8-bit digits, as `wgmma`'s K-major B operand. Shape
        (TM/8, JH, 32 + 2*PAD, 2, 8, 16), TM = max(M, 16), JH = max(1,
        TM/32): [output group of 8][32 j's of a k-step][digit a, PAD zero
        digits each side][16-byte half of the k-step][output in the
        group][j]. One (group, k-step) slab is a column of 8 x 16-byte core
        matrices, one per digit, so G consecutive digits of one group are
        one contiguous N = 8 G tile. Entries past M are zero (the side-16
        layout serves M < 16, and j past 16 at M = 16)."""
        if self._table is None:
            fs, m = self.fs, self.m
            ent = self._entries(pow(2, 32 * TABLE_WORDS, fs.p))
            raw = b"".join(int(v).to_bytes(U8_DIGITS, "little") for v in ent)
            w8 = np.frombuffer(raw, dtype=np.uint8).reshape(m, m, U8_DIGITS)
            tm = _table_side(m)
            jh = max(1, tm // 32)
            full = np.zeros((tm, 32 * jh, U8_DIGITS), np.uint8)
            full[:m, :m] = w8
            # (kg, kl, jh, ki, jb, a) -> (kg, jh, a, ki, kl, jb)
            t = full.reshape(tm // 8, 8, jh, 2, 16, U8_DIGITS) \
                .transpose(0, 2, 5, 3, 1, 4)
            out = np.zeros((tm // 8, jh, U8_DIGITS + 2 * PAD, 2, 8, 16),
                           np.uint8)
            out[:, :, PAD:PAD + U8_DIGITS] = t
            self._table = np.ascontiguousarray(out)
        return self._table

    def w_digits_dev(self, device) -> torch.Tensor:
        """(ND, M, M) int8 on `device`, sent once per device and kept."""
        key = "w7:" + str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.w_digits).to(device)
        return self._dev[key]

    def table_dev(self, device) -> torch.Tensor:
        """`table_u8` on `device` (47,104 bytes at M = 32), kept."""
        key = "u8:" + str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.table_u8.reshape(-1)) \
                .to(device)
        return self._dev[key]


@functools.lru_cache(maxsize=None)
def get_mxu_plan(fs: FieldSpec, log_m: int, inverse: bool) -> MXUNttPlan:
    return MXUNttPlan(fs, log_m, inverse)


def _decompose_digits(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """(NL, ...) 16-bit digits -> (ND, ...) int8 base-128 digits."""
    nd = _n_digits(fs)
    xp = torch.cat([x.to(torch.int64), torch.zeros_like(x[:1],
                                                        dtype=torch.int64)])
    planes = []
    for j in range(nd):
        pos = DIGIT_BITS * j
        a, s = pos // 16, pos % 16
        v = xp[a] >> s
        if s > 16 - DIGIT_BITS and a + 1 <= fs.nl:
            v = v | (xp[a + 1] << (16 - s))
        planes.append(v & DIGIT_MASK)
    return torch.stack(planes).to(torch.int8)


def _mont_reduce_wide(fs: FieldSpec, planes: torch.Tensor,
                      plane_bound: int) -> torch.Tensor:
    """planes: (NP, ...) base-128 digit sums (any integer type) of a value
    V < 2^(16 NL) * p; returns V * 2^(-16 (NL+1)) mod p as canonical
    (NL, ...) int32 digits.

    As in the JAX package: the planes are packed into 16-bit lazy columns
    straight from their sums (column sums < 2^20), NL + 1 Montgomery rounds
    shrink the array by one column each, then one carry sweep and a
    conditional subtract."""
    nl = fs.nl
    rounds = nl + 1
    np_planes = planes.shape[0]
    bshape = tuple(planes.shape[1:])
    db = plane_bound.bit_length()                  # per-plane digit bits
    pl = planes.to(torch.int64)
    nw = (DIGIT_BITS * (np_planes - 1) + db) // 16 + 2
    cols = []
    for i in range(nw):
        acc = torch.zeros(bshape, dtype=torch.int64, device=pl.device)
        for j in range(np_planes):
            off = DIGIT_BITS * j - 16 * i          # plane j's bit offset
            if off >= 16 or off <= -db:
                continue
            if off >= 0:
                acc += (pl[j] & (MASK >> off)) << off
            else:
                acc += (pl[j] >> (-off)) & MASK
        cols.append(acc)
    t = torch.stack(cols)

    ninv = fs.ninv16
    p_col = torch.tensor([int(v) for v in fs.p_limbs], dtype=torch.int64,
                         device=pl.device).reshape((nl,) + (1,) * len(bshape))
    for _ in range(rounds):
        m = (t[0] * ninv) & MASK
        mp = m[None] * p_col
        lo = mp & MASK
        hi = mp >> 16
        carry0 = (t[0] + lo[0]) >> 16
        t = t[1:]
        t[:nl - 1] += lo[1:]
        t[:nl] += hi
        t[0] += carry0

    # full carry sweep; the value is < 2p, so columns beyond NL are 0 and
    # column NL carries at most 1 (nw >= 2 NL + 2, so NL + 1 columns are
    # left after the rounds)
    t = t[:nl + 1].reshape(nl + 1, -1)
    digits, c = HF._carry_sweep(t[:nl])
    return HF._cond_sub_p(fs, digits, t[nl] + c).to(torch.int32) \
        .reshape((nl,) + bshape)


def block_ntt_plain(fs: FieldSpec, plan: MXUNttPlan,
                    x: torch.Tensor) -> torch.Tensor:
    """The plain block transform. x: (NL, M, B) Montgomery digits; the
    transform runs along axis 1. The JAX arithmetic: each W_a @ x_b product
    of 7-bit digits is one float64 matrix product (exact: its sums are
    below M 127^2 < 2^24)."""
    nd, m = plan.nd, plan.m
    b = x.shape[2]
    xd = _decompose_digits(fs, x).to(torch.float64)          # (ND, M, B)
    xflat = xd.permute(1, 0, 2).reshape(m, nd * b)           # (M_j, ND*B)
    w = plan.w_digits_dev(x.device)
    acc = torch.zeros((2 * nd - 1, m, b), dtype=torch.int64, device=x.device)
    for a in range(nd):
        part = w[a].to(torch.float64) @ xflat                # (M, ND*B)
        acc[a:a + nd] += part.reshape(m, nd, b).permute(1, 0, 2) \
            .to(torch.int64)
    # per-plane bound: M columns of 127^2, times <= ND diagonal merges
    plane_bound = m * (DIGIT_MASK ** 2) * nd
    return _mont_reduce_wide(fs, acc, plane_bound)


# ---------------------------------------------------------------------------
# passes: geometry, packed layout, twiddle tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PassGeom:
    """One pass over the natural array x[j, c, b] (j < m the transformed
    index, c < c the vectors' slow part, b < b their fast part; vector
    v = c * b + b). Output element (k, c, b), times w_(m c)^(c k) if
    `twiddle`, goes to the natural position (c * m + k) * b + b, which the
    next pass (side m2) reads as j' = c / (c / m2). Tiles of 64 vectors:
    row r = 4 jq + kl holds v = base + (jq << lsj) + (kl << lsk), the tile
    index being v with those six bits taken out; (lsj, lsk) = (2, 0) is
    64 consecutive vectors. `lsj2`, `lsk2` are the next pass's."""
    m: int
    c: int
    b: int
    lsj: int = 2
    lsk: int = 0
    in_packed: bool = False
    out_packed: bool = False
    twiddle: bool = False
    m2: int = 1
    lsj2: int = 2
    lsk2: int = 0

    @property
    def v(self) -> int:
        return self.c * self.b

    @property
    def tiles(self) -> int:
        return -(-self.v // ROWS)

    @property
    def n(self) -> int:
        return self.m * self.v

    def next_view(self) -> tuple[int, int, int]:
        """(m2, c2, b2) of the pass this one hands its output to."""
        return self.m2, self.c // self.m2, self.m * self.b


def _lanes_ok(v: int, lsj: int, lsk: int) -> bool:
    bits = v.bit_length() - 1
    if v != 1 << bits or lsj < 0 or lsk < 0:
        return False
    if lsj + 4 > bits or lsk + 2 > bits:
        return False
    return lsk + 2 <= lsj or lsj + 4 <= lsk


def _lanes(sides: list[int], p: int) -> tuple[int, int]:
    """The tile lanes of pass p (0-based) of a chain with log sides
    `sides` and batch 1: the J lanes run over 16 consecutive values of the
    next pass's transform index (or, in the last pass, of its vectors' fast
    part), the K lanes over 4 consecutive outputs of the pass before (or,
    in the first, of the vectors' next slow part). Then every output piece
    of a pass is 4 rows x 16 bytes of one digit, 64 contiguous bytes of
    the next pass's tile. Falls back to 64 consecutive vectors."""
    log_b = sum(sides[:p])
    log_c = sum(sides[p + 1:])
    log_v = log_b + log_c
    lsj = lsk = -1
    if p + 1 < len(sides) and sides[p + 1] >= 4:
        lsj = log_b + sum(sides[p + 2:])          # j' stride c2 * b
    elif p > 0 and log_b - sides[p - 1] >= 4:
        lsj = 0                                   # the previous b'' part
    if p > 0 and sides[p - 1] >= 2:
        lsk = log_b - sides[p - 1]                # k_(p-1) stride
    elif p + 1 < len(sides):
        lsk = 0                                   # c' of the first pass
    if _lanes_ok(1 << log_v, lsj, lsk):
        return lsj, lsk
    return 2, 0


def chain_geoms(sides: list[int]) -> list[PassGeom]:
    """The passes of a transform of 2^sum(sides) points, batch 1: pass p
    transforms side 2^sides[p] with the twiddle of the four-step, except
    the last; the data goes packed between two passes whose sides are
    both at least 16, else as int32."""
    out = []
    lanes = [_lanes(sides, p) for p in range(len(sides))]
    for p, s in enumerate(sides):
        last = p + 1 == len(sides)
        packed_in = p > 0 and sides[p - 1] >= 4 and s >= 4
        packed_out = not last and s >= 4 and sides[p + 1] >= 4
        nxt = lanes[p + 1] if not last else (2, 0)
        out.append(PassGeom(
            m=1 << s, c=1 << sum(sides[p + 1:]), b=1 << sum(sides[:p]),
            lsj=lanes[p][0], lsk=lanes[p][1], in_packed=packed_in,
            out_packed=packed_out, twiddle=not last,
            m2=1 << sides[p + 1] if not last else 1, lsj2=nxt[0],
            lsk2=nxt[1]))
    return out


def plan_sides(log_n: int, log_block: int | None = None) -> list[int]:
    """log2 of the pass sides of a 2^log_n transform. `log_block` keeps its
    JAX meaning: the block side of the top split (the last pass, or passes,
    cover 2^log_block; the rest covers the first factor). By default passes
    of side 2^5, a pass of 2^16 costing what one of 2^32 costs and one of
    2^64 half as much again (PERF.md, kernel 8); a remainder of one bit
    makes one pass 2^6, one of r = 2 to 4 bits turns 5 - r passes into
    2^4 (5,5,5,5 at 2^20, 5,5,5,5,4 at 2^24, 6,5,5,5,5 at 2^26). A log_n
    of 6 or less is one pass, 7 is 2^4 x 2^3."""
    if log_block is not None and 0 < log_block < log_n:
        return plan_sides(log_n - log_block) + plan_sides(log_block)
    if log_n <= MAX_LOG_SIDE:
        return [log_n] if log_n > 0 else []
    if log_n == 7:
        return [4, 3]
    if log_n % 5 == 1:
        return [6] + [5] * (log_n // 5 - 1)
    fours = (5 - log_n % 5) % 5
    return [5] * ((log_n - 4 * fours) // 5) + [4] * fours


def _insert_zero_bits(t: int | torch.Tensor, pos: int, width: int):
    low = (1 << pos) - 1
    return ((t >> pos) << (pos + width)) | (t & low)


def _remove_bits(v: int | torch.Tensor, pos: int, width: int):
    low = (1 << pos) - 1
    return ((v >> (pos + width)) << pos) | (v & low)


def tile_row(v, lsj: int, lsk: int):
    """(tile, row) of vector(s) v under the lanes (lsj, lsk)."""
    (lo, lw), (hi, hw) = sorted([(lsj, 4), (lsk, 2)])
    tile = _remove_bits(_remove_bits(v, hi, hw), lo, lw)
    row = ((v >> lsj) & 15) * 4 + ((v >> lsk) & 3)
    return tile, row


def tile_base(tile, lsj: int, lsk: int):
    """The vector of row 0 of `tile`: `tile_row`'s inverse."""
    (lo, lw), (hi, hw) = sorted([(lsj, 4), (lsk, 2)])
    return _insert_zero_bits(_insert_zero_bits(tile, lo, lw), hi, hw)


def packed_tile_bytes(m: int) -> int:
    """Bytes of one packed tile of side m (m >= 16): 64 vectors x m j's x
    32 digits."""
    return ROWS * m * U8_DIGITS


def _packed_offsets(m: int, v: int, lsj: int, lsk: int,
                    device) -> torch.Tensor:
    """(32, m, v) int64 byte offsets of the packed layout of side m: tile
    [j / 32][digit][(j % 32) / 16][row][j % 16], each tile
    `packed_tile_bytes(m)` bytes; a 16-byte row piece of 8 rows is one
    `wgmma` core matrix."""
    ki = 2 if m >= 32 else 1
    vv = torch.arange(v, dtype=torch.int64, device=device)
    tile, row = tile_row(vv, lsj, lsk)
    j = torch.arange(m, dtype=torch.int64, device=device)
    d = torch.arange(U8_DIGITS, dtype=torch.int64, device=device)
    jpart = (j >> 5) * (U8_DIGITS * ki * 1024) + ((j >> 4) & 1) * 1024 \
        + (j & 15)
    vpart = tile * packed_tile_bytes(m) + row * 16
    return d[:, None, None] * (ki * 1024) + jpart[None, :, None] \
        + vpart[None, None, :]


def _digit_bytes(x: torch.Tensor) -> torch.Tensor:
    """(NL, ...) 16-bit digits -> (2 NL, ...) bytes, little-endian."""
    x = x.to(torch.int64)
    return torch.stack([x & 0xFF, (x >> 8) & 0xFF], dim=1) \
        .reshape((2 * x.shape[0],) + tuple(x.shape[1:]))


def pack_plain(fs: FieldSpec, x: torch.Tensor, lsj: int = 2,
               lsk: int = 0) -> torch.Tensor:
    """(NL, M, V) int32 digits (the natural input of a pass of side M, M
    >= 16) -> the packed bytes that pass reads (uint8, tiles * M * 2048)."""
    _, m, v = x.shape
    if m < PACKED_MIN_SIDE or fs.nl * 2 != U8_DIGITS:
        raise ValueError(f"packed layout: side {m}, {fs.nl} digits")
    buf = torch.zeros(-(-v // ROWS) * packed_tile_bytes(m),
                      dtype=torch.uint8, device=x.device)
    off = _packed_offsets(m, v, lsj, lsk, x.device)
    buf[off.reshape(-1)] = _digit_bytes(x).reshape(-1).to(torch.uint8)
    return buf


def unpack_plain(fs: FieldSpec, buf: torch.Tensor, m: int, v: int,
                 lsj: int = 2, lsk: int = 0) -> torch.Tensor:
    """`pack_plain`'s inverse: packed bytes -> (NL, M, V) int32 digits."""
    off = _packed_offsets(m, v, lsj, lsk, buf.device)
    byte = buf[off.reshape(-1)].to(torch.int64).reshape(U8_DIGITS, m, v)
    return (byte[0::2] | (byte[1::2] << 8)).to(torch.int32)[:fs.nl]


# a pass's twiddles w_n^e, e < n, are one table of n entries up to this
# size (32 MB of 32-byte words at 2^20; one Montgomery product an element,
# measured faster than two tables at 2^15 and at 2^20: PERF.md, kernel
# 8), two tables of about sqrt(n) above it (2 GB would be one at 2^26)
TW_ONE_MAX_LOG = 20


def twiddle_split(log_n: int) -> int:
    """h of a pass's twiddle tables for n = 2^log_n: log_n (one table, one
    Montgomery product an element) up to `TW_ONE_MAX_LOG`, else
    ceil(log_n / 2) (two tables, two products)."""
    return log_n if log_n <= TW_ONE_MAX_LOG else (log_n + 1) // 2


@functools.lru_cache(maxsize=None)
def _twiddle_tables_np(fs: FieldSpec, log_n: int, inverse: bool, h: int):
    """w_n^e = lo[e mod 2^h] * hi[e >> h] (Montgomery form), two tables of
    32-byte words, (2^h, 8) and (2^(log_n - h), 8) uint32, 2 * 2^10 entries
    (64 KB) at n = 2^20 with h = 10; h = log_n: lo is every power and
    hi = [1]."""
    p, r = fs.p, fs.R_mod_p
    omega = fs.root_of_unity(1 << log_n)
    if inverse:
        omega = pow(omega, -1, p)

    def table(step: int, count: int) -> np.ndarray:
        vals, acc = [], r
        for _ in range(count):
            vals.append(acc)
            acc = acc * step % p
        raw = b"".join(v.to_bytes(fs.nl * 2, "little") for v in vals)
        return np.frombuffer(raw, dtype="<u4").reshape(count,
                                                       fs.nl // 2).copy()

    return h, table(omega, 1 << h), table(pow(omega, 1 << h, p),
                                          1 << (log_n - h))


_TW_DEV: dict = {}


def twiddle_tables(fs: FieldSpec, log_n: int, inverse: bool, device):
    """(h, lo, hi) with the tables as int32 word tensors on `device`."""
    h = twiddle_split(log_n)
    key = (fs, log_n, inverse, str(torch.device(device)), h)
    if key not in _TW_DEV:
        h, lo, hi = _twiddle_tables_np(fs, log_n, inverse, h)
        _TW_DEV[key] = (h, torch.from_numpy(lo.view(np.int32)).to(device),
                        torch.from_numpy(hi.view(np.int32)).to(device))
    return _TW_DEV[key]


def _words_to_digits(w: torch.Tensor) -> torch.Tensor:
    """(..., NW) int32 words -> (2 NW, ...) int32 16-bit digits."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    d = torch.stack([w & MASK, w >> 16], dim=-1).reshape(
        tuple(w.shape[:-1]) + (2 * w.shape[-1],))
    return d.permute(-1, *range(d.dim() - 1)).to(torch.int32)


def pass_twiddles_plain(fs: FieldSpec, m: int, c: int, inverse: bool,
                        device) -> torch.Tensor:
    """(NL, M, C) w_(M C)^(c k) in Montgomery form, as the kernel forms
    it: lo[e mod 2^h] * hi[e >> h] with e = c k."""
    log_n = (m * c).bit_length() - 1
    h, lo, hi = twiddle_tables(fs, log_n, inverse, device)
    e = torch.arange(m, device=device)[:, None] * \
        torch.arange(c, device=device)[None, :]
    if h == log_n:
        return _words_to_digits(lo[e])
    return HF.mont_mul_plain(fs, _words_to_digits(lo[e & ((1 << h) - 1)]),
                             _words_to_digits(hi[e >> h]))


def pass_plain(fs: FieldSpec, g: PassGeom, x: torch.Tensor,
               inverse: bool) -> torch.Tensor:
    """The plain version of one pass, the kernel's contract: x is packed
    bytes (`g.in_packed`) or (NL, M * V) int32 digits in natural order; the
    block transform, the twiddle if `g.twiddle`, and the output packed for
    the next pass (`g.out_packed`) or as (NL, M * V) int32 digits."""
    nl = fs.nl
    if g.in_packed:
        xs = unpack_plain(fs, x, g.m, g.v, g.lsj, g.lsk)
    else:
        xs = x.reshape(nl, g.m, g.v)
    y = block_ntt_plain(fs, get_mxu_plan(fs, g.m.bit_length() - 1, inverse),
                        xs.contiguous())
    if g.twiddle:
        tw = pass_twiddles_plain(fs, g.m, g.c, inverse, x.device)
        y = HF.mont_mul_plain(fs, y.reshape(nl, g.m, g.c, g.b),
                              tw[..., None]).reshape(nl, g.m, g.v)
    # (k, c, b) -> natural (c, k, b)
    y = y.reshape(nl, g.m, g.c, g.b).transpose(1, 2).contiguous()
    if not g.out_packed:
        return y.reshape(nl, g.n)
    m2, c2, b2 = g.next_view()
    return pack_plain(fs, y.reshape(nl, m2, c2 * b2), g.lsj2, g.lsk2)


def _check_pass(fs: FieldSpec, g: PassGeom, x: torch.Tensor) -> None:
    """What the kernel takes, refused otherwise (any device)."""
    if fs.nl not in KERNEL_DIGITS:
        raise ValueError(f"{fs.name}: the mxu_ntt kernel has no instance "
                         f"for {fs.nl} digits (instances: {KERNEL_DIGITS})")
    if g.m < 2 or g.m > 1 << MAX_LOG_SIDE or g.m & (g.m - 1):
        raise ValueError(f"mxu_ntt: side {g.m} (2 to 64, a power of two)")
    if g.v < 1:
        raise ValueError("mxu_ntt: no columns")
    if g.c > 1 and g.b & (g.b - 1):
        raise ValueError("mxu_ntt: with c > 1, b must be a power of two")
    if (g.in_packed and g.m < PACKED_MIN_SIDE) or \
            (g.out_packed and g.m2 < PACKED_MIN_SIDE):
        raise ValueError("mxu_ntt: packed digits need sides of 16 or more")
    if g.out_packed and (g.c % g.m2 or g.m2 > 1 << MAX_LOG_SIDE):
        raise ValueError(f"mxu_ntt: the next side {g.m2} does not divide "
                         f"c = {g.c}")
    lanes = [(g.lsj, g.lsk, g.v)]
    if g.out_packed:
        lanes.append((g.lsj2, g.lsk2, g.n // g.m2))
    for lsj, lsk, v in lanes:
        if (lsj, lsk) != (2, 0) and not _lanes_ok(v, lsj, lsk):
            raise ValueError(f"mxu_ntt: tile lanes ({lsj}, {lsk}) for {v} "
                             f"vectors")
    if g.in_packed:
        want = (g.tiles * packed_tile_bytes(g.m),)
        if x.dtype != torch.uint8 or tuple(x.shape) != want:
            raise TypeError(f"mxu_ntt: packed input must be uint8 {want}")
    elif x.dtype != torch.int32 or tuple(x.shape) != (fs.nl, g.n):
        raise TypeError(f"mxu_ntt: x must be ({fs.nl}, {g.n}) int32 digits")
    if not x.is_contiguous():
        raise ValueError("mxu_ntt: x must be contiguous")


def _out_offsets(g: PassGeom, v: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Where output (v, k) goes (numpy int64): the byte of digit 0 in the
    next pass's packed tiles, or the int32 index of limb 0 (kernel 8's
    `out_offset`)."""
    log_m = g.m.bit_length() - 1
    if g.c > 1:
        log_b = g.b.bit_length() - 1
        c, b = v >> log_b, v & (g.b - 1)
    else:
        c, b = np.zeros_like(v), v
    if not g.out_packed:
        return ((c << log_m) + k) * g.b + b
    log_c2 = (g.c // g.m2).bit_length() - 1
    jn, cn = c >> log_c2, c & ((1 << log_c2) - 1)
    vn = ((cn << log_m) + k) * g.b + b
    ki2 = 2 if g.m2 >= 32 else 1
    tile, row = tile_row(vn, g.lsj2, g.lsk2)
    return tile * packed_tile_bytes(g.m2) + (jn >> 5) * (U8_DIGITS * ki2
                                                          * 1024) \
        + ((jn >> 4) & 1) * 1024 + row * 16 + (jn & 15)


@functools.lru_cache(maxsize=None)
def _runs(g: PassGeom) -> int:
    """1 (packed) or 2 (int32) where every output group of a tile lands in
    whole 64-byte runs as kernel 8's staged stores take them (the run of
    rows kl and outputs 4 kb .. 4 kb + 3 holds element (jq, kl, 4 kb + i)
    at 16 i + jq; int32: the run of (kl, k) holds jq at jq), checked on the
    first, a middle and the last tile; else 0 (one store an element)."""
    if g.m < 16 or (g.lsj, g.lsk) == (2, 0) or g.v % ROWS or \
            (g.c > 1 and g.b & (g.b - 1)):
        return 0
    r = np.arange(ROWS)
    jq, kl = r >> 2, r & 3
    for tile in sorted({0, g.tiles // 2, g.tiles - 1}):
        base = tile_base(tile, g.lsj, g.lsk)
        v = base + (jq << g.lsj) + (kl << g.lsk)
        for group in range(g.m // 8):
            k = group * 8 + np.arange(8)
            off = _out_offsets(g, v[:, None], k[None, :])
            if g.out_packed:
                start = off[kl[:, None], (k[None, :] // 4) * 4 - group * 8]
                want = start + (k[None, :] & 3) * 16 + jq[:, None]
            else:
                want = off[kl[:, None], k[None, :] - group * 8] + jq[:, None]
            if not np.array_equal(off, want):
                return 0
    return 1 if g.out_packed else 2


def pass_launch(fs: FieldSpec, g: PassGeom, x: torch.Tensor, inverse: bool,
                blocks: int):
    """(output tensor, the entry's arguments but the stream) of one launch
    of kernel 8 on x's device: `blocks` persistent blocks (one an SM on the
    card; a multiple of 4 at side 64, whose blocks each keep a quarter of
    the table)."""
    _check_pass(fs, g, x)
    dev = x.device
    plan = get_mxu_plan(fs, g.m.bit_length() - 1, inverse)
    table = plan.table_dev(dev)
    if g.out_packed:
        m2, c2, b2 = g.next_view()
        out = torch.empty(-(-(c2 * b2) // ROWS) * packed_tile_bytes(m2),
                          dtype=torch.uint8, device=dev)
    else:
        out = torch.empty((fs.nl, g.n), dtype=torch.int32, device=dev)
    tw_one = 0
    if g.twiddle and g.c > 1:
        log_n = (g.m * g.c).bit_length() - 1
        h, lo, hi = twiddle_tables(fs, log_n, inverse, dev)
        tw_one = int(h == log_n)
    else:
        h, lo, hi = 0, table, table
    if _table_side(g.m) == 64:
        blocks = max(4, blocks - blocks % 4)
    log_b = g.b.bit_length() - 1 if g.b & (g.b - 1) == 0 else -1
    vals = [g.m, g.c, g.b, g.tiles, g.lsj, g.lsk, int(g.in_packed),
            int(g.out_packed), int(g.twiddle and g.c > 1), h, g.m2, g.lsj2,
            g.lsk2, blocks, log_b,
            _runs(g), tw_one]
    geom = (ctypes.c_longlong * len(vals))(*vals)
    nw, consts = K.field_consts(fs)
    return out, [nw, consts, geom, x.data_ptr(), table.data_ptr(),
                 lo.data_ptr(), hi.data_ptr(), out.data_ptr()]


def mxu_pass(fs: FieldSpec, g: PassGeom, x: torch.Tensor,
             inverse: bool) -> torch.Tensor:
    """One pass: kernel 8 on a CUDA tensor (it raises where it cannot
    run), `pass_plain` on the CPU."""
    if not x.is_cuda:
        _check_pass(fs, g, x)
        return pass_plain(fs, g, x, inverse)
    _check_pass(fs, g, x)
    fn = K.entry("zk_mxu_pass")
    blocks = torch.cuda.get_device_properties(x.device).multi_processor_count
    out, args = pass_launch(fs, g, x, inverse, blocks)
    K.check(fn(*args, K.stream_ptr()), "zk_mxu_pass")
    LAUNCHES["mxu_ntt"] += 1
    return out


def block_launch(fs: FieldSpec, plan: MXUNttPlan, x: torch.Tensor):
    """The block pass's shape checks (any device): x is (NL, M, B) int32,
    M the plan's. Returns (M, B)."""
    if fs.nl not in KERNEL_DIGITS:
        raise ValueError(f"{fs.name}: the mxu_ntt kernel has no instance "
                         f"for {fs.nl} digits (instances: {KERNEL_DIGITS})")
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[0] != fs.nl:
        raise TypeError("mxu_ntt: x must be (NL, M, B) int32 digit planes")
    _, m, b = x.shape
    if m != plan.m or plan.fs != fs:
        raise ValueError(f"mxu_ntt: the plan is for M = {plan.m} of "
                         f"{plan.fs.name}, x has M = {m} of {fs.name}")
    if b < 1:
        raise ValueError("mxu_ntt: no columns")
    if not x.is_contiguous():
        raise ValueError("mxu_ntt: x must be contiguous")
    return m, b


def block_ntt(fs: FieldSpec, plan: MXUNttPlan,
              x: torch.Tensor) -> torch.Tensor:
    """One block transform, (NL, M, B) -> (NL, M, B) along axis 1: a pass
    with int32 input and output and no twiddle (kernel 8 on a CUDA tensor,
    `block_ntt_plain` on the CPU)."""
    m, b = block_launch(fs, plan, x)
    if not x.is_cuda:
        return block_ntt_plain(fs, plan, x)
    g = PassGeom(m=m, c=1, b=b)
    return mxu_pass(fs, g, x.reshape(fs.nl, m * b), plan.inverse) \
        .reshape(fs.nl, m, b)


def ntt_chain(fs: FieldSpec, x: torch.Tensor, inverse: bool,
              sides: list[int]) -> torch.Tensor:
    """(NL, N) -> (NL, N): natural-order transform as the chain of passes
    `chain_geoms(sides)`, each through `mxu_pass`."""
    if not sides:
        return x.clone()
    y = x.contiguous()
    for g in chain_geoms(sides):
        y = mxu_pass(fs, g, y, inverse)
    return y


def ntt_mxu(fs: FieldSpec, x: torch.Tensor, inverse: bool = False,
            log_block: int | None = None) -> torch.Tensor:
    """(NL, N) -> (NL, N), natural order both ways, Montgomery form, on x's
    device. Equal to `ops/ntt.py::ntt` digit for digit (the same 1/N
    product on the inverse, by kernel 1 on the card)."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "NTT size must be a power of two"
    out = ntt_chain(fs, x.reshape(fs.nl, n), inverse,
                    plan_sides(log_n, log_block))
    if inverse:
        out = L.mont_mul(fs, out, L.const_mont(fs, pow(n, -1, fs.p), (1,),
                                               x.device))
    return out
