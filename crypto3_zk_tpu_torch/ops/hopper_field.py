"""CUDA kernels for the hot field ops: Montgomery multiply and the row NTT.

Counterpart of `ops/pallas_field.py` of the JAX package.

- Kernel 1, `mont_mul_hopper(fs, a, b)`: elementwise modular multiply over
  digit planes. Replaces `mont_mul_pallas` / `_mont_mul_kernel`. Source:
  `csrc/mont_mul.cu`. One thread per element, word-level CIOS with 64-bit
  products. It moves 12*NL bytes per element for NW*(2NW+1) 32-bit
  multiply-adds (NW = NL/2): by the card's published peaks the bytes are
  the bound, so each operand is read once, coalesced, and nothing else
  touches memory.
- Kernel 2, `ntt_rows_hopper(fs, x, inverse, mul, out)`: batched radix-2
  NTTs of length B <= 2^10 along the last axis of a strided (NL, M, B) view,
  optionally times a multiplier, optionally into a strided view. Replaces
  `_ntt_rows_pallas` / `_ntt_rows_kernel`. Source: `csrc/ntt_rows.cu`. A row
  is read and written once (8*NL bytes per element) for (log B)/2
  butterflies per element; the bytes are few and the time goes to the
  products and to every trip through shared memory, so a thread keeps 4
  elements in registers for 2 stages between barriers, the twiddles are
  staged once per block, and a block takes several rows when they are short.
- `ntt_hopper(fs, x, inverse)`: the four-step transform of any 2^k. Up to
  2^20 it is two launches of kernel 2 and nothing else: the first reads
  columns and multiplies by w_N^(c*k2) before its store, the second reads
  and writes columns and, on the inverse, multiplies by 1/N. Above, a side
  longer than 2^10 is itself a batched four-step, and a twiddle that cannot
  ride in a row launch is one launch of kernel 1.

Each wrapper runs its plain PyTorch version only for a tensor that lies on
the CPU. On a CUDA tensor it launches the kernel or raises. `LAUNCHES`
counts kernel launches, one per launch and nowhere else; `LARGEST` keeps the
longest `ntt_hopper` transform (`chip_smoke.py` checks the kernels at that
length). Both are measurement state only: nothing in the port reads them.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels as K
from ..fields.params import MASK, W, FieldSpec
from . import limbs as L

LAUNCHES = {"mont_mul": 0, "ntt_rows": 0}
LARGEST = {"ntt_hopper": 0}   # the longest transform, in elements

_MAX_ROW_LOG = 10     # a row of 2^10 elements of 12 words fills 48 KB


# ---------------------------------------------------------------------------
# plain versions: int64 arithmetic on digit planes (a 16x16-bit product does
# not fit a signed int32); they return int32, the same digits as the kernels.
#
# Two forms, chosen by the number of lanes. Few lanes (up to _FEW_LANES): the
# time goes to library calls, so a fixed, small number of whole-tensor calls
# per operation, whatever the digit count: the schoolbook product as one outer
# product, the Montgomery reduction as two float64 matrix products against
# Toeplitz tables of constants (m = (ab mod R)(-1/p) mod R, then ab + m p),
# carries settled in whole-tensor passes and a carry lookahead. Many lanes:
# the time goes to memory, so the digit-serial forms, which touch one digit
# row at a time. `tools/time_plain.py` times both: on one CPU thread the
# whole-tensor product wins up to 2^9 lanes and loses from 2^10 on (2.4x
# slower at 2^12); on an H100 it wins up to 2^16 lanes and loses at 2^20
# (14.5 against 8.9 ms). The plain versions serve the CPU, so the CPU's
# crossover sets the bound; at 2^20 lanes, where the card holds kernel 1
# against them, the digit-serial forms are the faster ones there too. Both
# forms give the same digits.
# ---------------------------------------------------------------------------

_FEW_LANES = 512


def _digits(x: int, n: int) -> list[int]:
    return [(x >> (W * j)) & MASK for j in range(n)]


def _toeplitz(digits: list[int], rows: int) -> np.ndarray:
    """(rows, len(digits)) table T[k, i] = digits[k - i], 0 outside: the
    product of a digit column with these digits is T times the column."""
    n = len(digits)
    out = np.zeros((rows, n), dtype=np.int64)
    for k in range(rows):
        for i in range(n):
            if 0 <= k - i < n:
                out[k, i] = digits[k - i]
    return out


@functools.lru_cache(maxsize=None)
def _plain_consts(fs: FieldSpec, device: str):
    """Per-field tables of the plain versions, cached per device: the
    Toeplitz tables of -1/p mod R (low half) and of p, and the digit columns
    of p, of 1 and of 2^(16 (NL+1)) - k p."""
    nl = fs.nl
    nprime = (-pow(fs.p, -1, fs.R)) % fs.R

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return {
        "nprime": t(_toeplitz(_digits(nprime, nl), nl).astype(np.float64)),
        "p_toeplitz": t(_toeplitz(_digits(fs.p, nl), 2 * nl)
                        .astype(np.float64)),
        "p": t(np.array(_digits(fs.p, nl), dtype=np.int64)[:, None]),
        "one": t(np.array(_digits(1, nl), dtype=np.int64)[:, None]),
        "minus_p": t(np.array(_digits((fs.R << W) - fs.p, nl + 1),
                              dtype=np.int64)[:, None]),
        # column k: 2^(16 (NL+1)) - k p, k = 0 .. 4 (k = 0 as 2^(16 (NL+1)),
        # which the NL + 1 digits drop, so the column is 0 and H stays H)
        "minus_kp": t(np.array([_digits(((fs.R << W) - k * fs.p)
                                        % (fs.R << W), nl + 1)
                                for k in range(5)], dtype=np.int64).T),
    }


def _carry_pass(t: torch.Tensor) -> torch.Tensor:
    """t: lazy non-negative digits along axis 0, the top one a scratch
    digit that may grow: every digit below the top keeps its low 16 bits
    and hands the rest to the digit above. In place; the value is
    unchanged."""
    c = t[:-1] >> W
    t[:-1] &= MASK
    t[1:] += c
    return t


def _settle(t: torch.Tensor, bound: int) -> torch.Tensor:
    """`_carry_pass` until each digit below the top is at most 2^16, for
    digits at most `bound` (the number of passes follows from it)."""
    while bound > 1 << W:
        _carry_pass(t)
        bound = MASK + (bound >> W)
    return t


def _resolve(t: torch.Tensor) -> torch.Tensor:
    """t: digits along axis 0, each in [0, 2^16] below the scratch top one.
    Makes them exact 16-bit digits and adds the carry out to the top, by a
    carry lookahead: a digit of 2^16 makes a carry, 0xFFFF passes the one
    below on, any other stops it, so the carry out of digit j is made by the
    highest digit at or below j that is not 0xFFFF. In place."""
    lo = t[:-1]
    pos = torch.arange(lo.shape[0], device=t.device)
    pos = pos.reshape((-1,) + (1,) * (t.dim() - 1))
    key = torch.where(lo != MASK, 2 * pos + (lo >> W), -1)
    carry = torch.cummax(key, dim=0).values.clamp(min=0) & 1
    t[1:] += carry
    t[:-1] &= MASK
    return t


def _exact(t: torch.Tensor, bound: int) -> torch.Tensor:
    """t (rows, ...) lazy digits at most `bound`, with a zero scratch row
    appended: the exact digits, and in the last row the carry out."""
    t = torch.cat([t, torch.zeros_like(t[:1])])
    return _resolve(_settle(t, bound))


def _select_low(fs: FieldSpec, pair: torch.Tensor,
                take_second: torch.Tensor) -> torch.Tensor:
    """pair (rows, 2, ...) exact digits of two candidates: the low NL
    digits of the second where `take_second`, else of the first."""
    nl = fs.nl
    return torch.where(take_second[None], pair[:nl, 1],
                       pair[:nl, 0]).to(torch.int32)


def _flat_pair(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Both operands as (NL, lanes) int64 over their broadcast batch shape,
    and that shape."""
    bshape = _broadcast_shape(a.shape[1:], b.shape[1:])
    shape = (fs.nl,) + bshape
    return (a.to(torch.int64).expand(shape).reshape(fs.nl, -1),
            b.to(torch.int64).expand(shape).reshape(fs.nl, -1), shape)


def add_plain(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """a + b, less p once if the sum is at least p."""
    a, b, shape = _flat_pair(fs, a, b)
    if a.shape[1] > _FEW_LANES:
        s, c = _carry_sweep(a + b)
        return _cond_sub_p(fs, s, c).to(torch.int32).reshape(shape)
    c = _plain_consts(fs, str(a.device))
    s = torch.cat([a + b, torch.zeros_like(a[:1])])         # NL + 1 digits
    pair = _exact(torch.stack([s, s + c["minus_p"]], dim=1), 3 * MASK)
    # a carry out of s + 2^(16 (NL+1)) - p means s >= p
    return _select_low(fs, pair, pair[-1, 1] > 0).reshape(shape)


def sub_plain(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """a - b, plus p if a < b: a + (2^(16 NL) - b) carries out iff a >= b."""
    a, b, shape = _flat_pair(fs, a, b)
    d = a + (MASK - b)
    d[0] += 1
    if a.shape[1] > _FEW_LANES:
        d, c = _carry_sweep(d)
        e, _ = _carry_sweep(d + _plain_consts(fs, str(d.device))["p"])
        return torch.where((c == 0)[None], e, d).to(torch.int32) \
            .reshape(shape)
    c = _plain_consts(fs, str(a.device))
    pair = _exact(torch.stack([d, d + c["p"]], dim=1), 3 * MASK + 1)
    return _select_low(fs, pair, pair[fs.nl, 0] == 0).reshape(shape)


def _schoolbook(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(NL, lanes) digits -> the 2NL lazy columns of ab, each below NL 2^32:
    one outer product written with a row stride of 2NL + 1 and read back
    with a stride of 2NL, which puts a_i b_j in column i + j, and one sum."""
    nl, lanes = a.shape
    z = torch.zeros((nl, 2 * nl + 1, lanes), dtype=torch.int64,
                    device=a.device)
    torch.mul(a[:, None], b[None], out=z[:, :nl])
    return z.view(-1, lanes)[:2 * nl * nl].view(nl, 2 * nl, lanes).sum(0)


def _times_const(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """table (rows, NL) float64 of digits times x (NL, lanes) int64 lazy
    digits, as one float64 matrix product: exact while every sum stays
    below 2^53, which the callers' bounds keep (at most NL 2^16 times the
    largest entry of x)."""
    return (table @ x.to(torch.float64)).to(torch.int64)


def _reduce_lanes(fs: FieldSpec, t: torch.Tensor, terms: int = 1):
    """T R^-1 mod p for T given as 2NL lazy int64 columns (lanes last),
    T a sum of `terms` products of residues below p, each column below
    terms NL 2^32. Montgomery's reduction by whole products: m = T (-1/p)
    mod R (exactly the number digit-serial CIOS builds a digit at a time),
    H = (T + m p) / R < (terms p / R + 1) p, less p as often as H allows.
    With one term that is CIOS's single conditional subtract, so a product
    agrees with the kernel's for any digit inputs."""
    nl = fs.nl
    c = _plain_consts(fs, str(t.device))
    # one pass brings the columns under 2^23, so the products with the
    # constants below stay exact in float64
    t = _carry_pass(torch.cat([t, torch.zeros_like(t[:1])]))
    col = MASK + (terms * nl * MASK * MASK >> W)
    # m, exact mod R: the carries out of the low NL digits are dropped
    m = _exact(_times_const(c["nprime"], t[:nl]), nl * MASK * col)[:nl]
    # T + m p: its low NL digits settle to 0 or to R exactly (at most 2^16
    # each, a multiple of R, below 2R), so R's carry is "any nonzero"
    u = t
    u[:2 * nl] += _times_const(c["p_toeplitz"], m)
    u = _settle(u, col + nl * MASK * MASK)
    h = u[nl:]                                              # NL + 1 digits
    h[0] += (u[:nl] != 0).any(0)
    kmax = 1 + terms * fs.p // fs.R
    cands = _exact(h[:, None] + c["minus_kp"][:, :kmax + 1, None], 2 << W)
    # a carry out of H + 2^(16 (NL+1)) - k p means H >= k p
    k = (cands[-1, 1:] > 0).sum(0)
    return cands[:nl].gather(1, k.expand(nl, 1, -1)).squeeze(1) \
        .to(torch.int32)


def _mont_mul_lanes(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """a b R^-1 mod p for (NL, lanes) int64 digits."""
    return _reduce_lanes(fs, _schoolbook(a, b))


def mont_matvec_plain(fs: FieldSpec, table: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """sum_j M[i][j] x[j] R^-1 mod p for a constant k x k matrix M given by
    `matvec_table(fs, M digits)` and x (NL, k, lanes): one float64 product
    against the matrix's digits and one reduction per output, which give
    the same residues as k^2 Montgomery products and the adds."""
    nl, k, lanes = x.shape
    t = table @ x.transpose(0, 1).reshape(k * nl, lanes).to(torch.float64)
    t = t.to(torch.int64).reshape(k, 2 * nl, lanes).transpose(0, 1)
    return _reduce_lanes(fs, t.reshape(2 * nl, k * lanes), k) \
        .reshape(nl, k, lanes)


def matvec_table(digits: np.ndarray) -> np.ndarray:
    """(NL, k, k) digits of a constant matrix M -> the (k 2NL, k NL)
    float64 block table whose product with the stacked digits of x gives
    the lazy columns of every sum_j M[i][j] x[j]."""
    nl, k, _ = digits.shape
    out = np.zeros((k * 2 * nl, k * nl))
    for i in range(k):
        for j in range(k):
            out[i * 2 * nl:(i + 1) * 2 * nl, j * nl:(j + 1) * nl] = \
                _toeplitz([int(d) for d in digits[:, i, j]], 2 * nl)
    return out


def _carry_sweep(t: torch.Tensor):
    """Normalize lazy digits (any non-negative int64) along axis 0 to 16
    bits, one digit row after another; returns (digits, carry_out)."""
    out = torch.empty_like(t)
    c = torch.zeros_like(t[0])
    for j in range(t.shape[0]):
        v = t[j] + c
        out[j] = v & MASK
        c = v >> W
    return out, c


def _cond_sub_p(fs: FieldSpec, s: torch.Tensor, carry: torch.Tensor):
    """s: normalized digits (int64) with a carry beyond; subtract p once if
    s >= p or the carry is set: s + (2^(16 NL) - p) carries out iff s >= p."""
    consts = _plain_consts(fs, str(s.device))
    d, c = _carry_sweep(s + (MASK - consts["p"]) + consts["one"])
    return torch.where(((carry > 0) | (c > 0))[None], d, s)


def _mont_mul_cios(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Digit-serial CIOS with lazy carries for (NL, lanes) int64 digits: the
    schoolbook product accumulates into 2NL columns, each of the NL
    reduction steps clears the lowest column, one carry sweep and a
    conditional subtract finish."""
    nl = fs.nl
    t = torch.zeros((2 * nl + 1, a.shape[1]), dtype=torch.int64,
                    device=a.device)
    for i in range(nl):
        t[i:i + nl] += a[i] * b
    pl = _plain_consts(fs, str(a.device))["p"]
    for i in range(nl):
        m = (t[i] * fs.ninv16) & MASK
        t[i:i + nl] += m * pl
        t[i + 1] += t[i] >> W
    digits, c = _carry_sweep(t[nl:2 * nl])
    return _cond_sub_p(fs, digits, t[2 * nl] + c).to(torch.int32)


def mont_mul_plain(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """a b R^-1 mod p over digit planes that broadcast over batch dims."""
    a, b, shape = _flat_pair(fs, a, b)
    if a.shape[1] > _FEW_LANES:
        return _mont_mul_cios(fs, a, b).reshape(shape)
    return _mont_mul_lanes(fs, a, b).reshape(shape)


# ---------------------------------------------------------------------------
# kernel 1: Montgomery multiply (and the add / subtract entries beside it)
# ---------------------------------------------------------------------------

def _broadcast_shape(sa, sb) -> tuple:
    """Broadcast of two batch shapes (plain tuple work: this runs once per
    launch, tens of thousands of times per proof)."""
    sa, sb = tuple(sa), tuple(sb)
    if sa == sb:
        return sa
    sa = (1,) * (len(sb) - len(sa)) + sa
    sb = (1,) * (len(sa) - len(sb)) + sb
    out = []
    for x, y in zip(sa, sb):
        if x != y and x != 1 and y != 1:
            raise ValueError(f"shapes {sa} and {sb} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _launch_geometry(nl: int, a: torch.Tensor, b: torch.Tensor):
    """How the elementwise kernel walks two broadcasting operands without
    copying them: the batch is viewed as three axes (d0, d1, d2) and each
    operand as a strided (NL, d0, d1, d2) view, stride 0 on a broadcast
    axis. Returns (output batch shape, (d0, d1, d2), view of a, view of b).
    Pure shape work, the same on any device."""
    bshape = _broadcast_shape(a.shape[1:], b.shape[1:])
    if a.shape == b.shape and a.is_contiguous() and b.is_contiguous():
        shape3 = (1, 1, a[0].numel())
        return (bshape, shape3, a.reshape((nl,) + shape3),
                b.reshape((nl,) + shape3))
    if len(bshape) > 3:
        raise ValueError("broadcasting over more than three batch axes is "
                         "not supported")
    shape3 = (1,) * (3 - len(bshape)) + bshape
    a = a.reshape((nl,) + (1,) * (4 - a.dim()) + tuple(a.shape[1:]))
    b = b.reshape((nl,) + (1,) * (4 - b.dim()) + tuple(b.shape[1:]))
    return (bshape, shape3, a.expand((nl,) + shape3),
            b.expand((nl,) + shape3))


def _kernel_strides(v: torch.Tensor):
    """{stride d0, stride d1, stride d2, limb stride} of a 4-axis view."""
    st = v.stride()
    return (ctypes.c_longlong * 4)(st[1], st[2], st[3], st[0])


def elementwise(fs: FieldSpec, entry: str, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Launch one of the elementwise entries (`zk_mont_mul`, `zk_add`,
    `zk_sub`) on CUDA tensors. Operands broadcast over batch dims through
    strides; the output is a new contiguous tensor."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(f"{entry}: both operands must be CUDA tensors")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"{entry}: operands must be int32 digit planes")
    if a.shape[0] != fs.nl or b.shape[0] != fs.nl:
        raise ValueError(f"{entry}: limb axis must be first and hold "
                         f"{fs.nl} digits")
    nw, consts = K.field_consts(fs)
    bshape, shape3, av, bv = _launch_geometry(fs.nl, a, b)
    out = torch.empty((fs.nl,) + bshape, dtype=torch.int32, device=a.device)
    code = K.entry(entry)(nw, consts, av.data_ptr(), bv.data_ptr(),
                          out.data_ptr(), shape3[0], shape3[1], shape3[2],
                          _kernel_strides(av), _kernel_strides(bv),
                          K.stream_ptr())
    K.check(code, entry)
    return out


def mont_mul_hopper(fs: FieldSpec, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Kernel 1. a, b: (NL, *batch) int32 digit planes in Montgomery form,
    broadcasting over batch dims. Returns a*b*R^-1 mod p."""
    if not (a.is_cuda or b.is_cuda):
        return mont_mul_plain(fs, a, b)
    out = elementwise(fs, "zk_mont_mul", a, b)
    LAUNCHES["mont_mul"] += 1
    return out


def add_hopper(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Modular add: the `zk_add` entry beside kernel 1 on the card."""
    if not (a.is_cuda or b.is_cuda):
        return add_plain(fs, a, b)
    return elementwise(fs, "zk_add", a, b)


def sub_hopper(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Modular subtract: the `zk_sub` entry beside kernel 1 on the card."""
    if not (a.is_cuda or b.is_cuda):
        return sub_plain(fs, a, b)
    return elementwise(fs, "zk_sub", a, b)


# ---------------------------------------------------------------------------
# kernel 2: row NTT
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _twiddles_np(fs: FieldSpec, log_b: int, inverse: bool) -> np.ndarray:
    """(NL, B/2) plain table w^j in Montgomery form."""
    w = fs.root_of_unity(1 << log_b)
    if inverse:
        w = pow(w, -1, fs.p)
    return L.powers_np(fs, w, max((1 << log_b) // 2, 1))


@functools.lru_cache(maxsize=None)
def _twiddles(fs: FieldSpec, log_b: int, inverse: bool, device: str):
    return L.from_numpy(_twiddles_np(fs, log_b, inverse), device)


@functools.lru_cache(maxsize=None)
def bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt_rows_plain(fs: FieldSpec, x: torch.Tensor, inverse: bool,
                   mul: torch.Tensor | None = None,
                   out: torch.Tensor | None = None):
    """The radix-2 decimation-in-time stage loop along the last axis:
    bit-reverse, then log B butterfly layers of one Montgomery multiply, one
    add and one subtract each. x: (NL, *batch, B), any strides. `mul`
    (broadcasting against x) multiplies the result; `out`, a view of x's
    shape, receives it."""
    b = x.shape[-1]
    log_b = b.bit_length() - 1
    tw = _twiddles(fs, log_b, inverse, str(x.device))
    lead = tuple(x.shape[:-1])
    half_shape = lead + (b // 2,)
    x = x[..., torch.from_numpy(bitrev_perm(log_b)).to(x.device)]
    for s in range(1, log_b + 1):
        m = 1 << s
        xr = x.reshape(lead + (b // m, m))
        even = xr[..., : m // 2].reshape(half_shape)
        odd = xr[..., m // 2:].reshape(half_shape)
        stw = tw[:, :: b // m]                              # (NL, m/2)
        stw = stw.reshape((fs.nl,) + (1,) * (len(lead) - 1) + (1, m // 2)) \
            .expand(lead + (b // m, m // 2)).reshape(half_shape)
        t = mont_mul_plain(fs, odd, stw)
        lo = add_plain(fs, even, t)
        hi = sub_plain(fs, even, t)
        x = torch.cat([lo.reshape(lead + (b // m, m // 2)),
                       hi.reshape(lead + (b // m, m // 2))],
                      dim=-1).reshape(lead + (b,))
    if mul is not None:
        x = mont_mul_plain(fs, x, mul)
    if out is None:
        return x
    out.copy_(x)
    return out


@functools.lru_cache(maxsize=None)
def _twiddle_words(fs: FieldSpec, log_b: int, inverse: bool, device: str):
    """The table kernel 2 stages in shared memory: (NW, B/2) int32, digit
    pairs of w^j fused to 32-bit words, slot m holding j = the bit reversal
    of m over log B - 1 bits (stage t then reads the slots below 2^(t-1))."""
    words = K.fuse_words(_twiddles_np(fs, log_b, inverse))
    words = words[:, bitrev_perm(log_b - 1)]
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)) \
        .to(device)


_ROWS_TILE = 2048         # elements a block of kernel 2 takes, at most
_ROWS_MAX_THREADS = 256
_ROWS_MIN_BLOCKS = 128    # rows are grouped only while this many blocks remain


def _row_strides(v: torch.Tensor):
    """{limb, row, element} strides of an (NL, M, B) view, in int32s."""
    return (ctypes.c_longlong * 3)(*v.stride())


def _rows_launch(fs: FieldSpec, x: torch.Tensor, mul, out):
    """What kernel 2 is given for an (NL, M, B) view x, a multiplier and an
    output view, and the refusal of what it does not take. Pure shape and
    stride work, the same on any device. Returns (rows, log_b, log_g,
    threads, shared-memory bytes, strides of x, multiplier view or None,
    strides of out or None): a block takes 2^log_g neighbouring rows, as
    many as fit a tile of 2048 elements while at least 128 blocks remain,
    and one thread for every 4 elements, 32 to 256 of them."""
    if x.dim() != 3 or x.shape[0] != fs.nl or x.dtype != torch.int32:
        raise TypeError("ntt_rows: x must be (NL, M, B) int32 digit planes")
    nl, m_rows, b = x.shape
    log_b = b.bit_length() - 1
    if 1 << log_b != b or not 1 <= log_b <= _MAX_ROW_LOG:
        raise ValueError(f"row length {b} is not a power of two in "
                         f"[2, 2^{_MAX_ROW_LOG}]")
    if m_rows < 1:
        raise ValueError("ntt_rows: no rows")
    mul_view = out_strides = None
    if mul is not None:
        if mul.dtype != torch.int32 or mul.dim() != 3 or mul.shape[0] != nl \
                or any(s not in (1, t) for s, t in zip(mul.shape, x.shape)):
            raise ValueError(f"ntt_rows: a multiplier of shape "
                             f"{tuple(mul.shape)} does not broadcast over "
                             f"{tuple(x.shape)}")
        mul_view = mul.expand(x.shape)
    if out is not None:
        if out.shape != x.shape or out.dtype != torch.int32:
            raise ValueError("ntt_rows: out must have x's shape and type")
        if 0 in out.stride():
            raise ValueError("ntt_rows: out overlaps itself (a stride is 0)")
        if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
            raise ValueError("ntt_rows: out shares x's storage; the "
                             "transform is not done in place")
        out_strides = _row_strides(out)
    log_g = 0
    while (b << (log_g + 1)) <= _ROWS_TILE \
            and (m_rows >> (log_g + 1)) >= _ROWS_MIN_BLOCKS:
        log_g += 1
    threads = min(_ROWS_MAX_THREADS, max(32, (b << log_g) >> 2))
    smem = K.words(nl) * ((b << log_g) + b // 2) * 4
    return (m_rows, log_b, log_g, threads, smem, _row_strides(x), mul_view,
            out_strides)


def ntt_rows_hopper(fs: FieldSpec, x: torch.Tensor, inverse: bool,
                    mul: torch.Tensor | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 2. x: (NL, M, B) int32 digit planes in natural order, any
    strides, B a power of two with 2 <= B <= 2^10. Computes the unscaled
    transform of every row (no 1/B factor on the inverse), natural order,
    times `mul` where given ((NL, M, B), or 1 on an axis it broadcasts
    over). The result goes to `out`, a view of x's shape with any nonzero
    strides that does not share x's storage, or to a new contiguous
    tensor."""
    (m_rows, log_b, log_g, threads, _, x_strides, mul_view,
     out_strides) = _rows_launch(fs, x, mul, out)
    if not x.is_cuda:
        return ntt_rows_plain(fs, x, inverse, mul, out)
    if (mul is not None and not mul.is_cuda) \
            or (out is not None and not out.is_cuda):
        raise ValueError("ntt_rows: every operand must be a CUDA tensor")
    nw, consts = K.field_consts(fs)
    tww = _twiddle_words(fs, log_b, inverse, str(x.device))
    if out is None:
        out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        out_strides = _row_strides(out)
    code = K.entry("zk_ntt_rows")(
        nw, consts, x.data_ptr(), x_strides, tww.data_ptr(),
        None if mul_view is None else mul_view.data_ptr(),
        None if mul_view is None else _row_strides(mul_view),
        out.data_ptr(), out_strides, m_rows, log_b, log_g, threads,
        K.stream_ptr())
    K.check(code, "zk_ntt_rows")
    LAUNCHES["ntt_rows"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _four_step_twiddles(fs: FieldSpec, n: int, r: int, c: int,
                        inverse: bool, device: str) -> torch.Tensor:
    """(NL, C, R) table w_N^(c * k2), Montgomery form, built where it is
    used by doubling with the plain product (a one-time table: no host loop
    over its N entries, no kernel launch): row 1 is the powers of w_N, rows
    [j, 2j) are rows [0, j) times row j, and row 2j is row j squared."""
    omega = fs.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, fs.p)
    one = L.encode(fs, [1], device)
    step = L.encode(fs, [omega], device)
    row = one
    while row.shape[1] < r:
        row = torch.cat([row, mont_mul_plain(fs, row, step)], dim=1)
        step = mont_mul_plain(fs, step, step)
    row = row[:, :r]
    out = torch.empty((fs.nl, c, r), dtype=torch.int32, device=device)
    out[:, 0] = one
    j = 1
    while j < c:
        out[:, j:2 * j] = mont_mul_plain(fs, out[:, :j], row[:, None, :])
        if 2 * j < c:
            row = mont_mul_plain(fs, row, row)
        j *= 2
    return out


@functools.lru_cache(maxsize=None)
def _inverse_scale(fs: FieldSpec, n: int, device: str) -> torch.Tensor:
    """1/n as an (NL, 1, 1) Montgomery constant that stays on `device`."""
    return L.const_mont(fs, pow(n, -1, fs.p), (1, 1), device).contiguous()


def _lines(fs: FieldSpec, x: torch.Tensor, m: int, out: torch.Tensor,
           inverse: bool, scale, rows, mul) -> None:
    """NTTs of m interleaved lines into `out`, times `scale` (an (NL, 1, 1)
    constant or None), through the row transform `rows` and the product
    `mul`. x and out are (NL, m*L) with any stride along the last axis and
    do not share storage; element l of line i sits at l*m + i in both.

    Up to 2^10 one launch of the row kernel does it. Above that, the
    four-step split L = L1*L2 of every line, L1 = min(2^10, the larger
    half), so that the first side always fits one launch:
    X[k1*L1 + k2] = NTT_L2 over c { w_L^(c*k2) * NTT_L1 over r { x[r*L2+c] } }.
    Element r*L2 + c of line i sits at r*(L2*m) + (c*m + i): the first
    transforms are the m*L2 interleaved lines (c, i) of length L1, and the
    second the m*L1 interleaved lines (k2, i) of length L2, whose outputs
    land where the full transform's belong. A second side above 2^10 is
    again a four-step through this function.
    - one line (m = 1): the first launch reads the columns of x as an
      (L1, L2) matrix and stores w_L^(c*k2) times the result as rows
      (c, k2), the twiddle riding in it; up to 2^20 two launches in all;
    - more lines: the first transforms write `out` (dead until the second
      ones), and one launch of kernel 1 multiplies by w_L^(c*k2) while it
      moves the lines from (k2, c, i) order into (c, k2, i), where the
      second transforms find them interleaved. The twiddle depends on c and
      k2 but not on i, which a row launch's multiplier cannot express.
    Besides x and out, one (NL, m*L) temporary per level is live, two at
    most in all."""
    nl, n = x.shape
    length = n // m
    log_l = length.bit_length() - 1
    if log_l <= _MAX_ROW_LOG:
        rows(fs, x.unflatten(1, (length, m)).transpose(1, 2), inverse,
             mul=scale, out=out.unflatten(1, (length, m)).transpose(1, 2))
        return
    l1 = 1 << min(_MAX_ROW_LOG, log_l - log_l // 2)
    l2 = length // l1
    tw = _four_step_twiddles(fs, length, l1, l2, inverse,
                             str(x.device))                 # (NL, L2, L1)
    if m == 1:
        mid = rows(fs, x.unflatten(1, (l1, l2)).transpose(1, 2), inverse,
                   mul=tw)                                  # (NL, c, k2)
    else:
        _lines(fs, x, m * l2, out, inverse, None, rows, mul)
        mid = mul(fs, out.unflatten(1, (l1, l2, m)).permute(0, 2, 1, 3),
                  tw[..., None])                            # (NL, c, k2, i)
    _lines(fs, mid.reshape(nl, n), m * l1, out, inverse, scale, rows, mul)


def _transform(fs: FieldSpec, x: torch.Tensor, inverse: bool, scale,
               rows=ntt_rows_hopper, mul=mont_mul_hopper):
    """NTT of x (NL, N) along the last axis, N = 2^k, times `scale` (an
    (NL, 1, 1) constant or None), through the row transform `rows` and,
    above 2^20, the product `mul` (`_lines` has the split)."""
    nl, n = x.shape
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "NTT size must be a power of two"
    if n == 1:
        return x
    if log_n <= _MAX_ROW_LOG:
        return rows(fs, x[:, None, :], inverse, mul=scale)[:, 0, :]
    out = torch.empty((nl, n), dtype=torch.int32, device=x.device)
    _lines(fs, x, 1, out, inverse, scale, rows, mul)
    return out


def ntt_hopper_raw(fs: FieldSpec, x: torch.Tensor,
                   inverse: bool = False) -> torch.Tensor:
    """Unscaled NTT of x (NL, N): no 1/N factor on the inverse."""
    return _transform(fs, x, inverse, None)


def ntt_hopper(fs: FieldSpec, x: torch.Tensor, inverse: bool = False,
               rows=ntt_rows_hopper, mul=mont_mul_hopper) -> torch.Tensor:
    """Full NTT of x (NL, N), any N = 2^k; the inverse's 1/N factor rides in
    the last launch. `ntt_plain` is this with the plain row transform and
    product. `LARGEST` keeps the longest N seen."""
    LARGEST["ntt_hopper"] = max(LARGEST["ntt_hopper"], x.shape[1])
    scale = _inverse_scale(fs, x.shape[1], str(x.device)) \
        if inverse and x.shape[1] > 1 else None
    return _transform(fs, x, inverse, scale, rows, mul)


def ntt_plain(fs: FieldSpec, x: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """The plain version of `ntt_hopper`: the same split, strided views and
    multipliers, every row transform by `ntt_rows_plain` and every twiddle
    product by `mont_mul_plain`."""
    return ntt_hopper(fs, x, inverse, rows=ntt_rows_plain,
                      mul=mont_mul_plain)
