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
- `ntt_hopper(fs, x, inverse)`: the four-step transform as two launches of
  kernel 2 and nothing else: the first reads columns and multiplies by
  w_N^(c*k2) before its store, the second reads and writes columns and, on
  the inverse, multiplies by 1/N.

Each wrapper runs its plain PyTorch version only for a tensor that lies on
the CPU. On a CUDA tensor it launches the kernel or raises. `LAUNCHES`
counts kernel launches, one per launch and nowhere else.
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

_MAX_ROW_LOG = 10     # a row of 2^10 elements of 12 words fills 48 KB


# ---------------------------------------------------------------------------
# plain versions: int64 arithmetic on digit planes (a 16x16-bit product does
# not fit a signed int32); they return int32
# ---------------------------------------------------------------------------

def _p_col(fs: FieldSpec, ref: torch.Tensor) -> torch.Tensor:
    pl = torch.from_numpy(fs.p_limbs.astype(np.int64)).to(ref.device)
    return pl.reshape((fs.nl,) + (1,) * (ref.dim() - 1))


def _carry_sweep(t: torch.Tensor):
    """Normalize lazy digits (any non-negative int64) along axis 0 to 16
    bits; returns (digits, carry_out)."""
    out = torch.empty_like(t)
    c = torch.zeros_like(t[0])
    for j in range(t.shape[0]):
        v = t[j] + c
        out[j] = v & MASK
        c = v >> W
    return out, c


def _cond_sub_p(fs: FieldSpec, s: torch.Tensor, carry: torch.Tensor):
    """s: normalized digits (int64) with a carry beyond; subtract p once if
    s >= p or the carry is set."""
    d, c = _carry_sweep(s + (MASK - _p_col(fs, s)) + _first_digit_one(s))
    # s + (2^(16 NL) - p): a carry out means s >= p
    use_d = (carry > 0) | (c > 0)
    return torch.where(use_d[None], d, s)


def _first_digit_one(ref: torch.Tensor) -> torch.Tensor:
    one = torch.zeros((ref.shape[0],) + (1,) * (ref.dim() - 1),
                      dtype=torch.int64, device=ref.device)
    one[0] = 1
    return one


def add_plain(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    s, c = _carry_sweep(a.to(torch.int64) + b.to(torch.int64))
    return _cond_sub_p(fs, s, c).to(torch.int32)


def sub_plain(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    # a + (2^(16 NL) - b): a carry out means a >= b
    t = a.to(torch.int64) + (MASK - b.to(torch.int64))
    d, c = _carry_sweep(t + _first_digit_one(t))
    e, _ = _carry_sweep(d + _p_col(fs, d))
    return torch.where((c == 0)[None], e, d).to(torch.int32)


def mont_mul_plain(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Digit-level CIOS with lazy carries in int64: the schoolbook product
    accumulates into 2NL columns, each of the NL reduction steps clears the
    lowest column, one carry sweep and a conditional subtract finish."""
    nl = fs.nl
    bshape = _broadcast_shape(a.shape[1:], b.shape[1:])
    a = a.to(torch.int64).expand((nl,) + bshape)
    b = b.to(torch.int64).expand((nl,) + bshape)
    t = torch.zeros((2 * nl + 1,) + bshape, dtype=torch.int64, device=a.device)
    for i in range(nl):
        t[i:i + nl] += a[i][None] * b
    pl = _p_col(fs, a)
    ninv = fs.ninv16
    for i in range(nl):
        m = (t[i] * ninv) & MASK
        t[i:i + nl] += m[None] * pl
        t[i + 1] += t[i] >> W
    digits, c = _carry_sweep(t[nl:2 * nl])
    return _cond_sub_p(fs, digits, t[2 * nl] + c).to(torch.int32)


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
    d = _twiddles_np(fs, log_b, inverse).astype(np.uint32)
    words = d[0::2] | (d[1::2] << 16)
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
    smem = (nl // 2) * ((b << log_g) + b // 2) * 4
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
    """(NL, C, R) table w_N^(c * k2), Montgomery form."""
    p = fs.p
    omega = fs.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, p)
    vals = []
    for cc in range(c):
        base = pow(omega, cc, p)
        acc = fs.R_mod_p
        for _ in range(r):
            vals.append(acc)
            acc = acc * base % p
    return L.from_numpy(L.pack_ints(fs, vals).reshape(fs.nl, c, r), device)


@functools.lru_cache(maxsize=None)
def _inverse_scale(fs: FieldSpec, n: int, device: str) -> torch.Tensor:
    """1/n as an (NL, 1, 1) Montgomery constant that stays on `device`."""
    return L.const_mont(fs, pow(n, -1, fs.p), (1, 1), device).contiguous()


def _transform(fs: FieldSpec, x: torch.Tensor, inverse: bool, scale,
               rows=ntt_rows_hopper):
    """NTT of x (NL, N) along the last axis, N = 2^k <= 2^20, times `scale`
    (an (NL, 1, 1) constant or None), through the row transform `rows`.

    Up to 2^10 one launch of the row kernel does it. Above that, the
    four-step split N = R*C:
    X[k1*R + k2] = NTT_C over c { w_N^(c*k2) * NTT_R over r { x[r*C+c] } },
    two launches: the first transforms the columns of x as an (R, C) matrix
    and stores w_N^(c*k2) times the result as rows (c, k2); the second
    transforms the columns of that, scales, and stores them as the columns
    of the output as a (C, R) matrix."""
    nl, n = x.shape
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "NTT size must be a power of two"
    if n == 1:
        return x
    if log_n <= _MAX_ROW_LOG:
        return rows(fs, x[:, None, :], inverse, mul=scale)[:, 0, :]
    # C <= R: the second launch reads and writes columns and so gains most
    # from short rows, which let a block take more of them side by side
    log_c = log_n // 2
    if log_n - log_c > _MAX_ROW_LOG:
        raise ValueError(f"NTT of 2^{log_n} exceeds the four-step range "
                         f"(2^{2 * _MAX_ROW_LOG})")
    c = 1 << log_c
    r = n >> log_c
    tw = _four_step_twiddles(fs, n, r, c, inverse, str(x.device))
    mid = rows(fs, x.reshape(nl, r, c).transpose(1, 2), inverse,
               mul=tw)                                     # (NL, c, k2)
    out = torch.empty((nl, n), dtype=torch.int32, device=x.device)
    rows(fs, mid.transpose(1, 2), inverse, mul=scale,
         out=out.reshape(nl, c, r).transpose(1, 2))
    return out                                             # (NL, k1*R + k2)


def ntt_hopper_raw(fs: FieldSpec, x: torch.Tensor,
                   inverse: bool = False) -> torch.Tensor:
    """Unscaled NTT of x (NL, N): no 1/N factor on the inverse."""
    return _transform(fs, x, inverse, None)


def ntt_hopper(fs: FieldSpec, x: torch.Tensor, inverse: bool = False,
               rows=ntt_rows_hopper) -> torch.Tensor:
    """Full NTT of x (NL, N); the inverse's 1/N factor rides in the last
    launch. `ntt_plain` is this with the plain row transform."""
    scale = _inverse_scale(fs, x.shape[1], str(x.device)) \
        if inverse and x.shape[1] > 1 else None
    return _transform(fs, x, inverse, scale, rows)


def ntt_plain(fs: FieldSpec, x: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """The plain version of `ntt_hopper`: the same split, strided views and
    multipliers, every row transform by `ntt_rows_plain`."""
    return ntt_hopper(fs, x, inverse, rows=ntt_rows_plain)
