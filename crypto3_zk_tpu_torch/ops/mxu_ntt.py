"""The NTT as int8 digit-plane matrix products, on the tensor cores.

Counterpart of `ops/mxu_ntt.py` of the JAX package, which maps the
transform onto the TPU's matrix unit; here the same algebra runs on the
H100's int8 tensor cores:

- A length-M block transform is the matrix product W @ x with
  W[k, j] = w^(kj): one (M x M) field matrix against a batch of columns.
- Field elements are split into base-128 digit planes (7-bit digits in
  int8), so the field product becomes ND^2 int8 products with int32 sums,
  plane s = sum over a + b = s of W_a @ x_b.
- The wide plane sums are brought back to canonical Montgomery digits by
  NL + 1 Montgomery rounds over lazy 16-bit columns. W is pre-scaled by
  2^(16 (NL+1)) mod p, so the rounds' 2^-(16 (NL+1)) cancels and
  Montgomery form is kept end to end.
- Larger transforms are the four-step split N = R * C with every factor a
  block transform and the twiddle product, fused with the move of the
  lines into place, one launch of kernel 1.

`block_ntt(fs, plan, x)` is one block pass: on a CUDA tensor one launch of
`csrc/mxu_ntt.cu` (digits in shared memory, the products on
`mma.sync ... s8.s8.s32`, plane merge and sweep in registers), on a CPU
tensor `block_ntt_plain`, which follows the JAX arithmetic in int64 and
float64 (exact: every sum stays below 2^53). `LAUNCHES["mxu_ntt"]` counts
the kernel's launches; nothing in the port reads it.

`ntt_mxu` is not on any prover's path: `ops/ntt.py` stays the transform of
the port, and this module is the measured alternative to it.
"""
from __future__ import annotations

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

# largest single block: plane_bound = M * 127^2 * ND must stay below 2^31
# (M = 2^10, ND = 37 -> 6.1e8)
_MAX_LOG_BLOCK = 10
# the kernel's instance: bls12-381 Fr and the other 16-digit fields
KERNEL_DIGITS = (16,)


def _n_digits(fs: FieldSpec) -> int:
    return -(-(fs.nl * 16) // DIGIT_BITS)


def _digitize_int(v: int, nd: int) -> list[int]:
    return [(v >> (DIGIT_BITS * j)) & DIGIT_MASK for j in range(nd)]


class MXUNttPlan:
    """Digit-plane DFT matrix of one (field, M, direction)."""

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
        # W'[k, j] = omega^(kj) * 2^(16 rounds) mod p, base-128 digit planes
        shift = pow(2, 16 * self.rounds, p)
        pows = np.empty(m, dtype=object)
        acc = 1
        for i in range(m):
            pows[i] = acc * shift % p
            acc = acc * omega % p
        kj = (np.outer(np.arange(m, dtype=np.int64),
                       np.arange(m, dtype=np.int64)) % m)
        ent = pows[kj].reshape(-1)        # (M*M,) python ints
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
        self._dev: dict[str, torch.Tensor] = {}

    def w_digits_dev(self, device) -> torch.Tensor:
        """(ND, M, M) int8 on `device`, sent once per device (37 MB at
        M = 1024) and kept."""
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.w_digits).to(device)
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
    """The plain version of the block pass. x: (NL, M, B) Montgomery digits;
    the transform runs along axis 1. Each W_a @ x_b product is one float64
    matrix product (exact: its sums are below M 127^2 < 2^24)."""
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


def block_launch(fs: FieldSpec, plan: MXUNttPlan, x: torch.Tensor):
    """What the kernel is given for x, and the refusal of what it does not
    take. Pure shape work, the same on any device. Returns (M, B, blocks):
    a block takes 16 output rows and 32 columns, rows fastest, so that the
    blocks in flight share their columns of x."""
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
    """One block pass, (NL, M, B) -> (NL, M, B): the kernel on a CUDA
    tensor (it raises where it cannot run), the plain version on the
    CPU."""
    if not x.is_cuda:
        return block_ntt_plain(fs, plan, x)
    m, b = block_launch(fs, plan, x)
    nw, consts = K.field_consts(fs)
    w = plan.w_digits_dev(x.device)
    out = torch.empty_like(x)
    code = K.entry("zk_mxu_block")(nw, consts, x.data_ptr(), w.data_ptr(),
                                   out.data_ptr(), m, b, K.stream_ptr())
    K.check(code, "zk_mxu_block")
    LAUNCHES["mxu_ntt"] += 1
    return out


def _ntt_axis1(fs: FieldSpec, x: torch.Tensor, inverse: bool,
               log_block: int | None = None) -> torch.Tensor:
    """(NL, M, B) -> (NL, M, B): natural-order NTT along axis 1. M <= 2^10
    is one block pass; a larger M (or a given `log_block`) is the four-step
    M = R * C, C the block side, each side again through this function."""
    m = x.shape[1]
    log_m = m.bit_length() - 1
    if log_m <= _MAX_LOG_BLOCK and log_block is None:
        return block_ntt(fs, get_mxu_plan(fs, log_m, inverse), x)
    log_c = log_block if log_block is not None \
        else min((log_m + 1) // 2, _MAX_LOG_BLOCK)
    log_r = log_m - log_c
    r, c = 1 << log_r, 1 << log_c
    nl = fs.nl
    b = x.shape[2]

    # (NL, R, C), [k2, cc] = w_M^(cc * k2): `hopper_field`'s table with its
    # sides swapped, the one `ntt_hopper` holds at the same N
    tw = HF._four_step_twiddles(fs, m, c, r, inverse, str(x.device))
    # step 1: size-R transforms over rows (batch c*b)
    a = _ntt_axis1(fs, x.reshape(nl, r, c * b), inverse)
    # steps 2+3: twiddle w_M^(cc * k2), broadcast over the caller batch, in
    # one product that also writes (NL, C, R, B): the swap of the JAX
    # package's axes 1 and 2 rides in the product's output
    a = L.mont_mul(fs, a.reshape(nl, r, c, b).transpose(1, 2),
                   tw.transpose(1, 2)[..., None])
    # step 4: size-C transforms along c (batch r*b)
    a = _ntt_axis1(fs, a.reshape(nl, c, r * b), inverse)
    # output O[k1, k2] -> X[k1 * R + k2]
    return a.reshape(nl, m, b)


def ntt_mxu(fs: FieldSpec, x: torch.Tensor, inverse: bool = False,
            log_block: int | None = None) -> torch.Tensor:
    """(NL, N) -> (NL, N), natural order both ways, Montgomery form, on x's
    device. Equal to `ops/ntt.py::ntt` digit for digit (the same 1/N
    product on the inverse, by kernel 1 on the card)."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "NTT size must be a power of two"
    out = _ntt_axis1(fs, x.reshape(fs.nl, n, 1), inverse,
                     log_block).reshape(fs.nl, n)
    if inverse:
        out = L.mont_mul(fs, out, L.const_mont(fs, pow(n, -1, fs.p), (1,),
                                               x.device))
    return out
