"""Vectorized multiprecision modular arithmetic on 16-bit digit planes.

Counterpart of `ops/limbs.py` of the JAX package, with the same public
layout so every tensor compares bit for bit with the reference array:

- a batch of field elements is a `torch.int32` tensor of shape
  ``(NL, *batch)``, limb axis FIRST, each entry a 16-bit digit;
- everything is in Montgomery form with R = 2^(16*NL) unless noted.

`mont_mul`, `add` and `sub` go through `ops/hopper_field.py`: a CUDA kernel
for tensors on the card, the plain PyTorch version for tensors on the CPU.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..fields.params import FieldSpec

I32 = torch.int32
I64 = torch.int64


def resolve_device(device) -> torch.device:
    """Resolve a device argument. The default is the card, and asking for
    it without one raises: nothing falls back to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run the plain versions on the CPU")
    return device


# ---------------------------------------------------------------------------
# host <-> device packing
# ---------------------------------------------------------------------------

def pack_ints(fs: FieldSpec, xs: Sequence[int]) -> np.ndarray:
    """Python ints -> (NL, n) uint32 digit array (NOT Montgomery-encoded).
    One python-level pass through fixed-width byte serialization."""
    p = fs.p
    nb = fs.nl * 2  # bytes per element
    buf = b"".join((x if 0 <= x < p else x % p).to_bytes(nb, "little")
                   for x in xs)
    a = np.frombuffer(buf, dtype="<u2").reshape(len(xs), fs.nl)
    return np.ascontiguousarray(a.T).astype(np.uint32)


def unpack_ints(fs: FieldSpec, arr) -> list[int]:
    """(NL, *batch) digits -> flat list of python ints (row-major batch)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr).reshape(fs.nl, -1).astype(np.uint16).T  # (n, NL)
    data = np.ascontiguousarray(a).tobytes()  # little-endian u16 digits
    nb = fs.nl * 2
    return [int.from_bytes(data[i * nb:(i + 1) * nb], "little")
            for i in range(a.shape[0])]


def from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """A (NL, ...) digit array of any integer dtype -> int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)) \
        .to(resolve_device(device))


def encode(fs: FieldSpec, xs: Sequence[int], device=None) -> torch.Tensor:
    """Python ints -> limb tensor in Montgomery form."""
    return from_numpy(pack_ints(fs, [x % fs.p * fs.R % fs.p for x in xs]),
                      device)


def decode(fs: FieldSpec, arr) -> list[int]:
    """Montgomery limb tensor -> python ints."""
    return [x * fs.Rinv % fs.p for x in unpack_ints(fs, arr)]


def zeros(fs: FieldSpec, shape=(), device=None) -> torch.Tensor:
    return torch.zeros((fs.nl,) + tuple(shape), dtype=I32,
                       device=resolve_device(device))


def _const_limbs(fs: FieldSpec, limbs: np.ndarray, shape, device):
    base = from_numpy(limbs, device)
    return base.reshape((fs.nl,) + (1,) * len(shape)).expand(
        (fs.nl,) + tuple(shape))


def ones_mont(fs: FieldSpec, shape=(), device=None) -> torch.Tensor:
    """Montgomery 1 broadcast (as a stride-0 view) to (NL, *shape)."""
    return _const_limbs(fs, fs.one_mont_limbs, shape, device)


def const_mont(fs: FieldSpec, x: int, shape=(), device=None) -> torch.Tensor:
    """Broadcast constant x (plain int) as a Montgomery-form limb tensor."""
    return _const_limbs(fs, fs.to_limbs(x * fs.R % fs.p), shape, device)


# ---------------------------------------------------------------------------
# modular add / sub / neg / mul (device dispatch)
# ---------------------------------------------------------------------------

def add(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from . import hopper_field as HF
    return HF.add_hopper(fs, a, b)


def sub(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from . import hopper_field as HF
    return HF.sub_hopper(fs, a, b)


def neg(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(fs, zeros(fs, (1,) * (a.dim() - 1), a.device), a)


def double(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(fs, a, a)


def is_zero(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Boolean mask over batch dims: element == 0 (works in either form)."""
    return (a == 0).all(dim=0)


def eq(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(mask, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(mask, a, b) with mask over batch dims (no limb axis)."""
    return torch.where(mask[None, ...], a, b)


def mont_mul(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(aR)(bR)R^{-1} = abR mod p. Shapes broadcast over batch dims. On the
    card this is kernel 1 (`hopper_field.mont_mul_hopper`)."""
    from . import hopper_field as HF
    return HF.mont_mul_hopper(fs, a, b)


def mont_sqr(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(fs, a, a)


def to_mont(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    r2 = _const_limbs(fs, fs.r2_limbs, (1,) * (a.dim() - 1), a.device)
    return mont_mul(fs, a, r2)


def from_mont(fs: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    one = _const_limbs(fs, fs.to_limbs(1), (1,) * (a.dim() - 1), a.device)
    return mont_mul(fs, a, one)


# ---------------------------------------------------------------------------
# exponentiation / inversion
# ---------------------------------------------------------------------------

def mont_pow_const(fs: FieldSpec, x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e with host-known exponent: square-and-multiply, one kernel launch
    per step (about 1.5 * log2(e) launches)."""
    if e == 0:
        return ones_mont(fs, x.shape[1:], x.device).contiguous()
    acc = None
    for bit in bin(e)[2:]:
        if acc is not None:
            acc = mont_mul(fs, acc, acc)
        if bit == "1":
            acc = x if acc is None else mont_mul(fs, acc, x)
    return acc


def inv(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Fermat inverse: x^(p-2). 0 maps to 0."""
    return mont_pow_const(fs, x, fs.p - 2)


def batch_inverse(fs: FieldSpec, x: torch.Tensor, axis: int = -1):
    """Batched inversion of every element (Montgomery's trick). Zeros invert
    to zero. An element's inverse does not depend on how the lanes are
    grouped, so the two paths agree exactly:

    - a CUDA tensor is flattened behind the limb axis and goes through
      kernels 3, 4 and the tail (`hopper_msm.batch_inverse_chunked`);
    - a CPU tensor takes two prefix-product scans along `axis` and ONE
      inversion per line, of the line's total, by host integers (a Fermat
      chain of single-lane products costs a third of a second here)."""
    if axis < 0:
        axis = x.dim() + axis
    assert axis >= 1, "axis 0 is the limb axis"
    zmask = is_zero(fs, x)
    x = select(zmask, ones_mont(fs, x.shape[1:], x.device), x)
    if x.is_cuda:
        from . import hopper_msm as HM
        out = HM.batch_inverse_chunked(
            fs, x.reshape(fs.nl, -1).contiguous()).reshape(x.shape)
    else:
        n = x.shape[axis]
        pre = _prefix_products(fs, x, axis, reverse=False)  # inclusive prefix
        suf = _prefix_products(fs, x, axis, reverse=True)   # inclusive suffix
        total = pre.narrow(axis, n - 1, 1)
        total_inv = encode(fs, [pow(v, -1, fs.p) for v in decode(fs, total)],
                           x.device).reshape(total.shape)
        one = ones_mont(fs, x.shape[1:], x.device).narrow(axis, 0, 1)
        pre_ex = torch.cat([one, pre.narrow(axis, 0, n - 1)], dim=axis)
        suf_ex = torch.cat([suf.narrow(axis, 1, n - 1), one], dim=axis)
        out = mont_mul(fs, mont_mul(fs, pre_ex, suf_ex), total_inv)
    return select(zmask, zeros(fs, (1,) * (x.dim() - 1), x.device), out)


def prefix_product_exclusive(fs: FieldSpec, x: torch.Tensor,
                             axis: int = -1) -> torch.Tensor:
    """[1, x0, x0x1, ...] along `axis`: the grand-product ladder of the
    Placeholder arguments as a log-depth scan."""
    if axis < 0:
        axis = x.dim() + axis
    n = x.shape[axis]
    incl = _prefix_products(fs, x, axis, reverse=False)
    one = ones_mont(fs, x.shape[1:], x.device).narrow(axis, 0, 1)
    return torch.cat([one, incl.narrow(axis, 0, n - 1)], dim=axis)


def _prefix_products(fs: FieldSpec, x: torch.Tensor, axis: int,
                     reverse: bool) -> torch.Tensor:
    """Inclusive prefix (or suffix) products via Hillis-Steele doubling:
    log2(n) mont_muls of full batch size."""
    n = x.shape[axis]
    acc = x
    shift = 1
    ones = ones_mont(fs, x.shape[1:], x.device)
    while shift < n:
        pad = ones.narrow(axis, 0, shift)
        if reverse:
            shifted = torch.cat([acc.narrow(axis, shift, n - shift), pad],
                                dim=axis)
        else:
            shifted = torch.cat([pad, acc.narrow(axis, 0, n - shift)],
                                dim=axis)
        acc = mont_mul(fs, acc, shifted)
        shift *= 2
    return acc


def powers(fs: FieldSpec, base_int: int, n: int, device=None) -> torch.Tensor:
    """[1, w, w^2, ..., w^(n-1)] in Montgomery form, built on `device`
    (`powers_of`)."""
    return powers_of(fs, encode(fs, [base_int], device), n)


def powers_np(fs: FieldSpec, base_int: int, n: int) -> np.ndarray:
    """`powers` as a numpy array of digits, by a host multiply chain: for
    the short tables a kernel's launch code packs on the host."""
    w = base_int % fs.p
    vals = []
    acc = fs.R_mod_p  # mont(1)
    for _ in range(n):
        vals.append(acc)
        acc = acc * w % fs.p
    return pack_ints(fs, vals)


def powers_of(fs: FieldSpec, x: torch.Tensor, n: int) -> torch.Tensor:
    """[1, x, x^2, ..., x^(n-1)] for a base x of shape (NL, 1) in Montgomery
    form, on x's device, by doubling: the table of length 2m is the table of
    length m followed by x^m times it. log2(n) products, no host chain."""
    pw = ones_mont(fs, (1,), x.device).contiguous()
    step = x                                   # x^(len(pw))
    while pw.shape[1] < n:
        pw = torch.cat([pw, mont_mul(fs, pw, step)], dim=1)
        step = mont_mul(fs, step, step)
    return pw[:, :n]
