"""CUDA kernels for the batched inversion inside the MSM's halving passes.

Counterpart of `ops/pallas_msm.py` of the JAX package.

- Kernel 3, `inv_scans_hopper(fs, x)`: per chunk of K elements, the
  exclusive prefix products f, the exclusive suffix products g and the chunk
  total. Replaces `inv_scans_pallas` / `_inv_scan_kernel`. Source:
  `csrc/inv_scans.cu`. One thread walks one chunk with the running product
  in registers: x is read and f and g are written once each (12*NL bytes
  per element for two Montgomery products), so by the published peaks the
  bytes are the bound. The walk is serial in K, so it needs many chunks to
  fill the card.
- Kernel 4, `mul3_bcast_hopper(fs, a, b, c)`: a*b*c with c broadcast over
  the scan axis. Replaces `mul3_bcast_pallas` / `_mul3_kernel`. Source:
  `csrc/mul3.cu`. One thread per element, two products, 12*NL bytes moved:
  bound by the bytes.

Layout, stated here and not taken from the reference: the scan axis K comes
BEFORE the chunk axis C. x, f, g, a, b and the output are (NL, K, C); tot and
c are (NL, C). Element k of chunk c lies at k*C + c, so the C axis is the
fastest-varying one in every load and store. A flat (NL, K*C) lane array is
such a tensor by a plain reshape: chunk c holds the lanes c, c+C, c+2C, ...

Each wrapper runs its plain version only for a CPU tensor; on a CUDA tensor
it launches or raises. `LAUNCHES` counts launches.
"""
from __future__ import annotations

import torch

from .. import kernels as K_
from ..fields.params import FieldSpec
from . import limbs as L
from .hopper_field import mont_mul_plain

LAUNCHES = {"inv_scans": 0, "mul3": 0}


def _check(fs: FieldSpec, name: str, *tensors):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: every operand must be a CUDA tensor")
        if t.dtype != torch.int32 or t.shape[0] != fs.nl:
            raise TypeError(f"{name}: operands are (NL, ...) int32 digits")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def inv_scans_plain(fs: FieldSpec, x: torch.Tensor):
    """Sequential walks along K in plain PyTorch, K multiplies each way."""
    nl, k, c = x.shape
    f = torch.empty_like(x)
    g = torch.empty_like(x)
    acc = L.ones_mont(fs, (c,), x.device).contiguous()
    for i in range(k):
        f[:, i] = acc
        acc = mont_mul_plain(fs, acc, x[:, i])
    tot = acc
    acc = L.ones_mont(fs, (c,), x.device).contiguous()
    for i in range(k - 1, -1, -1):
        g[:, i] = acc
        acc = mont_mul_plain(fs, acc, x[:, i])
    return f, g, tot


def inv_scans_hopper(fs: FieldSpec, x: torch.Tensor):
    """Kernel 3. x: (NL, K, C) nonzero Montgomery values. Returns
    (f, g, tot): f[:, k] = prod x[:, :k], g[:, k] = prod x[:, k+1:], both
    (NL, K, C), and tot = prod x[:, :] of shape (NL, C)."""
    if not x.is_cuda:
        return inv_scans_plain(fs, x)
    _check(fs, "inv_scans", x)
    nl, k, c = x.shape
    nw, consts = K_.field_consts(fs)
    f = torch.empty_like(x)
    g = torch.empty_like(x)
    tot = torch.empty((nl, c), dtype=torch.int32, device=x.device)
    code = K_.entry("zk_inv_scans")(nw, consts, x.data_ptr(), f.data_ptr(),
                                    g.data_ptr(), tot.data_ptr(), k, c,
                                    K_.stream_ptr())
    K_.check(code, "zk_inv_scans")
    LAUNCHES["inv_scans"] += 1
    return f, g, tot


def mul3_bcast_plain(fs: FieldSpec, a, b, c):
    return mont_mul_plain(fs, mont_mul_plain(fs, a, b), c[:, None, :])


def mul3_bcast_hopper(fs: FieldSpec, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """Kernel 4. a, b: (NL, K, C); c: (NL, C). Returns a*b*c, (NL, K, C)."""
    if not a.is_cuda:
        return mul3_bcast_plain(fs, a, b, c)
    _check(fs, "mul3_bcast", a, b, c)
    nl, k, cc = a.shape
    if b.shape != a.shape or c.shape != (nl, cc):
        raise ValueError("mul3_bcast: a, b are (NL, K, C) and c is (NL, C)")
    nw, consts = K_.field_consts(fs)
    out = torch.empty_like(a)
    code = K_.entry("zk_mul3")(nw, consts, a.data_ptr(), b.data_ptr(),
                               c.data_ptr(), out.data_ptr(), k, cc,
                               K_.stream_ptr())
    K_.check(code, "zk_mul3")
    LAUNCHES["mul3"] += 1
    return out
