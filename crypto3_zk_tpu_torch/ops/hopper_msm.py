"""CUDA kernels for the batched inversion inside the MSM's halving passes.

Counterpart of `ops/pallas_msm.py` of the JAX package.

- Kernel 3, `inv_scans_hopper(fs, x)`: per chunk of K elements, the
  exclusive prefix products f, the exclusive suffix products g and the chunk
  total. Replaces `inv_scans_pallas` / `_inv_scan_kernel`. Source:
  `csrc/inv_scans.cu`. x is read and f and g are written once each (12*NL
  bytes per element); the products take about as long as those sweeps, so
  several threads share a chunk (each multiplies up its own run of
  elements, the runs' totals are exchanged, then a forward and a backward
  walk: three products per element) and x is parked in shared memory as
  words between the passes.
- Its tail, `batch_inverse_small_hopper(fs, x)`: every element's inverse
  for at most `INV_TAIL_MAX` elements in ONE launch of one block (product
  tree up, one Fermat power of the root inside the kernel, inverses pushed
  back down). Same source, entry `zk_inv_tail`. It ends the recursion of the
  batched inversion, where the scans would run on a handful of lanes and
  the Fermat power would be some 380 launches of kernel 1. Bound by
  latency: about 330 products follow one another in one thread.
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
it launches or raises. `LAUNCHES` counts launches and `ELEMENTS` adds up the
field elements they were launched on, so a run can tell wide launches from
narrow ones.
"""
from __future__ import annotations

import torch

from .. import kernels as K_
from ..fields.params import FieldSpec
from . import limbs as L
from .hopper_field import mont_mul_plain

LAUNCHES = {"inv_scans": 0, "mul3": 0, "inv_tail": 0}
ELEMENTS = {"inv_scans": 0, "mul3": 0, "inv_tail": 0}

INV_TAIL_MAX = 1024         # elements one launch of the tail takes
INV_CHUNK = 64              # chunk width of the batched inversion
_SCAN_TILE = 32             # chunks a block of kernel 3 takes
_SCAN_MAX_SHARE = 8         # threads that share one chunk, at most
_SCAN_MIN_RUN = 8           # elements a thread owns, at least
_SCAN_SMEM_MAX = 200 * 1024


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


def scan_geometry(nl: int, k: int, c: int):
    """How kernel 3 is launched on (NL, K, C): (threads that share a chunk,
    blocks, bytes of dynamic shared memory). A chunk is shared by the largest
    power of two of threads, at most 8, that leaves each a run of at least 8
    elements; a block takes 32 neighbouring chunks and parks their K
    elements, plus one total per thread, as words. A K whose tile does not
    fit in shared memory is refused."""
    if k < 1 or c < 1:
        raise ValueError(f"inv_scans: empty input (K = {k}, C = {c})")
    share = 1
    while share < _SCAN_MAX_SHARE and k >= 2 * share * _SCAN_MIN_RUN:
        share *= 2
    smem = K_.words(nl) * (k + share) * _SCAN_TILE * 4
    if smem > _SCAN_SMEM_MAX:
        raise ValueError(f"inv_scans: a tile of {_SCAN_TILE} chunks of K = "
                         f"{k} elements ({smem} bytes) does not fit in "
                         f"shared memory")
    return share, -(-c // _SCAN_TILE), smem


def inv_scans_hopper(fs: FieldSpec, x: torch.Tensor):
    """Kernel 3. x: (NL, K, C) nonzero Montgomery values. Returns
    (f, g, tot): f[:, k] = prod x[:, :k], g[:, k] = prod x[:, k+1:], both
    (NL, K, C), and tot = prod x[:, :] of shape (NL, C)."""
    if not x.is_cuda:
        return inv_scans_plain(fs, x)
    _check(fs, "inv_scans", x)
    nl, k, c = x.shape
    share, _, _ = scan_geometry(nl, k, c)
    nw, consts = K_.field_consts(fs)
    f = torch.empty_like(x)
    g = torch.empty_like(x)
    tot = torch.empty((nl, c), dtype=torch.int32, device=x.device)
    code = K_.entry("zk_inv_scans")(nw, consts, x.data_ptr(), f.data_ptr(),
                                    g.data_ptr(), tot.data_ptr(), k, c,
                                    share, K_.stream_ptr())
    K_.check(code, "zk_inv_scans")
    LAUNCHES["inv_scans"] += 1
    ELEMENTS["inv_scans"] += k * c
    return f, g, tot


def _fermat_plain(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) by square and multiply, plain products only."""
    acc = None
    for bit in bin(fs.p - 2)[2:]:
        if acc is not None:
            acc = mont_mul_plain(fs, acc, acc)
        if bit == "1":
            acc = x if acc is None else mont_mul_plain(fs, acc, x)
    return acc


def batch_inverse_small_plain(fs: FieldSpec, x: torch.Tensor):
    """Montgomery's trick as a product tree in plain PyTorch: pairwise
    products up to one root, one Fermat power, and on the way down every
    node's inverse is its parent's inverse times its sibling."""
    nl, size = x.shape
    one = L.ones_mont(fs, (1,), x.device)
    levels = [x]
    while levels[-1].shape[1] > 1:
        v = levels[-1]
        if v.shape[1] % 2:
            v = levels[-1] = torch.cat([v, one], dim=1)
        levels.append(mont_mul_plain(fs, v[:, 0::2], v[:, 1::2]))
    inv = _fermat_plain(fs, levels[-1])
    for v in reversed(levels[:-1]):
        parent = inv[:, :v.shape[1] // 2].repeat_interleave(2, dim=1)
        sibling = v.reshape(nl, -1, 2).flip(2).reshape(nl, -1)
        inv = mont_mul_plain(fs, parent, sibling)
    return inv[:, :size].contiguous()


def tail_products_in_sequence(fs: FieldSpec, size: int) -> int:
    """Montgomery products that follow one another in one launch of the
    tail on `size` elements: one per tree level on the way up and on the way
    down (a node's two products do not wait for each other), and the ladder:
    15 for the table x^1..x^15, then four squarings per 4-bit window of p-2
    below the top one and a multiply where the window is not zero."""
    levels = (size - 1).bit_length()
    digits = [int(d, 16) for d in f"{fs.p - 2:x}"]
    return 2 * levels + 15 + sum(4 + (d != 0) for d in digits[1:])


def batch_inverse_small_hopper(fs: FieldSpec, x: torch.Tensor):
    """The tail of kernel 3. x: (NL, S) nonzero Montgomery values,
    1 <= S <= INV_TAIL_MAX. Returns every element's inverse, (NL, S)."""
    size = x.shape[1] if x.dim() == 2 else 0
    if not 1 <= size <= INV_TAIL_MAX:
        raise ValueError(f"batch_inverse_small: x must be (NL, S) with "
                         f"1 <= S <= {INV_TAIL_MAX}, not {tuple(x.shape)}")
    if not x.is_cuda:
        return batch_inverse_small_plain(fs, x)
    _check(fs, "batch_inverse_small", x)
    nw, consts = K_.field_consts(fs)
    out = torch.empty_like(x)
    code = K_.entry("zk_inv_tail")(nw, consts, x.data_ptr(), out.data_ptr(),
                                   size, K_.stream_ptr())
    K_.check(code, "zk_inv_tail")
    LAUNCHES["inv_tail"] += 1
    ELEMENTS["inv_tail"] += size
    return out


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
    ELEMENTS["mul3"] += k * cc
    return out


def batch_inverse_chunked(fs: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inverse of every element of x (NL, S), all nonzero. The lanes split
    into C chunks of K = 64 (chunk c holds lanes c, c+C, ...): kernel 3
    gives each element the product f of its chunk's elements before it, the
    product g of those after it and the chunk total; the totals are inverted
    by the same procedure, and kernel 4 forms f * g * total^-1. The
    recursion ends at `INV_TAIL_MAX` values or fewer, which the tail kernel
    inverts in one launch: 2 + 2 + 1 launches for up to 2^22 lanes. One
    zero element would zero its whole chunk's products: callers that may
    hold zeros mask them first (`limbs.batch_inverse` does)."""
    nl, size = x.shape
    if size == 0:
        return x
    if size <= INV_TAIL_MAX:
        return batch_inverse_small_hopper(fs, x.contiguous())
    k = INV_CHUNK
    c = -(-size // k)
    if c * k != size:
        x = torch.cat([x, L.ones_mont(fs, (c * k - size,), x.device)], dim=1)
    f, g, tot = inv_scans_hopper(fs, x.contiguous().reshape(nl, k, c))
    term = batch_inverse_chunked(fs, tot)
    inv = mul3_bcast_hopper(fs, f, g, term.contiguous())
    inv = inv.reshape(nl, k * c)
    return inv if c * k == size else inv[:, :size].contiguous()
