"""CUDA kernel 6: batched variable-base scalar multiplication.

- Kernel 6, `scalar_mul_batch_hopper(curve, P, k, group)`: [k_i] P_i for N
  Jacobian points, each by its own scalar or all by one. Source:
  `csrc/scalar_mul.cuh`, launched from `csrc/scalar_mul.cu` (G1, entry
  `zk_scalar_mul_g1`) and `csrc/scalar_mul_g2.cu` (G2). It has no Pallas
  counterpart: the JAX package makes these products with host `g1_mul` /
  `g2_mul` loops (`commitments/powers_of_tau.py`: the accumulator's
  transform and the group iNTT; `models/groth16/mpc.py`: the keypair from
  a ceremony and the phase-2 contributions). One thread runs one point's
  whole multiplication, so a batch is one launch where the elementwise ops
  of `ops/curve.py` would take thousands. Schedule: signed fixed windows of
  `WINDOW` bits (`signed_digits`) over a table of [1]P .. [2^(w-1)]P in
  shared memory; bound by the operations: per G1 point about bits(r)
  doublings of 7 products and bits(r) / w additions of 16.

Points are in the layout of `ops/curve.py`: a G1 point is (X, Y, Z) of
(NL, N) Montgomery digit tensors, a G2 point the same with each coordinate
a (c0, c1) pair; Z = 0 marks infinity. Scalars are canonical (not
Montgomery) values below 2^bits(r) as (16, N) 16-bit digits, or (16, 1)
for one scalar broadcast to every point. Only a = 0 curves whose Fq has a
kernel instance of 8 or 12 words (alt_bn128, bls12-381) are taken; G2 is
over Fq2 with u^2 = -1. Any other curve is refused before anything else.

The wrapper runs its plain version only for a tensor that lies on the CPU;
on a CUDA tensor it launches the kernel or raises. The plain version runs
the kernel's schedule over whole tensors with `ops/curve.py`'s
`jac_double`, `jac_add` and `jac_neg`, which select where the kernel
branches; both give the same Jacobian digits. `LAUNCHES` counts launches
and `ELEMENTS` the points they ran on: measurement state only, nothing in
the port reads them.
"""
from __future__ import annotations

import torch

from .. import kernels as K
from . import curve as CRV

LAUNCHES = {"scalar_mul": 0}
ELEMENTS = {"scalar_mul": 0}

SCALAR_DIGITS = 16          # 256-bit scalars as 16-bit digits
# window bits by group, as `ScalarMulShape` in `csrc/scalar_mul.cuh` has
# them (the C entries `zk_scalar_mul_g1_shape` / `_g2_shape` report what
# was compiled)
WINDOW = {"g1": 4, "g2": 3}


def check_curve(curve) -> None:
    """Refuse a curve kernel 6 does not cover: a != 0, or an Fq without an
    8- or 12-word kernel instance."""
    if getattr(curve, "a", 0) != 0:
        raise ValueError(f"{curve.name}: the scalar-multiplication formulas "
                         f"hold for a = 0 curves only")
    if curve.fq.nl not in (16, 24):
        raise ValueError(f"{curve.name}: kernel 6 has instances for 8- and "
                         f"12-word base fields only")


def group_ops(curve, group: str, device):
    return CRV.FqOps(curve.fq, device) if group == "g1" \
        else CRV.Fq2Ops(curve.fq, device)


def _flat(P, group: str) -> list:
    return list(P) if group == "g1" else [c for pair in P for c in pair]


def _point(coords, group: str):
    """The inverse of `_flat`."""
    if group == "g1":
        return tuple(coords)
    return tuple(tuple(coords[i:i + 2]) for i in (0, 2, 4))


def _check_scalars(k: torch.Tensor, n: int) -> None:
    if k.dim() != 2 or k.shape[0] != SCALAR_DIGITS \
            or k.shape[1] not in (1, n):
        raise ValueError(f"scalar_mul: scalars are ({SCALAR_DIGITS}, N) or "
                         f"({SCALAR_DIGITS}, 1) digits, not {tuple(k.shape)}"
                         f" for N = {n}")


def signed_digits(k: torch.Tensor, nbits: int, w: int) -> torch.Tensor:
    """(16, Ns) scalar digits -> (nbits // w + 1, Ns) int64 digits d_i in
    [-2^(w-1), 2^(w-1)] with k = sum d_i 2^(w i), bits of k from `nbits`
    up read as 0. Digit i is Booth's recoding of bits w i - 1 .. w i + w - 1
    (bit -1 is 0): with v those w + 1 bits, d = ceil(v / 2) - 2^w * (top
    bit of v). The top digit reads the bit below it and so takes the carry
    out of the window under it; it is never negative."""
    k64 = k.to(torch.int64)
    pos = torch.arange(SCALAR_DIGITS * 16, device=k.device)
    bits = (k64[pos >> 4] >> (pos & 15)[:, None]) & 1
    bits[nbits:] = 0
    ns = k.shape[1]
    nwin = nbits // w + 1
    # ext[j] is bit j - 1
    ext = torch.cat([bits.new_zeros((1, ns)), bits,
                     bits.new_zeros((w + 1, ns))])
    idx = w * torch.arange(nwin, device=k.device)[:, None] \
        + torch.arange(w + 1, device=k.device)[None, :]
    v = (ext[idx] << torch.arange(w + 1, device=k.device)[None, :, None]) \
        .sum(dim=1)
    return ((v + 1) >> 1) - ((v >> w) << w)


def scalar_mul_batch_plain(curve, P, k: torch.Tensor, group: str = "g1"):
    """Kernel 6's schedule over whole tensors: the table T[1] = P, T[j] =
    `jac_add(P, T[j-1])` up to j = 2^(w-1); acc = sign(d) T[|d|] of the top
    digit (infinity for 0); then for each lower digit, top first, w
    doublings and acc = `jac_add(sign(d) T[|d|], acc)` where d != 0."""
    check_curve(curve)
    ops = group_ops(curve, group, k.device)
    n = _flat(P, group)[0].shape[1]
    _check_scalars(k, n)
    w = WINDOW[group]
    digits = signed_digits(k, curve.fr.bits, w).expand(-1, n)
    table = [P]
    for _ in range((1 << (w - 1)) - 1):
        table.append(CRV.jac_add(ops, P, table[-1]))
    stacked = [torch.stack(c) for c in zip(*(_flat(t, group)
                                             for t in table))]

    def entry(d):
        idx = (d.abs() - 1).clamp(min=0)
        pt = _point([c.gather(0, idx.expand(c.shape[1], n)[None])[0]
                     for c in stacked], group)
        return CRV.point_select(ops, d < 0, CRV.jac_neg(ops, pt), pt)

    acc = CRV.point_select(ops, digits[-1] != 0, entry(digits[-1]),
                           CRV.inf_point(ops, (n,)))
    for i in reversed(range(digits.shape[0] - 1)):
        for _ in range(w):
            acc = CRV.jac_double(ops, acc)
        nz = digits[i] != 0
        if bool(nz.any()):
            acc = CRV.point_select(
                ops, nz, CRV.jac_add(ops, entry(digits[i]), acc), acc)
    return _point([c.contiguous() for c in _flat(acc, group)], group)


def entry_name(group: str) -> str:
    """The C entry of kernel 6 for a group (`csrc/scalar_mul.cu` for G1,
    `csrc/scalar_mul_g2.cu` for G2)."""
    return "zk_scalar_mul_g1" if group == "g1" else "zk_scalar_mul_g2"


def run_entry(fn, curve, P, k: torch.Tensor, group: str, stream):
    """Call the group's C entry `fn` (`entry_name`, of the card's library
    or of its host build, `tools/host_kernels.py`) on the points stacked as
    one (C, NL, N) tensor; returns the output in the layout of P."""
    fs = curve.fq
    coords = _flat(P, group)
    n = coords[0].shape[1]
    _check_scalars(k, n)
    if any(t.shape != (fs.nl, n) or t.dtype != torch.int32 for t in coords) \
            or k.dtype != torch.int32:
        raise ValueError(f"scalar_mul: coordinates are ({fs.nl}, {n}) "
                         f"int32 digits")
    pts = torch.stack(coords)
    k = k.contiguous()
    out = torch.empty_like(pts)
    nw, consts = K.field_consts(fs)
    K.check(fn(nw, consts, pts.data_ptr(), k.data_ptr(), k.shape[1],
               out.data_ptr(), n, curve.fr.bits, stream), entry_name(group))
    return _point(list(out), group)


def scalar_mul_batch_hopper(curve, P, k: torch.Tensor, group: str = "g1"):
    """Kernel 6. P: N Jacobian points (G1 or G2, `ops/curve.py` layout);
    k: (16, N) or (16, 1) canonical scalar digits on the same device.
    Returns [k_i] P_i, Jacobian, in the same layout."""
    check_curve(curve)
    coords = _flat(P, group)
    if not coords[0].is_cuda:
        return scalar_mul_batch_plain(curve, P, k, group)
    if not all(t.is_cuda for t in coords + [k]):
        raise ValueError("scalar_mul: every operand must be a CUDA tensor")
    out = run_entry(K.entry(entry_name(group)), curve, P, k, group,
                    K.stream_ptr())
    LAUNCHES["scalar_mul"] += 1
    ELEMENTS["scalar_mul"] += coords[0].shape[1]
    return out
