"""Vectors of affine curve points kept on a device, and the batched group
operations of the ceremony modules over them.

The ceremony modules (`commitments/powers_of_tau.py`, `models/groth16/
mpc.py`) hold 2^17 to 2^18 points per vector. The JAX package keeps them
as host lists of affine tuples; here a `PointVector` keeps the Montgomery
affine coordinates on a device with an infinity mask, and makes the host
list only when someone asks for it:

- `from_jacobian` normalizes the output of a batch of group operations with
  ONE batched inversion of the Z coordinates (`limbs.batch_inverse`:
  kernels 3, 4 and the tail on the card; G2's Z through its Fq norm);
- `host()` decodes the whole vector with one transfer into a list whose
  item assignment drops the device copy (the next device use re-encodes
  the list), so the reference's `acc.tau_powers_g1[2] = ...` works;
- `point(i)` decodes one point, `to_bytes()` serializes every point in the
  reference's fixed-width big-endian form (`proof_of_knowledge._ser_g1`)
  from the decoded digit arrays with numpy, one transfer.

`mul` multiplies Jacobian points by their scalars (or all by one): from
`DEVICE_MIN` points on by kernel 6 (`hopper_curve.scalar_mul_batch_hopper`,
its plain version on the CPU), below it by the host's `g1_mul` / `g2_mul`.
It is the one place that chooses by size. `segment_sum` adds up Jacobian
points that share a key, in halving passes over the key-sorted lanes.
`ifft` is the group iNTT of vectors side by side (the ceremony's Lagrange
basis, kimchi's Lagrange commitments).

Infinity is x = y = 0 with the mask set; as Jacobian (0, 0, 0).
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields import curves as CV
from . import curve as CRV
from . import hopper_curve as HC
from . import limbs as L
from .msm_affine import _ranks, _take, _tmap

# From this many points a batch of scalar multiplications runs on the
# device, by device type: the crossovers measured by
# `tools/scalar_mul_crossover.py` (PERF.md section 6). On the card kernel 6
# is faster at every size measured; on the CPU its plain version (its
# schedule in whole-tensor curve ops) is slower than the host's
# double-and-add at every size measured, so there the host multiplies.
DEVICE_MIN = {"cuda": 1, "cpu": float("inf")}


def cat_lanes(parts):
    return _tmap(lambda *a: torch.cat(a, dim=-1), *parts)


def encode_affine(ops, pts):
    """Host affine points (None = infinity) -> (x, y, inf) on ops' device."""
    zero = 0 if isinstance(ops, CRV.FqOps) else (0, 0)
    x = ops.encode([zero if pt is None else pt[0] for pt in pts])
    y = ops.encode([zero if pt is None else pt[1] for pt in pts])
    inf = torch.tensor([pt is None for pt in pts], dtype=torch.bool,
                       device=ops.device)
    return x, y, inf


def jacobian(ops, A):
    """(x, y, inf) -> Jacobian (x, y, Z), Z = 1 or 0."""
    x, y, inf = A
    shape = tuple(inf.shape)
    return (x, y, ops.select(inf, ops.zeros(shape), ops.ones(shape)))


def _inverse(ops, z):
    """Every element's inverse, zero to zero, one batched inversion."""
    if isinstance(ops, CRV.Fq2Ops):
        fs = ops.fs
        a, b = z
        ninv = L.batch_inverse(fs, L.add(fs, L.mont_mul(fs, a, a),
                                         L.mont_mul(fs, b, b)))
        return (L.mont_mul(fs, a, ninv), L.mont_mul(fs, L.neg(fs, b), ninv))
    return L.batch_inverse(ops.fs, z)


def normalize(ops, P):
    """Jacobian -> (x, y, inf): x = X/Z^2, y = Y/Z^3, and 0, 0 where Z = 0."""
    X, Y, Z = P
    zi = _inverse(ops, Z)
    zi2 = ops.sqr(zi)
    return (ops.mul(X, zi2), ops.mul(Y, ops.mul(zi2, zi)), ops.is_zero(Z))


def _canonical(ops, A):
    """(k, NL, n) canonical digits of the coordinates x (c0, c1), y (c0,
    c1) as numpy uint16; one transfer."""
    fs = ops.fs if isinstance(ops, CRV.FqOps) else ops.base.fs
    planes = [c for coord in A[:2]
              for c in (coord if isinstance(coord, tuple) else (coord,))]
    digits = torch.stack([L.from_mont(fs, c) for c in planes])
    return fs, digits.cpu().numpy().astype(np.uint16)


def decode_affine(ops, A) -> list:
    """(x, y, inf) -> host affine tuples, None at infinity."""
    fs, d = _canonical(ops, A)
    k, _, n = d.shape
    nb = 2 * fs.nl
    data = np.ascontiguousarray(d.transpose(2, 0, 1)).astype("<u2").tobytes()
    vals = [int.from_bytes(data[i * nb:(i + 1) * nb], "little")
            for i in range(n * k)]
    inf = A[2].cpu().numpy()
    if k == 2:
        return [None if inf[i] else (vals[2 * i], vals[2 * i + 1])
                for i in range(n)]
    return [None if inf[i] else ((vals[4 * i], vals[4 * i + 1]),
                                 (vals[4 * i + 2], vals[4 * i + 3]))
            for i in range(n)]


def affine_bytes(ops, A) -> bytes:
    """Every point's coordinates as fixed-width big-endian integers of
    (bits(q) + 7) // 8 bytes, x then y (each c0 then c1); infinity as
    zeros: the reference's `_ser_g1` and its G2 form, point after point."""
    fs, d = _canonical(ops, A)
    nb = (fs.bits + 7) // 8
    # (k, NL, n) little-endian digits -> (n, k, 2 NL) big-endian bytes
    be = np.ascontiguousarray(d[:, ::-1, :].transpose(2, 0, 1)).astype(">u2")
    raw = be.view(np.uint8).reshape(d.shape[2], d.shape[0], 2 * fs.nl)
    return np.ascontiguousarray(raw[:, :, 2 * fs.nl - nb:]).tobytes()


def host_bytes(curve, group: str, pts) -> bytes:
    """`affine_bytes` of host points, by Python ints."""
    nb = (curve.fq.bits + 7) // 8
    if group == "g1":
        return b"".join(b"\x00" * (2 * nb) if pt is None else
                        pt[0].to_bytes(nb, "big") + pt[1].to_bytes(nb, "big")
                        for pt in pts)
    return b"".join(b"\x00" * (4 * nb) if pt is None else
                    b"".join(v.to_bytes(nb, "big") for v in (*pt[0], *pt[1]))
                    for pt in pts)


class _HostList(list):
    """A vector's host view: assigning an item drops the device copy."""

    def __init__(self, items, owner):
        super().__init__(items)
        self._owner = owner

    def __setitem__(self, i, v):
        super().__setitem__(i, v)
        self._owner._dev = None


class PointVector:
    """n affine points of G1 or G2 of `curve`: a host list, a device copy
    (x, y, inf), or both, kept equal."""

    def __init__(self, curve, group: str, host=None, dev=None):
        self.curve = curve
        self.group = group
        self._dev = dev
        self._host = None if host is None else _HostList(host, self)

    @classmethod
    def from_jacobian(cls, curve, group, P):
        device = (P[2] if group == "g1" else P[2][0]).device
        return cls(curve, group, dev=normalize(
            HC.group_ops(curve, group, device), P))

    def __len__(self):
        return len(self._host) if self._dev is None \
            else int(self._dev[2].shape[0])

    def dev(self, device):
        """(x, y, inf) on `device`: the device copy, moved there or
        encoded from the host list if it lies elsewhere or is stale."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self._dev is not None and self._dev[2].device != device:
            self._dev = _tmap(lambda a: a.to(device), self._dev)
        if self._dev is None:
            self._dev = encode_affine(HC.group_ops(self.curve, self.group,
                                                device), self._host)
        return self._dev

    def jacobian(self, device):
        return jacobian(HC.group_ops(self.curve, self.group, device),
                        self.dev(device))

    def _ops(self):
        return HC.group_ops(self.curve, self.group, self._dev[2].device)

    def host(self) -> list:
        if self._host is None:
            self._host = _HostList(decode_affine(self._ops(), self._dev),
                                   self)
        return self._host

    def point(self, i: int):
        if self._host is not None:
            return self._host[i]
        i = i % len(self)
        return decode_affine(self._ops(), _tmap(lambda a: a[..., i:i + 1],
                                                self._dev))[0]

    def slice(self, lo: int, hi: int) -> "PointVector":
        if self._dev is None:
            return PointVector(self.curve, self.group, host=self._host[lo:hi])
        return PointVector(self.curve, self.group,
                           dev=_tmap(lambda a: a[..., lo:hi], self._dev))

    def copy(self) -> "PointVector":
        """A vector that shares the (never modified) device tensors and
        owns a copy of the host list."""
        return PointVector(self.curve, self.group, host=self._host,
                           dev=self._dev)

    def to_bytes(self) -> bytes:
        if self._dev is None:
            return host_bytes(self.curve, self.group, self._host)
        return affine_bytes(self._ops(), self._dev)


def scalar_digits(fr, scalars: list[int], device) -> torch.Tensor:
    """Canonical (16, n) digits of the scalars, reduced mod r."""
    return L.encode_canonical(fr, scalars, device)


def lanes(P, group: str) -> int:
    return int((P[2] if group == "g1" else P[2][0]).shape[-1])


def mul(curve, group: str, P, k: torch.Tensor):
    """[k_i] P_i, or [k] P_i for one scalar, for Jacobian points P (the
    layout of `ops/curve.py`) and canonical scalar digits k, (16, n) or
    (16, 1), on one device; Jacobian out. From `DEVICE_MIN` points on,
    kernel 6; below, the points are normalized and decoded, multiplied by
    the host's double-and-add and encoded again."""
    n = lanes(P, group)
    if n >= DEVICE_MIN[k.device.type]:
        return HC.scalar_mul_batch_hopper(curve, P, k, group)
    ops = HC.group_ops(curve, group, k.device)
    m = CV.g1_mul if group == "g1" else CV.g2_mul
    ks = L.unpack_ints(curve.fr, k)
    ks = ks * n if len(ks) == 1 else ks
    pts = decode_affine(ops, normalize(ops, P))
    return jacobian(ops, encode_affine(ops, [
        m(curve, pt, ki) for pt, ki in zip(pts, ks)]))


def mul_vector(vec: PointVector, scalars: list[int], device) -> PointVector:
    """`mul` of a vector's points by host scalars (one, or one a point)."""
    return PointVector.from_jacobian(vec.curve, vec.group, mul(
        vec.curve, vec.group, vec.jacobian(device),
        scalar_digits(vec.curve.fr, scalars, device)))


def segment_sum(ops, P, keys: torch.Tensor, n_out: int):
    """sum of the Jacobian points P whose key is j, for j < n_out, Jacobian
    (infinity where no point has key j). The lanes are sorted by key, then
    each halving pass adds every lane of even rank in its key's run to its
    right neighbour of the same key and keeps the even ranks."""
    keys, order = torch.sort(keys, stable=True)
    P = _take(P, order)
    while keys.numel():
        rank = _ranks(keys)
        nxt = torch.roll(keys, -1)
        nxt[-1] = -1
        pair = (rank % 2 == 0) & (nxt == keys)
        if not bool(pair.any()):
            break
        summed = CRV.jac_add(ops, P, _tmap(lambda a: torch.roll(a, -1, -1),
                                           P))
        P = CRV.point_select(ops, pair, summed, P)
        keep = torch.nonzero(rank % 2 == 0).squeeze(1)
        P, keys = _take(P, keep), keys.index_select(0, keep)
    out = CRV.inf_point(ops, (n_out,))
    out = _tmap(lambda a: a.expand(a.shape[0], n_out).contiguous(), out)

    def put(dst, src):
        return dst.index_copy(-1, keys, src)

    return _tmap(put, out, P)


def ifft(curve, group: str, vectors, m: int, omega_inv: int, device):
    """The inverse transform of each vector's first m points over the
    domain of order m whose generator's inverse is `omega_inv`, all side
    by side on `device`: out_j = (1/m) sum_i omega^(-ij) P_i. From [tau^i] G
    it gives [L_j(tau)] G (the ceremony's Lagrange basis), from an SRS's g
    the commitments to the Lagrange polynomials (kimchi's). Bit reversal,
    log2 m radix-2 stages, each one kernel-6 batch of its odd lanes by
    their twiddles and one `jac_add`, and a scaling by 1/m (kernel 6).
    Returns one `PointVector` per vector."""
    ops = HC.group_ops(curve, group, device)
    fr = curve.fr
    nv = len(vectors)
    P = jacobian(ops, cat_lanes([v.slice(0, m).dev(device)
                                 for v in vectors]))
    log_m = m.bit_length() - 1
    lanes = torch.arange(nv * m, device=device)
    vec, j = lanes // m, lanes % m
    rev = torch.zeros_like(j)
    for b in range(log_m):
        rev |= ((j >> b) & 1) << (log_m - 1 - b)
    P = _take(P, vec * m + rev)
    tw = [1] * max(1, m // 2)
    for i in range(1, len(tw)):
        tw[i] = tw[i - 1] * omega_inv % fr.p
    twiddles = scalar_digits(fr, tw, device)
    h = 1
    while h < m:
        half = torch.arange(nv * m // 2, device=device)
        v_, r = half // (m // 2), half % (m // 2)
        t = r % h
        lo = v_ * m + (r // h) * 2 * h + t
        hi = lo + h
        odd = _take(P, hi)
        if h > 1:
            k = twiddles.index_select(1, t * (m // (2 * h)))
            odd = mul(curve, group, odd, k)
        even = _take(P, lo)
        sums = CRV.jac_add(ops, cat_lanes([even, even]),
                           cat_lanes([odd, CRV.jac_neg(ops, odd)]))
        place = torch.argsort(torch.cat([lo, hi]))
        P = _take(sums, place)
        h *= 2
    P = mul(curve, group, P, scalar_digits(fr, [pow(m, -1, fr.p)], device))
    out = PointVector.from_jacobian(curve, group, P)
    return [out.slice(i * m, (i + 1) * m) for i in range(nv)]
