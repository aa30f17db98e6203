"""Distributed MSM: the points axis sharded over a mesh.

Counterpart of `parallel/msm.py` of the JAX package. The points are padded
to a power-of-two chunk per rank with zero scalars; each rank runs the
port's batched-affine MSM (`ops/msm_affine.py::MSMBases`: kernels 1, 3, 4
and the tail on the card) on its chunk and stops before the windows are
combined, keeping its per-window Jacobian totals. The totals (W x 3 x NL
digits, a few KB) are `all_gather`ed and reduced with log2(D) batched
Jacobian additions on the device, the same on every rank; the windows are
then combined on the host, so every rank returns the same affine point, the
one `ops/msm.py::msm` and `msm_host` give.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import curve as CRV
from ..ops import limbs as L
from ..ops import msm_affine as MA
from .context import axis_rank, axis_size


def _gather_axis(t: torch.Tensor, group, d: int) -> torch.Tensor:
    """(NL, W) on every rank -> (NL, D, W), rank s's tensor at [:, s]."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(d)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts, dim=1)


def _msm_on_mesh(curve, points_affine, scalars, mesh, axis, c, group,
                 device):
    d = axis_size(mesh, axis)
    if d & (d - 1):
        raise ValueError("mesh axis must be a power of two")
    me = axis_rank(mesh, axis)
    n = len(scalars)
    if n != len(points_affine) or n == 0:
        raise ValueError("need as many points as scalars, at least one")
    # pad to d * chunk, chunk a power of two (zero scalars have no digits)
    chunk = -(-n // d)
    chunk = 1 << (chunk - 1).bit_length() if chunk > 1 else 1
    points = list(points_affine) + [points_affine[0]] * (d * chunk - n)
    scalars = list(scalars) + [0] * (d * chunk - n)
    mine = slice(me * chunk, (me + 1) * chunk)
    bases = MA.MSMBases(curve, points[mine], group, window_bits=c,
                        device=device)
    totals = bases.window_totals(
        L.encode_canonical(curve.fr, scalars[mine], bases.device))
    if totals is None:                    # every scalar of the chunk is 0
        totals = CRV.inf_point(bases.ops, (bases.windows,))
    pg = mesh.get_group(axis)
    gathered = tuple(MA._tmap(lambda t: _gather_axis(t, pg, d), coord)
                     for coord in totals)
    reduced = MA._jac_reduce_axis(bases.ops, gathered, d, -2)   # (NL, W)
    return MA._combine_windows(curve, bases.ops, reduced, group, c)


def distributed_msm(curve, points_affine: list, scalars: list[int],
                    mesh=None, axis: str = "x", ranks: int | None = None,
                    c: int = 8, group: str = "g1", device=None):
    """sum_i scalars[i] * points_affine[i] (an affine point, None for the
    identity) with the points sharded over `mesh[axis]`; the whole input and
    the result on every rank. `device` is where each rank's share runs
    (default the card, the rank's current one).

    `mesh=None` builds a 1-D mesh over the first 2^k of the first `ranks`
    ranks of the world (default all of them), the counterpart of the JAX
    function's legacy `devices=`; ranks outside it receive the point from
    rank 0. Curves with a != 0 are refused (the device MSM's formulas)."""
    MA._check_bases(curve, c)         # every rank refuses before any collective
    device = L.resolve_device(device)
    if mesh is not None:
        return _msm_on_mesh(curve, points_affine, scalars, mesh, axis, c,
                            group, device)
    use = dist.get_world_size() if ranks is None else ranks
    d = 1 << (use.bit_length() - 1)
    sub = DeviceMesh(device.type, list(range(d)), mesh_dim_names=(axis,))
    out = [None]
    if sub.get_coordinate() is not None:
        out[0] = _msm_on_mesh(curve, points_affine, scalars, sub, axis, c,
                              group, device)
    dist.broadcast_object_list(out, src=0)
    return out[0]
