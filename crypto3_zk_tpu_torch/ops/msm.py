"""Multi-scalar multiplication entry point, fixed-base batch
exponentiation and the host MSM oracle.

Counterpart of `ops/msm.py` of the JAX package: `msm` (the reference's
windowed Pippenger with a segmented scan; here the batched-affine MSM of
`ops/msm_affine.py`, kernels 1, 3, 4 and the tail, with the same contract:
host affine points and host ints in, the one output point out),
`fixed_base_exp_batch` (the generators' query vectors, a KZG setup),
`_digits_host` and `msm_host`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import curve as CRV
from . import limbs as L
from .msm_affine import MSMBases, _tmap, window_digits_np


def _digits_host(fr, scalars: list[int], c: int, windows: int) -> np.ndarray:
    """(windows, n) uint32 unsigned c-bit digits of the scalars (reduced
    mod the scalar field), little-endian windows."""
    return window_digits_np(L.pack_ints(fr, scalars), c, windows) \
        .astype(np.uint32)


def msm(curve, points_affine, scalars: list[int], c: int = 16,
        group: str = "g1", device=None):
    """sum_i scalars[i] * points_affine[i] as a host affine point (None =
    infinity), on `device` (default: the card). `c` is the window width, in
    [2, 16]; the output point does not depend on it. Curves with a != 0 are
    refused before anything else. For repeated MSMs over the same points,
    build an `MSMBases` once."""
    if getattr(curve, "a", 0) != 0:
        raise ValueError(f"{curve.name}: the device MSM's point formulas "
                         f"hold for a = 0 curves only")
    n = len(scalars)
    assert n == len(points_affine) and n > 0
    return MSMBases(curve, points_affine, group, window_bits=c,
                    device=device).run(scalars)


def fixed_base_exp_batch(curve, base, scalars: list[int], c: int = 8,
                         group: str = "g1", device=None) -> list:
    """Windowed fixed-base batch exponentiation: [s_i * base for s_i], as
    host affine points (None where s_i = 0 mod r).

    Role of `algebra::get_window_table` + `batch_exp`
    (`generator.hpp (gg):163-229`): the per-window tables are built
    host-side once (windows * 2^c small group ops), then each output point
    is the sum of `windows` table entries, gathered by digit and combined
    with branch-free batched Jacobian adds on the device, one window per
    loop step."""
    from ..fields import curves as CV

    if getattr(curve, "a", 0) != 0:
        raise ValueError(f"{curve.name}: the device point formulas hold "
                         f"for a = 0 curves only")
    fr = curve.fr
    n = len(scalars)
    if n == 0:
        return []
    windows = -(-fr.bits // c)
    digits = _digits_host(fr, scalars, c, windows)

    if group == "g1":
        ops = CRV.FqOps(curve.fq, device)
        hadd = CV.g1_add
        zero_coord = 0
    else:
        ops = CRV.Fq2Ops(curve.fq, device)
        hadd = CV.g2_add
        zero_coord = (0, 0)

    # host window tables: T[w][d] = d * 2^(cw) * base
    tables = []
    base_w = base
    for w in range(windows):
        row = [None]
        cur = None
        for _ in range((1 << c) - 1):
            cur = hadd(curve, cur, base_w)
            row.append(cur)
        tables.append(row)
        for _ in range(c):
            base_w = hadd(curve, base_w, base_w)

    # one (NL, windows * 2^c) table per coordinate; entry d = 0 is infinity
    flat = [pt for row in tables for pt in row]
    xs = ops.encode([pt[0] if pt else zero_coord for pt in flat])
    ys = ops.encode([pt[1] if pt else zero_coord for pt in flat])
    dg = torch.from_numpy(digits.astype(np.int64)).to(ops.device)

    acc = CRV.inf_point(ops, (n,))
    one = ops.ones((n,))
    zero = ops.zeros((n,))
    for w in range(windows):
        dw = dg[w]
        idx = dw + (w << c)
        px = _tmap(lambda a: a.index_select(-1, idx), xs)
        py = _tmap(lambda a: a.index_select(-1, idx), ys)
        pz = ops.select(dw > 0, one, zero)
        acc = CRV.jac_add(ops, acc, (px, py, pz))
    return CRV.to_affine_host(ops, acc)


def msm_host(curve, points_affine, scalars, group: str = "g1"):
    """Host oracle (double-and-add), for tests and small MSMs."""
    from ..fields import curves as CV
    add = CV.g1_add if group == "g1" else CV.g2_add
    mul = CV.g1_mul if group == "g1" else CV.g2_mul
    acc = None
    for pt, s in zip(points_affine, scalars):
        acc = add(curve, acc, mul(curve, pt, s))
    return acc
