"""Shared batching bookkeeping for Placeholder-friendly commitment schemes.

`polys_evaluator` (`batched_commitment.hpp:58-244`): per-batch polynomial
lists, per-poly eval point sets, the z evaluation table, and the helpers
(get_V / get_U / unique points). Subclassed by LPC (`lpc.py`) and KZG
(`kzg.py`).
"""
from __future__ import annotations

from ..fields.params import FieldSpec
from ..poly.polynomial import PolyDFS


class EvalStorage:
    """z[batch][poly][point] (`eval_storage.hpp:36-95`)."""

    def __init__(self):
        self.z: dict[int, list[list[int]]] = {}

    def set_batch(self, k: int, vals: list[list[int]]):
        self.z[k] = vals

    def get(self, k: int, i: int, j: int) -> int:
        return self.z[k][i][j]

    def batches(self):
        return sorted(self.z.keys())

    def batch_size(self, k: int) -> int:
        return len(self.z[k])


def lagrange_interpolate(p: int, points: list[int], values: list[int]) -> list[int]:
    """Coefficients of the unique poly through (points[i], values[i])
    (`math::lagrange_interpolation`)."""
    n = len(points)
    assert n == len(values)
    coeffs = [0] * max(n, 1)
    for i in range(n):
        # basis poly: prod_{j!=i} (x - x_j) / (x_i - x_j)
        basis = [1]
        denom = 1
        for j in range(n):
            if j == i:
                continue
            # basis *= (x - x_j)
            new = [0] * (len(basis) + 1)
            for k, c in enumerate(basis):
                new[k] = (new[k] - c * points[j]) % p
                new[k + 1] = (new[k + 1] + c) % p
            basis = new
            denom = denom * (points[i] - points[j]) % p
        scale = values[i] * pow(denom, -1, p) % p
        for k, c in enumerate(basis):
            coeffs[k] = (coeffs[k] + c * scale) % p
    return coeffs


def poly_from_roots(p: int, roots: list[int]) -> list[int]:
    """V(x) = prod (x - r) coefficients (`get_V`)."""
    coeffs = [1]
    for r in roots:
        new = [0] * (len(coeffs) + 1)
        for k, c in enumerate(coeffs):
            new[k] = (new[k] - c * r) % p
            new[k + 1] = (new[k + 1] + c) % p
        coeffs = new
    return coeffs


def eval_coeffs(p: int, coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


class PolysEvaluator:
    """Batch state + helpers shared by stateful schemes."""

    def __init__(self, fs: FieldSpec):
        self.fs = fs
        self._polys: dict[int, list[PolyDFS]] = {}
        self._points: dict[int, list[list[int]]] = {}
        self._locked: dict[int, bool] = {}
        self._z = EvalStorage()

    # --- batch construction ---
    def append_to_batch(self, index: int, polys):
        self._locked.setdefault(index, False)
        assert not self._locked[index], "batch locked after commit"
        if isinstance(polys, PolyDFS):
            polys = [polys]
        self._polys.setdefault(index, []).extend(polys)

    def state_commited(self, index: int):
        self._locked[index] = True
        if len(self._points.get(index, [])) != len(self._polys[index]):
            self._points[index] = [[] for _ in self._polys[index]]

    def append_eval_point(self, batch_id: int, point: int, poly_id=None):
        assert self._locked[batch_id], "add points only after commit"
        if poly_id is None:
            for pts in self._points[batch_id]:
                if point not in pts:
                    pts.append(point)
        else:
            if point not in self._points[batch_id][poly_id]:
                self._points[batch_id][poly_id].append(point)

    def set_batch_size(self, batch_id: int, size: int):
        """Verifier-side registration (`batched_commitment.hpp:236-243`)."""
        self._points[batch_id] = [[] for _ in range(size)]
        self._locked[batch_id] = True

    def batch_size(self, index: int) -> int:
        return len(self._polys.get(index, []))

    # --- helpers ---
    def get_unique_points(self) -> list[int]:
        out = []
        for k in sorted(self._points.keys()):
            for pts in self._points[k]:
                for pt in pts:
                    if pt not in out:
                        out.append(pt)
        return out

    def eval_polys(self):
        for k in sorted(self._polys.keys()):
            vals = []
            for i, poly in enumerate(self._polys[k]):
                vals.append([poly.evaluate(pt) for pt in self._points[k][i]])
            self._z.set_batch(k, vals)

    def get_U(self, batch: int, poly_id: int) -> list[int]:
        """Interpolant through this poly's (point, value) pairs
        (`batched_commitment.hpp:98-113`)."""
        pts = self._points[batch][poly_id]
        vals = [self._z.get(batch, poly_id, j) for j in range(len(pts))]
        return lagrange_interpolate(self.fs.p, pts, vals)

    def get_V(self, points: list[int]) -> list[int]:
        return poly_from_roots(self.fs.p, points)
