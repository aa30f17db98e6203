"""LPC: batched list-polynomial commitment over FRI.

Counterpart of `commitments/lpc.py` of the JAX package: the equivalent of
`lpc_commitment_scheme` (`lpc.hpp:50-299`) and its batching base
`polys_evaluator` (`batched_commitment.hpp:58-244`): stateful batches,
per-poly eval points, η point for fixed batches, θ-combined multi-point
quotients fed into FRI.

Same output polynomial as the reference, different algorithm: the reference
builds combined_Q by coefficient-form long division per unique point
(`lpc.hpp:131-181`); here the quotient (Σθ^k g_k − Σθ^k z_k)/(x−ξ) is
computed in EVALUATION form over D_0 with one batched inverse of every
(w^i − ξ): exact polynomial division because the numerator vanishes at ξ,
and a few large launches on the device (the batched inversion is kernels 3,
4 and the tail). Where the JAX package has a fused and an eager form of
`eval_polys` and of the combined quotient, which give the same integers,
this module keeps the batched one alone.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import limbs as L
from ..ops import ntt as N
from ..poly.domain import get_domain
from ..poly.polynomial import PolyDFS
from ..transcript.fiat_shamir import Transcript
from ..utils.profiling import span, spanned
from . import fri as FRI
from .batched import EvalStorage, PolysEvaluator

def _eval_batch_at_points(fs, values, points):
    """values: (B, NL, N) device-resident evals over D_0; points: (NL, P)
    Montgomery. Returns (NL, B, P) evaluations: one batched iFFT and, for
    each point, one product against [1, x, x^2, ...] and a halving sum."""
    n = values.shape[-1]
    # limb axis must lead before any field op
    vals = values.permute(1, 0, 2)                   # (NL, B, N)
    coeffs = get_domain(fs, n).ifft(vals)
    outs = []
    for i in range(points.shape[1]):
        pw = L.powers_of(fs, points[:, i:i + 1], n)   # [1, x, x^2 ...]
        s = L.mont_mul(fs, coeffs, pw[:, None, :])
        outs.append(N.sum_reduce(fs, s, axis=-1))     # (NL, B)
    return torch.stack(outs, dim=-1)                  # (NL, B, P)


def _combined_q(fs, counts, gvs, theta_pows, z_accs, points_arr, omega_pows):
    """Combined Q (`lpc.hpp:131-181` restated in evaluation form):
    theta-weighted numerators, per-point z subtraction, ONE batched inverse
    of every (w^i - xi) denominator, sum of quotients. `counts` is the
    contribution count per evaluation point; gvs (NL, C, N) are the
    contributing value tables concatenated in theta order; theta_pows
    (NL, C, 1), z_accs and points_arr (NL, P, 1) broadcast over N."""
    n = gvs.shape[-1]
    terms = L.mont_mul(fs, gvs, theta_pows)           # (NL, C, N)
    nums = []
    off = 0
    for c in counts:
        s = terms[:, off, :]
        for j in range(1, c):
            s = L.add(fs, s, terms[:, off + j, :])
        nums.append(s)
        off += c
    num = torch.stack(nums, dim=1)                    # (NL, P, N)
    num = L.sub(fs, num, z_accs)
    den = L.sub(fs, omega_pows[:, None, :], points_arr)
    p_cnt = len(counts)
    inv = L.batch_inverse(fs, den.reshape(den.shape[0], p_cnt * n), axis=1)
    q = L.mont_mul(fs, num, inv.reshape(num.shape))
    out = q[:, 0, :]
    for i in range(1, p_cnt):
        out = L.add(fs, out, q[:, i, :])
    return out.contiguous()


@dataclasses.dataclass
class LPCProof:
    z: EvalStorage
    fri_proof: FRI.FRIProof


class LPCScheme(PolysEvaluator):
    """Stateful Placeholder-friendly commitment scheme object. It lives
    where its committed polynomials live: the verifier side is host only."""

    def get_params(self) -> dict:
        """`lpc_commitment_scheme::get_params` (`lpc.hpp:275-298`)."""
        out = dict(self.fri_params.get_params())
        out["scheme"] = "lpc"
        return out

    def __init__(self, fri_params: FRI.FRIParams):
        super().__init__(fri_params.fs)
        self.fri_params = fri_params
        self._trees: dict[int, FRI.Precommitment] = {}
        self._batch_fixed: dict[int, bool] = {}
        self._fixed_polys_values: dict[int, list[int]] = {}
        self._etha: int = 0
        self._omega_pows = None      # (NL, |D0|) table w^i, built at first use

    def commit(self, index: int):
        self.state_commited(index)
        self._trees[index] = FRI.precommit(
            self._polys[index], self.fri_params.D[0],
            self.fri_params.step_list[0], self.fri_params)
        return self._trees[index].root()

    def mark_batch_as_fixed(self, index: int):
        self._batch_fixed[index] = True

    def fork(self) -> "LPCScheme":
        """A prover-side scheme that shares this one's committed batches
        marked fixed (their polynomials and trees, read only) and holds
        nothing else: what each proof starts from, as the reference hands
        every proof a copy of the preprocessed scheme."""
        out = LPCScheme(self.fri_params)
        for k, fixed in self._batch_fixed.items():
            if fixed and k in self._trees:
                out._polys[k] = list(self._polys[k])
                out._trees[k] = self._trees[k]
                out._batch_fixed[k] = True
                out.state_commited(k)
        out._omega_pows = self._omega_pows
        return out

    # --- setup / preprocess (lpc.hpp:82-106) ---
    def preprocess(self, transcript: Transcript) -> dict[int, list[int]]:
        etha = transcript.challenge(self.fs)
        result = {}
        for index, fixed in self._batch_fixed.items():
            if not fixed:
                continue
            result[index] = [p.evaluate(etha) for p in self._polys[index]]
        return result

    def setup(self, transcript: Transcript,
              preprocessed_data: dict[int, list[int]]):
        self._etha = transcript.challenge(self.fs)
        self._fixed_polys_values = preprocessed_data

    def eval_polys(self):
        """Batched z-table evaluation: every committed batch's resident
        (B, NL, N0) eval table is iFFT'd and dotted against all unique
        points, one decode per batch (the per-(poly, point) `evaluate`
        path costs a transform and a host sync each)."""
        fs = self.fs
        points = self.get_unique_points()
        if not points:
            return super().eval_polys()
        for k in sorted(self._polys.keys()):
            if k not in self._trees or not self._points[k]:
                # uncommitted batch (shouldn't happen in proof_eval flows)
                vals = [[p.evaluate(pt) for pt in self._points[k][i]]
                        for i, p in enumerate(self._polys[k])]
                self._z.set_batch(k, vals)
                continue
            values = self._trees[k].values
            got = _eval_batch_at_points(
                fs, values, L.encode(fs, points, values.device))
            flat = L.decode(fs, got)                  # row-major (B, P)
            P_ = len(points)
            vals = []
            for i in range(len(self._polys[k])):
                row = flat[i * P_:(i + 1) * P_]
                vals.append([row[points.index(pt)]
                             for pt in self._points[k][i]])
            self._z.set_batch(k, vals)

    # --- proof_eval (lpc.hpp:113-200) ---
    @spanned("zk.lpc.proof_eval")
    def proof_eval(self, transcript: Transcript,
                   clock: FRI.PhaseClock | None = None) -> LPCProof:
        """`clock`, where given, is marked after each phase (`eval_polys`,
        `combined_q`, `q_precommit`, then FRI's two); the phases are spans
        under `zk.lpc.proof_eval` (`zk.lpc.<phase>`, `zk.fri.<phase>`)."""
        def mark(name):
            if clock is not None:
                clock.mark(name)

        device = next(iter(self._trees.values())).values.device
        with span("zk.lpc.eval_polys"):
            self.eval_polys()
        mark("eval_polys")
        with span("zk.lpc.combined_q"):
            combined_Q_v = self._combined_q_values(transcript, device)
        mark("combined_q")
        with span("zk.lpc.q_precommit"):
            combined_Q = PolyDFS(self.fs, combined_Q_v,
                                 self.fri_params.max_degree + 1)
            combined_Q_pre = FRI.precommit([combined_Q], self.fri_params.D[0],
                                           self.fri_params.step_list[0],
                                           self.fri_params)
        mark("q_precommit")
        ordered_polys = {k: self._polys[k] for k in sorted(self._polys.keys())}
        fri_proof = FRI.proof_eval(ordered_polys, combined_Q, self._trees,
                                   combined_Q_pre, self.fri_params, transcript,
                                   clock)
        return LPCProof(z=self._z, fri_proof=fri_proof)

    def _combined_q_values(self, transcript: Transcript,
                           device) -> torch.Tensor:
        """The trees' roots absorbed, theta drawn, and the combined
        quotient's values over the first FRI domain."""
        fs = self.fs
        for k in sorted(self._trees.keys()):
            FRI.absorb_root(transcript, self.fri_params, self._trees[k].root())

        theta = transcript.challenge(fs)
        D0 = self.fri_params.D[0]
        n0 = D0.n

        # contribution layout (static per circuit): per point, the (batch,
        # poly) pairs in theta order; fixed batches contribute at etha last
        groups: list[tuple[int, list]] = []
        for point in self.get_unique_points():
            contribs = []
            for k in self._z.batches():
                for j in range(self._z.batch_size(k)):
                    if point in self._points[k][j]:
                        idx = self._points[k][j].index(point)
                        contribs.append((k, j, self._z.get(k, j, idx)))
            groups.append((point, contribs))
        for k in self._z.batches():
            if not self._batch_fixed.get(k, False):
                continue
            contribs = [(k, j, self._fixed_polys_values[k][j])
                        for j in range(self._z.batch_size(k))]
            groups.append((self._etha, contribs))

        if self._omega_pows is None or self._omega_pows.device != device:
            self._omega_pows = L.powers(fs, D0.omega, n0, device)

        if groups:
            theta_pows, z_accs, counts, gv_list = [], [], [], []
            acc = 1
            for point, contribs in groups:
                z_acc = 0
                for (bk, bj, zv) in contribs:
                    gv_list.append(self._trees[bk].values[bj])
                    theta_pows.append(acc)
                    z_acc = (z_acc + zv * acc) % fs.p
                    acc = acc * theta % fs.p
                z_accs.append(z_acc)
                counts.append(len(contribs))
            gvs = torch.stack(gv_list, dim=1)         # (NL, C, N0)
            combined_Q_v = _combined_q(
                fs, tuple(counts), gvs,
                L.encode(fs, theta_pows, device)[:, :, None],
                L.encode(fs, z_accs, device)[:, :, None],
                L.encode(fs, [pt for pt, _ in groups], device)[:, :, None],
                self._omega_pows)
        else:
            combined_Q_v = L.zeros(fs, (n0,), device)
        return combined_Q_v

    # --- verify_eval (lpc.hpp:202-267) ---
    def verify_eval(self, proof: LPCProof, commitments: dict[int, object],
                    transcript: Transcript) -> bool:
        fs = self.fs
        self._z = proof.z
        for k in sorted(commitments.keys()):
            FRI.absorb_root(transcript, self.fri_params, commitments[k])

        points = self.get_unique_points()
        total_points = len(points)
        has_fixed = any(self._batch_fixed.values())
        if has_fixed:
            total_points += 1

        U = [0] * total_points
        V = [None] * total_points
        poly_map: list[list[tuple[int, int]]] = [[] for _ in range(total_points)]

        theta = transcript.challenge(fs)
        theta_acc = 1
        for pi, point in enumerate(points):
            V[pi] = [(-point) % fs.p, 1]
            for k in self._z.batches():
                for j in range(self._z.batch_size(k)):
                    if point in self._points[k][j]:
                        idx = self._points[k][j].index(point)
                        U[pi] = (U[pi] + self._z.get(k, j, idx) * theta_acc) % fs.p
                        poly_map[pi].append((k, j))
                        theta_acc = theta_acc * theta % fs.p
        if has_fixed:
            pi = len(points)
            V[pi] = [(-self._etha) % fs.p, 1]
            for k in self._z.batches():
                if not self._batch_fixed.get(k, False):
                    continue
                for j in range(self._z.batch_size(k)):
                    U[pi] = (U[pi] + self._fixed_polys_values[k][j] * theta_acc) % fs.p
                    poly_map[pi].append((k, j))
                    theta_acc = theta_acc * theta % fs.p

        return FRI.verify_eval(proof.fri_proof, self.fri_params, commitments,
                               theta, poly_map, U, V, transcript)

    def get_commitment_params(self):
        return self.fri_params
