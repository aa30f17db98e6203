"""KZG polynomial commitments: basic single-point, SHPLONK v2 and BDFG20.

Counterpart of `commitments/kzg.py` of the JAX package:
- `kzg` static algorithms (`kzg.hpp:76-206`): commit = MSM(ck, f), open
  q = (f - f(z))/(x - z), pairing verify e(pi, [tau - z]_2) = e([eval]_1
  - C, [1]_2)^-1;
- `kzg_commitment_scheme_v2` (`kzg_v2.hpp:76-384`, "SHPLONK"): two
  openings, pi_1 over the merged point set T and pi_2 the linearization at
  theta_2, one double pairing;
- the batched BDFG20 scheme (`kzg.hpp:219-873`): one opening, a pairing per
  polynomial, with G2 powers of tau.

Commitments are byte blobs (x||y big-endian per point, concatenated per
batch) that the transcript absorbs, identical to the reference's.

Where the work runs:
- `KZGParams.setup` makes the powers of tau in G1 with the fixed-base batch
  of `ops/msm.py` on `device` (the reference: one host `g1_mul` each; the
  points are the same); the few G2 powers stay on the host;
- the commitment key is encoded on a device once per `KZGParams` and device
  (`KZGParams.msm_bases`), one `MSMBases` over all its points, and every
  commitment of 64 nonzero terms or more is an MSM over its first bases;
  below 64 the host oracle takes it, the reference's own rule;
- the schemes commit the coefficient tensors where they lie
  (`commit_poly`): one kernel-1 product by 1 takes them out of Montgomery
  form, the window digits are cut on the device, and the transfers are
  the nonzero count and the MSM's pass counts. `commit_one` keeps the reference's list-of-ints
  signature for host callers;
- quotients divide in evaluation form on a coset that holds none of the
  divisor's roots (`poly.polynomial.divide_by_roots`: transforms and a
  batched inversion, kernels 1 to 4 and the tail);
- pairings and verifiers are host Python, as in the reference.
"""
from __future__ import annotations

import dataclasses
import random

import torch

from ..fields import curves as CV
from ..fields import tower as T
from ..ops import limbs as L
from ..ops import ntt as N
from ..ops.msm import fixed_base_exp_batch, msm_host
from ..ops.msm_affine import MSMBases
from ..poly.polynomial import Poly, _pad_last, divide_by_roots
from ..transcript.fiat_shamir import Transcript
from .batched import EvalStorage, PolysEvaluator, eval_coeffs, poly_from_roots
from .fri import PhaseClock

# From this many nonzero terms a commitment is a device MSM
# (the reference's `kzg.py:109`).
DEVICE_MSM_MIN = 64
# The commitment MSM's window width: at a 2^16-term MSM on the H100, timed
# round-robin over the widths (`tools/msm_windows.py`), 5 bits was the
# fastest or within 5 % of 4 in seven trials and 10 to 22 % under the
# reference's 8, and a whole 2^16-row v2 prove took 1.275 s at 5 bits
# against 1.425 s at 8 (medians of 8 rounds; PERF.md §6).
COMMIT_WINDOW_BITS = 5


# ---------------------------------------------------------------------------
# params / serialization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KZGParams:
    curve: CV.CurveSpec
    commitment_key: list          # [tau^i]_1, len d
    verification_key: list        # [tau^j]_2, len d2 (>= 2; basic uses 0,1)
    _bases: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def transcript_repr(self) -> str:
        return f"KZG:{self.curve.name},d={len(self.commitment_key)}"

    @classmethod
    def setup(cls, curve: CV.CurveSpec, d: int,
              tau: int | None = None,
              rng: random.Random | None = None,
              d2: int = 2, device=None) -> "KZGParams":
        """d powers of tau in G1, made on `device` (default: the card) by
        the fixed-base batch (which, like every device MSM, refuses a != 0
        curves), and max(2, d2) in G2 on the host."""
        device = L.resolve_device(device)
        rng = rng if rng is not None else random.SystemRandom()
        p = curve.fr.p
        tau = tau if tau is not None else rng.randrange(1, p)
        pows = [1]
        for _ in range(max(d, d2, 2) - 1):
            pows.append(pows[-1] * tau % p)
        ck = fixed_base_exp_batch(curve, curve.g1, pows[:d], device=device)
        vk = [CV.g2_mul(curve, curve.g2, k) for k in pows[:max(2, d2)]]
        return cls(curve, ck, vk)

    def msm_bases(self, device) -> MSMBases:
        """The commitment key encoded on `device`, once per device."""
        device = L.resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        if key not in self._bases:
            self._bases[key] = MSMBases(self.curve, self.commitment_key,
                                        "g1", COMMIT_WINDOW_BITS, device)
        return self._bases[key]

    def g2_commit(self, coeffs: list[int]):
        """[f(tau)]_2 from the stored G2 powers (batched verifier side)."""
        if len(coeffs) > len(self.verification_key):
            raise ValueError(
                f"a G2 commitment of {len(coeffs)} coefficients needs as "
                f"many G2 powers of tau; the SRS has "
                f"{len(self.verification_key)} (KZGParams.setup's d2)")
        acc = None
        for base, c in zip(self.verification_key, coeffs):
            if c % self.curve.fr.p:
                acc = CV.g2_add(self.curve, acc,
                                CV.g2_mul(self.curve, base, c))
        return acc


def g1_to_bytes(curve: CV.CurveSpec, pt) -> bytes:
    nb = (curve.fq.bits + 7) // 8
    if pt is None:
        return b"\x00" * (2 * nb)
    return pt[0].to_bytes(nb, "big") + pt[1].to_bytes(nb, "big")


def g1_from_bytes(curve: CV.CurveSpec, data: bytes):
    """Deserialize an UNTRUSTED G1 byte blob. Raises ValueError for points
    not in the prime-order subgroup (reference verifiers reject via
    `is_well_formed()`)."""
    nb = (curve.fq.bits + 7) // 8
    x = int.from_bytes(data[:nb], "big")
    y = int.from_bytes(data[nb:2 * nb], "big")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not CV.g1_well_formed(curve, pt):
        raise ValueError("G1 point not in prime-order subgroup")
    return pt


# ---------------------------------------------------------------------------
# basic single-point KZG (static algorithm style)
# ---------------------------------------------------------------------------

def commit_one(params: KZGParams, coeffs: list[int], device=None):
    """MSM(ck[:len(f)], f) (`kzg.hpp:143-148`) of host ints: the host oracle
    below 64 nonzero terms, else the MSM on `device` (default: the card)."""
    curve = params.curve
    p = curve.fr.p
    assert len(coeffs) <= len(params.commitment_key)
    pairs = [(b, s % p) for b, s in zip(params.commitment_key, coeffs)
             if s % p != 0]
    if not pairs:
        return None
    if len(pairs) < DEVICE_MSM_MIN:
        pts, sc = zip(*pairs)
        return msm_host(curve, list(pts), list(sc))
    return params.msm_bases(device).run([s % p for s in coeffs])


def commit_poly(params: KZGParams, poly: Poly):
    """`commit_one` of a coefficient tensor where it lies: out of
    Montgomery form by one kernel-1 product and counted on the device (one
    small transfer), then from 64 nonzero terms the MSM of those digits
    (`MSMBases.run_limbs`), below that the host oracle of the decoded
    coefficients."""
    assert poly.n <= len(params.commitment_key)
    if poly.n >= DEVICE_MSM_MIN:
        canonical = L.from_mont(params.curve.fr, poly.c)
        if int((canonical != 0).any(dim=0).sum()) >= DEVICE_MSM_MIN:
            return params.msm_bases(poly.device).run_limbs(canonical)
    return commit_one(params, poly.to_ints(), poly.device)


def proof_eval_one(params: KZGParams, f: Poly, z: int):
    """pi = commit((f - f(z))/(x - z)) (`kzg.hpp:156-181`)."""
    return commit_poly(params, f.divide_by_linear(z))


def verify_eval_one(params: KZGParams, proof, commitment, z: int,
                    eval_v: int) -> bool:
    """e(pi, [tau - z]_2) * e([eval]_1 - C, [1]_2) == 1 (`kzg.hpp:183-206`)."""
    curve = params.curve
    if not (CV.g1_well_formed(curve, proof)
            and CV.g1_well_formed(curve, commitment)):
        return False
    tau_minus_z = CV.g2_add(curve, params.verification_key[1],
                            CV.g2_neg(curve, CV.g2_mul(curve, curve.g2, z)))
    b1 = CV.g1_add(curve, CV.g1_mul(curve, curve.g1, eval_v),
                   CV.g1_neg(curve, commitment))
    out = CV.multi_pairing(curve, [(proof, tau_minus_z),
                                   (b1, params.verification_key[0])])
    return out == T.FQ12_ONE


# ---------------------------------------------------------------------------
# the stateful schemes' shared part
# ---------------------------------------------------------------------------

class _KZGScheme(PolysEvaluator):
    """Batches, commitments and point bookkeeping of both schemes. A prover
    side scheme commits on `device` (default: the card), where its
    polynomials must lie; a verifier-side one needs no device."""

    def __init__(self, params: KZGParams, device=None):
        super().__init__(params.curve.fr)
        self.params = params
        self.curve = params.curve
        self.device = device
        self._commitments: dict[int, bytes] = {}
        self._coeffs: dict[int, list[Poly]] = {}
        self._batch_fixed: dict[int, bool] = {}
        self._merged_points: list[int] = []

    def mark_batch_as_fixed(self, index: int):
        self._batch_fixed[index] = True

    def preprocess(self, transcript: Transcript):
        return True

    def setup(self, transcript: Transcript, preprocessed_data=True):
        pass

    def get_commitment_params(self):
        return self.params

    def fork(self):
        """A prover-side scheme that shares this one's committed batches
        marked fixed (their polynomials, coefficients and commitments, read
        only) and holds nothing else: what each proof starts from."""
        out = type(self)(self.params, self.device)
        for k, fixed in self._batch_fixed.items():
            if fixed and k in self._commitments:
                out._polys[k] = list(self._polys[k])
                out._coeffs[k] = self._coeffs[k]
                out._commitments[k] = self._commitments[k]
                out._batch_fixed[k] = True
                out.state_commited(k)
        return out

    def commit(self, index: int) -> bytes:
        device = L.resolve_device(self.device)
        self.state_commited(index)
        coeffs, blob = [], b""
        for poly in self._polys[index]:
            if poly.device.type != device.type:
                raise ValueError(f"a polynomial of batch {index} lies on "
                                 f"{poly.device}, not on {device}")
            c = poly.coefficients()
            coeffs.append(c)
            blob += g1_to_bytes(self.curve, commit_poly(self.params, c))
        self._coeffs[index] = coeffs
        self._commitments[index] = blob
        return blob

    def eval_polys(self):
        """The z table from the coefficients kept at commit time: per batch,
        one stacked product against the powers of each of its points and a
        halving sum, one decode (the same integers as evaluating each
        polynomial at each of its points)."""
        fs = self.fs
        for k in sorted(self._polys.keys()):
            coeffs = self._coeffs[k]
            pts = []
            for ps in self._points[k]:
                for pt in ps:
                    if pt not in pts:
                        pts.append(pt)
            if not pts:
                self._z.set_batch(k, [[] for _ in coeffs])
                continue
            m = max(c.n for c in coeffs)
            stack = torch.stack([_pad_last(c.c, m) for c in coeffs], dim=1)
            xs = L.encode(fs, pts, stack.device)
            outs = []
            for i in range(len(pts)):
                pw = L.powers_of(fs, xs[:, i:i + 1], m)
                outs.append(N.sum_reduce(
                    fs, L.mont_mul(fs, stack, pw[:, None, :]), axis=-1))
            flat = L.decode(fs, torch.stack(outs, dim=-1))    # (B, P)
            n_pts = len(pts)
            self._z.set_batch(k, [
                [flat[i * n_pts + pts.index(pt)] for pt in self._points[k][i]]
                for i in range(len(coeffs))])

    def _merge_eval_points(self):
        s = set()
        for k in self._points:
            for pts in self._points[k]:
                s.update(pts)
        self._merged_points = sorted(s)

    def _set_difference_polynom(self, merged, points) -> list[int]:
        rest = sorted(set(merged) - set(points))
        if not rest:
            return [1]
        return poly_from_roots(self.fs.p, rest)

    def _update_transcript(self, k: int, transcript: Transcript):
        transcript.absorb(self._commitments[k])
        for i in range(self._z.batch_size(k)):
            for j in range(len(self._z.z[k][i])):
                transcript.absorb_field(self.fs, self._z.get(k, i, j))
        for i in range(len(self._points[k])):
            for c in self.get_U(k, i):
                transcript.absorb_field(self.fs, c)

    def _commitment_point(self, k: int, i: int):
        nb = 2 * ((self.curve.fq.bits + 7) // 8)
        return g1_from_bytes(self.curve,
                             self._commitments[k][i * nb:(i + 1) * nb])


def _mark(clock: PhaseClock | None, name: str) -> None:
    if clock is not None:
        clock.mark(name)


# ---------------------------------------------------------------------------
# SHPLONK v2 stateful scheme (kzg_v2.hpp:76-384)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KZGv2Proof:
    z: EvalStorage
    pi_1: object
    pi_2: object


class KZGSchemeV2(_KZGScheme):

    def proof_eval(self, transcript: Transcript,
                   clock: PhaseClock | None = None) -> KZGv2Proof:
        """`kzg_v2.hpp:236-310`. `clock`, where given, is marked after
        `eval_polys`, `combine_f`, each division of f by (x - t) for t in
        T (`divide_T`, one pass: f vanishes on T), `pi_1_commit`,
        `combine_L`, `divide_theta_2` and `pi_2_commit`; without one nothing
        synchronizes but what needs a value."""
        fs, p = self.fs, self.fs.p
        dev = L.resolve_device(self.device)
        self.eval_polys()
        _mark(clock, "eval_polys")
        self._merge_eval_points()
        for k in sorted(self._commitments.keys()):
            self._update_transcript(k, transcript)

        theta = transcript.challenge(fs)
        theta_i = 1
        f = Poly.zero(fs, dev)
        for k in sorted(self._polys.keys()):
            for i in range(self._z.batch_size(k)):
                diff = self._set_difference_polynom(self._merged_points,
                                                    self._points[k][i])
                u = Poly.from_ints(fs, self.get_U(k, i), dev)
                term = self._coeffs[k][i] - u
                if diff != [1]:
                    term = term * Poly.from_ints(fs, diff, dev)
                f = f + term.scale(theta_i)
                theta_i = theta_i * theta % p
        _mark(clock, "combine_f")
        f = divide_by_roots(f, self._merged_points)
        _mark(clock, "divide_T")
        pi_1 = commit_poly(self.params, f)
        transcript.absorb(g1_to_bytes(self.curve, pi_1))
        _mark(clock, "pi_1_commit")

        theta_2 = transcript.challenge(fs)
        theta_i = 1
        L_poly = Poly.zero(fs, dev)
        for k in sorted(self._polys.keys()):
            for i in range(self._z.batch_size(k)):
                diff = self._set_difference_polynom(self._merged_points,
                                                    self._points[k][i])
                z_t_s = eval_coeffs(p, diff, theta_2)
                u_at = eval_coeffs(p, self.get_U(k, i), theta_2)
                term = (self._coeffs[k][i]
                        - Poly.from_ints(fs, [u_at], dev)).scale(
                            theta_i * z_t_s % p)
                L_poly = L_poly + term
                theta_i = theta_i * theta % p
        v_at = eval_coeffs(p, poly_from_roots(p, self._merged_points), theta_2)
        L_poly = L_poly - f.scale(v_at)
        _mark(clock, "combine_L")
        assert L_poly.evaluate(theta_2) == 0
        L_poly = L_poly.divide_by_linear(theta_2)
        _mark(clock, "divide_theta_2")
        pi_2 = commit_poly(self.params, L_poly)
        transcript.absorb(g1_to_bytes(self.curve, pi_2))
        _mark(clock, "pi_2_commit")
        return KZGv2Proof(z=self._z, pi_1=pi_1, pi_2=pi_2)

    def verify_eval(self, proof: KZGv2Proof,
                    commitments: dict[int, bytes],
                    transcript: Transcript) -> bool:
        """`kzg_v2.hpp:312-384`, on the host."""
        if not (CV.g1_well_formed(self.curve, proof.pi_1)
                and CV.g1_well_formed(self.curve, proof.pi_2)):
            return False
        try:
            return self._verify_eval(proof, commitments, transcript)
        except ValueError:   # malformed commitment blob (off-curve point)
            return False

    def _verify_eval(self, proof: KZGv2Proof,
                     commitments: dict[int, bytes],
                     transcript: Transcript) -> bool:
        p = self.fs.p
        curve = self.curve
        self._z = proof.z
        self._commitments = dict(commitments)
        self._merge_eval_points()
        for k in sorted(self._commitments.keys()):
            self._update_transcript(k, transcript)

        theta = transcript.challenge(self.fs)
        transcript.absorb(g1_to_bytes(curve, proof.pi_1))
        theta_2 = transcript.challenge(self.fs)

        theta_i = 1
        F = None
        rsum = 0
        for k in sorted(self._commitments.keys()):
            for i in range(len(self._points[k])):
                cm_i = self._commitment_point(k, i)
                z_t_s = eval_coeffs(
                    p, self._set_difference_polynom(self._merged_points,
                                                    self._points[k][i]),
                    theta_2)
                F = CV.g1_add(curve, F,
                              CV.g1_mul(curve, cm_i, theta_i * z_t_s % p))
                rsum = (rsum + theta_i * z_t_s
                        * eval_coeffs(p, self.get_U(k, i), theta_2)) % p
                theta_i = theta_i * theta % p

        F = CV.g1_add(curve, F,
                      CV.g1_neg(curve, CV.g1_mul(curve, curve.g1, rsum)))
        v_at = eval_coeffs(p, poly_from_roots(p, self._merged_points), theta_2)
        F = CV.g1_add(curve, F,
                      CV.g1_neg(curve, CV.g1_mul(curve, proof.pi_1, v_at)))
        transcript.absorb(g1_to_bytes(curve, proof.pi_2))

        lhs = CV.pairing(curve,
                         CV.g1_add(curve, F,
                                   CV.g1_mul(curve, proof.pi_2, theta_2)),
                         self.params.verification_key[0])
        rhs = CV.pairing(curve, proof.pi_2, self.params.verification_key[1])
        return lhs == rhs


# ---------------------------------------------------------------------------
# batched KZG, BDFG20 v1 (kzg.hpp:219-629)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KZGBDFGProof:
    z: EvalStorage
    pi: object               # single combined-quotient commitment


class KZGSchemeBDFG(_KZGScheme):
    """Stateful batched KZG, the reference's `batched_kzg` /
    `kzg_commitment_scheme` (`kzg.hpp:219-319` scheme, `:322-629` static
    algorithms, `:636-873` stateful adapter).

    One proof pi = commit( sum_i theta^i (f_i - r_i) / Z_{S_i} ) where r_i
    interpolates f_i on its point set S_i; the verifier checks

        prod_i e(theta^i (C_i - [r_i(tau)]_1), [Z_{T \\ S_i}(tau)]_2)
            == e(pi, [Z_T(tau)]_2)

    with the [.]_2 terms built from the SRS's G2 powers, of which it needs
    |T| + 1 (`KZGParams.setup`'s d2)."""

    def proof_eval(self, transcript: Transcript,
                   clock: PhaseClock | None = None) -> KZGBDFGProof:
        """`clock`, where given, is marked after `eval_polys`, the divisions
        of each batch's polynomials by their points (`divide_batch_<k>`, a
        pass a polynomial) and `pi_commit`."""
        fs, p = self.fs, self.fs.p
        dev = L.resolve_device(self.device)
        self.eval_polys()
        _mark(clock, "eval_polys")
        self._merge_eval_points()
        for k in sorted(self._commitments.keys()):
            self._update_transcript(k, transcript)

        theta = transcript.challenge(fs)
        theta_i = 1
        q = Poly.zero(fs, dev)
        for k in sorted(self._polys.keys()):
            for i in range(self._z.batch_size(k)):
                u = Poly.from_ints(fs, self.get_U(k, i), dev)
                term = (self._coeffs[k][i] - u).scale(theta_i)
                q = q + divide_by_roots(term, self._points[k][i])
                theta_i = theta_i * theta % p
            _mark(clock, f"divide_batch_{k}")
        pi = commit_poly(self.params, q)
        transcript.absorb(g1_to_bytes(self.curve, pi))
        _mark(clock, "pi_commit")
        return KZGBDFGProof(z=self._z, pi=pi)

    def verify_eval(self, proof: KZGBDFGProof,
                    commitments: dict[int, bytes],
                    transcript: Transcript) -> bool:
        """`kzg.hpp:569-629`, on the host. Raises ValueError where the SRS
        holds fewer than |T| + 1 G2 powers."""
        if not CV.g1_well_formed(self.curve, proof.pi):
            return False
        self._merge_eval_points()
        need = len(self._merged_points) + 1
        if len(self.params.verification_key) < need:
            raise ValueError(
                f"the BDFG verifier needs {need} G2 powers of tau for "
                f"{need - 1} evaluation points; the SRS has "
                f"{len(self.params.verification_key)}: set "
                f"KZGParams.setup(..., d2={need}) or more")
        try:
            return self._verify_eval(proof, commitments, transcript)
        except ValueError:
            return False

    def _verify_eval(self, proof: KZGBDFGProof,
                     commitments: dict[int, bytes],
                     transcript: Transcript) -> bool:
        p = self.fs.p
        curve = self.curve
        self._z = proof.z
        self._commitments = dict(commitments)
        self._merge_eval_points()
        for k in sorted(self._commitments.keys()):
            self._update_transcript(k, transcript)

        theta = transcript.challenge(self.fs)
        transcript.absorb(g1_to_bytes(curve, proof.pi))

        theta_i = 1
        pairs = []
        for k in sorted(self._commitments.keys()):
            for i in range(len(self._points[k])):
                cm_i = self._commitment_point(k, i)
                r_tau_1 = commit_one(self.params, self.get_U(k, i))
                lhs_g1 = CV.g1_mul(
                    curve,
                    CV.g1_add(curve, cm_i, CV.g1_neg(curve, r_tau_1)),
                    theta_i)
                z_rest = self._set_difference_polynom(self._merged_points,
                                                      self._points[k][i])
                pairs.append((lhs_g1, self.params.g2_commit(z_rest)))
                theta_i = theta_i * theta % p
        z_t_2 = self.params.g2_commit(poly_from_roots(p, self._merged_points))
        pairs.append((CV.g1_neg(curve, proof.pi), z_t_2))
        return CV.multi_pairing(curve, pairs) == T.FQ12_ONE
