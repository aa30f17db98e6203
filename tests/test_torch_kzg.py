"""The port's KZG commitments (`commitments/kzg.py`) and its `ops.msm.msm`
against the JAX package's, on the CPU, exact equality: the SRS made by the
port's fixed-base batch equals the reference's host setup for the same tau;
for the basic scheme, SHPLONK v2 and BDFG20 the same inputs (made from a
seed) give identical commitment bytes, proofs and next challenges, each
package's verifier accepts the other's proof, and a tampered evaluation is
rejected. Each case runs once per package (module-scoped fixtures). The
scheme cases lower the device-MSM threshold and the window so that the
port's tensor commit path (`commit_poly` -> `MSMBases.run_limbs`) runs at
these sizes."""
import random

import pytest
import torch

from crypto3_zk_tpu.commitments import batched as RB
from crypto3_zk_tpu.commitments import kzg as RK
from crypto3_zk_tpu.fields import curves as RCV
from crypto3_zk_tpu.ops import msm as RM
from crypto3_zk_tpu.poly.polynomial import Poly as RPoly
from crypto3_zk_tpu.poly.polynomial import PolyDFS as RPolyDFS
from crypto3_zk_tpu.transcript.fiat_shamir import Transcript as RTranscript
from crypto3_zk_tpu_torch import convert as CONV
from crypto3_zk_tpu_torch.commitments import kzg as K
from crypto3_zk_tpu_torch.fields import curves as CV
from crypto3_zk_tpu_torch.fields import mnt as MNT
from crypto3_zk_tpu_torch.ops import msm as M
from crypto3_zk_tpu_torch.ops import msm_affine as MA
from crypto3_zk_tpu_torch.poly import polynomial as TPOLY
from crypto3_zk_tpu_torch.poly.polynomial import Poly, PolyDFS
from crypto3_zk_tpu_torch.transcript.fiat_shamir import Transcript

import torch_threads  # noqa: F401  one torch thread a worker

CURVE, RCURVE = CV.ALT_BN128, RCV.ALT_BN128
FS, RFS = CURVE.fr, RCURVE.fr
SEED = bytes(range(8))
TAU = 0x1D2C3B4A5968778695A4B3C2D1E0F


# ---------------------------------------------------------------------------
# msm
# ---------------------------------------------------------------------------

def _points(group, n, seed):
    rng = random.Random(seed)
    mul = CV.g1_mul if group == "g1" else CV.g2_mul
    gen = CURVE.g1 if group == "g1" else CURVE.g2
    pts = [mul(CURVE, gen, rng.randrange(1, FS.p)) for _ in range(n)]
    sc = [rng.randrange(FS.p) for _ in range(n)]
    sc[1] = 0
    sc[3] = sc[5] = sc[7]                 # in the same buckets
    return pts, sc


@pytest.mark.parametrize("group,c,n", [("g1", 8, 40), ("g1", 3, 12),
                                       ("g2", 5, 16)])
def test_msm_equals_the_host_oracle(group, c, n):
    pts, sc = _points(group, n, 0x31 + c)
    want = M.msm_host(CURVE, pts, sc, group=group)
    assert want == RM.msm_host(RCURVE, pts, sc, group=group)
    assert M.msm(CURVE, pts, sc, c=c, group=group, device="cpu") == want


def test_msm_refuses_nonzero_a_and_counts():
    with pytest.raises(ValueError):
        M.msm(MNT.MNT4, [MNT.MNT4.g1], [3], device="cpu")
    with pytest.raises(AssertionError):
        M.msm(CURVE, [CURVE.g1], [1, 2], device="cpu")


def test_tensor_scalars_equal_host_scalars():
    """`run_limbs` of digits on the device against `run` of host ints and
    the oracle, on a short prefix of the bases with an infinity base."""
    from crypto3_zk_tpu_torch.ops import limbs as TL
    pts, sc = _points("g1", 24, 0x77)
    pts[2] = None
    live = [(q, s) for q, s in zip(pts[:20], sc[:20]) if q is not None]
    want = M.msm_host(CURVE, [q for q, _ in live], [s for _, s in live])
    digits = TL.from_numpy(TL.pack_ints(FS, sc[:20]), "cpu")
    bases = MA.MSMBases(CURVE, pts, "g1", 7, "cpu")   # windows across digits
    assert bases.run_limbs(digits) == bases.run(sc[:20]) == want
    assert bases.run_limbs(torch.zeros_like(digits)) is None


# ---------------------------------------------------------------------------
# SRS and serialization
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def srs():
    """The reference's host setup and the port's device-path setup (the
    fixed-base batch, here its plain version) for the same tau."""
    ref = RK.KZGParams.setup(RCURVE, 16, tau=TAU, d2=8)
    port = K.KZGParams.setup(CURVE, 16, tau=TAU, d2=8, device="cpu")
    return ref, port


def test_setup_equals_the_reference_point_by_point(srs):
    ref, port = srs
    assert port.commitment_key == ref.commitment_key
    assert port.verification_key == ref.verification_key
    assert port.transcript_repr() == ref.transcript_repr() \
        == "KZG:alt_bn128,d=16"
    carried = CONV.kzg_params_from_reference(
        {"curve": ref.curve, "commitment_key": ref.commitment_key,
         "verification_key": ref.verification_key})
    assert carried == port


def test_g1_bytes_roundtrip_and_refusals():
    rng = random.Random(5)
    pt = CV.g1_mul(CURVE, CURVE.g1, rng.randrange(1, FS.p))
    blob = K.g1_to_bytes(CURVE, pt)
    assert blob == RK.g1_to_bytes(RCURVE, pt) and len(blob) == 64
    assert K.g1_from_bytes(CURVE, blob) == pt
    assert K.g1_to_bytes(CURVE, None) == bytes(64)
    assert K.g1_from_bytes(CURVE, bytes(64)) is None
    with pytest.raises(ValueError):                  # off the curve
        K.g1_from_bytes(CURVE, K.g1_to_bytes(CURVE, (1, 1)))
    # bls12-381 G1 has a cofactor: a curve point outside the subgroup
    bls = CV.BLS12_381
    q = bls.fq.p
    x = 1
    while True:
        rhs = (x ** 3 + 4) % q
        y = pow(rhs, (q + 1) // 4, q)
        if y * y % q == rhs and not CV.g1_well_formed(bls, (x, y)):
            break
        x += 1
    assert not RCV.g1_well_formed(RCV.BLS12_381, (x, y))
    with pytest.raises(ValueError):
        K.g1_from_bytes(bls, K.g1_to_bytes(bls, (x, y)))
    with pytest.raises(ValueError):
        RK.g1_from_bytes(RCV.BLS12_381, K.g1_to_bytes(bls, (x, y)))


# ---------------------------------------------------------------------------
# the basic scheme
# ---------------------------------------------------------------------------

def test_basic_scheme_equals_the_reference(srs):
    ref, port = srs
    rng = random.Random(0x5E)
    coeffs = [rng.randrange(FS.p) for _ in range(16)]
    z = rng.randrange(FS.p)
    f, rf = Poly.from_ints(FS, coeffs, "cpu"), RPoly.from_ints(RFS, coeffs)
    c = K.commit_one(port, coeffs)
    assert c == RK.commit_one(ref, coeffs)
    assert K.commit_poly(port, f) == c
    ev = f.evaluate(z)
    assert ev == rf.evaluate(z)
    proof = K.proof_eval_one(port, f, z)
    assert proof == RK.proof_eval_one(ref, rf, z)
    assert K.verify_eval_one(port, proof, c, z, ev)
    assert RK.verify_eval_one(ref, proof, c, z, ev)
    assert not K.verify_eval_one(port, proof, c, z, (ev + 1) % FS.p)
    assert not K.verify_eval_one(port, proof, c, (z + 1) % FS.p, ev)


def test_divide_by_linear_inside_and_outside_the_domain():
    """z in the transform's domain (where the reference takes the host
    synthetic division) and a random z: the coset division equals the
    reference and the long division."""
    rng = random.Random(8)
    coeffs = [rng.randrange(FS.p) for _ in range(8)]
    omega = FS.root_of_unity(8)
    for z in (pow(omega, 3, FS.p), 1, rng.randrange(FS.p)):
        got = Poly.from_ints(FS, coeffs, "cpu").divide_by_linear(z).to_ints()
        assert got == RPoly.from_ints(RFS, coeffs).divide_by_linear(z) \
            .to_ints()
        out, acc = [0] * 7, 0
        for i in range(7, 0, -1):
            acc = (acc * z + coeffs[i]) % FS.p
            out[i - 1] = acc
        assert got == out


def test_divide_by_roots_equals_one_root_at_a_time():
    """The one-pass exact division by prod (x - r) (the schemes' quotients)
    against `divide_by_linear` by each root in turn, with random roots and
    with a root inside the transform's domain."""
    rng = random.Random(9)
    omega = FS.root_of_unity(16)
    for roots in ([rng.randrange(FS.p) for _ in range(3)],
                  [rng.randrange(FS.p), pow(omega, 5, FS.p)]):
        base = Poly.from_ints(FS, [rng.randrange(FS.p) for _ in range(9)],
                              "cpu")
        for r in roots:
            base = base * Poly.from_ints(FS, [(-r) % FS.p, 1], "cpu")
        one_at_a_time = base
        for r in roots:
            one_at_a_time = one_at_a_time.divide_by_linear(r)
        got = TPOLY.divide_by_roots(base, roots)
        assert got.n == one_at_a_time.n == 9
        assert got.to_ints() == one_at_a_time.to_ints()


# ---------------------------------------------------------------------------
# the stateful schemes
# ---------------------------------------------------------------------------

# (batch sizes: coefficient counts), points per batch: ("z1", "z2") indices
LAYOUTS = {
    "v2": ("V2", {0: [8, 8], 1: [12]}, {0: (0, 1), 1: (0,)}),
    "bdfg": ("BDFG", {0: [8, 8], 1: [12]}, {0: (0, 1), 1: (0,)}),
}


class SchemeCase:
    """One layout committed, opened and proved by both packages from the
    same integers."""

    def __init__(self, name, ref_params, params):
        kind, sizes, points = LAYOUTS[name]
        self.kind = kind
        rng = random.Random(0x5E + list(LAYOUTS).index(name))
        self.coeffs = {k: [[rng.randrange(FS.p) for _ in range(n)]
                           for n in ns] for k, ns in sizes.items()}
        zs = [rng.randrange(FS.p), rng.randrange(FS.p)]
        self.points = {k: [zs[i] for i in idx] for k, idx in points.items()}
        self.ref_params, self.params = ref_params, params
        self.ref_mod = RK
        self.ref_proof, self.ref_roots, self.ref_next = self._prove(
            getattr(RK, f"KZGScheme{kind}")(ref_params),
            lambda c: RPolyDFS.from_poly(RPoly.from_ints(RFS, c)),
            RTranscript)
        self.proof, self.roots, self.next = self._prove(
            getattr(K, f"KZGScheme{kind}")(params, "cpu"),
            lambda c: PolyDFS.from_poly(Poly.from_ints(FS, c, "cpu")),
            Transcript)

    def _prove(self, scheme, make, transcript):
        roots = {}
        for k, cs in self.coeffs.items():
            scheme.append_to_batch(k, [make(c) for c in cs])
            roots[k] = scheme.commit(k)
        for k, pts in self.points.items():
            for z in pts:
                scheme.append_eval_point(k, z)
        tr = transcript("keccak_256", SEED)
        proof = scheme.proof_eval(tr)
        return proof, roots, tr.challenge(FS)

    def verifier(self, mod, params, transcript=Transcript):
        v = getattr(mod, f"KZGScheme{self.kind}")(params)
        for k, cs in self.coeffs.items():
            v.set_batch_size(k, len(cs))
        for k, pts in self.points.items():
            for z in pts:
                v.append_eval_point(k, z)
        return v, transcript("keccak_256", SEED)


@pytest.fixture(scope="module")
def cases(srs):
    ref, _ = srs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "DEVICE_MSM_MIN", 8)
        mp.setattr(K, "COMMIT_WINDOW_BITS", 5)
        params = K.KZGParams.setup(CURVE, 16, tau=TAU, d2=8, device="cpu")
        runs = []
        real = MA.MSMBases.run_limbs
        mp.setattr(MA.MSMBases, "run_limbs",
                   lambda self, *a, **kw: runs.append(1) or real(self, *a,
                                                                 **kw))
        out = {name: SchemeCase(name, ref, params) for name in LAYOUTS}
    assert len(runs) >= 3 * len(LAYOUTS)   # the tensor commit path ran
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_scheme_equals_the_reference(cases, name):
    c = cases[name]
    assert c.roots == c.ref_roots
    assert CONV.kzg_proof_fields(c.proof) == CONV.kzg_proof_fields(
        c.ref_proof)
    assert c.next == c.ref_next


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_each_verifier_accepts_the_other_proof(cases, name):
    c = cases[name]
    as_ref = CONV.kzg_proof_from_fields(CONV.kzg_proof_fields(c.proof), RK,
                                        RB)
    v, tr = c.verifier(RK, c.ref_params, RTranscript)
    assert v.verify_eval(as_ref, c.roots, tr)
    assert tr.challenge(RFS) == c.next
    as_port = CONV.kzg_proof_from_fields(CONV.kzg_proof_fields(c.ref_proof))
    v, tr = c.verifier(K, c.params)
    assert v.verify_eval(as_port, c.ref_roots, tr)
    assert tr.challenge(FS) == c.next


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_rejects_a_tampered_evaluation(cases, name):
    c = cases[name]
    bad = CONV.kzg_proof_from_fields(CONV.kzg_proof_fields(c.proof))
    bad.z.z[0][0][0] = (bad.z.z[0][0][0] + 1) % FS.p
    v, tr = c.verifier(K, c.params)
    assert not v.verify_eval(bad, c.roots, tr)


def test_bdfg_verifier_asks_for_enough_g2_powers(cases):
    c = cases["bdfg"]
    short = K.KZGParams(CURVE, c.params.commitment_key,
                        c.params.verification_key[:2])
    v, tr = c.verifier(K, short)
    with pytest.raises(ValueError, match="d2=3"):
        v.verify_eval(c.proof, c.roots, tr)


def test_fork_shares_the_fixed_batch_and_nothing_else(srs):
    _, params = srs
    rng = random.Random(11)
    scheme = K.KZGSchemeV2(params, "cpu")
    for k in (0, 1):
        scheme.append_to_batch(k, [PolyDFS.from_poly(Poly.from_ints(
            FS, [rng.randrange(FS.p) for _ in range(4)], "cpu"))])
        scheme.commit(k)
    scheme.mark_batch_as_fixed(0)
    scheme.append_eval_point(0, 5)
    fork = scheme.fork()
    assert type(fork) is K.KZGSchemeV2 and fork.device == "cpu"
    assert list(fork._polys) == list(fork._commitments) == [0]
    assert fork._polys[0][0] is scheme._polys[0][0]
    assert fork._coeffs[0] is scheme._coeffs[0]
    assert fork._commitments[0] == scheme._commitments[0]
    assert fork._points == {0: [[]]} and fork._z.z == {}
    assert fork.params is params


def test_entry_points_default_to_the_card(srs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, params = srs
    with pytest.raises(RuntimeError):
        M.msm(CURVE, [CURVE.g1], [3])
    with pytest.raises(RuntimeError):
        K.KZGParams.setup(CURVE, 4, tau=3)
    with pytest.raises(RuntimeError):
        params.msm_bases(None)
    for cls in (K.KZGSchemeV2, K.KZGSchemeBDFG):
        scheme = cls(params)
        scheme.append_to_batch(0, PolyDFS.from_poly(
            Poly.from_ints(FS, [1, 2, 3], "cpu")))
        with pytest.raises(RuntimeError):
            scheme.commit(0)
