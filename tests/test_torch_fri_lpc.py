"""FRI and LPC of the port (`commitments/fri.py`, `commitments/lpc.py`) on
the CPU: the cases of `tests/test_fri_lpc.py` on the port, and parity with
the JAX package: the same polynomials, points and transcript seed give equal
roots, equal proofs (as plain ints and bytes), the same next challenge, and
each package's verifier accepts the other's proof. Exact equality."""
import copy
import functools
import random

import numpy as np
import pytest
import torch

from crypto3_zk_tpu.commitments import batched as RB
from crypto3_zk_tpu.commitments import fri as RFRI
from crypto3_zk_tpu.commitments import lpc as RLPC
from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.poly import polynomial as RPoly
from crypto3_zk_tpu.transcript import fiat_shamir as RT
from crypto3_zk_tpu_torch import convert as C
from crypto3_zk_tpu_torch.commitments import batched as TB
from crypto3_zk_tpu_torch.commitments import fri as FRI
from crypto3_zk_tpu_torch.commitments import lpc as LPC
from crypto3_zk_tpu_torch.commitments import proof_of_work as POW
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.poly.polynomial import Poly, PolyDFS
from crypto3_zk_tpu_torch.transcript.fiat_shamir import Transcript

import torch_threads  # noqa: F401  one torch thread a worker

FS = TP.BLS12_381_FR
SEED = bytes(range(10))


def _ref_poly(rfs, n, rng):
    return RPoly.PolyDFS.from_poly(
        RPoly.Poly.from_ints(rfs, [rng.randrange(rfs.p) for _ in range(n)]))


def _carry(fs, ref_poly):
    return C.poly_dfs_from_reference(fs, np.asarray(ref_poly.v),
                                     ref_poly.deg, "cpu")


def _rand_dfs(n, rng):
    return PolyDFS.from_poly(
        Poly.from_ints(FS, [rng.randrange(FS.p) for _ in range(n)], "cpu"))


# ---------------------------------------------------------------------------
# FRI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merkle_hash,field", [
    ("poseidon", "BLS12_381_FR"), ("sha2_256", "BLS12_381_FR"),
    ("poseidon_nil", "PALLAS_FQ")])
@pytest.mark.parametrize("steps", [[1, 1, 1], [2, 1]])
def test_fri_single_roundtrip_and_parity(merkle_hash, field, steps):
    rfs, fs = getattr(P, field), getattr(TP, field)
    ref_params = RFRI.FRIParams.build(
        rfs, degree_log=4, expand_factor=2, lambda_=4, step_list=steps,
        merkle_hash=merkle_hash, use_grinding=True, grinding_parameter=0xF)
    params = C.fri_params_from_reference(ref_params.get_params())
    assert params.get_params() == ref_params.get_params()
    assert params.transcript_repr() == ref_params.transcript_repr()
    assert [d.omega for d in params.D] == [d.omega for d in ref_params.D]

    ref_f = _ref_poly(rfs, 16, random.Random(0xF121))
    f = _carry(fs, ref_f)
    pre = FRI.precommit([f], params.D[0], params.step_list[0], params)
    ref_pre = RFRI.precommit([ref_f], ref_params.D[0],
                             ref_params.step_list[0], ref_params)
    root = pre.root()
    assert root == ref_pre.root()

    tr = Transcript("keccak_256", SEED)
    proof = FRI.proof_eval_single(f, pre, params, tr)
    tv = Transcript("keccak_256", SEED)
    assert FRI.verify_eval_single(proof, root, params, tv)
    challenge = tr.challenge(fs)
    assert challenge == tv.challenge(fs)       # transcript equivalence

    rtr = RT.Transcript("keccak_256", SEED)
    ref_proof = RFRI.proof_eval_single(ref_f, ref_pre, ref_params, rtr)
    assert C.fri_proof_as_plain(proof) == C.fri_proof_as_plain(ref_proof)
    assert challenge == rtr.challenge(rfs)
    # each verifier accepts the other package's proof
    carried = C.fri_proof_from_fields(C.fri_proof_fields(proof), RFRI)
    assert RFRI.verify_eval_single(carried, root, ref_params,
                                   RT.Transcript("keccak_256", SEED))
    back = C.fri_proof_from_fields(C.fri_proof_fields(ref_proof))
    assert back == proof
    assert FRI.verify_eval_single(back, root, params,
                                  Transcript("keccak_256", SEED))


def _fri_fixture():
    params = FRI.FRIParams.build(FS, degree_log=4, expand_factor=2,
                                 lambda_=4, merkle_hash="poseidon")
    f = _rand_dfs(16, random.Random(2))
    pre = FRI.precommit([f], params.D[0], params.step_list[0], params)
    proof = FRI.proof_eval_single(f, pre, params, Transcript("keccak_256",
                                                             SEED))
    return params, pre.root(), proof


def test_fri_rejects_tampered_value():
    params, root, proof = _fri_fixture()
    assert FRI.verify_eval_single(proof, root, params,
                                  Transcript("keccak_256", SEED))
    q = proof.query_proofs[0].initial_proof[0]
    v0 = q.values[0][0]
    q.values[0][0] = ((v0[0] + 1) % FS.p, v0[1])
    assert not FRI.verify_eval_single(proof, root, params,
                                      Transcript("keccak_256", SEED))


def test_fri_rejects_wrong_degree():
    params, root, proof = _fri_fixture()
    proof.final_polynomial = proof.final_polynomial + [1] * 10
    assert not FRI.verify_eval_single(proof, root, params,
                                      Transcript("keccak_256", SEED))


@pytest.mark.parametrize("domain_size,fri_step", [(64, 1), (64, 2), (64, 3),
                                                  (16, 4), (8, 1)])
def test_leaf_order_indices_equal_the_enumeration(domain_size, fri_step):
    got = FRI._leaf_order_indices(domain_size, fri_step)
    want = [[i for pair in FRI.coset_enum(leaf, fri_step, domain_size)
             for i in pair] for leaf in range(domain_size >> fri_step)]
    assert got.tolist() == want
    assert got.tolist() == np.asarray(
        RFRI._leaf_order_indices(domain_size, fri_step)).tolist()


def test_index_math_equals_the_reference():
    d, rd = FRI.FRIParams.build(FS, 4).D[0], RFRI.FRIParams.build(
        P.BLS12_381_FR, 4).D[0]
    for j in (0, 1, 17, 63):
        assert FRI.domain_index_of(d, d.element(j)) == j
        assert RFRI.domain_index_of(rd, rd.element(j)) == j
    with pytest.raises(AssertionError):
        FRI.domain_index_of(d, 5)
    for x in (0, 5, 33):
        for step in (1, 2, 3):
            s = FRI.coset_enum(x, step, 64)
            assert s == RFRI.coset_enum(x, step, 64)
            assert FRI.get_correct_order(x, 64, step, s) == \
                RFRI.get_correct_order(x, 64, step, s)
            assert FRI.get_folded_index(x, 64, step) == \
                RFRI.get_folded_index(x, 64, step)
    assert FRI.get_paired_index(5, 64) == 37


def test_fold_halves_the_degree():
    params = FRI.FRIParams.build(FS, degree_log=4, expand_factor=2)
    coeffs = [random.Random(3).randrange(FS.p) for _ in range(16)]
    f = PolyDFS.from_poly(Poly.from_ints(FS, coeffs, "cpu")).resize(64)
    alpha = 0x1234
    g = FRI.fold_dfs(params, f, alpha, params.D[0])
    # f(x) = fe(x^2) + x fo(x^2)  ->  fe + alpha fo
    want = [(coeffs[2 * i] + alpha * coeffs[2 * i + 1]) % FS.p
            for i in range(8)]
    assert (g.n, g.deg) == (32, 8)
    assert g.coefficients().to_ints() == want
    # a smaller domain's table is a strided view of the cached one
    g2 = FRI.fold_dfs(params, g, alpha, params.D[1])
    assert g2.coefficients().to_ints() == \
        [(want[2 * i] + alpha * want[2 * i + 1]) % FS.p for i in range(4)]


# ---------------------------------------------------------------------------
# LPC
# ---------------------------------------------------------------------------

class _LPCRun:
    """One package's LPC run on the fixture of
    `tests/test_fri_lpc.py::_lpc_fixture`: the prover-side scheme, its
    proof, the roots, the prover transcript's next challenge and, for the
    port, the phase clock. `verifier()` makes a fresh verifier-side scheme
    and transcript (a verifier is stateful, so every check takes its own)."""

    def __init__(self, ref, polys, points, degree_log, with_fixed):
        fri_mod, scheme_cls, tr_cls, fs = \
            (RFRI, RLPC.LPCScheme, RT.Transcript, P.BLS12_381_FR) if ref \
            else (FRI, LPC.LPCScheme, Transcript, FS)
        self.fs, self.points, self.with_fixed = fs, points, with_fixed
        self.scheme_cls, self.tr_cls = scheme_cls, tr_cls
        self.params = fri_mod.FRIParams.build(
            fs, degree_log=degree_log, expand_factor=2, lambda_=4,
            merkle_hash="poseidon")
        self.scheme = scheme_cls(self.params)
        for k, batch in enumerate(polys):
            self.scheme.append_to_batch(
                k, batch if ref else [_carry(FS, pl) for pl in batch])
        self.roots = {0: self.scheme.commit(0), 1: self.scheme.commit(1)}
        self._points(self.scheme)
        tr = tr_cls("keccak_256", SEED)
        self.pre_data = None
        if with_fixed:
            self.scheme.mark_batch_as_fixed(1)
            self.pre_data = self.scheme.preprocess(tr_cls("keccak_256", SEED))
            self.scheme.setup(tr, self.pre_data)
        self.clock = None if ref else FRI.PhaseClock("cpu")
        self.proof = self.scheme.proof_eval(tr, *([] if ref else [self.clock]))
        self.challenge = tr.challenge(fs)

    def _points(self, scheme):
        z1, z2 = self.points
        scheme.append_eval_point(0, z1)
        scheme.append_eval_point(0, z2)
        scheme.append_eval_point(1, z1)

    def verifier(self):
        ver = self.scheme_cls(self.params)
        ver.set_batch_size(0, 2)
        ver.set_batch_size(1, 1)
        self._points(ver)
        tv = self.tr_cls("keccak_256", SEED)
        if self.with_fixed:
            ver.mark_batch_as_fixed(1)
            ver.setup(tv, self.pre_data)
        return ver, tv


@functools.lru_cache(maxsize=None)
def _lpc_pair(degree_log, with_fixed, seed=0xF121):
    """The port's and the reference's `_LPCRun` on the same polynomials and
    points, built once per module and shared by the tests that read them
    (a test that tampers with a proof works on a deep copy)."""
    rfs = P.BLS12_381_FR
    rng = random.Random(seed)
    n = 1 << degree_log
    ref_polys = ([_ref_poly(rfs, n, rng) for _ in range(2)],
                 [_ref_poly(rfs, 3 * n // 4, rng)])
    points = (rng.randrange(FS.p), rng.randrange(FS.p))
    return tuple(_LPCRun(ref, ref_polys, points, degree_log, with_fixed)
                 for ref in (False, True))


@pytest.mark.parametrize("degree_log,with_fixed", [(4, False), (4, True),
                                                   (6, True)])
def test_lpc_roundtrip_and_parity(degree_log, with_fixed):
    """degree_log = 6 gives trees of 128 leaves, whose leaves the JAX
    package too hashes by its batched permutation; at 4 it hashes on the
    host. The port's Poseidon trees are batched down to the root at both."""
    ours, theirs = _lpc_pair(degree_log, with_fixed)
    scheme, proof, roots = ours.scheme, ours.proof, ours.roots
    ver, tv = ours.verifier()
    rver, rtv = theirs.verifier()
    rproof = theirs.proof
    assert scheme._trees[0].tree.levels_dev[-1].shape == (FS.nl, 1)
    assert roots == theirs.roots
    assert proof.z.z == rproof.z.z
    assert C.lpc_proof_as_plain(proof) == C.lpc_proof_as_plain(rproof)
    assert scheme.get_params() == theirs.scheme.get_params()
    # the evaluations are the polynomials' values at the points
    for k in (0, 1):
        for j, poly in enumerate(scheme._polys[k]):
            assert proof.z.z[k][j] == [poly.evaluate(pt)
                                       for pt in scheme._points[k][j]]
    # each verifier accepts the other package's proof
    z = RB.EvalStorage()
    z.z = copy.deepcopy(proof.z.z)
    carried = RLPC.LPCProof(z=z, fri_proof=C.fri_proof_from_fields(
        C.fri_proof_fields(proof.fri_proof), RFRI))
    assert rver.verify_eval(carried, theirs.roots, rtv)
    z = TB.EvalStorage()
    z.z = copy.deepcopy(rproof.z.z)
    back = LPC.LPCProof(z=z, fri_proof=C.fri_proof_from_fields(
        C.fri_proof_fields(rproof.fri_proof)))
    assert ver.verify_eval(back, roots, tv)
    assert ours.challenge == tv.challenge(FS) == theirs.challenge \
        == rtv.challenge(P.BLS12_381_FR)
    # the caller's clock took the phases
    assert list(ours.clock.seconds) == [
        "eval_polys", "combined_q", "q_precommit", "fri_commit_phase",
        "fri_query_phase"]


def test_lpc_rejects_tampered_eval():
    ours = _lpc_pair(4, False)[0]
    proof = copy.deepcopy(ours.proof)
    proof.z.z[0][0][0] = (proof.z.z[0][0][0] + 1) % FS.p
    ver, tv = ours.verifier()
    assert not ver.verify_eval(proof, ours.roots, tv)


def test_lpc_verifies_its_own_proof_with_a_fixed_batch():
    ours = _lpc_pair(4, True)[0]
    ver, tv = ours.verifier()
    assert ver.verify_eval(copy.deepcopy(ours.proof), ours.roots, tv)
    assert ours.challenge == tv.challenge(FS)
    assert ours.scheme.get_commitment_params() is ours.scheme.fri_params
    assert ours.scheme.batch_size(0) == 2


def test_proof_of_work_roundtrip():
    t1 = Transcript("keccak_256", SEED)
    t1.absorb(b"ctx")
    nonce = POW.generate(t1, 0xFF)
    t2 = Transcript("keccak_256", SEED)
    t2.absorb(b"ctx")
    assert POW.verify(t2, nonce, 0xFF)
    assert t1.challenge(FS) == t2.challenge(FS)
    t3 = Transcript("keccak_256", SEED)
    n2 = POW.field_generate(t3, FS, 6)
    assert POW.field_verify(Transcript("keccak_256", SEED), FS, n2, 6)
    t5 = Transcript("keccak_256", SEED)
    t5.absorb(b"ctx")
    assert not POW.verify(t5, nonce + 1, 0xFF)
    # the same nonces as the reference's search
    from crypto3_zk_tpu.commitments import proof_of_work as RPOW
    r1 = RT.Transcript("keccak_256", SEED)
    r1.absorb(b"ctx")
    assert RPOW.generate(r1, 0xFF) == nonce
    assert RPOW.field_generate(RT.Transcript("keccak_256", SEED),
                               P.BLS12_381_FR, 6) == n2


def test_batched_helpers_equal_the_reference():
    p = FS.p
    pts, vals = [3, 5, 11], [7, 1, 4]
    coeffs = TB.lagrange_interpolate(p, pts, vals)
    assert coeffs == RB.lagrange_interpolate(p, pts, vals)
    assert [TB.eval_coeffs(p, coeffs, x) for x in pts] == vals
    assert TB.poly_from_roots(p, pts) == RB.poly_from_roots(p, pts)
    assert TB.eval_coeffs(p, TB.poly_from_roots(p, pts), 5) == 0


def test_entry_points_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Poly.from_ints(FS, [1, 2])
    with pytest.raises(RuntimeError):
        PolyDFS.constant(FS, 1, 4)
    with pytest.raises(RuntimeError):
        PolyDFS.from_evals_ints(FS, [1, 2])
    # the Placeholder prover: preprocessing makes its polynomials on the
    # card unless told otherwise, and prove asks for the card
    from crypto3_zk_tpu_torch.models.placeholder import preprocessor as PP
    from crypto3_zk_tpu_torch.models.placeholder.prover import prove
    from crypto3_zk_tpu_torch.tools.placeholder_fixture import PlaceholderRun
    run = PlaceholderRun(4, None, lambda_=4, table_bits=2,
                         merkle_hash="keccak_256")
    with pytest.raises(RuntimeError):
        run.preprocess()
    with pytest.raises(RuntimeError):
        PP.process_private(run.params, run.cs, run.assignment, run.desc)
    run.device = "cpu"
    run.preprocess()
    with pytest.raises(RuntimeError):
        prove(run.params, run.public, run.private, run.desc, run.cs,
              run.scheme.fork())
