"""The port's last host-only modules against the JAX package's, on the CPU:
`utils/{serialization,tvm,algebraic_engine,sparse_vector,checkpoint,
metrics,zkllvm}.py` and `arithmetization/{non_linear_combination,routing,
pairing_gadget}.py`, from the same seeded inputs, with the cases of
`tests/test_aux_components.py`, `tests/test_conformance.py:227`,
`tests/test_routing.py`, `tests/test_pairing_gadget.py` and
`tests/test_zkllvm_circuits.py`. Keys and proofs are the port's (made on
the CPU); each package's serializer turns them into the same bytes. Exact
equality throughout. (`utils/profiling.py` is held in
`test_torch_parallel.py`, beside the proof it reports on.)"""
import os
import random

import numpy as np
import pytest

from crypto3_zk_tpu.arithmetization import non_linear_combination as RNLC
from crypto3_zk_tpu.arithmetization import pairing_gadget as RPG
from crypto3_zk_tpu.arithmetization import plonk as RPK
from crypto3_zk_tpu.arithmetization import routing as RROUT
from crypto3_zk_tpu.fields import curves as RCV
from crypto3_zk_tpu.fields import mnt as RMNT
from crypto3_zk_tpu.ops.msm import msm_host
from crypto3_zk_tpu.utils import algebraic_engine as RAE
from crypto3_zk_tpu.utils import checkpoint as RCK
from crypto3_zk_tpu.utils import metrics as RMX
from crypto3_zk_tpu.utils import serialization as RSER
from crypto3_zk_tpu.utils import sparse_vector as RSV
from crypto3_zk_tpu.utils import tvm as RTVM
from crypto3_zk_tpu.utils import zkllvm as RZ
from crypto3_zk_tpu_torch.arithmetization import non_linear_combination as NLC
from crypto3_zk_tpu_torch.arithmetization import pairing_gadget as PG
from crypto3_zk_tpu_torch.arithmetization import plonk as PK
from crypto3_zk_tpu_torch.arithmetization import r1cs as R
from crypto3_zk_tpu_torch.arithmetization import routing as ROUT
from crypto3_zk_tpu_torch.fields import curves as CV
from crypto3_zk_tpu_torch.fields import mnt as MNT
from crypto3_zk_tpu_torch.models import groth16 as G16
from crypto3_zk_tpu_torch.utils import algebraic_engine as AE
from crypto3_zk_tpu_torch.utils import checkpoint as CK
from crypto3_zk_tpu_torch.utils import metrics as MX
from crypto3_zk_tpu_torch.utils import serialization as SER
from crypto3_zk_tpu_torch.utils import sparse_vector as SV
from crypto3_zk_tpu_torch.utils import tvm as TVM
from crypto3_zk_tpu_torch.utils import zkllvm as Z

import torch_threads  # noqa: F401  one torch thread a worker


def power_chain(curve, n):
    """x (primary); a_1 = x^2, a_{i+1} = a_i * x (`test_groth16.py:14`)."""
    p = curve.fr.p
    cs = R.R1CSConstraintSystem(primary_input_size=1, auxiliary_input_size=n)
    cs.add_constraint(R.lc((1, 1)), R.lc((1, 1)), R.lc((2, 1)))
    for i in range(1, n):
        cs.add_constraint(R.lc((1 + i, 1)), R.lc((1, 1)), R.lc((2 + i, 1)))
    x, aux, v = 7, [], 7
    for _ in range(n):
        v = v * x % p
        aux.append(v)
    return cs, [x], aux


# ---------------------------------------------------------------------------
# serialization, tvm (`test_aux_components.py:27`, `test_conformance.py:227`)
# ---------------------------------------------------------------------------

def test_groth16_serialization_roundtrip():
    curve, rcurve = CV.ALT_BN128, RCV.ALT_BN128
    rng = random.Random(0xA2)
    cs, primary, aux = power_chain(curve, 4)
    kp = G16.generate(curve, cs, rng=rng, device="cpu")
    proof = G16.prove(kp.pk, primary, aux, rng=rng, device="cpu")
    blob = SER.groth16_proof_to_bytes(curve, proof)
    assert blob == RSER.groth16_proof_to_bytes(rcurve, proof)
    assert SER.groth16_proof_from_bytes(curve, blob) == proof
    vk_blob = SER.groth16_vk_to_bytes(curve, kp.vk)
    assert vk_blob == RSER.groth16_vk_to_bytes(rcurve, kp.vk)
    vk2 = SER.groth16_vk_from_bytes(curve, vk_blob)
    pi_blob = SER.primary_input_to_bytes(curve, primary)
    assert pi_blob == RSER.primary_input_to_bytes(rcurve, primary)
    assert G16.verify(vk2, SER.primary_input_from_bytes(curve, pi_blob),
                      SER.groth16_proof_from_bytes(curve, blob))
    with pytest.raises(ValueError):
        SER.groth16_proof_from_bytes(curve, blob[:-1])


@pytest.fixture(scope="module")
def bls_instance():
    curve = CV.BLS12_381
    cs = R.R1CSConstraintSystem(primary_input_size=2, auxiliary_input_size=1)
    cs.add_constraint(R.lc((1, 1)), R.lc((2, 1)), R.lc((3, 1)))  # x1*x2 = a1
    kp = G16.generate(curve, cs, rng=random.Random(5), device="cpu")
    proof = G16.prove(kp.pk, [3, 4], [12], rng=random.Random(6),
                      device="cpu")
    return kp, proof


def test_tvm_verifier_input_roundtrip(bls_instance):
    curve, rcurve = CV.BLS12_381, RCV.BLS12_381
    kp, proof = bls_instance
    primary = [3, 4]
    assert G16.verify(kp.vk, primary, proof)
    blob = TVM.verifier_input_to_bytes(curve, kp.vk, primary, proof)
    assert blob == RTVM.verifier_input_to_bytes(rcurve, kp.vk, primary, proof)
    vk2, primary2, proof2 = TVM.verifier_input_from_bytes(curve, blob)
    assert primary2 == primary and proof2 == proof
    assert vk2.alpha_g1_beta_g2 == kp.vk.alpha_g1_beta_g2
    assert vk2.gamma_ABC_g1 == kp.vk.gamma_ABC_g1
    assert G16.verify(vk2, primary2, proof2)
    bad = bytearray(blob)
    bad[20] ^= 0x01              # g_A's x: no square root, or off-subgroup
    with pytest.raises(ValueError):
        TVM.verifier_input_from_bytes(curve, bytes(bad))


def test_tvm_proving_key_roundtrip():
    curve, rcurve = CV.BLS12_381, RCV.BLS12_381
    cs = R.R1CSConstraintSystem(primary_input_size=1, auxiliary_input_size=2)
    cs.add_constraint(R.lc((1, 1)), R.lc((1, 1)), R.lc((2, 1)))
    cs.add_constraint(R.lc((2, 1), (0, 5)), R.lc((1, 1)), R.lc((3, 1)))
    kp = G16.generate(curve, cs, rng=random.Random(9), device="cpu")
    blob = TVM.proving_key_to_bytes(curve, kp.pk)
    assert blob == RTVM.proving_key_to_bytes(rcurve, kp.pk)
    pk2 = TVM.proving_key_from_bytes(curve, blob)
    assert pk2.A_query == kp.pk.A_query
    assert pk2.B_query_g2 == kp.pk.B_query_g2
    assert pk2.H_query == kp.pk.H_query
    assert [c.a.terms for c in pk2.constraint_system.constraints] \
        == [c.a.terms for c in cs.constraints]
    x = 3
    aux = [x * x % curve.fr.p, (x * x + 5) * x % curve.fr.p]
    proof = G16.prove(pk2, [x], aux, rng=random.Random(10), device="cpu")
    assert G16.verify(kp.vk, [x], proof)


# ---------------------------------------------------------------------------
# non-linear combinations, the algebraic engine, sparse vectors
# ---------------------------------------------------------------------------

def test_non_linear_combination():
    p = CV.ALT_BN128.fr.p
    vals = {0: 5, 1: 7}
    out = []
    for pk, nlc in ((PK, NLC), (RPK, RNLC)):
        w0, w1 = pk.Var(0), pk.Var(1)
        e = pk.BinOp("*", pk.BinOp("+", w0, pk.Const(3)), pk.Pow(w1, 2))
        c = nlc.expression_to_non_linear_combination(e).collect(p)
        want = pk.evaluate_expr(e, lambda v: vals[v.index] % p,
                                lambda k: k % p) % p
        assert c.evaluate(p, lambda v: vals[v.index]) == want
        assert c.max_degree() == 3
        back = c.to_expression()
        assert pk.evaluate_expr(back, lambda v: vals[v.index] % p,
                                lambda k: k % p) % p == want
        out.append((want, [(t.coeff, str(t.vars)) for t in c.terms],
                    str(back)))
    assert out[0] == out[1]


def test_algebraic_engine_and_accumulation_vector():
    curve, rcurve = CV.ALT_BN128, RCV.ALT_BN128
    e1, e2 = AE.AlgebraicEngine(42), RAE.AlgebraicEngine(42)
    assert e1.field_elements(curve.fr, 5) == e2.field_elements(rcurve.fr, 5)
    assert e1.g1(curve) == e2.g1(rcurve)
    assert AE.AlgebraicEngine(b"seed").g2(curve) == \
        RAE.AlgebraicEngine(b"seed").g2(rcurve)
    eng = AE.AlgebraicEngine(7)
    ic = [eng.g1(curve) for _ in range(4)]
    xs = [eng.field_element(curve.fr) for _ in range(3)]
    folded = SV.AccumulationVector.from_dense(ic).accumulate_chunk(
        curve, xs, device="cpu")
    ref = RSV.AccumulationVector.from_dense(ic).accumulate_chunk(rcurve, xs)
    want = ic[0]
    for pt, x in zip(ic[1:], xs):
        want = CV.g1_add(curve, want, CV.g1_mul(curve, pt, x))
    assert folded.first == ref.first == want
    assert folded.rest.indices == ref.rest.indices == []


def test_sparse_accumulator_streaming():
    curve, rcurve = CV.ALT_BN128, RCV.ALT_BN128
    eng = AE.AlgebraicEngine(11)
    ic = [eng.g1(curve) for _ in range(5)]
    xs = [eng.field_element(curve.fr) for _ in range(4)]
    acc = SV.SparseAccumulator(curve, SV.AccumulationVector.from_dense(ic),
                               device="cpu")
    acc(xs[:2], 0)
    acc(xs[2:], 2)
    ref = RSV.SparseAccumulator(rcurve,
                                RSV.AccumulationVector.from_dense(ic))
    ref(xs[:2], 0)
    ref(xs[2:], 2)
    got, rest = acc.result()
    assert got == ref.result()[0] and rest.indices == []
    sv = SV.SparseVector.from_dense([None, 1, None, 2])
    assert sv.is_valid() and sv.to_dense() == [None, 1, None, 2]


# ---------------------------------------------------------------------------
# checkpoints (`test_aux_components.py:247`, `:259`)
# ---------------------------------------------------------------------------

def test_checkpoint_manager_roundtrip(tmp_path):
    for mod, sub in ((CK, "port"), (RCK, "ref")):
        mgr = mod.CheckpointManager(str(tmp_path / sub))
        mgr.save(3, arrays={"x": np.arange(5)}, meta={"stage": "ntt"})
        mgr.save(7, meta={"stage": "msm"})
        assert mgr.latest() == 7
        arrays, meta = mgr.load(3)
        assert meta["stage"] == "ntt" and list(arrays["x"]) == [0, 1, 2, 3, 4]
        assert mgr.load(99) is None
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))


def test_msm_checkpoint_resume(tmp_path):
    """Whole, replayed from disk and resumed after a cut at half the
    windows: always `msm_host`'s point; another job's checkpoint is not
    resumed. The windows run one at a time through `MSMBases.window_totals`
    (the plain versions of kernels 1, 3, 4 and the tail here)."""
    curve = CV.ALT_BN128
    rng = random.Random(0xC4)
    n = 8
    pts = [CV.g1_mul(curve, curve.g1, rng.randrange(1, curve.fr.p))
           for _ in range(n)]
    sc = [rng.randrange(curve.fr.p) for _ in range(n)]
    want = msm_host(RCV.ALT_BN128, pts, sc)
    d = str(tmp_path)
    assert CK.msm_checkpointed(curve, pts, sc, d, c=8, device="cpu") == want
    assert CK.msm_checkpointed(curve, pts, sc, d, c=8, device="cpu") == want
    mgr = CK.CheckpointManager(d)
    _, meta = mgr.load("msm")
    windows = len(meta["window_results"])
    meta["window_results"] = meta["window_results"][:windows // 2]
    mgr.save("msm", meta=meta)
    assert CK.msm_checkpointed(curve, pts, sc, d, c=8, device="cpu") == want
    assert len(mgr.load("msm")[1]["window_results"]) == windows
    # another job (zero scalars, whose windows cost nothing) must not take
    # the checkpoint's windows
    assert CK.msm_checkpointed(curve, pts, [0] * n, d, c=8,
                               device="cpu") is None


# ---------------------------------------------------------------------------
# metrics (`test_aux_components.py:275`)
# ---------------------------------------------------------------------------

def test_metrics_roofline():
    for mx in (MX, RMX):
        mx.reset()
    assert MX.ntt_cost(1 << 20, 16) == RMX.ntt_cost(1 << 20, 16)
    assert MX.msm_cost(1 << 16, 8, 254) == RMX.msm_cost(1 << 16, 8, 254)
    muls, byts = MX.ntt_cost(1 << 20, 16)
    r = MX.record("ntt_2^20", 0.1, muls, byts)
    assert 0 < r.roofline_fraction
    with MX.timed_kernel("noop"):
        pass
    s = MX.summary()
    assert s[0]["kernel"] == "ntt_2^20" and len(s) == 2
    RMX.record("ntt_2^20", 0.1, muls, byts)
    assert s[0].keys() == RMX.summary()[0].keys()
    MX.reset()
    RMX.reset()
    assert MX.summary() == []


# ---------------------------------------------------------------------------
# routing (`tests/test_routing.py`)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
def test_benes_routes_random_permutations(n):
    rng = random.Random(0xBE + n)
    for _ in range(10):
        pi = list(range(n))
        rng.shuffle(pi)
        net = ROUT.benes_route(pi)
        assert net == RROUT.benes_route(pi)
        out = ROUT.apply_routing(net, list(range(n)))
        assert all(out[pi[i]] == i for i in range(n))


@pytest.mark.parametrize("n", [2, 3, 5, 6, 7, 9, 12, 17, 33])
def test_as_waksman_routes_arbitrary_sizes(n):
    rng = random.Random(0xA5 + n)
    for _ in range(10):
        pi = list(range(n))
        rng.shuffle(pi)
        net = ROUT.as_waksman_route(pi)
        assert net == RROUT.as_waksman_route(pi)
        out = ROUT.apply_routing(net, list(range(n)))
        assert out == RROUT.apply_routing(net, list(range(n)))
        assert all(out[pi[i]] == i for i in range(n))


def test_integer_permutation():
    """As the reference's, with ValueError where it asserts."""
    pi = ROUT.IntegerPermutation([2, 0, 3, 1])
    assert pi.inverse().mapping == [1, 3, 0, 2]
    assert pi.compose(pi.inverse()).is_identity()
    with pytest.raises(ValueError):
        ROUT.IntegerPermutation([0, 0, 1])
    with pytest.raises(ValueError):
        ROUT.benes_route([0, 2, 1])
    with pytest.raises(ValueError):
        ROUT.as_waksman_route([0, 0])


# ---------------------------------------------------------------------------
# pairing gadgets (`tests/test_pairing_gadget.py`)
# ---------------------------------------------------------------------------

def test_ext_mul_inv_gadgets_match_host():
    curve = MNT.MNT4
    F = curve.ext
    rng = random.Random(3)
    a_val = tuple(rng.randrange(curve.p) for _ in range(F.k))
    b_val = tuple(rng.randrange(curve.p) for _ in range(F.k))
    got = []
    for pg, c in ((PG, curve), (RPG, RMNT.MNT4)):
        bld = pg.Builder(c.p)
        a = pg.ext_var(bld, a_val)
        b = pg.ext_var(bld, b_val)
        prod = pg.ext_val(bld, c.ext, pg.ext_mul(bld, c.ext, a, b))
        inv = pg.ext_val(bld, c.ext, pg.ext_inv(bld, c.ext, a))
        fro = pg.ext_val(bld, c.ext, pg.ext_frobenius2(c.ext, a))
        assert bld.is_satisfied()
        got.append((prod, inv, fro, len(bld.constraints), bld.values))
    assert got[0] == got[1]
    assert got[0][:3] == (F.mul(a_val, b_val), F.inv(a_val),
                          F.pow(a_val, curve.p ** 2))


def test_pairing_product_bilinearity_check():
    """e(sP, Q) * e(P, sQ)^-1 == 1 in-circuit, the same system as the
    reference's; a tampered witness breaks a constraint."""
    built = []
    for pg, mnt in ((PG, MNT), (RPG, RMNT)):
        curve = mnt.MNT4
        F = curve.ext
        s = 0x1234567
        sP = mnt.g1_mul(curve, curve.g1, s)
        sQ = mnt.g2_mul(curve, curve.g2, s)
        bld = pg.Builder(curve.p)
        Pv = pg.g1_var(bld, sP)
        Pv2 = pg.g1_var(bld, curve.g1)
        pg.g1_on_curve(bld, curve, Pv)
        Qc = (pg.ext_const(F, curve.g2[0]), pg.ext_const(F, curve.g2[1]))
        Qc2 = (pg.ext_const(F, sQ[0]), pg.ext_const(F, sQ[1]))
        pg.pairing_product_check(bld, curve, [(Pv, Qc, +1), (Pv2, Qc2, -1)])
        assert bld.is_satisfied()
        built.append(bld)
    bld, ref = built
    assert bld.values == ref.values
    assert len(bld.constraints) == len(ref.constraints)
    cs, aux = bld.to_r1cs()
    assert MNT.MNT4.p == MNT.MNT6.r
    assert cs.is_satisfied(MNT.MNT4.p, [], aux)
    bld.values[1] = (bld.values[1] + 1) % MNT.MNT4.p
    assert not bld.is_satisfied()


@pytest.fixture(scope="module")
def mnt4_proof():
    """A real Groth16 proof over MNT4 by the port (host scalar layer: MNT
    curves never take the device path)."""
    curve = MNT.MNT4
    rng = random.Random(5)
    cs, primary, aux = power_chain(curve, 8)
    kp = G16.generate(curve, cs, rng=rng, device="cpu")
    proof = G16.prove(kp.pk, primary, aux, rng=rng, device="cpu")
    assert G16.verify(kp.vk, primary, proof)
    return kp, primary, proof


def test_groth16_proof_verified_in_circuit(mnt4_proof):
    """A real MNT4 proof passes the in-circuit pairing-product check (A, B,
    C and the input accumulator as variables); a wrong accumulator does
    not."""
    curve = MNT.MNT4
    F = curve.ext
    kp, primary, proof = mnt4_proof
    vk = kp.vk
    acc = vk.gamma_ABC_g1[0]
    for i, x in enumerate(primary):
        acc = CV.g1_add(curve, acc, CV.g1_mul(curve, vk.gamma_ABC_g1[i + 1],
                                              x))
    gamma = (PG.ext_const(F, vk.gamma_g2[0]), PG.ext_const(F, vk.gamma_g2[1]))
    delta = (PG.ext_const(F, vk.delta_g2[0]), PG.ext_const(F, vk.delta_g2[1]))
    k_const = F.inv(vk.alpha_g1_beta_g2)

    def check(acc_point):
        bld = PG.Builder(curve.p)
        Av = PG.g1_var(bld, proof.g_A)
        Cv = PG.g1_var(bld, proof.g_C)
        accv = PG.g1_var(bld, acc_point)
        Bv = (PG.ext_var(bld, proof.g_B[0]), PG.ext_var(bld, proof.g_B[1]))
        PG.g1_on_curve(bld, curve, Av)
        PG.g1_on_curve(bld, curve, Cv)
        PG.pairing_product_check(
            bld, curve, [(Av, Bv, +1), (accv, gamma, -1), (Cv, delta, -1)],
            const_factor=k_const)
        return bld.is_satisfied()

    assert check(acc)
    try:
        satisfied = check(CV.g1_add(curve, acc, vk.gamma_ABC_g1[1]))
    except AssertionError:
        satisfied = False
    assert not satisfied


def test_complete_groth16_verifier_gadget(mnt4_proof):
    """`groth16_verify_gadget` is the reference's system plus B's on-curve
    constraints (`ext_on_curve`: 3 extension products of 2k - 1 and k
    equalities), satisfied by a real proof and broken by a changed input;
    a B off its curve breaks it too, and an input count that differs from
    the key's is refused (the reference drops the extra inputs)."""
    curve = MNT.MNT4
    k = curve.ext.k
    kp, primary, proof = mnt4_proof

    def build(pg, mnt_curve, b_y=None, inputs=None):
        bld = pg.Builder(mnt_curve.p)
        x_lcs = [bld.aux(v) for v in (primary if inputs is None else inputs)]
        Av = pg.g1_var(bld, proof.g_A)
        Cv = pg.g1_var(bld, proof.g_C)
        Bv = (pg.ext_var(bld, proof.g_B[0]),
              pg.ext_var(bld, proof.g_B[1] if b_y is None else b_y))
        pg.groth16_verify_gadget(bld, mnt_curve, kp.vk, x_lcs, Av, Bv, Cv)
        return bld

    bld, ref = build(PG, curve), build(RPG, RMNT.MNT4)
    assert bld.is_satisfied() and ref.is_satisfied()
    assert len(bld.constraints) == len(ref.constraints) + 3 * (2 * k - 1) + k
    bld.values[1] = (bld.values[1] + 1) % curve.p
    assert not bld.is_satisfied()
    y = list(proof.g_B[1])
    y[0] = (y[0] + 1) % curve.p
    assert not build(PG, curve, b_y=tuple(y)).is_satisfied()
    with pytest.raises(ValueError):
        build(PG, curve, inputs=list(primary) + [1])


def test_ext_on_curve_and_the_k6_refusal():
    curve = MNT.MNT4
    F = curve.ext
    for pt, ok in ((curve.g2, True), ((curve.g2[0], F.neg(F.one())), False)):
        bld = PG.Builder(curve.p)
        PG.ext_on_curve(bld, curve, (PG.ext_var(bld, pt[0]),
                                     PG.ext_var(bld, pt[1])))
        assert bld.is_satisfied() is ok
    bld = PG.Builder(MNT.MNT6.p)
    with pytest.raises(NotImplementedError):
        PG.final_exponentiation(bld, MNT.MNT6,
                                PG.ext_const(MNT.MNT6.ext, MNT.MNT6.ext.one()))


# ---------------------------------------------------------------------------
# zkLLVM dumps (`tests/test_zkllvm_circuits.py`): the parser
# ---------------------------------------------------------------------------

from test_zkllvm_circuits import DATA, MERKLE  # noqa: E402  the dumps' place


def _needs_data():
    if not os.path.isdir(DATA):
        pytest.skip("reference circuit dumps not present")


def _u64(v):
    return v.to_bytes(8, "big")


def _var(index, rotation, col_type):
    return _u64(index) + rotation.to_bytes(4, "big", signed=True) \
        + bytes([0, col_type])


def _write_dumps(tmp_path):
    """A small `.crct` (two gates, a copy constraint, a lookup gate and
    table) and a `.tbl` of 4 columns by 4 rows, in the documented format."""
    fe = lambda v: v.to_bytes(32, "big")                       # noqa: E731
    ref = lambda kind, idx: bytes([kind]) + idx.to_bytes(4, "big")  # noqa
    w0, w1, w2 = (_var(i, 0, 0) for i in range(3))
    # w0 * w1 - 3 * w2^2 : terms [w0*w1, 3*w2], pow [(2, term 1)],
    # binop [("-", term 0, pow 0)]
    expr1 = (_u64(2) + fe(1) + _u64(2) + w0 + w1 + fe(3) + _u64(1) + w2
             + _u64(1) + _u64(2) + ref(0, 1)
             + _u64(1) + bytes([1]) + ref(0, 0) + ref(1, 0) + ref(2, 0))
    # w0 (rotation 1) + 5
    expr2 = (_u64(2) + fe(1) + _u64(1) + _var(0, 1, 0) + fe(5) + _u64(0)
             + _u64(0) + _u64(1) + bytes([0]) + ref(0, 0) + ref(0, 1)
             + ref(2, 0))
    crct = (_u64(2) + _u64(0) + _u64(1) + expr1 + _u64(1) + _u64(1) + expr2
            + _u64(1) + _var(1, 2, 0) + _var(0, 0, 1)
            + _u64(1) + _u64(1) + _u64(1) + _u64(0) + _u64(1) + expr2
            + _u64(1) + _u64(0) + _u64(1) + _u64(2) + _var(0, 0, 2)
            + _var(0, 1, 2))
    tbl = _u64(3) + _u64(4) + _u64(16) + b"".join(fe(v) for v in range(16))
    paths = tmp_path / "c.crct", tmp_path / "a.tbl"
    paths[0].write_text("0x" + crct.hex())
    paths[1].write_text("0x" + tbl.hex())
    return [str(p) for p in paths]


def _circuit_summary(cs):
    return ([(g.selector_index, [str(c) for c in g.constraints])
             for g in cs.gates],
            [(str(a), str(b)) for a, b in cs.copy_constraints],
            [(g.tag_index, [(c.table_id, [str(e) for e in c.lookup_input])
                            for c in g.constraints]) for g in cs.lookup_gates],
            [(t.tag_index, t.columns_number, [[str(v) for v in o]
                                              for o in t.lookup_options])
             for t in cs.lookup_tables])


def test_zkllvm_parser_equals_the_reference(tmp_path):
    crct, tbl = _write_dumps(tmp_path)
    got, want = Z.load_circuit(crct), RZ.load_circuit(crct)
    assert _circuit_summary(got) == _circuit_summary(want)
    assert len(got.gates) == 2
    assert got.max_gates_degree() == want.max_gates_degree() == 2
    split = dict(witness_columns=2, public_input_columns=1,
                 constant_columns=1, selector_columns=0)
    t, r = Z.load_assignment_table(tbl, **split), \
        RZ.load_assignment_table(tbl, **split)
    assert t.public_input == r.public_input == [[8, 9, 10, 11]]
    assert (t.desc.usable_rows_amount, t.desc.rows_amount) == (3, 4)
    assert t.assignment.witnesses == r.assignment.witnesses
    with pytest.raises(ValueError):
        Z.load_assignment_table(tbl)                  # 56 columns != 4
    (tmp_path / "bad.crct").write_text("0x" + _u64(1).hex())
    with pytest.raises(ValueError):
        Z.load_circuit(str(tmp_path / "bad.crct"))   # truncated


def test_merkle_tree_poseidon_loads_like_the_reference():
    _needs_data()
    path = f"{MERKLE}/merkle_tree_posseidon_circuit.crct"
    cs = Z.load_circuit(path)
    assert _circuit_summary(cs) == _circuit_summary(RZ.load_circuit(path))
    assert len(cs.gates) == 13 and len(cs.copy_constraints) == 273
    t = Z.load_assignment_table(
        f"{MERKLE}/merkle_tree_posseidon_assignment.tbl")
    assert t.desc.usable_rows_amount == 475 and t.desc.rows_amount == 512


def test_many_hashes_circuit_parses_like_the_reference():
    _needs_data()
    path = f"{DATA}/many_hashes/many_hashes_circuit.crct"
    assert _circuit_summary(Z.load_circuit(path)) == \
        _circuit_summary(RZ.load_circuit(path))


# ---------------------------------------------------------------------------
# the SASS instruction mix behind kernel 7's issue-rate floor
# ---------------------------------------------------------------------------

SASS = """
        Function : _Z20sha256_blocks_kernelPKjxiPj
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   ULDC.64 UR4, c[0x0][0x218] ;
        /*0030*/                   IMAD.MOV.U32 R2, RZ, RZ, R0 ;
        /*0040*/                   LOP3.LUT R3, R2, R0, RZ, 0x3c, !PT ;
        /*0050*/                   SHF.R.W.U32.HI R4, R3, 0x7, R3 ;
        /*0060*/                   IADD3 R5, R4, R3, R2 ;
        /*0070*/               @P0 BRA 0x40 ;
        /*0080*/                   STG.E [R6.64], R5 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
        /*00b0*/                   NOP;
        Function : _Z19sha256_nodes_kernelPKjxPj
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0010*/                   EXIT ;
"""


def test_sass_mix_counts_a_loop_once_a_trip():
    from crypto3_zk_tpu_torch.tools import sass_mix as SM
    kernels = SM.parse(SASS)
    assert [len(v) for v in kernels.values()] == [11, 2]
    per = SM.mix(kernels["_Z20sha256_blocks_kernelPKjxiPj"], trips=5)
    assert (per["alu"], per["fma"], per["mem"], per["uniform"],
            per["control"], per["total"], per["loop_body"]) == \
        (15, 1, 2, 1, 8, 27, 4)
    ms, by = SM.floor_ms(per, threads=128 * 132, sms=132, clock_hz=1e9)
    assert by == "alu" and ms == pytest.approx(15 / 64 * 128 / 1e9 * 1e3)
    with pytest.raises(ValueError):          # no loop to run 5 times
        SM.mix(kernels["_Z19sha256_nodes_kernelPKjxPj"], trips=5)
    body = kernels["_Z20sha256_blocks_kernelPKjxiPj"]
    with pytest.raises(ValueError):          # two loops
        SM.mix(body + [(0xc0, "BRA", "0x10")], trips=2)


def test_sass_mix_counts_each_loop_by_its_own_trips():
    """Several loops, one nested in another: each instruction counts as
    often as the innermost loop that holds it runs in all."""
    from crypto3_zk_tpu_torch.tools import sass_mix as SM
    body = [(0x00, "IADD3", ""), (0x10, "IMAD", ""),      # outer loop ...
            (0x20, "IMAD", ""), (0x30, "BRA", "0x20"),    # ... inner loop
            (0x40, "LOP3", ""), (0x50, "BRA", "0x10"),    # outer back edge
            (0x60, "EXIT", ""), (0x70, "BRA", "0x70")]
    assert SM.loops(body) == [(0x10, 0x50), (0x20, 0x30)]
    per = SM.mix(body, trips=[8, 57])
    assert (per["alu"], per["fma"], per["control"], per["total"]) == \
        (1 + 8, 8 + 57, 57 + 8 + 1 + 1, 1 + 8 + 57 + 57 + 8 + 8 + 1 + 1)
    with pytest.raises(ValueError):          # a count for each loop
        SM.mix(body, trips=[8])


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem, 1024 bytes cmem[3]
ptxas info    : Compiling entry function '_Z20sha256_blocks_kernelPKjxi11ZkSha256PadPj' for 'sm_90a'
ptxas info    : Function properties for _Z20sha256_blocks_kernelPKjxi11ZkSha256PadPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, 736 bytes cmem[0]
ptxas info    : Compiling entry function '_Z15mxu_pass_kernelILi64EEvPKi' for 'sm_90a'
ptxas info    : Function properties for _Z15mxu_pass_kernelILi64EEvPKi
    936 bytes stack frame, 936 bytes spill stores, 1308 bytes spill loads
ptxas info    : Used 168 registers, 560 bytes cmem[0]
"""


def test_ptxas_table_reads_registers_and_spills_by_kernel():
    """The timing tools' `ptxas -v` reader keeps the kernels its key picks,
    each with its registers, spills and stack frame, and as the tools key
    them (kernel 7 by mangled name, kernel 8 by table side)."""
    from crypto3_zk_tpu_torch.tools import mxu_pass_times as MPT
    from crypto3_zk_tpu_torch.tools import sha256_times as ST
    from crypto3_zk_tpu_torch.tools import timing as T
    assert ST.ptxas_kernels(PTXAS_LOG) == {
        "_Z20sha256_blocks_kernelPKjxi11ZkSha256PadPj": {
            "registers": 72, "spill_stores": 0, "spill_loads": 0,
            "stack_frame": 0}}
    assert MPT.ptxas_by_side(PTXAS_LOG) == {64: {
        "registers": 168, "spill_stores": 936, "spill_loads": 1308,
        "stack_frame": 936}}
    assert T.ptxas_table(PTXAS_LOG, lambda f: None) == {}
