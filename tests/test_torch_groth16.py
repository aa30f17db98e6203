"""The slice as a whole, on the CPU: the port's Groth16 prover, generator
and verifier against the JAX package's on a 20-constraint product chain.
With the same key and the same (r, s) both packages must emit the identical
proof (every value is an integer: equality is exact). Also the import rule:
the port imports neither jax nor the JAX package."""
import dataclasses
import pathlib
import re
import subprocess
import sys

import pytest

from crypto3_zk_tpu.arithmetization import qap as QAP
from crypto3_zk_tpu.arithmetization import r1cs as R
from crypto3_zk_tpu.fields import curves as CV
from crypto3_zk_tpu.models import groth16 as G16
from crypto3_zk_tpu_torch import convert as CONV
from crypto3_zk_tpu_torch.arithmetization import qap as TQAP
from crypto3_zk_tpu_torch.arithmetization import r1cs as TR
from crypto3_zk_tpu_torch.fields import curves as TCV
from crypto3_zk_tpu_torch.models import groth16 as TG16

import torch_threads  # noqa: F401  one torch thread a worker

ROOT = pathlib.Path(__file__).resolve().parents[1]
CURVE, TCURVE = CV.ALT_BN128, TCV.ALT_BN128
TOXIC = {"t": 0x1234567, "alpha": 0x2345678, "beta": 0x3456789,
         "gamma": 0x456789A, "delta": 0x56789AB}
NCONS = 20          # 22 variables: the JAX side stays on its host MSM path
ZK_RS = (0xABCDEF, 0x123457)


def product_chain(mod, p, ncons, v1=3, v2=5):
    """v_{i+2} = v_i * v_{i+1}: every variable stands on the A side and on
    the B side, so no query vector of the key is sparse."""
    cs = mod.R1CSConstraintSystem(primary_input_size=1,
                                  auxiliary_input_size=ncons + 1)
    vals = [v1, v2]
    for i in range(ncons):
        cs.add_constraint(mod.lc((1 + i, 1)), mod.lc((2 + i, 1)),
                          mod.lc((3 + i, 1)))
        vals.append(vals[-2] * vals[-1] % p)
    return cs, vals[:1], vals[1:]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def reference():
    cs, primary, aux = product_chain(R, CURVE.fr.p, NCONS)
    kp = G16.generate(CURVE, cs, toxic=TOXIC)
    proof = G16.prove(kp.pk, primary, aux, zk_rs=ZK_RS)
    return kp, primary, aux, proof


@pytest.fixture(scope="module")
def port_keys(reference):
    kp = reference[0]
    return (CONV.proving_key_from_reference(_fields(kp.pk)),
            CONV.verification_key_from_reference(_fields(kp.vk)))


def _msm_on(mp):
    """Lower the port's thresholds so that its batched-affine MSM and its
    fixed-base batch run on a circuit this small."""
    mp.setattr(TG16, "_DEVICE_MSM_MIN", 8)
    mp.setattr(TG16, "_MSM_WINDOW_BITS", 5)
    mp.setattr(TG16, "_FIXED_BASE_DEVICE_MIN", 8)


@pytest.fixture(scope="module")
def port_proof(reference, port_keys):
    from crypto3_zk_tpu_torch.ops import msm_affine as TMA
    runs = []
    real = TMA.MSMBases.run
    _, primary, aux, _ = reference
    with pytest.MonkeyPatch.context() as mp:
        _msm_on(mp)
        mp.setattr(TMA.MSMBases, "run",
                   lambda self, sc: runs.append(self.group) or real(self, sc))
        proof = TG16.prove(port_keys[0], primary, aux, zk_rs=ZK_RS,
                           device="cpu")
    assert sorted(runs) == ["g1"] * 4 + ["g2"]    # the MSM code did run
    return proof


def test_proofs_are_identical(reference, port_proof):
    ref = reference[3]
    assert (port_proof.g_A, port_proof.g_B, port_proof.g_C) \
        == (ref.g_A, ref.g_B, ref.g_C)


def test_each_verifier_accepts_the_others_proof(reference, port_keys,
                                                port_proof):
    kp, primary, _, ref = reference
    as_ref = G16.Proof(port_proof.g_A, port_proof.g_B, port_proof.g_C)
    as_port = TG16.Proof(ref.g_A, ref.g_B, ref.g_C)
    assert G16.verify(kp.vk, primary, as_ref)
    assert TG16.verify(port_keys[1], primary, as_port)
    assert TG16.verify_strong_ic(port_keys[1], primary, as_port)
    pvk = TG16.process_verification_key(port_keys[1])
    assert TG16.online_verify_weak_ic(pvk, primary, as_port)
    assert TG16.online_verify_strong_ic(pvk, primary, as_port)
    assert not TG16.online_verify_strong_ic(pvk, [], as_port)


def test_wrong_public_input_is_rejected(reference, port_keys, port_proof):
    kp, primary, _, _ = reference
    wrong = [primary[0] + 1]
    assert not TG16.verify(port_keys[1], wrong, port_proof)
    assert not G16.verify(kp.vk, wrong, G16.Proof(
        port_proof.g_A, port_proof.g_B, port_proof.g_C))


def test_coefficients_for_h_are_identical(reference):
    _, primary, aux, _ = reference
    cs, _, _ = product_chain(R, CURVE.fr.p, NCONS)
    tcs, _, _ = product_chain(TR, CURVE.fr.p, NCONS)
    for d in ((0, 0, 0), (5, 6, 7)):
        ref = QAP.witness_map(CURVE.fr, cs, primary, aux, *d)
        got = TQAP.witness_map(TCURVE.fr, tcs, primary, aux, *d, device="cpu")
        assert got.coefficients_for_H == ref.coefficients_for_H
        assert got.coefficients_for_ABCs == ref.coefficients_for_ABCs
        assert (got.num_variables, got.degree, got.num_inputs) \
            == (ref.num_variables, ref.degree, ref.num_inputs)


def test_generate_with_the_same_toxic_gives_the_same_key(reference,
                                                         monkeypatch):
    _msm_on(monkeypatch)
    kp = reference[0]
    tcs, _, _ = product_chain(TR, CURVE.fr.p, NCONS)
    tkp = TG16.generate(TCURVE, tcs, toxic=TOXIC, device="cpu")
    for name in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
                 "A_query", "B_query_g1", "B_query_g2", "H_query", "L_query"):
        assert getattr(tkp.pk, name) == getattr(kp.pk, name), name
    for name in ("alpha_g1_beta_g2", "gamma_g2", "delta_g2", "gamma_ABC_g1"):
        assert getattr(tkp.vk, name) == getattr(kp.vk, name), name
    assert all(pt is not None for pt in tkp.pk.B_query_g2[2:-1])


def test_mnt_curve_is_refused_on_the_device_path(monkeypatch):
    """a != 0: `_msm_skip_inf` must take the host path whatever the size,
    and the device MSM itself must refuse the curve."""
    from crypto3_zk_tpu_torch.fields import mnt as TMNT
    from crypto3_zk_tpu_torch.ops import msm_affine as TMA
    curve = TMNT.MNT4
    monkeypatch.setattr(TG16, "_DEVICE_MSM_MIN", 2)

    def boom(*a, **k):
        raise AssertionError("the device MSM was reached for an MNT curve")

    monkeypatch.setattr(TG16, "MSMBases", boom)
    g = curve.g1
    pts = [g, TCV.g1_mul(curve, g, 2), None, TCV.g1_mul(curve, g, 3)]
    got = TG16._msm_skip_inf(curve, pts, [5, 6, 7, 0], device="cpu")
    assert got == TCV.g1_mul(curve, g, 17)
    with pytest.raises(ValueError):
        TMA.MSMBases(curve, [g, g], "g1", device="cpu")


@pytest.mark.parametrize("name", ["ALT_BN128", "BLS12_381"])
def test_pairing_equals_the_reference(name):
    """The port's host pairing, whose final exponentiation takes its easy
    part by Frobenius maps and then one power, gives the JAX package's
    value; the Frobenius map equals the p-th power."""
    from crypto3_zk_tpu_torch.fields import tower as TT
    curve, tcurve = getattr(CV, name), getattr(TCV, name)
    P = TCV.g1_mul(tcurve, tcurve.g1, 0x1234567)
    Q = TCV.g2_mul(tcurve, tcurve.g2, 0x7654321)
    assert TCV.pairing(tcurve, P, Q) == CV.pairing(curve, P, Q)
    f = TCV.miller_loop(tcurve, P, Q)
    assert TCV._fq12_frobenius(tcurve, f) == TT.fq12_pow(
        tcurve.fq.p, tcurve.xi, f, tcurve.fq.p)


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = re.compile(
        r"^\s*(?:import|from)\s+(jax|jaxlib|crypto3_zk_tpu)(?:[.\s]|$)", re.M)
    files = sorted((ROOT / "crypto3_zk_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the walk takes in the mesh layer, the last host-only modules and the
    # digit-plane NTT
    names = {p.relative_to(ROOT / "crypto3_zk_tpu_torch").as_posix()
             for p in files[:-1]}
    assert {f"parallel/{m}.py" for m in ("context", "ntt", "msm", "fri")} \
        | {f"utils/{m}.py" for m in (
            "config", "serialization", "sparse_vector", "algebraic_engine",
            "metrics", "tvm", "checkpoint", "profiling", "zkllvm")} \
        | {f"arithmetization/{m}.py" for m in (
            "non_linear_combination", "routing", "pairing_gadget")} \
        | {"entry.py", "launch.py", "ops/mxu_ntt.py"} <= names
    for path in files:
        assert not banned.search(path.read_text()), path
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            .removesuffix(".__init__") for p in files[:-1]]
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in set(sys.modules) - before if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'crypto3_zk_tpu')]\n"
            "print('BAD', sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
