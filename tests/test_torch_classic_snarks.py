"""The port's classic R1CS provers against the JAX package's, on the CPU,
exact equality, at the sizes of the reference's own tests
(`test_classic_snarks.py`, `test_uscs_circuits.py`): the QAP Lagrange
instance, the SAP and SSP instance and witness maps; with the same draws
from a seeded `random.Random`, identical keys and proofs for PGHR13, GM17,
the USCS ppzkSNARK and the TBCS / BACS frontends; each package's verifier
accepts the other's proof, and the port's verifier rejects the reference's
negative cases. Each system runs once per package (module-scoped)."""
import dataclasses
import random

import pytest
import torch

from crypto3_zk_tpu.arithmetization import circuits as RCIR
from crypto3_zk_tpu.arithmetization import qap as RQAP
from crypto3_zk_tpu.arithmetization import sap as RSAP
from crypto3_zk_tpu.arithmetization import uscs as RUSCS
from crypto3_zk_tpu.arithmetization.r1cs import LinearCombination as RLC
from crypto3_zk_tpu.arithmetization.r1cs import lc as rlc
from crypto3_zk_tpu.commitments import knowledge_commitment as RKC
from crypto3_zk_tpu.fields import curves as RCV
from crypto3_zk_tpu.models import circuit_snarks as RCS
from crypto3_zk_tpu.models import gm17 as RGM
from crypto3_zk_tpu.models import pghr13 as RPG
from crypto3_zk_tpu.models import uscs_ppzksnark as RUP
from crypto3_zk_tpu_torch import convert as CONV
from crypto3_zk_tpu_torch.arithmetization import circuits as CIR
from crypto3_zk_tpu_torch.arithmetization import qap as QAP
from crypto3_zk_tpu_torch.arithmetization import sap as SAP
from crypto3_zk_tpu_torch.arithmetization import uscs as USCS
from crypto3_zk_tpu_torch.arithmetization.r1cs import LinearCombination, lc
from crypto3_zk_tpu_torch.commitments import knowledge_commitment as KC
from crypto3_zk_tpu_torch.fields import curves as CV
from crypto3_zk_tpu_torch.models import api
from crypto3_zk_tpu_torch.models import circuit_snarks as CS
from crypto3_zk_tpu_torch.models import gm17 as GM
from crypto3_zk_tpu_torch.models import pghr13 as PG
from crypto3_zk_tpu_torch.models import uscs_ppzksnark as UP
from test_groth16 import power_chain_example

import torch_threads  # noqa: F401  one torch thread a worker

RCURVE, CURVE = RCV.ALT_BN128, CV.ALT_BN128
P = CURVE.fr.p


def _fields(obj, skip=("curve", "constraint_system")):
    """A dataclass's fields as plain values (KC pairs as tuples)."""
    def plain(v):
        if dataclasses.is_dataclass(v):
            return tuple(plain(x) for x in dataclasses.astuple(v))
        if isinstance(v, list):
            return [plain(x) for x in v]
        return v
    return {f.name: plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name not in skip}


def _as(mod, cls_name, obj, kc=None):
    """`obj` rebuilt as the dataclass `cls_name` of the module `mod`, KC
    pairs as `kc.KC` where given."""
    vals = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if kc is not None and dataclasses.is_dataclass(v):
            v = kc.KC(v.g, v.h)
        vals[f.name] = v
    return getattr(mod, cls_name)(**vals)


def _r1cs(n):
    cs, primary, aux = power_chain_example(RCURVE, n)
    return cs, CONV.constraint_system_from_reference(cs), primary, aux


def uscs_example(mod, lcm):
    """The reference test's USCS: x1 - x2, x2 - x3, x3 in {+-1}."""
    cs = mod.USCSConstraintSystem(primary_input_size=1,
                                  auxiliary_input_size=2)
    cs.add_constraint(lcm([(1, 1), (2, -1)]))
    cs.add_constraint(lcm([(2, 1), (3, -1)]))
    cs.add_constraint(lcm([(3, 1)]))
    return cs, [3], [2, 1]


def tbcs_example(mod):
    c = mod.TBCSCircuit(primary_input_size=2, auxiliary_input_size=0)
    c.gates.append(mod.TBCSGate(1, 2, mod.TBCS_GATE_AND, 3,
                                is_circuit_output=True))
    return c


def bacs_example(mod, lcf, lcm):
    """(x1 + a1) * x1 -> w3; (w3 - 12) * 1 -> w4 = 0."""
    c = mod.BACSCircuit(primary_input_size=1, auxiliary_input_size=1)
    c.gates.append(mod.BACSGate(lcf((1, 1), (2, 1)), lcf((1, 1)), 3))
    c.gates.append(mod.BACSGate(lcm([(3, 1), (0, -12)]), lcf((0, 1)), 4,
                                is_circuit_output=True))
    return c


# ---------------------------------------------------------------------------
# instance and witness maps
# ---------------------------------------------------------------------------

def test_qap_lagrange_instance_equals_the_reference():
    rcs, cs, _, _ = _r1cs(6)
    got = QAP.instance_map_lagrange(CURVE.fr, cs)
    want = RQAP.instance_map_lagrange(RCURVE.fr, rcs)
    assert (got.num_variables, got.degree, got.num_inputs, got.A, got.B,
            got.C) == (want.num_variables, want.degree, want.num_inputs,
                       want.A, want.B, want.C)
    assert got.domain.n == want.domain.n


def test_sap_maps_equal_the_reference():
    rcs, cs, primary, aux = _r1cs(5)
    t = random.Random(0x18).randrange(P)
    got = SAP.instance_map_with_evaluation(CURVE.fr, cs, t)
    want = RSAP.instance_map_with_evaluation(RCURVE.fr, rcs, t)
    assert (got.At, got.Ct, got.Ht, got.Zt, got.degree, got.num_variables) \
        == (want.At, want.Ct, want.Ht, want.Zt, want.degree,
            want.num_variables)
    wit = SAP.witness_map(CURVE.fr, cs, primary, aux, 7, 11, device="cpu")
    rwit = RSAP.witness_map(RCURVE.fr, rcs, primary, aux, 7, 11)
    assert (wit.coefficients_for_ACs, wit.coefficients_for_H) \
        == (rwit.coefficients_for_ACs, rwit.coefficients_for_H)
    # the SAP identity A(t)^2 - C(t) = H(t) Z(t) with d1 = d2 = 0
    wit = SAP.witness_map(CURVE.fr, cs, primary, aux, device="cpu")
    full = [1] + wit.coefficients_for_ACs
    at = sum(a * v for a, v in zip(got.At, full)) % P
    ct = sum(c * v for c, v in zip(got.Ct, full)) % P
    ht = sum(h * pow(t, i, P) for i, h in enumerate(wit.coefficients_for_H))
    assert (at * at - ct) % P == ht * got.Zt % P


def test_ssp_maps_equal_the_reference():
    cs, primary, aux = uscs_example(USCS, LinearCombination)
    rcs, _, _ = uscs_example(RUSCS, RLC)
    t = random.Random(0x55).randrange(P)
    got = USCS.instance_map_with_evaluation(CURVE.fr, cs, t)
    want = RUSCS.instance_map_with_evaluation(RCURVE.fr, rcs, t)
    assert (got.Vt, got.Ht, got.Zt) == (want.Vt, want.Ht, want.Zt)
    wit = USCS.witness_map(CURVE.fr, cs, primary, aux, 5, device="cpu")
    rwit = RUSCS.witness_map(RCURVE.fr, rcs, primary, aux, 5)
    assert (wit.coefficients_for_Vs, wit.coefficients_for_H) \
        == (rwit.coefficients_for_Vs, rwit.coefficients_for_H)


def test_circuit_frontends_equal_the_reference():
    tb, rtb = tbcs_example(CIR), tbcs_example(RCIR)
    assert tb.is_satisfied([1, 0], []) and not tb.is_satisfied([1, 1], [])
    assert tb.num_wires() == rtb.num_wires() == 3
    assert tb.get_all_wires([1, 0], []) == rtb.get_all_wires([1, 0], [])
    got, want = CIR.tbcs_to_uscs_instance(tb), RCIR.tbcs_to_uscs_instance(rtb)
    assert [c.terms for c in got.constraints] == \
        [c.terms for c in want.constraints]
    ba = bacs_example(CIR, lc, LinearCombination)
    rba = bacs_example(RCIR, rlc, RLC)
    assert ba.is_satisfied(P, [3], [1]) and not ba.is_satisfied(P, [4], [1])
    assert ba.get_all_wires(P, [3], [1]) == rba.get_all_wires(P, [3], [1])
    got, want = CIR.bacs_to_r1cs_instance(ba), RCIR.bacs_to_r1cs_instance(rba)
    assert [(c.a.terms, c.b.terms, c.c.terms) for c in got.constraints] == \
        [(c.a.terms, c.b.terms, c.c.terms) for c in want.constraints]
    for gate in range(16):
        assert [CIR.tbcs_gate_eval(gate, x, y) for x in (0, 1)
                for y in (0, 1)] == [RCIR.tbcs_gate_eval(gate, x, y)
                                     for x in (0, 1) for y in (0, 1)]


def test_kc_batch_exp_equals_host_multiples():
    g, h = CURVE.g1, CV.g1_mul(CURVE, CURVE.g1, 5)
    ks = [0, 1, 7, P - 1]
    got = KC.kc_batch_exp(CURVE, g, h, ks, c=4, device="cpu")
    assert [(k.g, k.h) for k in got] == [
        (RCV.g1_mul(RCURVE, g, k), RCV.g1_mul(RCURVE, h, k)) for k in ks]
    dense = KC.KnowledgeCommitmentVector.from_dense([None] + got)
    assert dense.indices == [2, 3, 4] and dense.to_dense()[2] == got[1]


# ---------------------------------------------------------------------------
# the provers
# ---------------------------------------------------------------------------

class System:
    """One proof system's keys and proof made by both packages with the
    same draws (one `random.Random` through generate and prove, as in the
    reference's tests)."""

    def __init__(self, name, seed, build):
        (self.ref_gen, self.ref_prove, self.ref_verify, self.gen, self.prove,
         self.verify, self.primary, self.aux) = build()
        rng = random.Random(seed)
        self.ref_kp = self.ref_gen(rng)
        self.ref_proof = self.ref_prove(self.ref_kp, rng)
        rng = random.Random(seed)
        self.kp = self.gen(rng)
        self.proof = self.prove(self.kp, rng)
        self.name = name


def _pghr13():
    rcs, cs, primary, aux = _r1cs(6)
    return (lambda r: RPG.generate(RCURVE, rcs, r),
            lambda kp, r: RPG.prove(kp.pk, primary, aux, r),
            lambda kp, x, pr: RPG.verify(kp.vk, x, _as(RPG, "Proof", pr, RKC)),
            lambda r: PG.generate(CURVE, cs, r, device="cpu"),
            lambda kp, r: PG.prove(kp.pk, primary, aux, r, device="cpu"),
            lambda kp, x, pr: PG.verify(kp.vk, x, _as(PG, "Proof", pr, KC)),
            primary, aux)


def _gm17():
    rcs, cs, primary, aux = _r1cs(6)
    return (lambda r: RGM.generate(RCURVE, rcs, r),
            lambda kp, r: RGM.prove(kp.pk, primary, aux, r),
            lambda kp, x, pr: RGM.verify(kp.vk, x, _as(RGM, "Proof", pr)),
            lambda r: GM.generate(CURVE, cs, r, device="cpu"),
            lambda kp, r: GM.prove(kp.pk, primary, aux, r, device="cpu"),
            lambda kp, x, pr: GM.verify(kp.vk, x, _as(GM, "Proof", pr)),
            primary, aux)


def _uscs():
    rcs, primary, aux = uscs_example(RUSCS, RLC)
    cs, _, _ = uscs_example(USCS, LinearCombination)
    return (lambda r: RUP.generate(RCURVE, rcs, r),
            lambda kp, r: RUP.prove(kp.pk, primary, aux, r),
            lambda kp, x, pr: RUP.verify(kp.vk, x, _as(RUP, "Proof", pr)),
            lambda r: UP.generate(CURVE, cs, r, device="cpu"),
            lambda kp, r: UP.prove(kp.pk, primary, aux, r, device="cpu"),
            lambda kp, x, pr: UP.verify(kp.vk, x, _as(UP, "Proof", pr)),
            primary, aux)


def _tbcs():
    rtb, tb = tbcs_example(RCIR), tbcs_example(CIR)
    return (lambda r: RCS.tbcs_generate(RCURVE, rtb, r)[0],
            lambda kp, r: RCS.tbcs_prove(kp, rtb, [1, 0], [], r),
            lambda kp, x, pr: RCS.tbcs_verify(kp, x, _as(RUP, "Proof", pr)),
            lambda r: CS.tbcs_generate(CURVE, tb, r, device="cpu")[0],
            lambda kp, r: CS.tbcs_prove(kp, tb, [1, 0], [], r, device="cpu"),
            lambda kp, x, pr: CS.tbcs_verify(kp, x, _as(UP, "Proof", pr)),
            [1, 0], [])


def _bacs():
    rba, ba = bacs_example(RCIR, rlc, RLC), bacs_example(CIR, lc,
                                                         LinearCombination)
    return (lambda r: RCS.bacs_generate(RCURVE, rba, r)[0],
            lambda kp, r: RCS.bacs_prove(kp, rba, [3], [1], r),
            lambda kp, x, pr: RCS.bacs_verify(kp, x,
                                              _as(RPG, "Proof", pr, RKC)),
            lambda r: CS.bacs_generate(CURVE, ba, r, device="cpu")[0],
            lambda kp, r: CS.bacs_prove(kp, ba, [3], [1], r, device="cpu"),
            lambda kp, x, pr: CS.bacs_verify(kp, x, _as(PG, "Proof", pr, KC)),
            [3], [1])


SYSTEMS = {"pghr13": (0x19, _pghr13), "gm17": (0x17, _gm17),
           "uscs": (0x56, _uscs), "tbcs": (0x57, _tbcs),
           "bacs": (0x58, _bacs)}


@pytest.fixture(scope="module")
def systems():
    return {name: System(name, seed, build)
            for name, (seed, build) in SYSTEMS.items()}


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_keys_and_proofs_equal_the_reference(systems, name):
    s = systems[name]
    assert _fields(s.kp.pk) == _fields(s.ref_kp.pk)
    assert _fields(s.kp.vk) == _fields(s.ref_kp.vk)
    assert _fields(s.proof) == _fields(s.ref_proof)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_each_verifier_accepts_the_other_proof(systems, name):
    s = systems[name]
    assert s.ref_verify(s.ref_kp, s.primary, s.proof)
    assert s.verify(s.kp, s.primary, s.ref_proof)


def _wrong_input(s):
    return [(s.primary[0] + 1) % P] if s.name != "tbcs" else [0, 1]


def _bumped(s):
    """The reference's tampered proof: one G1 element plus the generator."""
    field = {"pghr13": "g_H", "gm17": "C", "uscs": "H_g1"}.get(s.name)
    if field is None:
        return None
    return dataclasses.replace(s.proof, **{field: CV.g1_add(
        CURVE, getattr(s.proof, field), CURVE.g1)})


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_rejects_the_reference_negative_cases(systems, name):
    s = systems[name]
    assert not s.verify(s.kp, _wrong_input(s), s.proof)
    bad = _bumped(s)
    if bad is not None:
        assert not s.verify(s.kp, s.primary, bad)


def test_api_dispatches_to_the_port(systems):
    assert api.system(api.GROTH16).__name__.endswith("models.groth16")
    assert api.system("pghr13") is PG and api.system("gm17") is GM
    s = systems["gm17"]
    assert api.verify("gm17", s.kp.vk, s.primary, s.proof)
    proof = api.prove("gm17", s.kp.pk, s.primary, s.aux,
                      rng=random.Random(4), device="cpu")
    assert proof == GM.prove(s.kp.pk, s.primary, s.aux, random.Random(4),
                             device="cpu")
    _, cs, primary, _ = _r1cs(2)
    kp = api.generate("pghr13", CURVE, cs, rng=random.Random(3),
                      device="cpu")
    assert kp == PG.generate(CURVE, _r1cs(2)[1], random.Random(3),
                             device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, cs, primary, aux = _r1cs(3)
    for mod in (PG, GM):
        with pytest.raises(RuntimeError):
            mod.generate(CURVE, cs, random.Random(1))
        kp = mod.generate(CURVE, cs, random.Random(1), device="cpu")
        with pytest.raises(RuntimeError):
            mod.prove(kp.pk, primary, aux, random.Random(2))
    ucs, uprimary, uaux = uscs_example(USCS, LinearCombination)
    with pytest.raises(RuntimeError):
        UP.generate(CURVE, ucs, random.Random(1))
    kp = UP.generate(CURVE, ucs, random.Random(1), device="cpu")
    with pytest.raises(RuntimeError):
        UP.prove(kp.pk, uprimary, uaux, random.Random(2))
    with pytest.raises(RuntimeError):
        SAP.witness_map(CURVE.fr, cs, primary, aux)
    with pytest.raises(RuntimeError):
        USCS.witness_map(CURVE.fr, ucs, uprimary, uaux)
    with pytest.raises(RuntimeError):
        KC.kc_batch_exp(CURVE, CURVE.g1, CURVE.g1, [1, 2])
