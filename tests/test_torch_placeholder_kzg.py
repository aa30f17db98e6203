"""Whole Placeholder proofs over KZG of the port against the JAX package's,
on the CPU: `circuit_1` over alt_bn128 Fr with the keccak transcript and an
SRS of 4 * rows + 8 powers of tau, with SHPLONK v2 and with BDFG20 (the
reference's own KZG runners). Each case proves once per package
(module-scoped); the proofs are compared challenge by challenge, then as
plain ints and bytes; each package's verifier accepts the other's proof,
and the port's verifier rejects a tampered quotient opening and a wrong
public input. Exact equality."""
import copy
import random
import types

import pytest

import circuits as CI
from crypto3_zk_tpu.commitments import batched as RB
from crypto3_zk_tpu.commitments import kzg as RK
from crypto3_zk_tpu.fields import curves as RCV
from crypto3_zk_tpu.models.placeholder import common as RC
from crypto3_zk_tpu.models.placeholder import preprocessor as RPP
from crypto3_zk_tpu.models.placeholder import prover as RPR
from crypto3_zk_tpu.models.placeholder import verifier as RV
from crypto3_zk_tpu_torch import convert as CV
from crypto3_zk_tpu_torch.commitments import fri as FRI
from crypto3_zk_tpu_torch.commitments import kzg as K
from crypto3_zk_tpu_torch.models.placeholder import common as TC
from crypto3_zk_tpu_torch.models.placeholder import preprocessor as TPP
from crypto3_zk_tpu_torch.models.placeholder import prover as TPR
from crypto3_zk_tpu_torch.models.placeholder import verifier as TV
from crypto3_zk_tpu_torch.transcript.poseidon_transcript import \
    make_transcript
from test_torch_placeholder_proofs import Recording, _recorded

import torch_threads  # noqa: F401  one torch thread a worker

RCURVE = RCV.ALT_BN128
RFS = RCURVE.fr
FS = CV.curve_by_name(RCURVE.name).fr
REF_MODULES = types.SimpleNamespace(common=RC, batched=RB, kzg=RK)


class Case:
    """`circuit_1` proved over one KZG scheme by both packages from the same
    inputs and the same SRS."""

    def __init__(self, kind, seed):
        rng = random.Random(seed)
        cs, asg, desc, self.public_input = CI.circuit_1(RFS, rng)
        self.ref_circuit = (cs, asg, desc)
        self.circuit_port = CV.plonk_from_reference(cs, asg, desc)
        tau = rng.randrange(2, RFS.p)
        self.ref_kzg = RK.KZGParams.setup(RCURVE, 4 * desc.rows_amount + 8,
                                          tau=tau, d2=8)
        self.kzg = CV.kzg_params_from_reference(
            {f: getattr(self.ref_kzg, f) for f in
             ("curve", "commitment_key", "verification_key")})
        self.ref_cls = getattr(RK, f"KZGScheme{kind}")
        self.cls = getattr(K, f"KZGScheme{kind}")
        self.ref_params = RC.PlaceholderParams(RFS,
                                               transcript_hash="keccak_256")
        self.params = TC.PlaceholderParams(FS, transcript_hash="keccak_256")

        scheme = self.ref_cls(self.ref_kzg)
        self.ref_pub = RPP.process_public(self.ref_params, cs, asg, desc,
                                          scheme)
        ref_priv = RPP.process_private(self.ref_params, cs, asg, desc)
        self.ref_proof, self.ref_transcript = _recorded(RPR, lambda: RPR.prove(
            self.ref_params, self.ref_pub, ref_priv, desc, cs, scheme))

        tcs, tasg, tdesc = self.circuit_port
        self.scheme = self.cls(self.kzg, "cpu")
        self.pub = TPP.process_public(self.params, tcs, tasg, tdesc,
                                      self.scheme, device="cpu")
        self.priv = TPP.process_private(self.params, tcs, tasg, tdesc,
                                        device="cpu")
        self.transcript = Recording(make_transcript("keccak_256", FS))
        self.clock = FRI.PhaseClock("cpu")
        self.proof = TPR.prove(self.params, self.pub, self.priv, tdesc, tcs,
                               self.scheme.fork(), self.clock,
                               self.transcript, "cpu")

    def verify(self, proof, public_input=None, transcript=None):
        tcs, _, tdesc = self.circuit_port
        return TV.verify(self.params, self.pub.common_data, proof, tdesc, tcs,
                         self.cls(self.kzg),
                         public_input=self.public_input if public_input is None
                         else public_input, transcript=transcript)

    def ref_verify(self, proof):
        cs, _, desc = self.ref_circuit
        return _recorded(RV, lambda: RV.verify(
            self.ref_params, self.ref_pub.common_data, proof, desc, cs,
            self.ref_cls(self.ref_kzg), public_input=self.public_input))


@pytest.fixture(scope="module")
def v2():
    return Case("V2", 0xCD)


@pytest.fixture(scope="module")
def bdfg():
    return Case("BDFG", 0xCE)


CASES = ["v2", "bdfg"]


@pytest.mark.parametrize("case", CASES)
def test_proofs_equal_challenge_by_challenge(case, request):
    c = request.getfixturevalue(case)
    assert c.pub.common_data.vk.constraint_system_with_params_hash == \
        c.ref_pub.common_data.vk.constraint_system_with_params_hash
    assert c.pub.common_data.vk.fixed_values_commitment == \
        c.ref_pub.common_data.vk.fixed_values_commitment
    assert c.pub.common_data.commitment_scheme_data is True
    got, want = c.transcript.drawn, c.ref_transcript.drawn
    assert len(got) == len(want) > 8
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"challenge {i} differs"
    assert c.proof.commitments == c.ref_proof.commitments
    assert CV.placeholder_proof_as_plain(c.proof) == \
        CV.placeholder_proof_as_plain(c.ref_proof)
    assert c.transcript.challenge(FS) == c.ref_transcript.challenge(RFS)


@pytest.mark.parametrize("case", CASES)
def test_each_verifier_accepts_the_other_proof(case, request):
    c = request.getfixturevalue(case)
    carried = CV.placeholder_proof_from_fields(
        CV.placeholder_proof_fields(c.proof), REF_MODULES)
    ok, ref_tr = c.ref_verify(carried)
    assert ok
    back = CV.placeholder_proof_from_fields(
        CV.placeholder_proof_fields(c.ref_proof))
    tr = make_transcript("keccak_256", FS)
    assert c.verify(back, transcript=tr)
    assert tr.challenge(FS) == ref_tr.challenge(RFS)


@pytest.mark.parametrize("case", CASES)
def test_rejects_a_tampered_quotient_opening(case, request):
    c = request.getfixturevalue(case)
    bad = copy.deepcopy(c.proof)
    z = bad.eval_proof.eval_proof.z
    z.z[TC.QUOTIENT_BATCH][0][0] = (z.z[TC.QUOTIENT_BATCH][0][0] + 1) % FS.p
    assert not c.verify(bad)


@pytest.mark.parametrize("case", CASES)
def test_rejects_a_wrong_public_input(case, request):
    c = request.getfixturevalue(case)
    assert not c.verify(c.proof, [[(c.public_input[0][0] + 1) % FS.p]])


def test_clock_took_every_phase(v2, bdfg):
    head = ["variable_commit", "permutation_argument", "permutation_commit",
            "gates_argument", "quotient", "quotient_commit", "eval_polys"]
    assert list(v2.clock.seconds) == head + [
        "combine_f", "divide_T", "pi_1_commit", "combine_L",
        "divide_theta_2", "pi_2_commit"]
    marks = list(bdfg.clock.seconds)
    assert marks == head + [f"divide_batch_{k}" for k in sorted(
        bdfg.proof.eval_proof.eval_proof.z.z)] + ["pi_commit"]
