"""Whole Placeholder proofs of the port against the JAX package's, on the
CPU: `circuit_1` with Poseidon Merkle trees and the keccak transcript (the
card path's form) and with the Poseidon transcript over keccak trees. Each
case proves once per package (module-scoped), and the proofs are compared
challenge by challenge, then as plain ints and bytes; each package's
verifier accepts the other's proof, and the port's verifier rejects a wrong
public input and a tampered witness. `test_torch_placeholder_lookup.py`
holds the other two shared proofs. Exact equality."""
import copy
import random
import types

import pytest

import circuits as CI
from crypto3_zk_tpu.commitments import batched as RB
from crypto3_zk_tpu.commitments import fri as RFRI
from crypto3_zk_tpu.commitments import lpc as RLPC
from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.models.placeholder import common as RC
from crypto3_zk_tpu.models.placeholder import preprocessor as RPP
from crypto3_zk_tpu.models.placeholder import prover as RPR
from crypto3_zk_tpu.models.placeholder import verifier as RV
from crypto3_zk_tpu_torch import convert as CV
from crypto3_zk_tpu_torch.commitments import fri as FRI
from crypto3_zk_tpu_torch.commitments.lpc import LPCScheme
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.models.placeholder import common as TC
from crypto3_zk_tpu_torch.models.placeholder import preprocessor as TPP
from crypto3_zk_tpu_torch.models.placeholder import prover as TPR
from crypto3_zk_tpu_torch.models.placeholder import verifier as TV
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.poly.polynomial import PolyDFS
from crypto3_zk_tpu_torch.transcript.poseidon_transcript import \
    make_transcript

import torch_threads  # noqa: F401  one torch thread a worker

RFS, FS = P.BLS12_381_FR, TP.BLS12_381_FR
REF_MODULES = types.SimpleNamespace(common=RC, lpc=RLPC, batched=RB,
                                    fri=RFRI)


class Recording:
    """A transcript that keeps every challenge it hands out, in order."""

    def __init__(self, inner):
        self.inner = inner
        self.drawn = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def challenge(self, fs):
        self.drawn.append(self.inner.challenge(fs))
        return self.drawn[-1]

    def challenges(self, fs, n):
        return [self.challenge(fs) for _ in range(n)]

    def int_challenge(self, bits=64):
        self.drawn.append(self.inner.int_challenge(bits))
        return self.drawn[-1]


def _recorded(module, call):
    """Run `call()` with `module.make_transcript` recording; returns
    (result, the recording transcript)."""
    made = []
    original = module.make_transcript

    def make(*args, **kwargs):
        made.append(Recording(original(*args, **kwargs)))
        return made[-1]

    module.make_transcript = make
    try:
        out = call()
    finally:
        module.make_transcript = original
    return out, made[0]


class Case:
    """One circuit proved by both packages on the same inputs: the port's
    (params, preprocessed data, proof, recorded transcript) and the
    reference's."""

    def __init__(self, circuit, merkle_hash, transcript_hash, mqc=0):
        rng = random.Random(0xAB)
        self.circuit = circuit
        cs, asg, desc, self.public_input = getattr(CI, circuit)(RFS, rng)
        self.ref_circuit = (cs, asg, desc)
        self.circuit_port = CV.plonk_from_reference(cs, asg, desc)
        degree_log = desc.rows_amount.bit_length() - 1
        self.ref_fri = RFRI.FRIParams.build(
            RFS, degree_log=degree_log, expand_factor=2, lambda_=4,
            merkle_hash=merkle_hash, transcript_hash=transcript_hash)
        self.fri = CV.fri_params_from_reference(self.ref_fri.get_params())
        self.ref_params = RC.PlaceholderParams(
            RFS, transcript_hash=transcript_hash, max_quotient_chunks=mqc)
        self.params = TC.PlaceholderParams(
            FS, transcript_hash=transcript_hash, max_quotient_chunks=mqc)
        self.mqc = mqc

        scheme = RLPC.LPCScheme(self.ref_fri)
        self.ref_pub = RPP.process_public(self.ref_params, cs, asg, desc,
                                          scheme, max_quotient_poly_chunks=mqc)
        ref_priv = RPP.process_private(self.ref_params, cs, asg, desc)
        self.ref_proof, self.ref_transcript = _recorded(RPR, lambda: RPR.prove(
            self.ref_params, self.ref_pub, ref_priv, desc, cs, scheme))

        tcs, tasg, tdesc = self.circuit_port
        self.scheme = LPCScheme(self.fri)
        self.pub = TPP.process_public(self.params, tcs, tasg, tdesc,
                                      self.scheme,
                                      max_quotient_poly_chunks=mqc,
                                      device="cpu")
        self.priv = TPP.process_private(self.params, tcs, tasg, tdesc,
                                        device="cpu")
        self.transcript = Recording(make_transcript(transcript_hash, FS))
        self.clock = FRI.PhaseClock("cpu")
        self.proof = TPR.prove(self.params, self.pub, self.priv, tdesc, tcs,
                               self.scheme.fork(), self.clock,
                               self.transcript, "cpu")

    def verify(self, proof, public_input=None, transcript=None):
        tcs, _, tdesc = self.circuit_port
        return TV.verify(self.params, self.pub.common_data, proof, tdesc, tcs,
                         LPCScheme(self.fri),
                         public_input=self.public_input if public_input is None
                         else public_input, transcript=transcript)

    def ref_verify(self, proof):
        cs, _, desc = self.ref_circuit
        return _recorded(RV, lambda: RV.verify(
            self.ref_params, self.ref_pub.common_data, proof, desc, cs,
            RLPC.LPCScheme(self.ref_fri), public_input=self.public_input))


def check_equal_proofs(case):
    """The two packages' proofs: the same challenges in the same order, the
    same commitments, the same proof as plain values, the same next
    challenge."""
    assert case.pub.common_data.vk.constraint_system_with_params_hash == \
        case.ref_pub.common_data.vk.constraint_system_with_params_hash
    assert case.pub.common_data.vk.fixed_values_commitment == \
        case.ref_pub.common_data.vk.fixed_values_commitment
    assert case.pub.common_data.commitment_scheme_data == \
        case.ref_pub.common_data.commitment_scheme_data
    got, want = case.transcript.drawn, case.ref_transcript.drawn
    assert len(got) == len(want) > 8
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"challenge {i} differs"
    assert case.proof.commitments == case.ref_proof.commitments
    assert CV.placeholder_proof_as_plain(case.proof) == \
        CV.placeholder_proof_as_plain(case.ref_proof)
    assert case.transcript.challenge(FS) == \
        case.ref_transcript.challenge(RFS)


def check_cross_verification(case):
    """Each package's verifier accepts the other's proof, and the port's
    verifier and prover draw the same next challenge."""
    carried = CV.placeholder_proof_from_fields(
        CV.placeholder_proof_fields(case.proof), REF_MODULES)
    ok, ref_tr = case.ref_verify(carried)
    assert ok
    back = CV.placeholder_proof_from_fields(
        CV.placeholder_proof_fields(case.ref_proof))
    tr = make_transcript(case.params.transcript_hash, FS)
    assert case.verify(back, transcript=tr)
    assert tr.challenge(FS) == ref_tr.challenge(RFS)


@pytest.fixture(scope="module")
def poseidon_trees():
    return Case("circuit_1", "poseidon", "keccak_256")


@pytest.fixture(scope="module")
def poseidon_transcript():
    return Case("circuit_1", "keccak_256", "poseidon")


CASES = ["poseidon_trees", "poseidon_transcript"]


@pytest.mark.parametrize("case", CASES)
def test_proofs_equal_challenge_by_challenge(case, request):
    check_equal_proofs(request.getfixturevalue(case))


@pytest.mark.parametrize("case", CASES)
def test_each_verifier_accepts_the_other_proof(case, request):
    check_cross_verification(request.getfixturevalue(case))


def test_clock_took_every_phase(poseidon_trees):
    assert list(poseidon_trees.clock.seconds) == [
        "variable_commit", "permutation_argument", "permutation_commit",
        "gates_argument", "quotient", "quotient_commit", "eval_polys",
        "combined_q", "q_precommit", "fri_commit_phase", "fri_query_phase"]


@pytest.mark.parametrize("case", CASES)
def test_rejects_a_wrong_public_input(case, request):
    c = request.getfixturevalue(case)
    assert not c.verify(c.proof, [[(c.public_input[0][0] + 1) % FS.p]])
    assert c.verify(copy.deepcopy(c.proof))


def test_rejects_a_tampered_witness(poseidon_transcript):
    """A witness column replaced by random values: the port still proves
    (as the reference does), and its verifier rejects the proof."""
    c = poseidon_transcript
    _, _, tdesc = c.circuit_port
    rng = random.Random(3)
    priv = copy.copy(c.priv)
    priv.witnesses = list(c.priv.witnesses)
    priv.witnesses[2] = PolyDFS(FS, TL.encode(
        FS, [rng.randrange(FS.p) for _ in range(tdesc.rows_amount)], "cpu"),
        tdesc.rows_amount)
    tcs = c.circuit_port[0]
    bad = TPR.prove(c.params, c.pub, priv, tdesc, tcs, c.scheme.fork(),
                    device="cpu")
    assert not c.verify(bad)
