"""Whole Placeholder proofs of the port against the JAX package's, on the
CPU, over keccak Merkle trees: `circuit_lookup` (the lookup argument) and
`circuit_t` with `max_quotient_chunks=5` (rotations, the chunked
quotient). The shared proofs and the checks are those of
`test_torch_placeholder_proofs.py`; the port's verifier also rejects a
changed `LOOKUP_BATCH` value. Exact equality."""
import copy

import pytest

from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.models.placeholder import common as TC
from test_torch_placeholder_proofs import (Case, check_cross_verification,
                                           check_equal_proofs)

import torch_threads  # noqa: F401  one torch thread a worker

FS = TP.BLS12_381_FR


@pytest.fixture(scope="module")
def lookup():
    return Case("circuit_lookup", "keccak_256", "keccak_256")


@pytest.fixture(scope="module")
def chunked_quotient():
    return Case("circuit_t", "keccak_256", "keccak_256", mqc=5)


CASES = ["lookup", "chunked_quotient"]


@pytest.mark.parametrize("case", CASES)
def test_proofs_equal_challenge_by_challenge(case, request):
    check_equal_proofs(request.getfixturevalue(case))


@pytest.mark.parametrize("case", CASES)
def test_each_verifier_accepts_the_other_proof(case, request):
    check_cross_verification(request.getfixturevalue(case))


def test_rejects_a_changed_lookup_value(lookup):
    bad = copy.deepcopy(lookup.proof)
    z = bad.eval_proof.eval_proof.z.z
    z[TC.LOOKUP_BATCH][0][0] = (z[TC.LOOKUP_BATCH][0][0] + 1) % FS.p
    assert not lookup.verify(bad)
    assert lookup.verify(copy.deepcopy(lookup.proof))


def test_chunked_quotient_has_five_chunks(chunked_quotient):
    c = chunked_quotient
    assert len(c.proof.eval_proof.eval_proof.z.z[TC.QUOTIENT_BATCH]) == 5
    assert not c.verify(c.proof, [[(c.public_input[0][0] + 1) % FS.p]])
