"""A run of each cell on the CPU at a size a test can hold, without the
harness's look for a card: sound, `correct` comes out true; with the
control, or with the timed path broken underneath, it comes out false.

The faults a prover service can have: a proof that is the previous one
again (a step that returns its state unchanged), half of the work left out
(half of every MSM's scalars, or half of the witness rows), and an answer
altered where it is produced. One card, so no exchange between chips.
"""
import time

import pytest

from zkbench import harness

G16 = ("groth16_bn254.c16", {"constraints": 30})
LOOKUP = ("placeholder_lpc.r18.lookup", {"rows_log2": 5})
GATES = ("placeholder_lpc.r18.gates", {"rows_log2": 5})
SEED = 2 ** 33 + 17


def _run(cell, circuit, control=False, seconds=0.5):
    return harness.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                            device="cpu", control=control, circuit=circuit,
                            log=lambda msg: None)


def _stale(monkeypatch, system):
    """Every request answered with the proof made before it."""
    made = system.Service.prove

    def prove(self, k, clock=None):
        previous = getattr(self, "_previous", None)
        self._previous = made(self, k, clock)
        return previous if previous is not None else self._previous

    monkeypatch.setattr(system.Service, "prove", prove)


@pytest.mark.parametrize("cell,circuit", [G16, LOOKUP, GATES])
def test_sound_run_is_correct(cell, circuit):
    result = _run(cell, circuit)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("cell,circuit", [G16, LOOKUP, GATES])
def test_control_is_not_correct(cell, circuit):
    result = _run(cell, circuit, control=True)
    assert not result["correct"]


@pytest.mark.parametrize("cell,circuit", [G16, LOOKUP, GATES])
def test_stale_proof_is_not_correct(monkeypatch, cell, circuit):
    config = harness.load_json(
        "configs", harness.load_json("workloads", cell)["config"])
    _stale(monkeypatch, harness.system_module(config["system"]))
    assert not _run(cell, circuit)["correct"]


def test_groth16_half_of_each_msm_is_not_correct(monkeypatch):
    from crypto3_zk_tpu_torch.models import groth16
    msm = groth16._msm_skip_inf

    def half(curve, bases, scalars, *args, **kwargs):
        scalars = list(scalars)
        keep = len(scalars) // 2
        return msm(curve, bases, scalars[:keep] + [0] * (len(scalars) - keep),
                   *args, **kwargs)

    monkeypatch.setattr(groth16, "_msm_skip_inf", half)
    assert not _run(*G16)["correct"]


def test_groth16_altered_point_is_not_correct(monkeypatch):
    from crypto3_zk_tpu_torch.fields import curves
    from crypto3_zk_tpu_torch.models import groth16
    prove = groth16.prove

    def altered(pk, *args, **kwargs):
        proof = prove(pk, *args, **kwargs)
        proof.g_C = curves.g1_add(pk.curve, proof.g_C, pk.curve.g1)
        return proof

    monkeypatch.setattr(groth16, "prove", altered)
    assert not _run(*G16)["correct"]


@pytest.mark.parametrize("cell,circuit", [LOOKUP, GATES])
def test_placeholder_half_of_the_witness_is_not_correct(monkeypatch, cell,
                                                        circuit):
    from crypto3_zk_tpu_torch.models.placeholder import preprocessor
    process_private = preprocessor.process_private

    def half(params, cs, assignment, desc, device=None):
        rows = desc.rows_amount // 2
        cut = type(assignment)([c[:rows] + [0] * (len(c) - rows)
                                for c in assignment.witnesses],
                               assignment.public_inputs, assignment.constants,
                               assignment.selectors)
        return process_private(params, cs, cut, desc, device=device)

    monkeypatch.setattr(preprocessor, "process_private", half)
    assert not _run(cell, circuit)["correct"]


@pytest.mark.parametrize("cell,circuit", [LOOKUP, GATES])
def test_placeholder_altered_query_answer_is_not_correct(monkeypatch, cell,
                                                         circuit):
    from crypto3_zk_tpu_torch.models.placeholder import prover
    prove = prover.prove

    def altered(*args, **kwargs):
        proof = prove(*args, **kwargs)
        first = proof.eval_proof.eval_proof.fri_proof.query_proofs[0]
        values = first.initial_proof[1].values
        y0, y1 = values[0][0]
        values[0][0] = (y0 + 1, y1)
        return proof

    monkeypatch.setattr(prover, "prove", altered)
    assert not _run(cell, circuit)["correct"]
