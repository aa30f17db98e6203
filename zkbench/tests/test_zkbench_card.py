"""The command itself on a card: each cell's run prints a correct result,
and its control's is not correct. Skipped without a card."""
import json
import subprocess
import sys

import pytest

from zkbench import harness


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_benchmark()["workloads"]])
def test_cell_on_card(card, cell):
    def run(control):
        out = subprocess.run(
            [sys.executable, "zkbench/run.py", "--workload", cell, "--seed",
             "4000000007", "--seconds", "3", "--trace", "0", "--control",
             str(control)], cwd=harness.ROOT, capture_output=True, text=True,
            check=True, timeout=1200).stdout
        return json.loads(out.strip().splitlines()[-1])

    assert run(0)["correct"]
    assert not run(1)["correct"]


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload", "groth16_bn254.c16",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
