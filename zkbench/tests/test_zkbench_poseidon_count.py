"""`poseidon_roofline_pct`'s permutation formula counts the permutations
the port's Merkle trees make in one proof (a small proof on the CPU, where
every permutation goes through kernel 5's plain version), and its count of
multiply-adds a permutation follows its schedule."""
import pytest

from zkbench import harness

metric = harness.metric_module("poseidon_roofline_pct")


@pytest.mark.parametrize("cell", ["placeholder_lpc.r18.lookup",
                                  "placeholder_lpc.r18.gates"])
def test_formula_counts_the_trees_of_a_proof(monkeypatch, cell):
    from crypto3_zk_tpu_torch.ops import hopper_hash
    from zkbench.systems import placeholder_lpc

    workload = harness.load_json("workloads", cell)
    workload["circuit"]["rows_log2"] = 5
    config = harness.load_json("configs", workload["config"])
    service = placeholder_lpc.Service(config, workload, 11, "cpu")
    service.setup({})
    counted = []
    plain = hopper_hash.poseidon_permute_plain

    def counting(pp, ins, adds=(None, None), lane0_only=False):
        lanes = next(x for x in list(ins) + list(adds) if x is not None)
        counted.append(lanes.shape[-1])
        return plain(pp, ins, adds, lane0_only)

    monkeypatch.setattr(hopper_hash, "poseidon_permute_plain", counting)
    service.prove(0)
    shape = metric.circuit_shape(workload)
    assert sum(counted) == metric.permutations_per_proof(
        shape, 5, config["expand_factor"], config["fri_step"])


def test_multiply_adds_a_permutation():
    # x^5: two squares and a product; a dense row of three products and one
    # reduction; sparse partial rounds: row 0 dense, rows 1, 2 one product
    nw = 8
    product, square, reduction = 128, 72, 136
    sbox = 2 * square + product + 3 * reduction
    full = 3 * sbox + 3 * (3 * product + reduction)
    partial = sbox + (3 * product + reduction) + 2 * (product + reduction)
    assert metric.permutation_multiply_adds(nw) == 8 * full + 57 * partial \
        == 127296


def test_reader_stays_silent_without_kernel_time():
    run = harness.Run(harness.load_json("configs", "placeholder_lpc"),
                      harness.load_json("workloads",
                                        "placeholder_lpc.r18.lookup"),
                      0, 1.0, 1.0, [1.0], None, {})
    assert metric.read(run) is None
