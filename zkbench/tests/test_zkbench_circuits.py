"""The frozen traffic generators: at the source's own size they are the
source's circuits; deterministic from their seeds, the witness seed
changes the witness and nothing else, every witness satisfies its circuit,
and the program's and the reference's builds of one circuit agree."""
import random

import pytest

from zkbench import draws, harness
from zkbench.circuits import circuit_test_1, circuit_test_4, product_chain
from zkbench.reference import plonk as RPK
from zkbench.reference import r1cs as RR

P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
GENERATORS = [circuit_test_1, circuit_test_4]


def _value(e, at):
    if isinstance(e, RPK.Var):
        return at(e)
    if isinstance(e, RPK.Const):
        return e.v
    a, b = _value(e.l, at), _value(e.r, at)
    return (a + b if e.op == "+" else a - b if e.op == "-" else a * b) % P


@pytest.mark.parametrize("gen", GENERATORS)
def test_generators_are_deterministic(gen):
    a = gen.build(P, 6, 21, RPK)
    b = gen.build(P, 6, 21, RPK)
    assert (a.public_inputs, a.constants, a.selectors, a.public_input) == \
        (b.public_inputs, b.constants, b.selectors, b.public_input)
    seed = draws.witness_seed(2 ** 40 + 3, 1)
    assert gen.witness(a, P, seed) == gen.witness(b, P, seed)


@pytest.mark.parametrize("gen", GENERATORS)
def test_witness_seed_changes_only_the_witness(gen):
    c = gen.build(P, 6, 21, RPK)
    fixed = (c.public_inputs, c.constants, c.selectors, c.public_input)
    a = gen.witness(c, P, draws.witness_seed(7, 0))
    b = gen.witness(c, P, draws.witness_seed(7, 1))
    assert a != b
    assert fixed == (c.public_inputs, c.constants, c.selectors,
                     c.public_input)


@pytest.mark.parametrize("gen", GENERATORS)
def test_every_witness_satisfies_its_circuit(gen):
    c = gen.build(P, 7, 21, RPK)
    desc = c.desc
    for k in range(3):
        a = c.assignment(gen.witness(c, P, draws.witness_seed(99, k)))
        cols = {RPK.WITNESS: a.witnesses, RPK.PUBLIC_INPUT: a.public_inputs,
                RPK.CONSTANT: a.constants, RPK.SELECTOR: a.selectors}
        for row in range(desc.usable_rows_amount):
            def at(v):
                return cols[v.type][v.index][(row + v.rotation)
                                             % desc.rows_amount]
            for gate in c.cs.gates:
                if a.selectors[gate.selector_index][row]:
                    assert all(_value(e, at) == 0 for e in gate.constraints)
            for gate in c.cs.lookup_gates:
                if a.selectors[gate.tag_index][row]:
                    for lc in gate.constraints:
                        table = c.cs.lookup_tables[lc.table_id - 1]
                        entries = {tuple(a.constants[v.index][r]
                                         for v in table.lookup_options[0])
                                   for r in range(desc.rows_amount)
                                   if a.selectors[table.tag_index][r]}
                        assert tuple(_value(e, at)
                                     for e in lc.lookup_input) in entries
        for x, y in c.cs.copy_constraints:
            assert cols[x.type][x.index][x.rotation] == \
                cols[y.type][y.index][y.rotation]


def test_at_the_source_size_they_are_the_source_circuits():
    from crypto3_zk_tpu_torch.arithmetization import circuits, plonk
    c1 = circuit_test_1.build(P, 4, 21, plonk)
    cs, a, desc, _ = circuits.circuit_1(P, random.Random(5), plonk)
    assert c1.desc == desc and c1.selectors == a.selectors
    assert c1.cs.gates == cs.gates
    assert c1.cs.copy_constraints == cs.copy_constraints
    assert (desc.usable_rows_amount, desc.rows_amount) == (13, 16)
    # circuits.hpp circuit_test_4: 5 usable rows of 8
    c4 = circuit_test_4.build(P, 3, 21, RPK)
    assert (c4.desc.witness_columns, c4.desc.public_input_columns,
            c4.desc.constant_columns, c4.desc.selector_columns,
            c4.desc.usable_rows_amount, c4.desc.rows_amount) == \
        (3, 0, 3, 3, 5, 8)
    assert c4.constants == [[0, 0, 0, 1, 1, 0, 0, 0],
                            [0, 0, 1, 0, 1, 0, 0, 0],
                            [0, 0, 0, 0, 1, 0, 0, 0]]
    assert c4.selectors == [[1, 1, 0, 1, 1, 0, 0, 0],
                            [1, 1, 1, 1, 1, 0, 0, 0],
                            [0, 1, 1, 1, 1, 0, 0, 0]]


def test_config_states_the_rows_the_cells_build():
    config = harness.load_json("configs", "placeholder_lpc")
    for cell in ("placeholder_lpc.r18.lookup", "placeholder_lpc.r18.gates"):
        w = harness.load_json("workloads", cell)
        from zkbench.systems.placeholder_lpc import build
        c = build(config, w, RPK)
        assert c.desc.rows_amount == 1 << config["rows_log2"]
        assert c.desc.usable_rows_amount == config["usable_rows"]
    assert harness.load_json("workloads", "placeholder_lpc.r18.gates")[
        "circuit"]["generator"] == "circuit_test_1"
    lookup = build(config, harness.load_json(
        "workloads", "placeholder_lpc.r18.lookup"), RPK)
    assert lookup.cs.lookup_gates and lookup.cs.lookup_tables
    gates = build(config, harness.load_json(
        "workloads", "placeholder_lpc.r18.gates"), RPK)
    assert not gates.cs.lookup_gates and not gates.cs.lookup_tables


@pytest.mark.parametrize("gen", GENERATORS)
def test_program_and_reference_builds_agree(gen):
    from crypto3_zk_tpu_torch.arithmetization import plonk, r1cs
    from crypto3_zk_tpu_torch.fields import params as fields
    from crypto3_zk_tpu_torch.models.placeholder import common
    from zkbench.reference.placeholder import circuit_hash
    c, rc = gen.build(P, 6, 21, plonk), gen.build(P, 6, 21, RPK)
    assert (c.public_inputs, c.constants, c.selectors, c.public_input) == \
        (rc.public_inputs, rc.constants, rc.selectors, rc.public_input)
    params = common.PlaceholderParams(fields.BLS12_381_FR)
    assert common.constraint_system_with_params_hash(
        params, c.cs, c.desc, "repr", 7) == \
        circuit_hash(P, rc.cs, rc.desc, "repr", 7)
    pc = product_chain.generate(P, 12, 3, 5, r1cs)
    rr = product_chain.generate(P, 12, 3, 5, RR)
    assert pc[1:] == rr[1:] and pc[0].num_constraints == 12


def test_chain_inputs_and_blinding_are_seeded_streams():
    assert draws.chain_inputs(2 ** 62, 3, P) == draws.chain_inputs(2 ** 62, 3, P)
    assert draws.chain_inputs(1, 0, P) != draws.chain_inputs(1, 1, P)
    assert draws.blinding(5, 0, P) != draws.blinding(5, -1, P)
