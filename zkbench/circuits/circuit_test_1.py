"""crypto3-zk's Placeholder test circuit `circuit_test_1`
(`test/systems/plonk/placeholder/circuits.hpp:92-186`) with its rows scaled.

A frozen copy of the port's `arithmetization/circuits.py::circuit_1` (after
the JAX package's test fixture `tests/circuits.py::circuit_1`) with two
changes: the table has 2^rows_log2 rows, of which the last 3 are padding as
in the source's 13 of 16, and the draws are split between a circuit seed
(the public input, which the preprocessor reads) and a witness seed (every
other drawn value), so that one preprocessed circuit proves many witnesses.

- 3 witness, 1 public input, 0 constant and 2 selector columns;
- row 0: random w0, w1, w2 under no gate;
- ADD rows 1 .. usable - 6: random w0, w1 and w2 = w0 + w1 (selector q_add);
- MUL rows, the last 5 usable rows: random w0, w1 = pub0[0] (a copy
  constraint) and w2 = w0 * w1 (selector q_mul);
- padding rows: random witness values, zero public input and selectors.
"""
from __future__ import annotations

import random

from . import Circuit, field_elements

PADDING = 3          # the source's 16 - 13
MUL_ROWS = 5


def build(p: int, rows_log2: int, circuit_seed: int, PK) -> Circuit:
    rows = 1 << rows_log2
    usable = rows - PADDING
    if PK.pad_rows(usable) != rows or usable < MUL_ROWS + 2:
        raise ValueError(f"2^{rows_log2} rows do not hold the circuit")
    pub = [0] * rows
    pub[0] = random.Random(circuit_seed).randrange(p)
    q_add, q_mul = [0] * rows, [0] * rows
    for i in range(1, usable - MUL_ROWS):
        q_add[i] = 1
    copies = []
    for i in range(usable - MUL_ROWS, usable):
        q_mul[i] = 1
        copies.append((PK.Var(1, i, PK.WITNESS),
                       PK.Var(0, 0, PK.PUBLIC_INPUT)))
    w0, w1, w2 = (PK.Var(i, 0, PK.WITNESS) for i in range(3))
    cs = PK.ConstraintSystem(
        gates=[PK.Gate(0, [w0 + w1 - w2]), PK.Gate(1, [w0 * w1 - w2])],
        copy_constraints=copies, public_input_sizes=[1])
    desc = PK.TableDescription(3, 1, 0, 2, usable, rows)
    return Circuit(cs, desc, [pub], [], [q_add, q_mul], [[pub[0]]], PK)


def witness(circuit: Circuit, p: int, witness_seed: str) -> list[list[int]]:
    rng = random.Random(witness_seed)
    rows = circuit.desc.rows_amount
    usable = circuit.desc.usable_rows_amount
    pub0 = circuit.public_inputs[0][0]
    w0, w1, w2 = (field_elements(rng, p, rows) for _ in range(3))
    mul = usable - MUL_ROWS
    for i in range(1, mul):
        w2[i] = (w0[i] + w1[i]) % p
    for i in range(mul, usable):
        w1[i] = pub0
        w2[i] = w0[i] * pub0 % p
    return [w0, w1, w2]
