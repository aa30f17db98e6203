"""crypto3-zk's Placeholder test circuit `circuit_test_4`
(`test/systems/plonk/placeholder/circuits.hpp:449-565`, binary
multiplication with a lookup) with its rows scaled.

A frozen copy of the JAX package's test fixture `tests/circuits.py::
circuit_4` with two changes: the table has 2^rows_log2 rows, of which the
last 3 are padding as in the source's 5 of 8, and the source's 5 usable
rows are tiled over the usable rows; and the witness is drawn from a
witness seed (the circuit draws nothing), so that one preprocessed circuit
proves many witnesses.

- 3 witness, 0 public input, 3 constant and 3 selector columns;
- constant rows 1 .. 4 hold the binary product table (a, b, a * b) under
  the table's tag selector (selector 2); row 0 and every later row are 0;
- every usable row multiplies (selector 1: w0 * w1 = w2); in each run of 5
  usable rows, the third holds two random field elements and their product
  and the other four two random bits and their product, looked up in the
  table (selector 0: (w0, w1, w2) is a row of the table);
- padding rows: zero, as in the source.
"""
from __future__ import annotations

import random

from . import Circuit, field_elements

PADDING = 3          # the source's 8 - 5
PERIOD, FREE_ROW = 5, 2
TABLE = [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 1)]


def build(p: int, rows_log2: int, circuit_seed: int, PK) -> Circuit:
    rows = 1 << rows_log2
    usable = rows - PADDING
    if PK.pad_rows(usable) != rows or usable <= len(TABLE):
        raise ValueError(f"2^{rows_log2} rows do not hold the circuit")
    consts = [[0] * rows for _ in range(3)]
    tag = [0] * rows
    for r, entry in enumerate(TABLE, start=1):
        for c, v in enumerate(entry):
            consts[c][r] = v
        tag[r] = 1
    lookup = [0 if i % PERIOD == FREE_ROW else 1 for i in range(usable)] \
        + [0] * PADDING
    mul = [1] * usable + [0] * PADDING
    v0, v1, v2 = (PK.Var(i, 0, PK.WITNESS) for i in range(3))
    table = PK.LookupTable(tag_index=2, columns_number=3)
    table.append_option([PK.Var(i, 0, PK.CONSTANT) for i in range(3)])
    gate = PK.LookupGate(tag_index=0, constraints=[
        PK.LookupConstraint(table_id=1, lookup_input=[v0, v1, v2])])
    cs = PK.ConstraintSystem(gates=[PK.Gate(1, [v0 * v1 - v2])],
                             lookup_gates=[gate], lookup_tables=[table])
    desc = PK.TableDescription(3, 0, 3, 3, usable, rows)
    return Circuit(cs, desc, [], consts, [lookup, mul, tag], [], PK)


def witness(circuit: Circuit, p: int, witness_seed: str) -> list[list[int]]:
    rng = random.Random(witness_seed)
    rows = circuit.desc.rows_amount
    usable = circuit.desc.usable_rows_amount
    free = range(FREE_ROW, usable, PERIOD)
    a, b = (field_elements(rng, p, len(free)) for _ in range(2))
    bits = rng.randbytes(-(-usable // 4))     # four (w0, w1) pairs a byte
    w0 = [(bits[i >> 2] >> (2 * (i & 3))) & 1 for i in range(usable)] \
        + [0] * PADDING
    w1 = [(bits[i >> 2] >> (2 * (i & 3) + 1)) & 1 for i in range(usable)] \
        + [0] * PADDING
    for j, i in enumerate(free):
        w0[i], w1[i] = a[j], b[j]
    w2 = [x * y % p for x, y in zip(w0, w1)]
    return [w0, w1, w2]
