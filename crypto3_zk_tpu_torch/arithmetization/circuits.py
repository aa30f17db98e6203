"""Circuit fixtures for the port's smoke run and profiling: the R1CS the
Groth16 path is driven with, the PLONK table the Placeholder path is, and
the reference's small `circuit_1` (its test fixture `tests/circuits.py`,
after `circuits.hpp` circuit_test_1) for proofs over other fields.
"""
from __future__ import annotations

from . import plonk as _plonk
from . import r1cs as R


def product_chain(p: int, ncons: int, v1: int = 3, v2: int = 5):
    """The R1CS v_{i+2} = v_i * v_{i+1}, i < ncons, over F_p, with v_1 the
    public input. Every variable stands once on the A side and once on the B
    side, so all five query vectors of a Groth16 key are dense (a circuit
    with one variable on the whole B side leaves the G2 MSM nothing to do).
    Returns (constraint system, primary input, auxiliary input)."""
    cs = R.R1CSConstraintSystem(primary_input_size=1,
                                auxiliary_input_size=ncons + 1)
    vals = [v1 % p, v2 % p]
    for i in range(ncons):
        cs.add_constraint(R.lc((1 + i, 1)), R.lc((2 + i, 1)),
                          R.lc((3 + i, 1)))
        vals.append(vals[-2] * vals[-1] % p)
    return cs, vals[:1], vals[1:]


def circuit_1(p: int, rng, PK=_plonk):
    """3 witness columns, 1 public input column, 2 selectors (q_add,
    q_mul): ADD rows w0 + w1 = w2, MUL rows w0 * w1 = w2 with w1 copied from
    pub0[0]; 13 usable rows padded to 16. The same values as the JAX
    package's test fixture for the same `rng`. Returns (constraint system,
    assignment, table description, public input)."""
    usable_rows = 13
    w = [[0] * usable_rows for _ in range(3)]
    pub = [0] * usable_rows
    q_add = [0] * usable_rows
    q_mul = [0] * usable_rows
    copies = []
    pub[0] = rng.randrange(p)
    w[0][0], w[1][0], w[2][0] = (rng.randrange(p) for _ in range(3))
    for i in range(1, usable_rows - 5):
        w[0][i] = rng.randrange(p)
        w[1][i] = rng.randrange(p)
        w[2][i] = (w[0][i] + w[1][i]) % p
        q_add[i] = 1
    for i in range(usable_rows - 5, usable_rows):
        w[0][i] = rng.randrange(p)
        w[1][i] = pub[0]
        w[2][i] = w[0][i] * w[1][i] % p
        q_mul[i] = 1
        copies.append((PK.Var(1, i, PK.WITNESS),
                       PK.Var(0, 0, PK.PUBLIC_INPUT)))
    rows = PK.pad_rows(usable_rows)
    for col in w:
        col.extend(rng.randrange(p) for _ in range(rows - usable_rows))
    pub.extend([0] * (rows - usable_rows))
    q_add.extend([0] * (rows - usable_rows))
    q_mul.extend([0] * (rows - usable_rows))
    assignment = PK.Assignment(w, [pub], [], [q_add, q_mul])
    desc = PK.TableDescription(3, 1, 0, 2, usable_rows, rows)
    w0, w1, w2 = (PK.Var(i, 0, PK.WITNESS) for i in range(3))
    cs = PK.ConstraintSystem(
        gates=[PK.Gate(0, [w0 + w1 - w2]), PK.Gate(1, [w0 * w1 - w2])],
        copy_constraints=copies, public_input_sizes=[1])
    return cs, assignment, desc, [[pub[0]]]


def placeholder_chain(p: int, usable_rows: int, rng, table_bits: int = 8,
                      PK=_plonk):
    """A PLONK table that runs all three Placeholder arguments, over F_p:

    - gates: the add/mul chain of the JAX package's `bench.py` Placeholder
      circuit: 3 witness columns, row i >= 1 takes w0[i] = w2[i-1] and a
      random w1[i], odd rows add (selector q_add), even rows multiply
      (q_mul); row 0 holds random w1, w2 and w0[0] = pub0[0];
    - copy constraints: every link w0[i] = w2[i-1] and w0[0] = pub0[0], so
      the permutation argument runs over w0, w2 and pub0;
    - lookup: a fourth witness column of values below 2^table_bits, range
      checked (selector tag_gate, rows after the table region up to the
      second-last usable row) into a table of 0 .. 2^table_bits - 1 held in
      one constant column under the selector tag_table at rows
      1 .. 2^table_bits (row 0 stays zero, as the lookup sort needs).

    4 witness, 1 public input, 1 constant and 4 selector columns; the rows
    past `usable_rows` are zero-knowledge padding (random witness values).
    `usable_rows = 2^k - 6` pads to 2^k rows. `PK` is the module whose
    classes build the circuit (this port's `plonk` by default). Returns
    (constraint system, assignment, table description, public input)."""
    size = 1 << table_bits
    rows = PK.pad_rows(usable_rows)
    if size + 3 > usable_rows:
        raise ValueError(f"{usable_rows} usable rows leave no lookup rows "
                         f"after a table of {size}")
    w = [[0] * usable_rows for _ in range(4)]
    pub = [0] * usable_rows
    const = [0] * usable_rows
    q_add, q_mul, tag_table, tag_gate = ([0] * usable_rows for _ in range(4))
    copies = []

    pub[0] = rng.randrange(p)
    w[0][0], w[1][0], w[2][0] = pub[0], rng.randrange(p), rng.randrange(p)
    copies.append((PK.Var(0, 0, PK.WITNESS), PK.Var(0, 0, PK.PUBLIC_INPUT)))
    for i in range(1, usable_rows):
        w[0][i] = w[2][i - 1]
        w[1][i] = rng.randrange(p)
        if i % 2:
            w[2][i] = (w[0][i] + w[1][i]) % p
            q_add[i] = 1
        else:
            w[2][i] = w[0][i] * w[1][i] % p
            q_mul[i] = 1
        copies.append((PK.Var(0, i, PK.WITNESS), PK.Var(2, i - 1, PK.WITNESS)))
    for t in range(size):
        const[t + 1] = t
        tag_table[t + 1] = 1
    for i in range(usable_rows):
        w[3][i] = rng.randrange(size)
    for i in range(size + 1, usable_rows - 1):
        tag_gate[i] = 1

    for col in w:
        col.extend(rng.randrange(p) for _ in range(rows - usable_rows))
    for col in (pub, const, q_add, q_mul, tag_table, tag_gate):
        col.extend([0] * (rows - usable_rows))

    assignment = PK.Assignment(w, [pub], [const],
                               [q_add, q_mul, tag_table, tag_gate])
    desc = PK.TableDescription(4, 1, 1, 4, usable_rows, rows)
    w0, w1, w2 = (PK.Var(i, 0, PK.WITNESS) for i in range(3))
    table = PK.LookupTable(tag_index=2, columns_number=1)
    table.append_option([PK.Var(0, 0, PK.CONSTANT)])
    cs = PK.ConstraintSystem(
        gates=[PK.Gate(0, [w0 + w1 - w2]), PK.Gate(1, [w0 * w1 - w2])],
        copy_constraints=copies,
        lookup_gates=[PK.LookupGate(3, [PK.LookupConstraint(
            1, [PK.Var(3, 0, PK.WITNESS)])])],
        lookup_tables=[table],
        public_input_sizes=[1])
    return cs, assignment, desc, [[pub[0]]]
