"""Circuit fixtures and frontends.

- Fixtures for the port's smoke run and profiling: the R1CS the Groth16
  path is driven with, the PLONK table the Placeholder path is, and the
  reference's small `circuit_1` (its test fixture `tests/circuits.py`,
  after `circuits.hpp` circuit_test_1) for proofs over other fields.
- The TBCS / BACS circuit frontends and their reductions to USCS / R1CS,
  the counterpart of `arithmetization/circuits.py` of the JAX package
  (`arithmetization/circuit_satisfaction_problems/{tbcs,bacs}/` +
  `reductions/{tbcs_to_uscs,bacs_to_r1cs}.hpp`):
  - TBCS: two-input boolean circuits; wires are 1-based (0 = constant one
    pseudo-wire); each gate has one of 16 truth-table types and is reduced
    to one USCS constraint (the +-1 encodings from
    `tbcs_to_uscs.hpp:75-160`) plus binarity constraints and output-zero
    constraints;
  - BACS: bilinear arithmetic circuits; gate = lhs(lc) * rhs(lc) -> out,
    reduced 1:1 to R1CS constraints with circuit outputs forced to zero.
"""
from __future__ import annotations

import dataclasses

from . import plonk as _plonk
from . import r1cs as R
from .r1cs import LinearCombination, R1CSConstraintSystem, lc
from .uscs import USCSConstraintSystem


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


def tbcs_chain(n_gates: int, rng):
    """A satisfiable TBCS circuit of `n_gates` gates: two primary inputs
    (1, 0), each gate of a random type over two random earlier wires, and a
    last CONSTANT_0 gate that is the circuit's output (it must be 0). Its
    USCS reduction has about 2 * n_gates constraints. Returns (circuit,
    primary input, auxiliary input)."""
    c = TBCSCircuit(primary_input_size=2, auxiliary_input_size=0)
    for i in range(n_gates - 1):
        wires = 2 + i
        c.gates.append(TBCSGate(rng.randrange(1, wires + 1),
                                rng.randrange(1, wires + 1),
                                rng.randrange(16), wires + 1))
    c.gates.append(TBCSGate(1, 2, TBCS_GATE_CONSTANT_0, n_gates + 2,
                            is_circuit_output=True))
    return c, [1, 0], []


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


# TBCS gate types by truth table (00, 01, 10, 11) bits
TBCS_GATE_CONSTANT_0 = 0
TBCS_GATE_AND = 1
TBCS_GATE_X_AND_NOT_Y = 2
TBCS_GATE_X = 3
TBCS_GATE_NOT_X_AND_Y = 4
TBCS_GATE_Y = 5
TBCS_GATE_XOR = 6
TBCS_GATE_OR = 7
TBCS_GATE_NOR = 8
TBCS_GATE_EQUIVALENCE = 9
TBCS_GATE_NOT_Y = 10
TBCS_GATE_IF_Y_THEN_X = 11
TBCS_GATE_NOT_X = 12
TBCS_GATE_IF_X_THEN_Y = 13
TBCS_GATE_NAND = 14
TBCS_GATE_CONSTANT_1 = 15


def tbcs_gate_eval(gate_type: int, x: int, y: int) -> int:
    """Gate ordinal encodes the truth table (00,01,10,11) big-endian:
    the (1,1) entry is the least significant bit."""
    return (gate_type >> (3 - (2 * x + y))) & 1


@dataclasses.dataclass
class TBCSGate:
    left_wire: int
    right_wire: int
    type: int
    output: int
    is_circuit_output: bool = False


@dataclasses.dataclass
class TBCSCircuit:
    primary_input_size: int
    auxiliary_input_size: int
    gates: list[TBCSGate] = dataclasses.field(default_factory=list)

    def num_wires(self) -> int:
        return (self.primary_input_size + self.auxiliary_input_size
                + len(self.gates))

    def get_all_wires(self, primary, aux) -> list[int]:
        wires = [1] + list(primary) + list(aux)  # index 0 = constant one
        for g in self.gates:
            wires.append(tbcs_gate_eval(g.type, wires[g.left_wire],
                                        wires[g.right_wire]))
        return wires[1:]

    def is_satisfied(self, primary, aux) -> bool:
        wires = [1] + self.get_all_wires(primary, aux)
        return all(wires[g.output] == 0
                   for g in self.gates if g.is_circuit_output)


# USCS encodings: (cx, cy, cz, c1) per gate type (`tbcs_to_uscs.hpp:75-160`)
_TBCS_USCS = {
    TBCS_GATE_CONSTANT_0: (0, 0, 1, 1),
    TBCS_GATE_AND: (-2, -2, 4, 1),
    TBCS_GATE_X_AND_NOT_Y: (-2, 2, 4, -1),
    TBCS_GATE_X: (-1, 0, 1, 1),
    TBCS_GATE_NOT_X_AND_Y: (2, -2, 4, -1),
    TBCS_GATE_Y: (0, 1, 1, -1),
    TBCS_GATE_XOR: (1, 1, 1, -1),
    TBCS_GATE_OR: (-2, -2, 4, -1),
    TBCS_GATE_NOR: (2, 2, 4, -3),
    TBCS_GATE_EQUIVALENCE: (1, 1, 1, -2),
    TBCS_GATE_NOT_Y: (0, -1, 1, 0),
    TBCS_GATE_IF_Y_THEN_X: (-2, 2, 4, -3),
    TBCS_GATE_NOT_X: (-1, 0, 1, 0),
    TBCS_GATE_IF_X_THEN_Y: (2, -2, 4, -3),
    TBCS_GATE_NAND: (2, 2, 4, -5),
    TBCS_GATE_CONSTANT_1: (0, 0, 1, 0),
}


def tbcs_to_uscs_instance(circuit: TBCSCircuit) -> USCSConstraintSystem:
    """`tbcs_to_uscs.hpp:63-170`."""
    out = USCSConstraintSystem(
        primary_input_size=circuit.primary_input_size,
        auxiliary_input_size=circuit.auxiliary_input_size
        + len(circuit.gates))
    for g in circuit.gates:
        cx, cy, cz, c1 = _TBCS_USCS[g.type]
        terms = []
        if cx:
            terms.append((g.left_wire, cx))
        if cy:
            terms.append((g.right_wire, cy))
        terms.append((g.output, cz))
        if c1:
            terms.append((0, c1))
        out.add_constraint(LinearCombination(terms))
    for i in range(circuit.num_wires() + 1):
        # 2*wire - 1 in {-1, 1}  <=>  wire in {0, 1} (wire 0 is the one)
        out.add_constraint(LinearCombination([(i, 2), (0, -1)]))
    for g in circuit.gates:
        if g.is_circuit_output:
            out.add_constraint(LinearCombination([(g.output, 1), (0, 1)]))
    return out


def tbcs_to_uscs_witness(circuit: TBCSCircuit, primary, aux) -> list[int]:
    return circuit.get_all_wires(primary, aux)


# ---------------------------------------------------------------------------
# BACS
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BACSGate:
    lhs: LinearCombination
    rhs: LinearCombination
    output: int
    is_circuit_output: bool = False


@dataclasses.dataclass
class BACSCircuit:
    primary_input_size: int
    auxiliary_input_size: int
    gates: list[BACSGate] = dataclasses.field(default_factory=list)

    def num_wires(self) -> int:
        return (self.primary_input_size + self.auxiliary_input_size
                + len(self.gates))

    def get_all_wires(self, p: int, primary, aux) -> list[int]:
        wires = [1] + list(primary) + list(aux)
        for g in self.gates:
            wires.append(g.lhs.evaluate(p, wires)
                         * g.rhs.evaluate(p, wires) % p)
        return wires[1:]

    def is_satisfied(self, p: int, primary, aux) -> bool:
        wires = [1] + self.get_all_wires(p, primary, aux)
        return all(wires[g.output] == 0
                   for g in self.gates if g.is_circuit_output)


def bacs_to_r1cs_instance(circuit: BACSCircuit) -> R1CSConstraintSystem:
    """`bacs_to_r1cs.hpp`: gate lhs*rhs = out; outputs forced to 0 via
    out * 1 = 0."""
    out = R1CSConstraintSystem(
        primary_input_size=circuit.primary_input_size,
        auxiliary_input_size=circuit.auxiliary_input_size
        + len(circuit.gates))
    for g in circuit.gates:
        out.add_constraint(g.lhs, g.rhs, lc((g.output, 1)))
    for g in circuit.gates:
        if g.is_circuit_output:
            out.add_constraint(lc((g.output, 1)), lc((0, 1)),
                               LinearCombination([]))
    return out


def bacs_to_r1cs_witness(circuit: BACSCircuit, p: int, primary, aux) -> list[int]:
    return circuit.get_all_wires(p, primary, aux)
