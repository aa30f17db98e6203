"""Counterpart of `utils/zkllvm.py` of the JAX package: the parser only
(host only).

Loader for zkLLVM/proof-producer circuit dumps (`.crct` / `.tbl`).

The reference ships real Placeholder circuits as marshalled dumps under
`test/systems/plonk/placeholder/data/{merkle_tree_poseidon,many_hashes}/`,
consumed by downstream proof-producer tooling. The wire format (from nil's
crypto3-marshalling sibling repo, reverse-engineered here from the dumps
themselves and validated by evaluating every gate on the shipped
assignment):

Both files are one ASCII blob `0x<hex>`; the decoded bytes are big-endian
structures:

`.crct` (plonk_constraint_system):
    u64 n_gates
    gate := u64 selector_index, u64 n_constraints, constraint*
    constraint (expression AST, `zk/math/expression.hpp:45-176` node lists):
        u64 n_terms,   term*     term := fe32 coeff, u64 n_vars, var*
        u64 n_pows,    pow*      pow  := u64 exponent, ref base
        u64 n_binops,  binop*    binop:= u8 op (0=add,1=sub,2=mul),
                                          ref left, ref right
        ref root                  ref := u8 node_type (0=term,1=pow,
                                          2=binop), u32 index
    var := u64 index, i32 rotation, u8 relative, u8 type
           (type: 0=witness 1=public_input 2=constant 3=selector;
            in copy constraints relative=0 and rotation = absolute row)
    u64 n_copy_constraints, (var, var)*
    u64 n_lookup_gates,  lookup_gate*   (tag_index, constraints of
                                         (table_id, n_inputs, expr*))
    u64 n_lookup_tables, lookup_table*  (tag_index, columns_number,
                                         options of var lists)

`.tbl` (plonk_assignment_table):
    u64 usable_rows, u64 n_columns, u64 n_elements (= n_columns * rows)
    fe32 * n_elements, column-major
    Column-type split is NOT in the file — it is the zkLLVM assigner
    default (15 witness / 1 public_input / 5 constant / 35 selector),
    overridable by the caller.
"""
from __future__ import annotations

import dataclasses

from ..arithmetization import plonk as PK

_COL_TYPES = (PK.WITNESS, PK.PUBLIC_INPUT, PK.CONSTANT, PK.SELECTOR)
_OPS = ("+", "-", "*")


class _Reader:
    def __init__(self, path: str):
        with open(path) as f:
            text = f.read().strip()
        if not text.startswith("0x"):
            raise ValueError(f"{path}: expected 0x-prefixed hex blob")
        self.b = bytes.fromhex(text[2:])
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.b):
            raise ValueError(f"truncated stream at byte {self.pos}")
        v = self.b[self.pos:self.pos + n]
        self.pos += n
        return v

    def u64(self) -> int:
        return int.from_bytes(self._take(8), "big")

    def u32(self) -> int:
        return int.from_bytes(self._take(4), "big")

    def i32(self) -> int:
        return int.from_bytes(self._take(4), "big", signed=True)

    def u8(self) -> int:
        return self._take(1)[0]

    def fe(self) -> int:
        return int.from_bytes(self._take(32), "big")

    def var(self) -> PK.Var:
        index = self.u64()
        rotation = self.i32()
        _relative = self.u8()
        col_type = self.u8()
        return PK.Var(index, rotation, _COL_TYPES[col_type])

    def ref(self) -> tuple[int, int]:
        return (self.u8(), self.u32())

    def expr(self) -> PK.Expr:
        terms = []
        for _ in range(self.u64()):
            coeff = self.fe()
            vs = [self.var() for _ in range(self.u64())]
            e = PK.Const(coeff) if (not vs or coeff != 1) else None
            for v in vs:
                e = v if e is None else PK.BinOp("*", e, v)
            terms.append(e)
        pows = [(self.u64(), self.ref()) for _ in range(self.u64())]
        binops = [(self.u8(), self.ref(), self.ref())
                  for _ in range(self.u64())]
        root = self.ref()

        def node(ref, _depth=0):
            kind, idx = ref
            if kind == 0:
                return terms[idx]
            if kind == 1:
                exp, base = pows[idx]
                return PK.Pow(node(base, _depth + 1), exp)
            if kind == 2:
                op, l, r = binops[idx]
                return PK.BinOp(_OPS[op], node(l, _depth + 1),
                                node(r, _depth + 1))
            raise ValueError(f"bad expression node type {kind}")

        return node(root)


def load_circuit(path: str) -> PK.ConstraintSystem:
    """Parse a `.crct` dump into a ConstraintSystem."""
    r = _Reader(path)
    gates = []
    for _ in range(r.u64()):
        selector_index = r.u64()
        constraints = [r.expr() for _ in range(r.u64())]
        gates.append(PK.Gate(selector_index, constraints))
    copy_constraints = [(r.var(), r.var()) for _ in range(r.u64())]
    lookup_gates = []
    for _ in range(r.u64()):
        tag_index = r.u64()
        cons = []
        for _ in range(r.u64()):
            table_id = r.u64()
            inputs = [r.expr() for _ in range(r.u64())]
            cons.append(PK.LookupConstraint(table_id, inputs))
        lookup_gates.append(PK.LookupGate(tag_index, cons))
    lookup_tables = []
    for _ in range(r.u64()):
        tag_index = r.u64()
        columns_number = r.u64()
        table = PK.LookupTable(tag_index, columns_number)
        for _ in range(r.u64()):
            table.append_option([r.var() for _ in range(columns_number)])
        lookup_tables.append(table)
    if r.pos != len(r.b):
        raise ValueError(f"{path}: {len(r.b) - r.pos} trailing bytes "
                         f"(format drift?)")
    return PK.ConstraintSystem(gates=gates,
                               copy_constraints=copy_constraints,
                               lookup_gates=lookup_gates,
                               lookup_tables=lookup_tables)


@dataclasses.dataclass
class LoadedTable:
    assignment: PK.Assignment
    desc: PK.TableDescription
    public_input: list[list[int]]


def load_assignment_table(path: str,
                          witness_columns: int = 15,
                          public_input_columns: int = 1,
                          constant_columns: int = 5,
                          selector_columns: int = 35) -> LoadedTable:
    """Parse a `.tbl` dump into (Assignment, TableDescription, public
    input). The column split defaults to the zkLLVM assigner layout."""
    r = _Reader(path)
    usable_rows = r.u64()
    n_columns = r.u64()
    n_elements = r.u64()
    split = (witness_columns, public_input_columns, constant_columns,
             selector_columns)
    if sum(split) != n_columns:
        raise ValueError(f"{path}: {n_columns} columns != split {split}")
    if n_elements % n_columns:
        raise ValueError(f"{path}: {n_elements} elements not divisible by "
                         f"{n_columns} columns")
    rows = n_elements // n_columns
    cols = [[r.fe() for _ in range(rows)] for _ in range(n_columns)]
    if r.pos != len(r.b):
        raise ValueError(f"{path}: {len(r.b) - r.pos} trailing bytes")
    w = cols[:witness_columns]
    pi_end = witness_columns + public_input_columns
    pub = cols[witness_columns:pi_end]
    const = cols[pi_end:pi_end + constant_columns]
    sel = cols[pi_end + constant_columns:]
    assignment = PK.Assignment(w, pub, const, sel)
    desc = PK.TableDescription(witness_columns, public_input_columns,
                               constant_columns, selector_columns,
                               usable_rows, rows)
    # the verifier's Lagrange-sum consistency check needs the claimed
    # public input values: the used prefix of each public-input column
    public_input = []
    for col in pub:
        last = max((i for i, v in enumerate(col) if v), default=-1)
        public_input.append(col[:last + 1])
    return LoadedTable(assignment, desc, public_input)
