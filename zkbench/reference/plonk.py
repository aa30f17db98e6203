"""PLONK circuit description for the reference: variables, constraint
expressions, gates, lookup tables, the table description and the column
assignment.

A frozen copy of the port's host module `arithmetization/plonk.py`, kept
here so that the reference builds its circuits without importing the
program. The circuit generators of `zkbench/circuits/` take the module that
builds the circuit as an argument: the benchmark hands the port's module to
the program's side and this one to the reference, so both sides receive the
same circuit from the same seed. Expressions print the same strings as the
port's, which the reference's transcript needs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

WITNESS = "witness"
PUBLIC_INPUT = "public_input"
CONSTANT = "constant"
SELECTOR = "selector"
_COL_ORDER = (WITNESS, PUBLIC_INPUT, CONSTANT, SELECTOR)


class Expr:
    """Base expression node; operators build the AST."""

    def _wrap(self, o):
        if isinstance(o, Expr):
            return o
        return Const(int(o))

    def __add__(self, o):
        return BinOp("+", self, self._wrap(o))

    def __radd__(self, o):
        return BinOp("+", self._wrap(o), self)

    def __sub__(self, o):
        return BinOp("-", self, self._wrap(o))

    def __rsub__(self, o):
        return BinOp("-", self._wrap(o), self)

    def __mul__(self, o):
        return BinOp("*", self, self._wrap(o))

    def __rmul__(self, o):
        return BinOp("*", self._wrap(o), self)

    def __neg__(self):
        return BinOp("-", Const(0), self)

    def __pow__(self, e: int):
        return Pow(self, int(e))


@dataclasses.dataclass(frozen=True)
class Var(Expr):
    """(index, rotation, column type) — `plonk_variable`."""
    index: int
    rotation: int = 0
    type: str = WITNESS

    def __repr__(self):
        r = f"[{self.rotation:+d}]" if self.rotation else ""
        return f"{self.type[0]}{self.index}{r}"


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    v: int


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str
    l: Expr
    r: Expr


@dataclasses.dataclass(frozen=True)
class Pow(Expr):
    base: Expr
    exp: int


def expr_max_degree(expr: Expr) -> int:
    """`expression_max_degree_visitor` (`expression_visitors.hpp:38`)."""
    if isinstance(expr, Var):
        return 1
    if isinstance(expr, Const):
        return 0
    if isinstance(expr, BinOp):
        a, b = expr_max_degree(expr.l), expr_max_degree(expr.r)
        return a + b if expr.op == "*" else max(a, b)
    if isinstance(expr, Pow):
        return expr_max_degree(expr.base) * expr.exp
    raise TypeError(expr)


def expr_for_each_variable(expr: Expr, fn: Callable[[Var], None]) -> None:
    if isinstance(expr, Var):
        fn(expr)
    elif isinstance(expr, BinOp):
        expr_for_each_variable(expr.l, fn)
        expr_for_each_variable(expr.r, fn)
    elif isinstance(expr, Pow):
        expr_for_each_variable(expr.base, fn)


@dataclasses.dataclass
class Gate:
    """selector + constraints (`gate.hpp:39-63`)."""
    selector_index: int
    constraints: list[Expr]


@dataclasses.dataclass
class LookupConstraint:
    """table_id + lookup input expressions (`lookup_constraint.hpp:59`)."""
    table_id: int
    lookup_input: list[Expr]


@dataclasses.dataclass
class LookupGate:
    tag_index: int
    constraints: list[LookupConstraint]


@dataclasses.dataclass
class LookupTable:
    """tag + options of constant columns (`lookup_table.hpp:74`)."""
    tag_index: int
    columns_number: int
    lookup_options: list[list[Var]] = dataclasses.field(default_factory=list)

    def append_option(self, columns: list[Var]):
        assert len(columns) == self.columns_number
        self.lookup_options.append(columns)


@dataclasses.dataclass
class TableDescription:
    """`plonk_table_description` (`table_description.hpp:39-103`)."""
    witness_columns: int
    public_input_columns: int
    constant_columns: int
    selector_columns: int
    usable_rows_amount: int = 0
    rows_amount: int = 0

    def global_index(self, v: Var) -> int:
        base = {
            WITNESS: 0,
            PUBLIC_INPUT: self.witness_columns,
            CONSTANT: self.witness_columns + self.public_input_columns,
            SELECTOR: self.witness_columns + self.public_input_columns
            + self.constant_columns,
        }[v.type]
        return base + v.index

    def table_width(self) -> int:
        return (self.witness_columns + self.public_input_columns
                + self.constant_columns + self.selector_columns)


@dataclasses.dataclass
class ConstraintSystem:
    """`plonk_constraint_system` (`constraint_system.hpp:56-313`)."""
    gates: list[Gate] = dataclasses.field(default_factory=list)
    copy_constraints: list[tuple[Var, Var]] = dataclasses.field(default_factory=list)
    lookup_gates: list[LookupGate] = dataclasses.field(default_factory=list)
    lookup_tables: list[LookupTable] = dataclasses.field(default_factory=list)
    public_input_sizes: list[int] = dataclasses.field(default_factory=list)

    def max_gates_degree(self) -> int:
        d = 0
        for g in self.gates:
            for c in g.constraints:
                d = max(d, expr_max_degree(c))
        return d

    def max_lookup_gates_degree(self) -> int:
        d = 0
        for g in self.lookup_gates:
            for c in g.constraints:
                for e in c.lookup_input:
                    d = max(d, expr_max_degree(e))
        return d

    def permuted_columns(self, desc: TableDescription) -> list[Var]:
        """Distinct zero-rotation columns appearing in copy constraints,
        ordered by global index (`constraint_system.hpp:101-110`; the
        reference's unordered_set is consumed through global_index sort)."""
        seen = {}
        for (a, b) in self.copy_constraints:
            for v in (a, b):
                key = (v.type, v.index)
                if key not in seen:
                    seen[key] = Var(v.index, 0, v.type)
        return sorted(seen.values(), key=desc.global_index)

    def lookup_poly_degree_bound(self) -> int:
        """`constraint_system.hpp:235-253`: degree bound of the lookup
        argument's F[2] in units of (rows-1) — a SUM of (max input degree
        + 1) per lookup constraint plus 3 per table option."""
        if not self.lookup_gates:
            return 0
        d = 0
        for g in self.lookup_gates:
            for c in g.constraints:
                deg = max((expr_max_degree(e) for e in c.lookup_input),
                          default=0)
                d += deg + 1
        for t in self.lookup_tables:
            d += 3 * len(t.lookup_options)
        return d

    def sorted_lookup_columns_number(self) -> int:
        if not self.lookup_gates:
            return 0
        return self.lookup_constraints_number() + self.lookup_options_number()

    def lookup_options_number(self) -> int:
        return sum(len(t.lookup_options) for t in self.lookup_tables)

    def lookup_constraints_number(self) -> int:
        return sum(len(g.constraints) for g in self.lookup_gates)

class Assignment:
    """Column assignment table over host ints (`assignment.hpp:55-504`).
    Column layout: witnesses / public_inputs / constants / selectors, each a
    list of per-row int lists."""

    def __init__(self, witnesses: list[list[int]],
                 public_inputs: list[list[int]],
                 constants: list[list[int]],
                 selectors: list[list[int]]):
        self.witnesses = witnesses
        self.public_inputs = public_inputs
        self.constants = constants
        self.selectors = selectors


def pad_rows(n: int, minimum: int = 8) -> int:
    """Next power of two >= max(n, minimum) (`padding.hpp:40-80`)."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()
