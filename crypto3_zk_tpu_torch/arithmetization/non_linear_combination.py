"""Counterpart of `arithmetization/non_linear_combination.py` of the JAX
package (host only).

Legacy flattened constraint form: sums of variable-product terms.

`zk/math/non_linear_combination.hpp:46-292` — the pre-expression-AST
representation of PLONK constraints: a combination is a list of terms,
each term a coefficient times a product of variables. The modern path is
the `Expr` AST in `plonk.py`; this form survives as the target of
`expression_to_non_linear_combination` (`expression_visitors.hpp`), useful
for degree counting and for exporting constraints to flat formats.
"""
from __future__ import annotations

import dataclasses

from .plonk import BinOp, Const, Expr, Pow, Var


@dataclasses.dataclass(frozen=True)
class NonLinearTerm:
    coeff: int
    vars: tuple            # tuple of Var, sorted for canonical form

    def degree(self) -> int:
        return len(self.vars)


class NonLinearCombination:
    def __init__(self, terms: list[NonLinearTerm] | None = None):
        self.terms: list[NonLinearTerm] = list(terms or [])

    @classmethod
    def from_var(cls, v: Var) -> "NonLinearCombination":
        return cls([NonLinearTerm(1, (v,))])

    @classmethod
    def constant(cls, c: int) -> "NonLinearCombination":
        return cls([NonLinearTerm(c, ())]) if c else cls()

    def __add__(self, other: "NonLinearCombination") -> "NonLinearCombination":
        return NonLinearCombination(self.terms + other.terms)

    def __neg__(self) -> "NonLinearCombination":
        return NonLinearCombination(
            [NonLinearTerm(-t.coeff, t.vars) for t in self.terms])

    def __sub__(self, other: "NonLinearCombination") -> "NonLinearCombination":
        return self + (-other)

    def __mul__(self, other: "NonLinearCombination") -> "NonLinearCombination":
        out = []
        for a in self.terms:
            for b in other.terms:
                out.append(NonLinearTerm(
                    a.coeff * b.coeff,
                    tuple(sorted(a.vars + b.vars,
                                 key=lambda v: (v.type, v.index, v.rotation)))))
        return NonLinearCombination(out)

    def max_degree(self) -> int:
        return max((t.degree() for t in self.terms), default=0)

    def collect(self, p: int) -> "NonLinearCombination":
        """Merge duplicate monomials mod p (canonical form)."""
        acc: dict[tuple, int] = {}
        for t in self.terms:
            acc[t.vars] = (acc.get(t.vars, 0) + t.coeff) % p
        def key(kv):
            vs = kv[0]
            return (len(vs), [(v.type, v.index, v.rotation) for v in vs])

        return NonLinearCombination(
            [NonLinearTerm(c, vs)
             for vs, c in sorted(acc.items(), key=key) if c])

    def evaluate(self, p: int, get_var) -> int:
        total = 0
        for t in self.terms:
            prod = t.coeff % p
            for v in t.vars:
                prod = prod * get_var(v) % p
            total = (total + prod) % p
        return total

    def to_expression(self) -> Expr:
        e: Expr = Const(0)
        for t in self.terms:
            term: Expr = Const(t.coeff)
            for v in t.vars:
                term = BinOp("*", term, v)
            e = BinOp("+", e, term)
        return e


def expression_to_non_linear_combination(e: Expr) -> NonLinearCombination:
    """`expression_to_non_linear_combination` visitor
    (`expression_visitors.hpp:110-164`): expand an AST to the flat form."""
    if isinstance(e, Const):
        return NonLinearCombination.constant(e.v)
    if isinstance(e, Var):
        return NonLinearCombination.from_var(e)
    if isinstance(e, Pow):
        base = expression_to_non_linear_combination(e.base)
        out = NonLinearCombination.constant(1)
        for _ in range(e.exp):
            out = out * base
        return out
    if isinstance(e, BinOp):
        a = expression_to_non_linear_combination(e.l)
        b = expression_to_non_linear_combination(e.r)
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
    raise TypeError(f"unknown expression node: {e!r}")
