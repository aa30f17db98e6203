"""R1CS constraint systems.

`arithmetization/constraint_satisfaction_problems/r1cs.hpp`: constraints
a·b = c of linear combinations over variables (index 0 = the constant ONE),
`is_satisfied` (`r1cs.hpp:126-193`), `swap_AB_if_beneficial` (`r1cs.hpp:193`).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LinearCombination:
    """terms: [(index, coeff)]; index 0 is the constant 1."""
    terms: list[tuple[int, int]] = dataclasses.field(default_factory=list)

    def evaluate(self, p: int, full_assignment: list[int]) -> int:
        """full_assignment[0] must be 1."""
        acc = 0
        for idx, coeff in self.terms:
            acc += coeff * full_assignment[idx]
        return acc % p

    def add_term(self, index: int, coeff: int = 1):
        self.terms.append((index, coeff))
        return self


def lc(*terms) -> LinearCombination:
    """lc((idx, coeff), ...) convenience."""
    return LinearCombination(list(terms))


@dataclasses.dataclass
class R1CSConstraint:
    a: LinearCombination
    b: LinearCombination
    c: LinearCombination


@dataclasses.dataclass
class R1CSConstraintSystem:
    primary_input_size: int
    auxiliary_input_size: int
    constraints: list[R1CSConstraint] = dataclasses.field(default_factory=list)

    @property
    def num_inputs(self) -> int:
        return self.primary_input_size

    @property
    def num_variables(self) -> int:
        return self.primary_input_size + self.auxiliary_input_size

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    def add_constraint(self, a, b, c):
        self.constraints.append(R1CSConstraint(a, b, c))

    def is_satisfied(self, p: int, primary: list[int], aux: list[int]) -> bool:
        assert len(primary) == self.primary_input_size
        assert len(aux) == self.auxiliary_input_size
        full = [1] + list(primary) + list(aux)
        for cst in self.constraints:
            if cst.a.evaluate(p, full) * cst.b.evaluate(p, full) % p \
                    != cst.c.evaluate(p, full):
                return False
        return True

    def swap_AB_if_beneficial(self):
        """Make B lighter when it has more nonzero terms than A
        (`r1cs.hpp:193`; helps the G2 multiexp)."""
        a_nz = set()
        b_nz = set()
        for cst in self.constraints:
            a_nz.update(i for i, _ in cst.a.terms)
            b_nz.update(i for i, _ in cst.b.terms)
        if len(b_nz) > len(a_nz):
            for cst in self.constraints:
                cst.a, cst.b = cst.b, cst.a
