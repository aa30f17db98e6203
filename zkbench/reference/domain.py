"""Radix-2 evaluation domains of a prime field, and polynomial values from
a column's values on a domain, for the reference.

A column of n values over the domain {w^j} is the polynomial
f(x) = sum_j c_j L_j(x), L_j(x) = Z(x) w^j / (n (x - w^j)), Z(x) = x^n - 1.
`Lagrange(domain, x).dot(column)` gives f(x) in O(n) integer operations
with one inversion, and `.dot(column, shift)` gives f(x w^shift).
"""
from __future__ import annotations

import functools


class Field:
    def __init__(self, p: int, generator: int, two_adicity: int):
        self.p, self.generator, self.two_adicity = p, generator, two_adicity

    def root_of_unity(self, n: int) -> int:
        p = self.p
        g = pow(self.generator, (p - 1) >> self.two_adicity, p)
        return pow(g, (1 << self.two_adicity) // n, p)


BLS12_381_FR = Field(
    0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001, 7, 32)


class Domain:
    def __init__(self, field: Field, n: int):
        self.field, self.p, self.n = field, field.p, n
        self.log_n = n.bit_length() - 1
        self.omega = field.root_of_unity(n) if n > 1 else 1

    def element(self, i: int) -> int:
        return pow(self.omega, i % self.n, self.p)

    def vanishing(self, x: int) -> int:
        return (pow(x, self.n, self.p) - 1) % self.p

    def lagrange_at(self, i: int, x: int) -> int:
        p = self.p
        x %= p
        wi = self.element(i)
        if x == wi:
            return 1
        z = self.vanishing(x)
        if z == 0:
            return 0
        return z * wi % p * pow(self.n, -1, p) % p * pow((x - wi) % p, -1, p) % p

    @functools.cached_property
    def powers(self) -> list[int]:
        p, w = self.p, self.omega
        out = [1] * self.n
        for j in range(1, self.n):
            out[j] = out[j - 1] * w % p
        return out


def domain_index_of(d: Domain, x: int) -> int:
    """j with w^j = x, bit by bit."""
    p = d.p
    j, cur = 0, x % p
    for k in range(d.log_n):
        if pow(cur, d.n >> (k + 1), p) != 1:
            j |= 1 << k
            cur = cur * pow(d.omega, (d.n - (1 << k)) % d.n, p) % p
    if cur != 1:
        raise ValueError("the point is not in the evaluation domain")
    return j


class Lagrange:
    """Every L_j(x) of a domain at one point x outside it."""

    def __init__(self, d: Domain, x: int):
        p, n = d.p, d.n
        x %= p
        z = d.vanishing(x)
        if z == 0:
            raise ValueError("the point lies in the domain")
        pows = d.powers
        prefix = [1] * (n + 1)
        acc = 1
        for j in range(n):
            acc = acc * (x - pows[j]) % p
            prefix[j + 1] = acc
        inv = pow(acc, -1, p)
        scale = z * pow(n, -1, p) % p
        out = [0] * n
        for j in range(n - 1, -1, -1):
            out[j] = inv * prefix[j] % p * pows[j] % p * scale % p
            inv = inv * (x - pows[j]) % p
        self.p, self.n, self.weights = p, n, out

    def dot(self, column: list[int], shift: int = 0) -> int:
        """f(x w^shift) of the column's polynomial: L_j(x w^s) = L_{j-s}(x),
        so the column is read s places on."""
        w, n = self.weights, self.n
        if shift % n == 0:
            acc = sum(c * l for c, l in zip(column, w))
        else:
            s = shift % n
            acc = sum(c * l for c, l in zip(column[s:] + column[:s], w))
        return acc % self.p
