"""Radix-2 evaluation domains.

Counterpart of `poly/domain.py` of the JAX package: the equivalent of
`math::evaluation_domain<F>` / `make_evaluation_domain` (reference usage:
`r1cs_to_qap.hpp:229-310`) and `math::calculate_domain_set`
(`basic_fri.hpp:162,179`). Device bulk transforms delegate to `ops.ntt`;
the host-side helpers (single Lagrange evaluation, vanishing polynomial)
serve the (scalar, host-run) verifiers.
"""
from __future__ import annotations

import functools

from ..fields.params import FieldSpec
from ..ops import ntt as N


class Domain:
    def __init__(self, fs: FieldSpec, n: int):
        assert n & (n - 1) == 0 and n >= 1
        self.fs = fs
        self.n = n
        self.log_n = n.bit_length() - 1
        self.omega = fs.root_of_unity(n) if n > 1 else 1
        self.omega_inv = pow(self.omega, -1, fs.p)

    # --- device transforms (along last axis) ---
    def fft(self, coeffs):
        assert coeffs.shape[-1] == self.n
        return N.ntt(self.fs, coeffs, inverse=False)

    def ifft(self, evals):
        assert evals.shape[-1] == self.n
        return N.ntt(self.fs, evals, inverse=True)

    # --- host scalar helpers (verifier side) ---
    def element(self, i: int) -> int:
        """w^i — `evaluation_domain::get_domain_element(i)`."""
        return pow(self.omega, i % self.n, self.fs.p)

    def evaluate_vanishing(self, x: int) -> int:
        """Z_H(x) = x^n - 1 — `compute_vanishing_polynomial`."""
        return (pow(x, self.n, self.fs.p) - 1) % self.fs.p

    def evaluate_all_lagrange(self, x: int) -> list[int]:
        """All L_i(x) — `evaluate_all_lagrange_polynomials`. O(n) host work;
        used only by verifiers / keygen on small public-input ranges."""
        p = self.fs.p
        x %= p
        # if x is in the domain, indicator vector
        if self.evaluate_vanishing(x) == 0:
            out = [0] * self.n
            w = 1
            for i in range(self.n):
                if w == x:
                    out[i] = 1
                w = w * self.omega % p
            return out
        z = self.evaluate_vanishing(x)
        n_inv = pow(self.n, -1, p)
        out = []
        wi = 1
        for i in range(self.n):
            # L_i(x) = Z(x) * w^i / (n * (x - w^i))
            out.append(z * wi % p * n_inv % p * pow((x - wi) % p, -1, p) % p)
            wi = wi * self.omega % p
        return out

    def lagrange_at(self, i: int, x: int) -> int:
        """Single L_i(x) in O(1) field ops."""
        p = self.fs.p
        x %= p
        wi = self.element(i)
        if x == wi:
            return 1
        z = self.evaluate_vanishing(x)
        if z == 0:
            return 0
        n_inv = pow(self.n, -1, p)
        return z * wi % p * n_inv % p * pow((x - wi) % p, -1, p) % p

    def __repr__(self):
        return f"Domain<{self.fs.name}, n={self.n}>"


@functools.lru_cache(maxsize=None)
def get_domain(fs: FieldSpec, n: int) -> Domain:
    return Domain(fs, n)


def calculate_domain_set(fs: FieldSpec, max_log: int,
                         count: int) -> list[Domain]:
    """Nested FRI domains D_0, D_1, ... each half the size of the one before
    (`math::calculate_domain_set`, `basic_fri.hpp:162,179`)."""
    return [get_domain(fs, 1 << (max_log - i)) for i in range(count)]
