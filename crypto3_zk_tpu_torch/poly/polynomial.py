"""Polynomials in coefficient and evaluation (DFS) form.

Counterpart of `poly/polynomial.py` of the JAX package: the equivalents of
`math::polynomial<T>` and `math::polynomial_dfs<T>` (reference call sites
`lpc.hpp:131-181`, `basic_fri.hpp:365-371`,
`expression_evaluator.hpp:52-81`). Values live on one device as Montgomery
limb tensors of shape (NL, n); degree bookkeeping is host-side metadata. A
polynomial lives where its tensor lives; the constructors that make a tensor
take `device` (default: the card).

Conventions:
- `Poly`     — coefficient form, length n (not necessarily a power of two).
- `PolyDFS`  — evaluations over the radix-2 domain of size n (power of two),
  natural order (index i <-> f(w^i)), with tracked degree bound `deg` =
  (max degree + 1). `resize` re-FFTs between domains exactly like
  `polynomial_dfs::resize(size, old_domain, new_domain)`.
"""
from __future__ import annotations

import torch

from ..fields.params import FieldSpec
from ..ops import limbs as L
from ..ops import ntt as N
from .domain import get_domain


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (NL, ..., m) padded with zeros to (NL, ..., n)."""
    m = x.shape[-1]
    if m == n:
        return x
    assert n > m
    return torch.nn.functional.pad(x, (0, n - m))


class Poly:
    """Dense coefficient-form polynomial; c[i] is the x^i coefficient."""

    __slots__ = ("fs", "c")

    def __init__(self, fs: FieldSpec, c: torch.Tensor):
        self.fs = fs
        self.c = c  # (NL, n) mont form

    # --- constructors ---
    @classmethod
    def from_ints(cls, fs: FieldSpec, coeffs: list[int],
                  device=None) -> "Poly":
        return cls(fs, L.encode(fs, coeffs if coeffs else [0], device))

    @classmethod
    def zero(cls, fs: FieldSpec, device=None) -> "Poly":
        return cls(fs, L.zeros(fs, (1,), device))

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.c.device

    def to_ints(self) -> list[int]:
        return L.decode(self.fs, self.c)

    def degree(self) -> int:
        """Actual degree (host sync; -1 for zero poly)."""
        ints = self.to_ints()
        for i in range(len(ints) - 1, -1, -1):
            if ints[i]:
                return i
        return -1

    def _pad_to(self, n: int) -> torch.Tensor:
        return _pad_last(self.c, n)

    # --- arithmetic ---
    def __add__(self, o: "Poly") -> "Poly":
        n = max(self.n, o.n)
        return Poly(self.fs, L.add(self.fs, self._pad_to(n), o._pad_to(n)))

    def __sub__(self, o: "Poly") -> "Poly":
        n = max(self.n, o.n)
        return Poly(self.fs, L.sub(self.fs, self._pad_to(n), o._pad_to(n)))

    def __neg__(self) -> "Poly":
        return Poly(self.fs, L.neg(self.fs, self.c))

    def __mul__(self, o: "Poly") -> "Poly":
        """NTT-based product, output length la+lb-1."""
        out_len = self.n + o.n - 1
        m = _next_pow2(out_len)
        d = get_domain(self.fs, m)
        ea = d.fft(self._pad_to(m))
        eb = d.fft(o._pad_to(m))
        prod = d.ifft(L.mont_mul(self.fs, ea, eb))
        return Poly(self.fs, prod[..., :out_len])

    def scale(self, k: int) -> "Poly":
        return Poly(self.fs, L.mont_mul(
            self.fs, self.c, L.const_mont(self.fs, k, (1,), self.device)))

    # --- evaluation ---
    def evaluate(self, x: int) -> int:
        """f(x) for a host scalar point (exact, via device dot + decode).
        The powers of x are built on the device by doubling."""
        pw = L.powers(self.fs, x % self.fs.p, self.n, self.device)
        prods = L.mont_mul(self.fs, self.c, pw)
        return L.decode(self.fs, N.sum_reduce(self.fs, prods,
                                              axis=-1)[..., None])[0]

    def evaluate_many(self, xs: list[int]) -> list[int]:
        return [self.evaluate(x) for x in xs]

    # --- division ---
    def divide_by_linear(self, z: int) -> "Poly":
        """q = (f - f(z)) / (x - z), exact (`divide_by_roots`), in place of
        the reference's coefficient long division (`lpc.hpp:131-181`)."""
        fz = Poly.from_ints(self.fs, [self.evaluate(z)], self.device)
        return divide_by_roots(self - fz, [z])

    def __repr__(self):
        return f"Poly<{self.fs.name}, n={self.n}>"


def _coset_shift(fs: FieldSpec, roots: list[int], m: int) -> int:
    """The first of g, g^2, ... (g the field's generator) whose coset
    s*D_m holds none of the roots: x lies in s*D_m iff x^m = s^m."""
    held = {pow(r % fs.p, m, fs.p) for r in roots}
    s = fs.generator
    while pow(s, m, fs.p) in held:
        s = s * fs.generator % fs.p
    return s


def divide_by_roots(f: Poly, roots: list[int]) -> Poly:
    """f / prod_r (x - r) for an f that vanishes at every root, exact: the
    same polynomial, of the same length, as dividing by each root in turn.
    One pass in evaluation form on a coset s*D_m of the transform's domain
    that holds no root, so no denominator is zero: one coset transform, the
    denominators' product, one batched inversion, one inverse coset
    transform (kernels 1 to 4 and the tail)."""
    if not roots:
        return f
    fs, dev = f.fs, f.device
    m = _next_pow2(max(f.n, 2))
    s = _coset_shift(fs, roots, m)
    xs = L.mont_mul(fs, L.powers(fs, get_domain(fs, m).omega, m, dev),
                    L.const_mont(fs, s, (1,), dev))          # s * w^i
    den = None
    for r in roots:
        term = L.sub(fs, xs, L.const_mont(fs, r, (1,), dev))
        den = term if den is None else L.mont_mul(fs, den, term)
    evals = N.coset_ntt(fs, _pad_last(f.c, m), s)
    q = N.coset_intt(fs, L.mont_mul(fs, evals,
                                    L.batch_inverse(fs, den, axis=1)), s)
    return Poly(fs, q[..., :max(f.n - len(roots), 1)])


class PolyDFS:
    """Evaluation-form polynomial over the size-n radix-2 domain."""

    __slots__ = ("fs", "v", "deg")

    def __init__(self, fs: FieldSpec, v: torch.Tensor, deg: int):
        self.fs = fs
        self.v = v        # (NL, n) evals, natural order
        self.deg = deg    # bound: actual degree < deg  (reference's _d + 1)

    @property
    def n(self) -> int:
        return self.v.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v.device

    # --- constructors ---
    @classmethod
    def from_poly(cls, p: Poly, n: int | None = None) -> "PolyDFS":
        deg = p.n
        n = n or _next_pow2(deg)
        assert n >= deg
        d = get_domain(p.fs, n)
        return cls(p.fs, d.fft(p._pad_to(n)), deg)

    @classmethod
    def from_evals_ints(cls, fs: FieldSpec, evals: list[int],
                        device=None) -> "PolyDFS":
        n = len(evals)
        assert n & (n - 1) == 0
        return cls(fs, L.encode(fs, evals, device), n)

    @classmethod
    def constant(cls, fs: FieldSpec, k: int, n: int,
                 device=None) -> "PolyDFS":
        return cls(fs, L.const_mont(fs, k, (n,), device), 1)

    def to_ints(self) -> list[int]:
        return L.decode(self.fs, self.v)

    # --- form conversion ---
    def coefficients(self) -> Poly:
        d = get_domain(self.fs, self.n)
        return Poly(self.fs, d.ifft(self.v)[..., : self.deg])

    def resize(self, new_n: int) -> "PolyDFS":
        """Re-FFT onto the size-new_n domain (`polynomial_dfs::resize`)."""
        if new_n == self.n:
            return self
        assert new_n >= self.deg, (new_n, self.deg)
        c = get_domain(self.fs, self.n).ifft(self.v)[..., : self.deg]
        return PolyDFS(self.fs,
                       get_domain(self.fs, new_n).fft(_pad_last(c, new_n)),
                       self.deg)

    # --- arithmetic (auto-aligning domains, like cached_multiplication) ---
    def _align(self, o: "PolyDFS", for_mul: bool):
        need = (self.deg + o.deg - 1) if for_mul else max(self.deg, o.deg)
        n = max(self.n, o.n, _next_pow2(need))
        return self.resize(n), o.resize(n), need

    def __add__(self, o: "PolyDFS") -> "PolyDFS":
        a, b, deg = self._align(o, for_mul=False)
        return PolyDFS(self.fs, L.add(self.fs, a.v, b.v), deg)

    def __sub__(self, o: "PolyDFS") -> "PolyDFS":
        a, b, deg = self._align(o, for_mul=False)
        return PolyDFS(self.fs, L.sub(self.fs, a.v, b.v), deg)

    def __neg__(self) -> "PolyDFS":
        return PolyDFS(self.fs, L.neg(self.fs, self.v), self.deg)

    def __mul__(self, o: "PolyDFS") -> "PolyDFS":
        a, b, deg = self._align(o, for_mul=True)
        return PolyDFS(self.fs, L.mont_mul(self.fs, a.v, b.v), deg)

    def scale(self, k: int) -> "PolyDFS":
        return PolyDFS(self.fs, L.mont_mul(
            self.fs, self.v, L.const_mont(self.fs, k, (1,), self.device)),
            self.deg)

    def scale_arr(self, k: torch.Tensor) -> "PolyDFS":
        """Scale by a (NL, 1) Montgomery limb tensor (a Fiat-Shamir
        challenge that is on the device already)."""
        return PolyDFS(self.fs, L.mont_mul(self.fs, self.v, k), self.deg)

    def shift(self, rotation: int, domain_size: int | None = None) -> "PolyDFS":
        """g(x) = f(x * w_m^rotation) where m = domain_size (default: own
        size): evals roll by -rotation * (n/m)
        (`math::polynomial_shift(f, rot, m)`, used `gates_argument.hpp:117`,
        `lookup_argument.hpp:328`: the reference shifts by the BASIC
        domain's generator even for polys resident on larger domains)."""
        m = self.n if domain_size is None else domain_size
        assert self.n % m == 0
        step = rotation * (self.n // m)
        return PolyDFS(self.fs, torch.roll(self.v, -step, dims=-1), self.deg)

    def evaluate(self, x: int) -> int:
        return self.coefficients().evaluate(x)

    def __repr__(self):
        return f"PolyDFS<{self.fs.name}, n={self.n}, deg<{self.deg}>"


def _tree_reduce(ps: list[PolyDFS], op) -> PolyDFS:
    assert ps
    while len(ps) > 1:
        nxt = [op(ps[i], ps[i + 1]) for i in range(0, len(ps) - 1, 2)]
        if len(ps) % 2:
            nxt.append(ps[-1])
        ps = nxt
    return ps[0]


def polynomial_sum(ps: list[PolyDFS]) -> PolyDFS:
    """Tree-reduce sum (`polynomial_sum<F>`, `prover.hpp:275`)."""
    return _tree_reduce(ps, lambda a, b: a + b)


def polynomial_product(ps: list[PolyDFS]) -> PolyDFS:
    """Tree-reduce product (`polynomial_product<F>`,
    `permutation_argument.hpp:148-156`)."""
    return _tree_reduce(ps, lambda a, b: a * b)
