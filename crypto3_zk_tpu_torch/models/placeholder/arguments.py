"""Placeholder permutation and gates arguments.

Counterpart of `models/placeholder/arguments.py` of the JAX package:

- Permutation argument (`placeholder/permutation_argument.hpp:70-332`):
  grand product V_P over beta/gamma-randomized id/sigma chains, optionally
  chunked into `permutation_parts` partitions; F[0..2]. The reference's
  sequential V_P recurrence (`:123-133`) becomes a batched inverse plus a
  log-depth exclusive prefix-product scan.
- Gates argument (`placeholder/gates_argument.hpp:76-251`): theta-combined
  gate constraints bucketed by degree, evaluated over the polynomial table;
  F[7].

The JAX package has a fused program per phase and an eager path and holds
them equal; the port has one path, the eager one's arithmetic. Every
polynomial, constant and mask is made on the device of the table's
polynomials.
"""
from __future__ import annotations

import dataclasses

import torch

from ...arithmetization import plonk as PK
from ...ops import limbs as L
from ...poly.polynomial import PolyDFS, polynomial_product
from ...transcript.fiat_shamir import Transcript
from . import common as C
from .preprocessor import (CommonData, PublicPreprocessedData,
                           lagrange_polynomial)


class PolynomialTable:
    """Unified witness+public column access (`plonk_polynomial_dfs_table`)."""

    def __init__(self, witnesses: list[PolyDFS], public_inputs: list[PolyDFS],
                 constants: list[PolyDFS], selectors: list[PolyDFS]):
        self.witnesses = witnesses
        self.public_inputs = public_inputs
        self.constants = constants
        self.selectors = selectors

    @property
    def device(self) -> torch.device:
        for cols in (self.witnesses, self.selectors, self.public_inputs,
                     self.constants):
            if cols:
                return cols[0].device
        raise ValueError("the table has no columns")

    def by_type(self, col_type: str, index: int) -> PolyDFS:
        return {
            PK.WITNESS: self.witnesses,
            PK.PUBLIC_INPUT: self.public_inputs,
            PK.CONSTANT: self.constants,
            PK.SELECTOR: self.selectors,
        }[col_type][index]

    def by_global_index(self, desc: PK.TableDescription, i: int) -> PolyDFS:
        w, p, c = (desc.witness_columns, desc.public_input_columns,
                   desc.constant_columns)
        if i < w:
            return self.witnesses[i]
        if i < w + p:
            return self.public_inputs[i - w]
        if i < w + p + c:
            return self.constants[i - w - p]
        return self.selectors[i - w - p - c]


@dataclasses.dataclass
class PermutationProverResult:
    F_dfs: list[PolyDFS]                    # F[0..2]
    permutation_poly_parts: list[PolyDFS]   # V_P (+ partition products)


def _reduce_dfs_domain(poly: PolyDFS, new_n: int) -> PolyDFS:
    """Stride-sample evals down to the subgroup of size new_n
    (`permutation_argument.hpp` reduce_dfs_polynomial_domain). A strided
    view: the kernels take it through its strides."""
    if poly.n == new_n:
        return poly
    assert poly.n % new_n == 0
    stride = poly.n // new_n
    return PolyDFS(poly.fs, poly.v[..., ::stride], min(poly.deg, new_n))


def _running_parts(fs, previous: PolyDFS, gs: list[PolyDFS],
                   hs: list[PolyDFS], alphas: list[int], n: int,
                   row_mask: torch.Tensor, commitment_scheme):
    """The chunked grand product (`permutation_parts > 1` or several lookup
    parts): each partition's running product, committed to the
    PERMUTATION batch, and sum_i alpha_i (previous gs_i - current hs_i).
    Returns (that sum, the last running product, the parts)."""
    acc = PolyDFS.constant(fs, 0, n, previous.device)
    current_vals = previous.v
    parts = []
    for i, alpha in enumerate(alphas):
        rg = _reduce_dfs_domain(gs[i], n)
        rh = _reduce_dfs_domain(hs[i], n)
        ratio_i = L.mont_mul(fs, rg.v, L.batch_inverse(fs, rh.v, axis=1))
        upd = L.mont_mul(fs, previous.v, ratio_i)
        current_vals = L.select(row_mask, upd, current_vals)
        current = PolyDFS(fs, current_vals, n)
        commitment_scheme.append_to_batch(C.PERMUTATION_BATCH, current)
        parts.append(current)
        acc = acc + (previous * gs[i] - current * hs[i]).scale(alpha)
        previous = current
    return acc, previous, parts


def permutation_prove_eval(
        params: C.PlaceholderParams,
        constraint_system: PK.ConstraintSystem,
        preprocessed: PublicPreprocessedData,
        desc: PK.TableDescription,
        table: PolynomialTable,
        commitment_scheme,
        transcript: Transcript) -> PermutationProverResult:
    fs = params.fs
    common = preprocessed.common_data
    S_sigma = preprocessed.permutation_polynomials
    S_id = preprocessed.identity_polynomials
    n = common.basic_domain.n
    dev = table.device
    global_indices = common.permuted_columns

    beta = transcript.challenge(fs)
    gamma = transcript.challenge(fs)

    g_v: list[PolyDFS] = []
    h_v: list[PolyDFS] = []
    beta_c = L.const_mont(fs, beta, (1,), dev)
    gamma_c = L.const_mont(fs, gamma, (n,), dev)
    for i in range(len(S_id)):
        col = table.by_global_index(desc, global_indices[i])
        assert col.n == n
        gv = L.add(fs, L.add(fs, L.mont_mul(fs, S_id[i].v, beta_c), gamma_c),
                   col.v)
        hv = L.add(fs, L.add(fs, L.mont_mul(fs, S_sigma[i].v, beta_c),
                             gamma_c), col.v)
        g_v.append(PolyDFS(fs, gv, n))
        h_v.append(PolyDFS(fs, hv, n))

    # V_P: exclusive prefix product of prod_i g/h ratios
    nom = g_v[0].v
    den = h_v[0].v
    for i in range(1, len(g_v)):
        nom = L.mont_mul(fs, nom, g_v[i].v)
        den = L.mont_mul(fs, den, h_v[i].v)
    ratio = L.mont_mul(fs, nom, L.batch_inverse(fs, den, axis=1))
    V_P = PolyDFS(fs, L.prefix_product_exclusive(fs, ratio, axis=1), n)

    permutation_poly_parts = [V_P]
    commitment_scheme.append_to_batch(C.PERMUTATION_BATCH, V_P)

    # partition products gs/hs
    gs: list[PolyDFS] = []
    hs: list[PolyDFS] = []
    gf: list[PolyDFS] = []
    hf: list[PolyDFS] = []
    for i in range(len(g_v)):
        gf.append(g_v[i])
        hf.append(h_v[i])
        if (common.max_quotient_chunks != 0
                and len(gf) == common.max_quotient_chunks - 1):
            gs.append(polynomial_product(gf))
            hs.append(polynomial_product(hf))
            gf, hf = [], []
    if gf:
        gs.append(polynomial_product(gf))
        hs.append(polynomial_product(hf))
    assert len(gs) == common.permutation_parts

    one_poly = PolyDFS.constant(fs, 1, n, dev)
    V_P_shifted = V_P.shift(1)

    # F0 = lagrange_0 * (1 - V_P)
    lagrange_0 = lagrange_polynomial(fs, common.basic_domain, 0, dev)
    F0 = (one_poly - V_P) * lagrange_0

    permutation_alphas = [transcript.challenge(fs)
                          for _ in range(common.permutation_parts - 1)]

    if common.permutation_parts == 1:
        g, h = gs[0], hs[0]
        acc = V_P_shifted * h - V_P * g
        F1 = (one_poly - preprocessed.q_last - preprocessed.q_blind) * acc
    else:
        row_mask = torch.arange(n, device=dev) \
            < common.desc.usable_rows_amount
        F1, previous, parts = _running_parts(
            fs, V_P, gs, hs, permutation_alphas, n, row_mask,
            commitment_scheme)
        permutation_poly_parts += parts
        last = len(permutation_alphas)
        F1 = F1 + (previous * gs[last] - V_P_shifted * hs[last])
        F1 = F1 * (preprocessed.q_last + preprocessed.q_blind - one_poly)

    F2 = (V_P - one_poly) * V_P * preprocessed.q_last
    return PermutationProverResult(F_dfs=[F0, F1, F2],
                                   permutation_poly_parts=permutation_poly_parts)


def permutation_verify_eval(
        fs, common: CommonData,
        S_id: list[int], S_sigma: list[int],
        special_selector_values: list[int],
        challenge: int,
        column_values: list[int],
        perm_value: int, perm_shifted_value: int,
        perm_partitions: list[int],
        transcript: Transcript) -> list[int]:
    """`permutation_argument.hpp:226-332` (host scalars)."""
    p = fs.p
    beta = transcript.challenge(fs)
    gamma = transcript.challenge(fs)

    gs, hs = [], []
    g, h = 1, 1
    current_size = 0
    for i in range(len(column_values)):
        pp_ = (column_values[i] + gamma) % p
        g = g * ((S_id[i] * beta + pp_) % p) % p
        h = h * ((S_sigma[i] * beta + pp_) % p) % p
        current_size += 1
        if (common.max_quotient_chunks != 0
                and current_size == common.max_quotient_chunks - 1):
            gs.append(g)
            hs.append(h)
            g, h = 1, 1
            current_size = 0
    if current_size != 0:
        gs.append(g)
        hs.append(h)

    F = [0, 0, 0]
    F[0] = common.lagrange_0_at(challenge) * (1 - perm_value) % p

    permutation_alphas = [transcript.challenge(fs)
                          for _ in range(common.permutation_parts - 1)]
    assert len(permutation_alphas) == len(perm_partitions)

    if common.permutation_parts == 1:
        val = (perm_shifted_value * hs[0] - perm_value * gs[0]) % p
        val = val * (1 - special_selector_values[1]
                     - special_selector_values[2]) % p
        F[1] = val
    else:
        previous = perm_value
        acc = 0
        for i in range(len(permutation_alphas)):
            current = perm_partitions[i]
            acc = (acc + permutation_alphas[i]
                   * (previous * gs[i] - current * hs[i])) % p
            previous = current
        last = len(permutation_alphas)
        acc = (acc + previous * gs[last] - perm_shifted_value * hs[last]) % p
        acc = acc * ((special_selector_values[1]
                      + special_selector_values[2] - 1) % p) % p
        F[1] = acc

    F[2] = special_selector_values[1] * (perm_value * perm_value - perm_value) % p
    return F


# ---------------------------------------------------------------------------
# gates argument
# ---------------------------------------------------------------------------

def column_var_fn(table: PolynomialTable, cache: dict | None = None):
    """The variable lookup of an expression fold over the table: the column,
    rotated by the variable's rotation (cached per variable if `cache`)."""
    def var_fn(v: PK.Var):
        if cache is not None and v in cache:
            return cache[v]
        poly = table.by_type(v.type, v.index)
        if v.rotation != 0:
            poly = poly.shift(v.rotation)
        if cache is not None:
            cache[v] = poly
        return poly
    return var_fn


def gates_prove_eval(params: C.PlaceholderParams,
                     constraint_system: PK.ConstraintSystem,
                     table: PolynomialTable,
                     basic_domain,
                     max_gates_degree: int,
                     mask_polynomial: PolyDFS,
                     transcript: Transcript) -> PolyDFS:
    """`gates_argument.hpp:126-218`: theta-combine constraints into two
    degree buckets, evaluate over (rotated) column polynomials, multiply by
    the selector and the (1 - q_last - q_blind) mask."""
    fs = params.fs
    dev = table.device
    max_gates_degree += 1  # selector multiplication
    theta = transcript.challenge(fs)

    max_degree = 1 << (max_gates_degree - 1).bit_length()
    degree_limits = [max_degree, max_degree // 2]

    bucket_exprs: list[PK.Expr | None] = [None, None]
    theta_acc = 1
    for gate in constraint_system.gates:
        gate_results: list[PK.Expr | None] = [None, None]
        for constraint in gate.constraints:
            term = constraint * PK.Const(theta_acc)
            theta_acc = theta_acc * theta % fs.p
            cdeg = PK.expr_max_degree(constraint) + 1
            for i in range(len(degree_limits) - 1, -1, -1):
                if degree_limits[i] >= cdeg or i == 0:
                    gate_results[i] = term if gate_results[i] is None \
                        else gate_results[i] + term
                    break
        selector = PK.Var(gate.selector_index, 0, PK.SELECTOR)
        for i in range(2):
            if gate_results[i] is None:
                continue
            ge = gate_results[i] * selector
            bucket_exprs[i] = ge if bucket_exprs[i] is None \
                else bucket_exprs[i] + ge

    n = basic_domain.n
    F = PolyDFS.constant(fs, 0, n, dev)
    for expr in bucket_exprs:
        if expr is None:
            continue
        val = PK.evaluate_expr(expr, column_var_fn(table, {}),
                               lambda c: PolyDFS.constant(fs, c, 1, dev))
        F = F + val
    return F * mask_polynomial


def gates_verify_eval(fs, gates: list[PK.Gate],
                      evaluations: dict,
                      challenge: int,
                      mask_value: int,
                      transcript: Transcript) -> int:
    """`gates_argument.hpp:220-251` (host scalars). `evaluations` maps
    (index, rotation, type) -> value at the challenge point."""
    p = fs.p
    theta = transcript.challenge(fs)
    theta_acc = 1
    F = 0
    for gate in gates:
        gate_result = 0
        for constraint in gate.constraints:
            val = scalar_expr(p, constraint, evaluations)
            gate_result = (gate_result + val * theta_acc) % p
            theta_acc = theta_acc * theta % p
        sel = evaluations[(gate.selector_index, 0, PK.SELECTOR)]
        F = (F + gate_result * sel) % p
    return F * mask_value % p


class _Scalar:
    """An element of F_p as a ring for `evaluate_expr`."""
    __slots__ = ("v", "p")

    def __init__(self, v: int, p: int):
        self.v = v % p
        self.p = p

    def __add__(self, o):
        return _Scalar(self.v + o.v, self.p)

    def __sub__(self, o):
        return _Scalar(self.v - o.v, self.p)

    def __mul__(self, o):
        return _Scalar(self.v * o.v, self.p)


def scalar_expr(p: int, expr: PK.Expr, evaluations: dict) -> int:
    """An expression's value mod p from `evaluations`, which maps
    (index, rotation, type) to a variable's value."""
    return PK.evaluate_expr(
        expr, lambda v: _Scalar(evaluations[(v.index, v.rotation, v.type)], p),
        lambda c: _Scalar(c, p)).v
