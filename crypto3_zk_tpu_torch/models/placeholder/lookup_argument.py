"""Placeholder lookup argument (plookup-style).

Counterpart of `models/placeholder/lookup_argument.py` of the JAX package:
`placeholder/lookup_argument.hpp:110-840`: theta-compressed lookup values /
inputs (`:411-494`), the counting sort (`:565-635`, host: pure index
bookkeeping), grand product V_L (`:375-409`, a batched inverse and a
log-depth prefix scan), gs/hs partition products (`:296-373`), F[3..6];
scalar verifier (`:664-833`). The sort needs the reduced columns on the
host (one decode a column) and the sorted ones back (one encode a column).
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from ...arithmetization import plonk as PK
from ...commitments.fri import PhaseClock
from ...ops import limbs as L
from ...poly.polynomial import PolyDFS, polynomial_product, polynomial_sum
from ...transcript.fiat_shamir import Transcript
from ...utils.profiling import span, spanned
from . import common as C
from .arguments import (PolynomialTable, _reduce_dfs_domain, _running_parts,
                        column_var_fn, scalar_expr)
from .preprocessor import (PublicPreprocessedData, _absorb_commitment,
                           lagrange_polynomial, lookup_parts_list)


@dataclasses.dataclass
class LookupProverResult:
    F_dfs: list[PolyDFS]
    lookup_commitment: object


def _prepare_lookup_value(fs, constraint_system, table: PolynomialTable,
                          theta: int, mask: PolyDFS) -> list[PolyDFS]:
    """`lookup_argument.hpp:411-437`."""
    out = []
    p = fs.p
    for t_id, l_table in enumerate(constraint_system.lookup_tables):
        tag = table.selectors[l_table.tag_index]
        for option in l_table.lookup_options:
            v = tag.scale(t_id + 1)
            theta_acc = theta
            for i in range(l_table.columns_number):
                col = table.constants[option[i].index]
                v = v + (tag * col).scale(theta_acc)
                theta_acc = theta_acc * theta % p
            out.append(v * mask)
    return out


def _prepare_lookup_input(fs, constraint_system, table: PolynomialTable,
                          theta: int) -> list[PolyDFS]:
    """`lookup_argument.hpp:440-494`."""
    p = fs.p
    dev = table.device
    out = []
    var_fn = column_var_fn(table)
    for gate in constraint_system.lookup_gates:
        selector = table.selectors[gate.tag_index]
        for constraint in gate.constraints:
            l = selector.scale(constraint.table_id)
            theta_acc = theta
            for e in constraint.lookup_input:
                val = PK.evaluate_expr(
                    e, var_fn, lambda c: PolyDFS.constant(fs, c, 1, dev))
                l = l + (selector * val).scale(theta_acc)
                theta_acc = theta_acc * theta % p
            out.append(l)
    return out


def _sort_polynomials(fs, reduced_input: list[list[int]],
                      reduced_value: list[list[int]],
                      domain_size: int, usable_rows: int) -> list[list[int]]:
    """Counting sort (`lookup_argument.hpp:565-635`), host ints: counts by
    `collections.Counter.update` over whole columns, runs emitted by
    `list.extend`. A non-member input (dishonest witness) gets a count
    without a table occurrence: it is never emitted, so the sorted columns
    fail the h/g telescoping identity and the verifier rejects the proof;
    the prover does not crash."""
    sorting_map: collections.Counter = collections.Counter()
    for col in reduced_value:
        sorting_map.update(col[:usable_rows])
    for col in reduced_input:
        sorting_map.update(col[:usable_rows])

    n_sorted = len(reduced_input) + len(reduced_value)
    flat: list[int] = []
    prev = 0
    for col in reduced_value:
        for v in col[:usable_rows]:
            if v != prev:
                if prev == 0:
                    flat.append(0)
                else:
                    flat.extend([prev] * sorting_map[prev])
                prev = v
    if prev != 0:
        flat.extend([prev] * sorting_map[prev])

    assert len(flat) <= n_sorted * usable_rows, "sorted emission overflow"
    sorted_cols = []
    for i in range(n_sorted):
        chunk = flat[i * usable_rows:(i + 1) * usable_rows]
        col = chunk + [0] * (domain_size - len(chunk))
        sorted_cols.append(col)
    for i in range(n_sorted - 1):
        sorted_cols[i][usable_rows] = sorted_cols[i + 1][0]
    return sorted_cols


def _shift_term(fs, v: torch.Tensor, obg: torch.Tensor,
                beta_c: torch.Tensor) -> torch.Tensor:
    """(1+beta) gamma + v + beta v(next row), row by row."""
    return L.add(fs, L.add(fs, obg, v),
                 L.mont_mul(fs, beta_c, torch.roll(v, -1, dims=-1)))


@spanned("zk.placeholder.lookup")
def lookup_prove_eval(params: C.PlaceholderParams,
                      constraint_system: PK.ConstraintSystem,
                      preprocessed: PublicPreprocessedData,
                      desc: PK.TableDescription,
                      table: PolynomialTable,
                      commitment_scheme,
                      transcript: Transcript,
                      clock: PhaseClock | None = None) -> LookupProverResult:
    """`clock`, where given, is marked after the compressed columns
    (`lookup_prepare`), their decode (`lookup_to_host`), the host sort
    (`lookup_sort`), the sorted columns' encode (`lookup_encode`) and their
    commit (`lookup_commit`). A call is the span `zk.placeholder.lookup`,
    and the same steps are spans under it, `zk.lookup.<step>` (`prepare`,
    `to_host`, `sort`, `encode`, `commit`)."""
    def mark(name):
        if clock is not None:
            clock.mark(name)

    fs = params.fs
    p = fs.p
    common = preprocessed.common_data
    n = common.basic_domain.n
    usable = desc.usable_rows_amount
    dev = table.device

    with span("zk.lookup.prepare"):
        theta = transcript.challenge(fs)

        one_poly = PolyDFS.constant(fs, 1, n, dev)
        mask = one_poly - preprocessed.q_last - preprocessed.q_blind

        lookup_value = _prepare_lookup_value(fs, constraint_system, table,
                                             theta, mask)
        lookup_input = _prepare_lookup_input(fs, constraint_system, table,
                                             theta)

        reduced_value = [_reduce_dfs_domain(v, n) for v in lookup_value]
        reduced_input = [_reduce_dfs_domain(v, n) for v in lookup_input]
    mark("lookup_prepare")

    with span("zk.lookup.to_host"):
        rv_ints = [v.to_ints() for v in reduced_value]
        ri_ints = [v.to_ints() for v in reduced_input]
    mark("lookup_to_host")
    with span("zk.lookup.sort"):
        sorted_cols = _sort_polynomials(fs, ri_ints, rv_ints, n, usable)
    mark("lookup_sort")
    with span("zk.lookup.encode"):
        sorted_polys = [PolyDFS(fs, L.encode(fs, col, dev), n)
                        for col in sorted_cols]
    mark("lookup_encode")

    with span("zk.lookup.commit"):
        for s in sorted_polys:
            commitment_scheme.append_to_batch(C.LOOKUP_BATCH, s)
        lookup_commitment = commitment_scheme.commit(C.LOOKUP_BATCH)
        _absorb_commitment(transcript, fs, lookup_commitment)
    mark("lookup_commit")

    beta = transcript.challenge(fs)
    gamma = transcript.challenge(fs)

    part_sizes = lookup_parts_list(constraint_system,
                                   common.max_quotient_chunks)
    lookup_alphas = [transcript.challenge(fs)
                     for _ in range(len(part_sizes) - 1)]

    # --- V_L: ratio per row, exclusive prefix, zero after usable ---
    beta_c = L.const_mont(fs, beta, (1,), dev)
    gamma_c = L.const_mont(fs, gamma, (n,), dev)
    obg = L.const_mont(fs, (1 + beta) * gamma % p, (n,), dev)  # (1+β)γ
    ob = L.const_mont(fs, (1 + beta) % p, (1,), dev)

    num = L.ones_mont(fs, (n,), dev)
    for ri in reduced_input:
        num = L.mont_mul(fs, num,
                         L.mont_mul(fs, ob, L.add(fs, gamma_c, ri.v)))
    for rv in reduced_value:
        num = L.mont_mul(fs, num, _shift_term(fs, rv.v, obg, beta_c))
    den = L.ones_mont(fs, (n,), dev)
    for s in sorted_polys:
        den = L.mont_mul(fs, den, _shift_term(fs, s.v, obg, beta_c))
    ratio = L.mont_mul(fs, num, L.batch_inverse(fs, den, axis=1))
    vl_vals = L.prefix_product_exclusive(fs, ratio, axis=1)
    row_mask = torch.arange(n, device=dev) <= usable
    vl_vals = L.select(row_mask, vl_vals, L.zeros(fs, (n,), dev))
    V_L = PolyDFS(fs, vl_vals, n)
    commitment_scheme.append_to_batch(C.PERMUTATION_BATCH, V_L)

    # --- gs / hs partition products (`:296-373`) ---
    obg_poly = PolyDFS.constant(fs, (1 + beta) * gamma % p, 1, dev)
    gs: list[PolyDFS] = []
    mults: list[PolyDFS] = []
    current_part = 0
    for li in lookup_input:
        mults.append((li + PolyDFS.constant(fs, gamma, 1, dev))
                     .scale((1 + beta) % p))
        if len(mults) == part_sizes[current_part]:
            gs.append(polynomial_product(mults))
            mults = []
            current_part += 1
    for lv in lookup_value:
        mults.append(obg_poly + lv + lv.shift(1, n).scale(beta))
        if len(mults) == part_sizes[current_part]:
            gs.append(polynomial_product(mults))
            mults = []
            current_part += 1
    assert not mults

    hs: list[PolyDFS] = []
    mults = []
    current_part = 0
    for s in sorted_polys:
        mults.append(obg_poly + s + s.shift(1, n).scale(beta))
        if len(mults) == part_sizes[current_part]:
            hs.append(polynomial_product(mults))
            mults = []
            current_part += 1
    assert not mults

    V_L_shifted = V_L.shift(1)
    lagrange_0 = lagrange_polynomial(fs, common.basic_domain, 0, dev)

    F = [None] * 4
    F[0] = lagrange_0 * (one_poly - V_L)
    F[1] = preprocessed.q_last * (V_L * V_L - V_L)

    if len(part_sizes) == 1:
        g, h = gs[0], hs[0]
        acc = g * V_L - h * V_L_shifted
        F[2] = acc * (preprocessed.q_last + preprocessed.q_blind - one_poly)
    else:
        row_mask_u = torch.arange(n, device=dev) < usable
        F2, previous, _ = _running_parts(fs, V_L, gs, hs, lookup_alphas, n,
                                         row_mask_u, commitment_scheme)
        last = len(lookup_alphas)
        F2 = F2 + (previous * gs[last] - V_L_shifted * hs[last])
        F[2] = F2 * (preprocessed.q_last + preprocessed.q_blind - one_poly)

    # F[3]: sorted-poly continuity (`:279-288`)
    f3_parts = []
    for i in range(len(sorted_polys) - 1):
        alpha = transcript.challenge(fs)
        part = sorted_polys[i + 1] - sorted_polys[i].shift(usable)
        f3_parts.append((part * lagrange_0).scale(alpha))
    F[3] = polynomial_sum(f3_parts) if f3_parts \
        else PolyDFS.constant(fs, 0, n, dev)

    return LookupProverResult(F_dfs=F, lookup_commitment=lookup_commitment)


def lookup_verify_eval(params: C.PlaceholderParams, common,
                       special_selector_values: list[int],
                       special_selector_values_shifted: list[int],
                       constraint_system: PK.ConstraintSystem,
                       challenge: int,
                       evaluations: dict,
                       sorted_values: list[list[int]],
                       V_L_values: list[int],
                       parts_values: list[int],
                       lookup_commitment,
                       transcript: Transcript) -> list[int]:
    """`lookup_argument.hpp:664-833` (host scalars)."""
    fs = params.fs
    p = fs.p
    theta = transcript.challenge(fs)
    _absorb_commitment(transcript, fs, lookup_commitment)

    mask_value = (1 - special_selector_values[1]
                  - special_selector_values[2]) % p
    shifted_mask_value = (1 - special_selector_values_shifted[0]
                          - special_selector_values_shifted[1]) % p

    lookup_value = []
    shifted_lookup_value = []
    for t_id, lookup_table in enumerate(constraint_system.lookup_tables):
        sel = evaluations[(lookup_table.tag_index, 0, PK.SELECTOR)]
        sel_sh = evaluations[(lookup_table.tag_index, 1, PK.SELECTOR)]
        for option in lookup_table.lookup_options:
            v = sel * (t_id + 1) % p
            sv = sel_sh * (t_id + 1) % p
            theta_acc = theta
            for col in option:
                v = (v + theta_acc * evaluations[(col.index, 0, PK.CONSTANT)]
                     * sel) % p
                sv = (sv + theta_acc * evaluations[(col.index, 1, PK.CONSTANT)]
                      * sel_sh) % p
                theta_acc = theta_acc * theta % p
            lookup_value.append(v * mask_value % p)
            shifted_lookup_value.append(sv * shifted_mask_value % p)

    lookup_input = []
    for gate in constraint_system.lookup_gates:
        sel = evaluations[(gate.tag_index, 0, PK.SELECTOR)]
        for constraint in gate.constraints:
            l = sel * constraint.table_id % p
            theta_acc = theta
            for e in constraint.lookup_input:
                val = scalar_expr(p, e, evaluations)
                l = (l + sel * theta_acc * val) % p
                theta_acc = theta_acc * theta % p
            lookup_input.append(l)

    beta = transcript.challenge(fs)
    gamma = transcript.challenge(fs)
    parts = lookup_parts_list(constraint_system, common.max_quotient_chunks)
    lookup_alphas = [transcript.challenge(fs) for _ in range(len(parts) - 1)]
    assert len(lookup_alphas) == len(parts_values)

    gs, hs = [], []
    g = 1
    current_part, current_size = 0, 0
    for li in lookup_input:
        g = g * (1 + beta) % p * ((gamma + li) % p) % p
        current_size += 1
        if current_size == parts[current_part]:
            gs.append(g)
            g = 1
            current_size = 0
            current_part += 1
    for i in range(len(lookup_value)):
        g = g * (((1 + beta) * gamma + lookup_value[i]
                  + beta * shifted_lookup_value[i]) % p) % p
        current_size += 1
        if current_size == parts[current_part]:
            gs.append(g)
            g = 1
            current_size = 0
            current_part += 1
    assert current_size == 0

    h = 1
    current_part, current_size = 0, 0
    for sv in sorted_values:
        h = h * (((1 + beta) * gamma + sv[0] + beta * sv[1]) % p) % p
        current_size += 1
        if current_size == parts[current_part]:
            hs.append(h)
            h = 1
            current_size = 0
            current_part += 1
    assert current_size == 0

    V_L_value, V_L_shifted = V_L_values[0], V_L_values[1]
    F = [0, 0, 0, 0]
    F[0] = (1 - V_L_value) * special_selector_values[0] % p
    F[1] = special_selector_values[1] * (V_L_value * V_L_value - V_L_value) % p
    if len(parts) == 1:
        F[2] = mask_value * (V_L_shifted * hs[0] - V_L_value * gs[0]) % p
    else:
        previous = V_L_value
        acc = 0
        for i in range(len(lookup_alphas)):
            current = parts_values[i]
            acc = (acc + lookup_alphas[i]
                   * (previous * gs[i] - current * hs[i])) % p
            previous = current
        last = len(lookup_alphas)
        acc = (acc + previous * gs[last] - V_L_shifted * hs[last]) % p
        F[2] = acc * ((special_selector_values[1]
                       + special_selector_values[2] - 1) % p) % p
    F[3] = 0
    for i in range(1, len(sorted_values)):
        alpha = transcript.challenge(fs)
        F[3] = (F[3] + (sorted_values[i][0] - sorted_values[i - 1][2])
                * alpha * special_selector_values[0]) % p
    return F
