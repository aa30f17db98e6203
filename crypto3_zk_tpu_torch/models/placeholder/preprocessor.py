"""Placeholder public/private preprocessors.

Re-implements `placeholder/preprocessor.hpp`: copy-constraint cycle
representation (union-find with cycle splicing, `preprocessor.hpp:286-361`),
S_id/S_sigma permutation polynomials (`:418-459`), special selectors L0,
q_last, q_blind (`:461-472`), the FIXED_VALUES commitment (`:474-491`),
columns_rotations (`:364-416`), verification key and common_data
(`:494-611`), and the private witness-table conversion (`:625-639`).

Counterpart of `models/placeholder/preprocessor.py` of the JAX package.
Every polynomial is made on the `device` the caller names (default: the
card). S_id columns are delta^i-scaled omega-power ladders built there by
doubling; S_sigma values are assembled on the host from the cycle map (pure
index bookkeeping, a Python loop over rows x permuted columns) and encoded
once; all columns become `PolyDFS` evaluation-form polynomials over the
basic domain.
"""
from __future__ import annotations

import dataclasses

from ...arithmetization import plonk as PK
from ...commitments.fri import PhaseClock
from ...fields.params import FieldSpec
from ...ops import limbs as L
from ...poly.domain import Domain, get_domain
from ...poly.polynomial import PolyDFS
from ...transcript.poseidon_transcript import make_transcript
from ...utils.profiling import spanned
from . import common as C


class CycleRepresentation:
    """Union-find with explicit cycle structure (`preprocessor.hpp:286-361`):
    _mapping holds, for every cell, the NEXT cell of its copy-cycle."""

    def __init__(self, constraint_system: PK.ConstraintSystem,
                 desc: PK.TableDescription):
        self._mapping: dict[tuple[int, int], tuple[int, int]] = {}
        self._aux: dict[tuple[int, int], tuple[int, int]] = {}
        self._sizes: dict[tuple[int, int], int] = {}
        for i in range(desc.table_width() - desc.selector_columns):
            for j in range(desc.rows_amount):
                key = (i, j)
                self._mapping[key] = key
                self._aux[key] = key
                self._sizes[key] = 1
        for (a, b) in constraint_system.copy_constraints:
            x = (desc.global_index(a), a.rotation)
            y = (desc.global_index(b), b.rotation)
            self.apply_copy_constraint(x, y)

    def apply_copy_constraint(self, x, y):
        for k in (x, y):
            if k not in self._mapping:
                self._mapping[k] = k
                self._aux[k] = k
                self._sizes[k] = 1
        if self._aux[x] != self._aux[y]:
            left, right = x, y
            if self._sizes[self._aux[left]] < self._sizes[self._aux[right]]:
                left, right = right, left
            self._sizes[self._aux[left]] += self._sizes[self._aux[right]]
            z = self._aux[right]
            exit_condition = self._aux[right]
            while True:
                self._aux[z] = self._aux[left]
                z = self._mapping[z]
                if z == exit_condition:
                    break
            self._mapping[left], self._mapping[right] = \
                self._mapping[right], self._mapping[left]

    def __getitem__(self, key):
        return self._mapping[key]


def columns_rotations(constraint_system: PK.ConstraintSystem,
                      desc: PK.TableDescription) -> list[list[int]]:
    """Per-global-column sorted rotation sets (`preprocessor.hpp:364-416`)."""
    result = [{0} for _ in range(desc.table_width())]

    def visit(var: PK.Var):
        result[desc.global_index(var)].add(var.rotation)

    for gate in constraint_system.gates:
        for constraint in gate.constraints:
            PK.expr_for_each_variable(constraint, visit)

    if constraint_system.lookup_gates:
        for gate in constraint_system.lookup_gates:
            for constraint in gate.constraints:
                for e in constraint.lookup_input:
                    PK.expr_for_each_variable(e, visit)
        for table in constraint_system.lookup_tables:
            result[desc.witness_columns + desc.public_input_columns
                   + desc.constant_columns + table.tag_index].add(1)
            for option in table.lookup_options:
                for column in option:
                    result[desc.witness_columns + desc.public_input_columns
                           + column.index].add(1)
    return [sorted(s) for s in result]


def identity_polynomials(fs: FieldSpec, permutation_size: int,
                         domain: Domain, delta: int,
                         device=None) -> list[PolyDFS]:
    """S_id[i][j] = delta^i * omega^j (`preprocessor.hpp:418-435`)."""
    out = []
    omega_pows = L.powers(fs, domain.omega, domain.n, device)
    for i in range(permutation_size):
        di = L.const_mont(fs, pow(delta, i, fs.p), (1,), device)
        out.append(PolyDFS(fs, L.mont_mul(fs, omega_pows, di), domain.n))
    return out


def permutation_polynomials(fs: FieldSpec, global_indices: list[int],
                            domain: Domain, delta: int,
                            permutation: CycleRepresentation,
                            device=None) -> list[PolyDFS]:
    """S_sigma[i][j] = delta^idx(sigma_col) * omega^sigma_row
    (`preprocessor.hpp:437-459`). Host index bookkeeping + one encode."""
    p = fs.p
    delta_pows = [pow(delta, i, p) for i in range(len(global_indices))]
    omega_pows = [1] * domain.n
    for j in range(1, domain.n):
        omega_pows[j] = omega_pows[j - 1] * domain.omega % p
    pos_of = {g: i for i, g in enumerate(global_indices)}
    out = []
    for i, g in enumerate(global_indices):
        vals = []
        for j in range(domain.n):
            (pc, pr) = permutation[(g, j)]
            vals.append(delta_pows[pos_of[pc]] * omega_pows[pr] % p)
        out.append(PolyDFS(fs, L.encode(fs, vals, device), domain.n))
    return out


def lagrange_polynomial(fs: FieldSpec, domain: Domain, number: int,
                        device=None) -> PolyDFS:
    vals = [0] * domain.n
    if number < domain.n:
        vals[number] = 1
    return PolyDFS(fs, L.encode(fs, vals, device), domain.n)


def selector_blind(fs: FieldSpec, usable_rows: int, domain: Domain,
                   device=None) -> PolyDFS:
    vals = [0] * domain.n
    for j in range(usable_rows + 1, domain.n):
        vals[j] = 1
    return PolyDFS(fs, L.encode(fs, vals, device), domain.n)


@dataclasses.dataclass
class VerificationKey:
    constraint_system_with_params_hash: bytes
    fixed_values_commitment: object


@dataclasses.dataclass
class CommonData:
    """`common_data_type` (`preprocessor.hpp:127-253`)."""
    vk: VerificationKey
    columns_rotations: list[list[int]]
    desc: PK.TableDescription
    max_gates_degree: int
    permutation_parts: int
    lookup_parts: int
    permuted_columns: list[int]          # global indices
    max_quotient_chunks: int
    commitment_scheme_data: object       # LPC: {batch: eta values}; KZG: True
    basic_domain: Domain

    def lagrange_0_at(self, y: int) -> int:
        return self.basic_domain.lagrange_at(0, y)

    def Z_at(self, y: int) -> int:
        """Z = x^rows - 1."""
        return self.basic_domain.evaluate_vanishing(y)


@dataclasses.dataclass
class PublicPreprocessedData:
    public_inputs: list[PolyDFS]
    constants: list[PolyDFS]
    selectors: list[PolyDFS]
    permutation_polynomials: list[PolyDFS]   # S_sigma
    identity_polynomials: list[PolyDFS]      # S_id
    q_last: PolyDFS
    q_blind: PolyDFS
    common_data: CommonData


@dataclasses.dataclass
class PrivatePreprocessedData:
    basic_domain: Domain
    witnesses: list[PolyDFS]


def permutation_partitions_num(permutation_size: int,
                               max_quotient_chunks: int) -> int:
    if permutation_size == 0:
        return 0
    if max_quotient_chunks == 0:
        return 1
    return -(-permutation_size // (max_quotient_chunks - 1))


def lookup_parts_list(constraint_system: PK.ConstraintSystem,
                      max_quotient_chunks: int) -> list[int]:
    """`constraint_system.hpp:256-306`."""
    if max_quotient_chunks == 0:
        return [constraint_system.sorted_lookup_columns_number()]
    parts = []
    chunk = 0
    part = 0
    for gate in constraint_system.lookup_gates:
        for constr in gate.constraints:
            deg = max((PK.expr_max_degree(li) for li in constr.lookup_input),
                      default=0)
            if chunk + deg + 1 >= max_quotient_chunks:
                parts.append(part)
                chunk = 0
                part = 0
            chunk += deg + 1
            part += 1
    for table in constraint_system.lookup_tables:
        for _option in table.lookup_options:
            if chunk + 3 >= max_quotient_chunks:
                parts.append(part)
                chunk = 0
                part = 0
            chunk += 3
            part += 1
    if part != 0:
        parts.append(part)
    return parts


def process_public(params: C.PlaceholderParams,
                   constraint_system: PK.ConstraintSystem,
                   assignment: PK.Assignment,
                   desc: PK.TableDescription,
                   commitment_scheme,
                   max_quotient_poly_chunks: int = 0,
                   delta: int | None = None, device=None,
                   clock: PhaseClock | None = None) -> PublicPreprocessedData:
    """`placeholder_public_preprocessor::process` (`preprocessor.hpp:494-611`).
    Commits the FIXED_VALUES batch into `commitment_scheme` (which the prover
    then shares). The polynomials are made on `device` (default: the card).
    `clock`, where given, is marked after each step (`cycles`, `s_id`,
    `s_sigma`, `special_selectors`, `columns`, `fixed_commit`,
    `scheme_preprocess`)."""
    def mark(name):
        if clock is not None:
            clock.mark(name)

    fs = params.fs
    device = L.resolve_device(device)
    delta = fs.generator if delta is None else delta
    n_rows = desc.rows_amount
    usable_rows = desc.usable_rows_amount
    max_gates_degree = max(constraint_system.max_gates_degree(),
                           constraint_system.max_lookup_gates_degree())
    assert max_gates_degree > 0
    basic_domain = get_domain(fs, n_rows)

    permutation = CycleRepresentation(constraint_system, desc)
    permuted_columns = constraint_system.permuted_columns(desc)
    global_indices = [desc.global_index(v) for v in permuted_columns]
    mark("cycles")

    id_perm_polys = identity_polynomials(fs, len(permuted_columns),
                                         basic_domain, delta, device)
    mark("s_id")
    sigma_perm_polys = permutation_polynomials(fs, global_indices,
                                               basic_domain, delta,
                                               permutation, device)
    mark("s_sigma")
    q_last = lagrange_polynomial(fs, basic_domain, usable_rows, device)
    q_blind = selector_blind(fs, usable_rows, basic_domain, device)
    mark("special_selectors")

    def cols_to_dfs(cols):
        return [PolyDFS(fs, L.encode(fs, c, device), basic_domain.n)
                for c in cols]

    public_inputs = cols_to_dfs(assignment.public_inputs)
    constants = cols_to_dfs(assignment.constants)
    selectors = cols_to_dfs(assignment.selectors)
    mark("columns")

    assert max_quotient_poly_chunks == 0 \
        or max_quotient_poly_chunks > max_gates_degree
    permutation_parts_num = permutation_partitions_num(
        len(permuted_columns), max_quotient_poly_chunks)
    lookup_parts_num = len(lookup_parts_list(constraint_system,
                                             max_quotient_poly_chunks))

    # commitments (`preprocessor.hpp:474-491`)
    commitment_scheme.append_to_batch(C.FIXED_VALUES_BATCH, id_perm_polys)
    commitment_scheme.append_to_batch(C.FIXED_VALUES_BATCH, sigma_perm_polys)
    commitment_scheme.append_to_batch(C.FIXED_VALUES_BATCH, q_last)
    commitment_scheme.append_to_batch(C.FIXED_VALUES_BATCH, q_blind)
    commitment_scheme.append_to_batch(C.FIXED_VALUES_BATCH, constants)
    commitment_scheme.append_to_batch(C.FIXED_VALUES_BATCH, selectors)
    fixed_commitment = commitment_scheme.commit(C.FIXED_VALUES_BATCH)
    commitment_scheme.mark_batch_as_fixed(C.FIXED_VALUES_BATCH)
    mark("fixed_commit")

    c_rotations = columns_rotations(constraint_system, desc)
    cs_hash = C.constraint_system_with_params_hash(
        params, constraint_system, desc,
        commitment_scheme.get_commitment_params().transcript_repr(), delta)
    vk = VerificationKey(cs_hash, fixed_commitment)

    # transcript for commitment-scheme preprocessing (eta evaluations)
    transcript = make_transcript(params.transcript_hash, fs, b"")
    transcript.absorb(vk.constraint_system_with_params_hash)
    _absorb_commitment(transcript, params.fs, vk.fixed_values_commitment)
    scheme_data = commitment_scheme.preprocess(transcript)
    mark("scheme_preprocess")

    common_data = CommonData(
        vk=vk,
        columns_rotations=c_rotations,
        desc=desc,
        max_gates_degree=max_gates_degree,
        permutation_parts=permutation_parts_num,
        lookup_parts=lookup_parts_num,
        permuted_columns=global_indices,
        max_quotient_chunks=max_quotient_poly_chunks,
        commitment_scheme_data=scheme_data,
        basic_domain=basic_domain,
    )
    return PublicPreprocessedData(
        public_inputs=public_inputs,
        constants=constants,
        selectors=selectors,
        permutation_polynomials=sigma_perm_polys,
        identity_polynomials=id_perm_polys,
        q_last=q_last,
        q_blind=q_blind,
        common_data=common_data,
    )


@spanned("zk.placeholder.process_private")
def process_private(params: C.PlaceholderParams,
                    constraint_system: PK.ConstraintSystem,
                    assignment: PK.Assignment,
                    desc: PK.TableDescription,
                    device=None) -> PrivatePreprocessedData:
    """`placeholder_private_preprocessor::process` (`preprocessor.hpp:625-639`):
    the witness columns as polynomials on `device` (default: the card)."""
    fs = params.fs
    basic_domain = get_domain(fs, desc.rows_amount)
    witnesses = [PolyDFS(fs, L.encode(fs, c, device), basic_domain.n)
                 for c in assignment.witnesses]
    return PrivatePreprocessedData(basic_domain=basic_domain,
                                   witnesses=witnesses)


def _absorb_commitment(transcript, fs: FieldSpec, commitment):
    if isinstance(commitment, bytes):
        transcript.absorb(commitment)
    else:
        transcript.absorb_field(fs, commitment)
