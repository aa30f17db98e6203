"""The reference's judgement of a Placeholder proof over LPC/FRI.

A proof is accepted when both hold:

1. The verifier accepts it: a plain-integer copy of crypto3-zk's
   `placeholder/verifier.hpp` (142-400) as the port's verifier makes it,
   over this package's keccak transcript, Poseidon Merkle paths and FRI
   check (`fri.py`), with the verifier's side worked out here again from
   the circuit: the columns' rotations, the permuted columns, the argument
   parts, the circuit hash, the quotient's chunk count, and the fixed
   polynomials' values at the preprocessing challenge eta (the program's
   `commitment_scheme_data`).
2. Every value the proof opens of a witness, public input, constant,
   selector, identity, sigma or special selector column at the challenge
   (and its rotations) is the value of that column's polynomial there,
   computed from the columns the benchmark made. This binds the proof to
   the witness asked for and the fixed commitment to the circuit.

The only thing taken from the program's preprocessing is the fixed batch's
Merkle root, the claim that the FRI queries then check: every query opens
the fixed polynomials under it, and their values at eta are the
reference's own.
"""
from __future__ import annotations

import hashlib
import pathlib

from . import plonk as PK
from .domain import BLS12_381_FR, Domain, Lagrange
from .fri import FRIParams, verify_lpc
from .hashes import Transcript, keccak_256, poseidon

FIXED, VARIABLE, PERMUTATION, QUOTIENT, LOOKUP = range(5)
F_PARTS = 8
APPLICATION_ID = "Default application dependent transcript initialization string"
# keccak-256 of long texts, by their sha-256: a fixed directory of the
# checkout, so that only a checkout's first run hashes a circuit's text
CACHE = pathlib.Path(__file__).resolve().parents[2] / "build" / "zkbench" \
    / "reference"


def _expr_repr(e) -> str:
    if isinstance(e, PK.Var):
        return f"v({e.type},{e.index},{e.rotation})"
    if isinstance(e, PK.Const):
        return f"c({e.v})"
    if isinstance(e, PK.BinOp):
        return f"({_expr_repr(e.l)}{e.op}{_expr_repr(e.r)})"
    if isinstance(e, PK.Pow):
        return f"({_expr_repr(e.base)}^{e.exp})"
    raise TypeError(e)


def circuit_hash(p: int, cs, desc, commitment_repr: str, delta: int) -> bytes:
    """The circuit-and-parameters hash the transcript starts from: a
    canonical text of the field, table, commitment, gates, copies and
    lookups, hashed with keccak-256."""
    parts = [
        f"field={p:#x}",
        f"rows={desc.rows_amount},usable={desc.usable_rows_amount}",
        f"cols={desc.witness_columns},{desc.public_input_columns},"
        f"{desc.constant_columns},{desc.selector_columns}",
        f"delta={delta}",
        f"commitment={commitment_repr}",
        f"app={APPLICATION_ID}",
        "gates=" + ";".join(
            f"{g.selector_index}:" + ",".join(_expr_repr(c)
                                              for c in g.constraints)
            for g in cs.gates),
        "copies=" + ";".join(
            f"{a.type}{a.index}@{a.rotation}~{b.type}{b.index}@{b.rotation}"
            for a, b in cs.copy_constraints),
        "lookup_gates=" + ";".join(
            f"{g.tag_index}:" + "|".join(
                f"{c.table_id}:" + ",".join(_expr_repr(e)
                                            for e in c.lookup_input)
                for c in g.constraints)
            for g in cs.lookup_gates),
        "lookup_tables=" + ";".join(
            f"{t.tag_index}:{t.columns_number}:" + "|".join(
                ",".join(f"{v.type}{v.index}" for v in opt)
                for opt in t.lookup_options)
            for t in cs.lookup_tables),
        "pub_sizes=" + ",".join(map(str, cs.public_input_sizes)),
    ]
    return _cached_keccak("\n".join(parts).encode())


def _cached_keccak(text: bytes) -> bytes:
    """keccak-256 of `text`; a text of more than 64 KiB takes minutes in
    plain Python, so its digest is kept under `CACHE` by the text's
    sha-256 and read back by later runs of the checkout."""
    if len(text) <= 1 << 16:
        return keccak_256(text)
    path = CACHE / (hashlib.sha256(text).hexdigest() + ".keccak256")
    if path.exists():
        return bytes.fromhex(path.read_text().strip())
    digest = keccak_256(text)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(digest.hex())
    tmp.replace(path)
    return digest


def columns_rotations(cs, desc) -> list[list[int]]:
    result = [{0} for _ in range(desc.table_width())]

    def visit(v):
        result[desc.global_index(v)].add(v.rotation)

    for gate in cs.gates:
        for c in gate.constraints:
            PK.expr_for_each_variable(c, visit)
    if cs.lookup_gates:
        for gate in cs.lookup_gates:
            for c in gate.constraints:
                for e in c.lookup_input:
                    PK.expr_for_each_variable(e, visit)
        base = desc.witness_columns + desc.public_input_columns
        for table in cs.lookup_tables:
            result[base + desc.constant_columns + table.tag_index].add(1)
            for option in table.lookup_options:
                for column in option:
                    result[base + column.index].add(1)
    return [sorted(s) for s in result]


def lookup_parts(cs, max_chunks: int) -> list[int]:
    if max_chunks == 0:
        return [cs.sorted_lookup_columns_number()]
    parts, chunk, part = [], 0, 0
    for gate in cs.lookup_gates:
        for c in gate.constraints:
            deg = max((PK.expr_max_degree(e) for e in c.lookup_input),
                      default=0)
            if chunk + deg + 1 >= max_chunks:
                parts.append(part)
                chunk = part = 0
            chunk += deg + 1
            part += 1
    for table in cs.lookup_tables:
        for _ in table.lookup_options:
            if chunk + 3 >= max_chunks:
                parts.append(part)
                chunk = part = 0
            chunk += 3
            part += 1
    if part:
        parts.append(part)
    return parts


def sigma_columns(cs, desc, permuted: list[int], omega_pows: list[int],
                  delta: int, p: int) -> list[list[int]]:
    """S_sigma's values: the copy constraints' cycles (crypto3-zk's
    `preprocessor.hpp:286-361` union-find with cycle splicing, over flat
    arrays), each cell mapped to delta^(its column's place) w^(its row)."""
    n = desc.rows_amount
    cells = (desc.table_width() - desc.selector_columns) * n
    mapping = list(range(cells))
    aux = list(range(cells))
    sizes = [1] * cells
    for a, b in cs.copy_constraints:
        x = desc.global_index(a) * n + a.rotation
        y = desc.global_index(b) * n + b.rotation
        if aux[x] == aux[y]:
            continue
        left, right = x, y
        if sizes[aux[left]] < sizes[aux[right]]:
            left, right = right, left
        sizes[aux[left]] += sizes[aux[right]]
        z = exit_at = aux[right]
        while True:
            aux[z] = aux[left]
            z = mapping[z]
            if z == exit_at:
                break
        mapping[left], mapping[right] = mapping[right], mapping[left]
    place = {g: i for i, g in enumerate(permuted)}
    delta_pows = [pow(delta, i, p) for i in range(len(permuted))]
    out = []
    for g in permuted:
        col = []
        for j in range(n):
            m = mapping[g * n + j]
            col.append(delta_pows[place[m // n]] * omega_pows[m % n] % p)
        out.append(col)
    return out


class PlaceholderReference:
    """The verifier's side of one circuit under one configuration."""

    def __init__(self, config: dict, circuit):
        self.field = BLS12_381_FR
        p = self.p = self.field.p
        if p != config["field_modulus"]:
            raise ValueError("the reference knows bls12-381 Fr only")
        if config["merkle_hash"] != "poseidon" \
                or config["transcript_hash"] != "keccak_256":
            raise ValueError("the reference hashes with Poseidon trees and a "
                             "keccak-256 transcript")
        cs, desc = self.cs, self.desc = circuit.cs, circuit.desc
        self.public_input = circuit.public_input
        n = self.n = desc.rows_amount
        self.domain = Domain(self.field, n)
        self.mqc = config["max_quotient_chunks"]
        self.fri = FRIParams(self.field, n.bit_length() - 1,
                             config["expand_factor"], config["lambda"])
        self.hasher = poseidon(p)
        self.delta = self.field.generator
        self.rotations = columns_rotations(cs, desc)
        self.permuted = [desc.global_index(v)
                         for v in cs.permuted_columns(desc)]
        self.perm_parts = (0 if not self.permuted else 1 if self.mqc == 0
                           else -(-len(self.permuted) // (self.mqc - 1)))
        self.lookup_parts = lookup_parts(cs, self.mqc)
        self.lookup = len(cs.lookup_gates) > 0
        self.copy = len(cs.copy_constraints) > 0
        self.cs_hash = circuit_hash(p, cs, desc, self.fri.transcript_repr(),
                                    self.delta)
        gates_degree = max(cs.max_gates_degree(), cs.max_lookup_gates_degree())
        split = max((len(self.permuted) + 2) * (n - 1),
                    (cs.lookup_poly_degree_bound() + 1) * (n - 1),
                    (gates_degree + 1) * (n - 1))
        split = -(-split // n)
        if self.mqc and split > self.mqc:
            split = self.mqc
        self.sizes = {
            FIXED: 2 * len(self.permuted) + 2 + desc.constant_columns
            + desc.selector_columns,
            VARIABLE: desc.witness_columns + desc.public_input_columns,
            QUOTIENT: split,
        }
        if self.copy or self.lookup:
            self.sizes[PERMUTATION] = self.perm_parts + (
                len(self.lookup_parts) if self.lookup else 0)
        if self.lookup:
            self.sizes[LOOKUP] = cs.sorted_lookup_columns_number()
        # the fixed batch's columns, in its order
        usable = desc.usable_rows_amount
        q_last = [0] * n
        q_last[usable] = 1
        q_blind = [1 if j > usable else 0 for j in range(n)]
        self.fixed_columns = (
            sigma_columns(cs, desc, self.permuted, self.domain.powers,
                          self.delta, p)
            + [q_last, q_blind] + list(circuit.constants)
            + list(circuit.selectors))
        self.public_columns = list(circuit.public_inputs)
        self._fixed_at_eta = {}

    # -- the fixed batch's polynomials at a point --------------------------
    def fixed_rotations(self) -> list[list[int]]:
        """Each fixed polynomial's rotations, in the batch's order."""
        w, pc = self.desc.witness_columns, self.desc.public_input_columns
        rot = [[0]] * (2 * len(self.permuted)) + [[0, 1], [0, 1]]
        return rot + [self.rotations[w + pc + i] for i in range(
            self.desc.constant_columns + self.desc.selector_columns)]

    def fixed_values(self, lag: Lagrange, x: int) -> list[list[int]]:
        """[poly][rotation] values of the fixed batch at x."""
        p = self.p
        ids = [[pow(self.delta, i, p) * x % p] for i in range(
            len(self.permuted))]
        rots = self.fixed_rotations()[len(self.permuted):]
        rest = [[lag.dot(col, r) for r in rs]
                for col, rs in zip(self.fixed_columns, rots)]
        return ids + rest

    # -- judging -----------------------------------------------------------
    def accepts(self, proof: dict, witnesses: list, claims: dict) -> bool:
        """`witnesses`: the witness columns the proof was asked for."""
        try:
            return (self._shape(proof)
                    and self._columns(proof, witnesses)
                    and self._verify(proof, claims["fixed_root"]))
        except (KeyError, IndexError, TypeError, ValueError,
                ZeroDivisionError):
            return False

    def _shape(self, proof: dict) -> bool:
        z = proof["z"]
        return set(z) == set(self.sizes) and all(
            len(z[k]) == size for k, size in self.sizes.items())

    def _columns(self, proof: dict, witnesses: list) -> bool:
        """Check 2: the opened column values at the challenge."""
        z, y = proof["z"], proof["challenge"]
        lag = Lagrange(self.domain, y)
        cols = list(witnesses) + self.public_columns
        for i, col in enumerate(cols):
            if z[VARIABLE][i] != [lag.dot(col, r) for r in self.rotations[i]]:
                return False
        return z[FIXED] == self.fixed_values(lag, y)

    def _verify(self, proof: dict, fixed_root) -> bool:
        """Check 1: the verifier."""
        p, desc, cs = self.p, self.desc, self.cs
        z, commitments = proof["z"], proof["commitments"]
        challenge = proof["challenge"]
        omega = self.domain.omega
        w_cols, p_cols = desc.witness_columns, desc.public_input_columns
        c_cols, s_cols = desc.constant_columns, desc.selector_columns
        P = len(self.permuted)

        # public input consistency
        numerator = (pow(challenge, self.n, p) - 1) * pow(self.n, -1, p) % p
        for i, column in enumerate(self.public_input):
            size = min(len(column), cs.public_input_sizes[i]) \
                if cs.public_input_sizes else len(column)
            value, omega_pow = 0, 1
            for j in range(size):
                value = (value + column[j] * omega_pow
                         * pow((challenge - omega_pow) % p, -1, p)) % p
                omega_pow = omega_pow * omega % p
            if value * numerator % p != z[VARIABLE][w_cols + i][0]:
                return False

        tr = Transcript(p)
        tr.absorb(self.cs_hash)
        tr.absorb_field(fixed_root)
        eta = tr.challenge()
        tr.absorb_field(commitments[VARIABLE])

        special = [self.domain.lagrange_at(0, challenge),
                   z[FIXED][2 * P][0], z[FIXED][2 * P + 1][0]]
        mask = (1 - special[1] - special[2]) % p
        F = [0] * F_PARTS
        if self.copy:
            S_id = [z[FIXED][i][0] for i in range(P)]
            S_sigma = [z[FIXED][P + i][0] for i in range(P)]
            f_vals = []
            for i in self.permuted:
                zero = self.rotations[i].index(0)
                if i < w_cols + p_cols:
                    f_vals.append(z[VARIABLE][i][zero])
                else:
                    f_vals.append(z[FIXED][i - w_cols - p_cols + 2 * P + 2][zero])
            beta, gamma = tr.challenge(), tr.challenge()
            gs, hs, g, h, size = [], [], 1, 1, 0
            for i, v in enumerate(f_vals):
                g = g * ((S_id[i] * beta + v + gamma) % p) % p
                h = h * ((S_sigma[i] * beta + v + gamma) % p) % p
                size += 1
                if self.mqc and size == self.mqc - 1:
                    gs.append(g)
                    hs.append(h)
                    g, h, size = 1, 1, 0
            if size:
                gs.append(g)
                hs.append(h)
            perm, perm_shifted = z[PERMUTATION][0][0], z[PERMUTATION][0][1]
            F[0] = special[0] * (1 - perm) % p
            alphas = tr.challenges(self.perm_parts - 1)
            if self.perm_parts == 1:
                F[1] = (perm_shifted * hs[0] - perm * gs[0]) * mask % p
            else:
                previous, acc = perm, 0
                for i, a in enumerate(alphas):
                    current = z[PERMUTATION][1 + i][0]
                    acc = (acc + a * (previous * gs[i] - current * hs[i])) % p
                    previous = current
                acc = (acc + previous * gs[-1] - perm_shifted * hs[-1]) % p
                F[1] = acc * (-mask) % p
            F[2] = special[1] * (perm * perm - perm) % p

        at_y = {}
        for i in range(w_cols):
            for j, r in enumerate(self.rotations[i]):
                at_y[(i, r, PK.WITNESS)] = z[VARIABLE][i][j]
        for i in range(p_cols):
            for j, r in enumerate(self.rotations[w_cols + i]):
                at_y[(i, r, PK.PUBLIC_INPUT)] = z[VARIABLE][w_cols + i][j]
        for i in range(c_cols):
            for j, r in enumerate(self.rotations[w_cols + p_cols + i]):
                at_y[(i, r, PK.CONSTANT)] = z[FIXED][i + 2 * P + 2][j]
        for i in range(s_cols):
            for j, r in enumerate(
                    self.rotations[w_cols + p_cols + c_cols + i]):
                at_y[(i, r, PK.SELECTOR)] = z[FIXED][i + 2 * P + 2 + c_cols][j]

        if self.lookup:
            shifted_special = [z[FIXED][2 * P][1], z[FIXED][2 * P + 1][1]]
            F[3:7] = self._lookup(tr, z, commitments[LOOKUP], special,
                                  shifted_special, mask, at_y)
        if self.copy or self.lookup:
            tr.absorb_field(commitments[PERMUTATION])

        theta, theta_acc, gates = tr.challenge(), 1, 0
        for gate in cs.gates:
            result = 0
            for c in gate.constraints:
                result = (result + _scalar(p, c, at_y) * theta_acc) % p
                theta_acc = theta_acc * theta % p
            gates = (gates + result * at_y[(gate.selector_index, 0,
                                            PK.SELECTOR)]) % p
        F[7] = gates * mask % p

        alphas = tr.challenges(F_PARTS)
        tr.absorb_field(commitments[QUOTIENT])
        if tr.challenge() != challenge:
            return False

        points = {k: [[] for _ in range(size)]
                  for k, size in self.sizes.items()}

        def add(batch, point, poly=None):
            for j in range(len(points[batch])) if poly is None else [poly]:
                if point not in points[batch][j]:
                    points[batch][j].append(point)

        for i in range(w_cols + p_cols):
            for r in self.rotations[i]:
                add(VARIABLE, challenge * pow(omega, r % (p - 1), p) % p, i)
        if self.lookup or self.copy:
            add(PERMUTATION, challenge)
        if self.copy:
            add(PERMUTATION, challenge * omega % p, 0)
        if self.lookup:
            add(PERMUTATION, challenge * omega % p, self.perm_parts)
            add(LOOKUP, challenge)
            add(LOOKUP, challenge * omega % p)
            add(LOOKUP, challenge * pow(omega, desc.usable_rows_amount, p) % p)
        add(QUOTIENT, challenge)
        start = 2 * P + 2
        for i in range(start):
            add(FIXED, challenge, i)
        add(FIXED, challenge * omega % p, start - 2)
        add(FIXED, challenge * omega % p, start - 1)
        for i in range(c_cols + s_cols):
            for r in self.rotations[w_cols + p_cols + i]:
                add(FIXED, challenge * pow(omega, r % (p - 1), p) % p,
                    start + i)

        if eta not in self._fixed_at_eta:     # one eta a fixed root
            self._fixed_at_eta[eta] = [
                v[0] for v in self.fixed_values(Lagrange(self.domain, eta),
                                                eta)]
        fixed_at_eta = self._fixed_at_eta[eta]
        all_commitments = dict(commitments)
        all_commitments[FIXED] = fixed_root
        if set(all_commitments) != set(self.sizes):
            return False
        if not verify_lpc(proof, self.fri, self.hasher, all_commitments,
                          points, {FIXED: fixed_at_eta}, eta, tr):
            return False

        f_sum = sum(a * f for a, f in zip(alphas, F)) % p
        t_sum = sum(z[QUOTIENT][i][0] * pow(challenge, self.n * i, p)
                    for i in range(len(z[QUOTIENT]))) % p
        return f_sum == self.domain.vanishing(challenge) * t_sum % p

    def _lookup(self, tr, z, lookup_commitment, special, shifted_special,
                mask, at_y) -> list[int]:
        """The lookup argument's four parts of F at the challenge."""
        p, cs = self.p, self.cs
        theta = tr.challenge()
        tr.absorb_field(lookup_commitment)
        shifted_mask = (1 - shifted_special[0] - shifted_special[1]) % p
        values, shifted = [], []
        for t_id, table in enumerate(cs.lookup_tables):
            sel = at_y[(table.tag_index, 0, PK.SELECTOR)]
            sel_sh = at_y[(table.tag_index, 1, PK.SELECTOR)]
            for option in table.lookup_options:
                v, sv, acc = sel * (t_id + 1) % p, sel_sh * (t_id + 1) % p, theta
                for col in option:
                    v = (v + acc * at_y[(col.index, 0, PK.CONSTANT)] * sel) % p
                    sv = (sv + acc * at_y[(col.index, 1, PK.CONSTANT)]
                          * sel_sh) % p
                    acc = acc * theta % p
                values.append(v * mask % p)
                shifted.append(sv * shifted_mask % p)
        inputs = []
        for gate in cs.lookup_gates:
            sel = at_y[(gate.tag_index, 0, PK.SELECTOR)]
            for c in gate.constraints:
                l, acc = sel * c.table_id % p, theta
                for e in c.lookup_input:
                    l = (l + sel * acc * _scalar(p, e, at_y)) % p
                    acc = acc * theta % p
                inputs.append(l)
        beta, gamma = tr.challenge(), tr.challenge()
        parts = self.lookup_parts
        alphas = tr.challenges(len(parts) - 1)

        def grouped(factors):
            out, acc, size, part = [], 1, 0, 0
            for f in factors:
                acc = acc * f % p
                size += 1
                if size == parts[part]:
                    out.append(acc)
                    acc, size, part = 1, 0, part + 1
            if size:
                raise ValueError("lookup parts do not cover the factors")
            return out

        gs = grouped([(1 + beta) * (gamma + li) % p for li in inputs]
                     + [((1 + beta) * gamma + v + beta * s) % p
                        for v, s in zip(values, shifted)])
        sorted_values = z[LOOKUP]
        hs = grouped([((1 + beta) * gamma + sv[0] + beta * sv[1]) % p
                      for sv in sorted_values])
        V, V_shifted = (z[PERMUTATION][self.perm_parts][0],
                        z[PERMUTATION][self.perm_parts][1])
        F = [0, 0, 0, 0]
        F[0] = (1 - V) * special[0] % p
        F[1] = special[1] * (V * V - V) % p
        if len(parts) == 1:
            F[2] = mask * (V_shifted * hs[0] - V * gs[0]) % p
        else:
            previous, acc = V, 0
            for i, a in enumerate(alphas):
                current = z[PERMUTATION][self.perm_parts + 1 + i][0]
                acc = (acc + a * (previous * gs[i] - current * hs[i])) % p
                previous = current
            acc = (acc + previous * gs[-1] - V_shifted * hs[-1]) % p
            F[2] = acc * (-mask) % p
        for i in range(1, len(sorted_values)):
            alpha = tr.challenge()
            F[3] = (F[3] + (sorted_values[i][0] - sorted_values[i - 1][2])
                    * alpha * special[0]) % p
        return F


def _scalar(p: int, expr, values: dict) -> int:
    """An expression's value mod p, its variables read from `values`."""
    if isinstance(expr, PK.Var):
        return values[(expr.index, expr.rotation, expr.type)] % p
    if isinstance(expr, PK.Const):
        return expr.v % p
    if isinstance(expr, PK.BinOp):
        a, b = _scalar(p, expr.l, values), _scalar(p, expr.r, values)
        return (a + b if expr.op == "+" else a - b if expr.op == "-"
                else a * b) % p
    if isinstance(expr, PK.Pow):
        return pow(_scalar(p, expr.base, values), expr.exp, p)
    raise TypeError(expr)
