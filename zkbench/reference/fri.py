"""The LPC evaluation proof's check: the batched opening against the
commitments, then FRI over the combined quotient, for the reference.

A plain-integer copy of the checks of crypto3-zk's `lpc.hpp::verify_eval`
and `basic_fri.hpp::verify_eval` (932-1155), as the port's verifier makes
them, with one check more: the proof must answer exactly `lambda` queries,
the number the configuration states. Merkle trees hash with Poseidon; the
leaf of a query holds, poly by poly, the coset's pairs in the reference's
order (`coset_enum`, `get_correct_order`).
"""
from __future__ import annotations

from .domain import Domain, domain_index_of


class FRIParams:
    """The nested FRI domains D_0 .. D_r of a degree bound 2^k with the
    configured expand factor and steps."""

    def __init__(self, field, degree_log: int, expand_factor: int,
                 lambda_: int, step_list: list[int] | None = None):
        self.p = field.p
        self.step_list = step_list or [1] * (degree_log - 1)
        self.r = sum(self.step_list)
        self.max_degree = (1 << degree_log) - 1
        self.lambda_ = lambda_
        top = degree_log + expand_factor
        self.D = [Domain(field, 1 << (top - i)) for i in range(self.r)]

    def transcript_repr(self) -> str:
        return (f"LPC:r={self.r},m=2,max_degree={self.max_degree},"
                f"steps={self.step_list},lambda={self.lambda_},"
                f"grinding=False")


def paired_index(i: int, n: int) -> int:
    return (i + n // 2) % n


def folded_index(i: int, n: int, step: int) -> int:
    for _ in range(step):
        n //= 2
        i %= n
    return i


def coset_enum(x_index: int, step: int, n: int) -> list[tuple[int, int]]:
    coset = 1 << step
    s = [(x_index, paired_index(x_index, n))]
    base, prev_half = n // 4, 1
    while len(s) < coset // 2:
        for j in range(prev_half):
            if len(s) >= coset // 2:
                break
            i0 = (base + s[j][0]) % n
            s.append((i0, paired_index(i0, n)))
        base //= 2
        prev_half <<= 1
    return s


def correct_order(x_index: int, n: int, step: int, s_indices) -> list:
    coset = 1 << step
    ordered = [folded_index(x_index, n, step)]
    base, prev_half = n // 4, 1
    while len(ordered) < coset // 2:
        for j in range(prev_half):
            if len(ordered) >= coset // 2:
                break
            ordered.append((base + ordered[j]) % n)
        base //= 2
        prev_half <<= 1
    lookup = {}
    for pos, (a, b) in enumerate(s_indices):
        lookup[(a, b)] = (pos, 0)
        lookup.setdefault((b, a), (pos, 1))
    return [lookup[(oi, paired_index(oi, n))] for oi in ordered]


def _line(s: int, y0: int, y1: int, alpha: int, p: int) -> int:
    """At alpha, the line through (s, y0) and (-s, y1)."""
    return ((y0 * (alpha + s) - y1 * (alpha - s)) % p) \
        * pow(2 * s % p, -1, p) % p


def _eval(coeffs: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def _fold_path(hasher, digest, idx: int, path: list):
    for sib in path:
        digest = hasher.node(digest, sib) if idx % 2 == 0 \
            else hasher.node(sib, digest)
        idx //= 2
    return digest


def _path_root(hasher, values, leaf_index, path, order):
    row = []
    for pv in values:
        for pos, _ in order:
            row.extend([pv[pos][0], pv[pos][1]])
    return _fold_path(hasher, hasher.leaf(row), leaf_index, path)


def verify_fri(proof: dict, params: FRIParams, hasher, commitments: dict,
               theta: int, poly_ids: list, combined_u: list,
               denominators: list, transcript) -> bool:
    p = params.p
    bound = 2 ** (params.max_degree.bit_length() - params.r + 1) - 1
    if len(proof["final_polynomial"]) - 1 > bound:
        return False
    if len(proof["queries"]) != params.lambda_:
        return False
    if len(proof["fri_roots"]) != len(params.step_list):
        return False
    alphas = []
    for i, step in enumerate(params.step_list):
        transcript.absorb_field(proof["fri_roots"][i])
        alphas.extend(transcript.challenge() for _ in range(step))
    if proof["proof_of_work"] is not None:
        return False
    fp = proof["final_polynomial"]

    for initial, rounds in proof["queries"]:
        n0 = params.D[0].n
        coset = 1 << params.step_list[0]
        c = transcript.challenge()
        x_index = domain_index_of(params.D[0], pow(c, (p - 1) // n0, p))
        s_indices = coset_enum(x_index, params.step_list[0], n0)
        s_vals = [(params.D[0].element(a), params.D[0].element(b))
                  for a, b in s_indices]
        order = correct_order(x_index, n0, params.step_list[0], s_indices)
        if set(initial) != set(commitments):
            return False
        for k, (values, leaf_index, path) in initial.items():
            if commitments[k] != _path_root(hasher, values, leaf_index, path,
                                            order):
                return False

        theta_acc = 1
        y = [[0, 0] for _ in range(coset // 2)]
        for pi in range(len(poly_ids)):
            Q = [[0, 0] for _ in range(coset // 2)]
            for bk, bj in poly_ids[pi]:
                vals = initial[bk][0][bj]
                for j in range(coset // 2):
                    Q[j][0] = (Q[j][0] + vals[j][0] * theta_acc) % p
                    Q[j][1] = (Q[j][1] + vals[j][1] * theta_acc) % p
                theta_acc = theta_acc * theta % p
            for j in range(coset // 2):
                id0 = 0 if s_indices[j][0] < s_indices[j][1] else 1
                den0 = _eval(denominators[pi], s_vals[j][id0], p)
                den1 = _eval(denominators[pi], s_vals[j][1 - id0], p)
                Q[j][0] = (Q[j][0] - combined_u[pi]) * pow(den0, -1, p) % p
                Q[j][1] = (Q[j][1] - combined_u[pi]) * pow(den1, -1, p) % p
                y[j][0] = (y[j][0] + Q[j][0]) % p
                y[j][1] = (y[j][1] + Q[j][1]) % p

        if len(rounds) != len(params.step_list):
            return False
        t = 0
        for i, step in enumerate(params.step_list):
            dsize = params.D[t].n
            x_index %= dsize
            s_indices = coset_enum(x_index, step, dsize)
            order = correct_order(x_index, dsize, step, s_indices)
            row = []
            for pos, _ in order:
                row.extend([y[pos][0], y[pos][1]])
            ry, leaf_index, path = rounds[i]
            if _fold_path(hasher, hasher.leaf(row), leaf_index, path) \
                    != proof["fri_roots"][i]:
                return False
            for _ in range(step - 1):
                dsize = params.D[t].n
                x_index %= dsize
                s_indices = coset_enum(x_index, step, dsize)
                s_next = coset_enum(x_index % params.D[t + 1].n, step,
                                    params.D[t + 1].n)
                y_next = [[0, 0] for _ in range(len(y) // 2)]
                for yi in range(len(y_next)):
                    i0 = 0 if s_indices[2 * yi][0] < s_indices[2 * yi][1] else 1
                    s_ch = params.D[t].element(s_indices[2 * yi][i0])
                    left = _line(s_ch, y[2 * yi][0], y[2 * yi][1], alphas[t], p)
                    i0 = 0 if s_indices[2 * yi + 1][0] \
                        < s_indices[2 * yi + 1][1] else 1
                    s_ch = params.D[t].element(s_indices[2 * yi + 1][i0])
                    right = _line(s_ch, y[2 * yi + 1][0], y[2 * yi + 1][1],
                                  alphas[t], p)
                    y_next[yi] = [left, right] if s_next[yi][0] < s_next[yi][1] \
                        else [right, left]
                y = y_next
                t += 1
            dsize = params.D[t].n
            x_index %= dsize
            s_indices = coset_enum(x_index, step, dsize)
            i0 = 0 if s_indices[0][0] < s_indices[0][1] else 1
            s_ch = params.D[t].element(s_indices[0][i0])
            interp = _line(s_ch, y[0][0], y[0][1], alphas[t], p)
            ind = 0 if (s_indices[0][i0] % (dsize // 2)) < dsize // 4 else 1
            if interp != ry[0][ind] % p:
                return False
            y = [list(v) for v in ry]
            t += 1
            if i < len(params.step_list) - 1:
                x_index %= params.D[t].n
        t -= 1
        x_index %= params.D[t].n
        x = params.D[t].element(x_index)
        xx = x * x % p
        ind = 0 if (x_index % (params.D[t].n // 2)) < params.D[t].n // 4 else 1
        if y[0][ind] % p != _eval(fp, xx, p):
            return False
        if y[0][1 - ind] % p != _eval(fp, (-xx) % p, p):
            return False
    return True


def verify_lpc(proof: dict, params: FRIParams, hasher, commitments: dict,
               points: dict, fixed_batches: dict, eta: int,
               transcript) -> bool:
    """`lpc.hpp::verify_eval`: `points[batch][poly]` lists the points each
    polynomial is opened at, `proof["z"]` the values there;
    `fixed_batches[batch]` the fixed polynomials' values at `eta`."""
    p = params.p
    z = proof["z"]
    for k in sorted(commitments):
        transcript.absorb_field(commitments[k])
    unique = []
    for k in sorted(points):
        for pts in points[k]:
            for pt in pts:
                if pt not in unique:
                    unique.append(pt)
    for k in points:
        if k not in z or len(z[k]) != len(points[k]) or any(
                len(z[k][j]) != len(points[k][j]) for j in range(len(z[k]))):
            return False
    total = len(unique) + (1 if fixed_batches else 0)
    U, V = [0] * total, [None] * total
    poly_map = [[] for _ in range(total)]
    theta = transcript.challenge()
    theta_acc = 1
    for pi, point in enumerate(unique):
        V[pi] = [(-point) % p, 1]
        for k in sorted(z):
            for j in range(len(z[k])):
                if point in points[k][j]:
                    idx = points[k][j].index(point)
                    U[pi] = (U[pi] + z[k][j][idx] * theta_acc) % p
                    poly_map[pi].append((k, j))
                    theta_acc = theta_acc * theta % p
    if fixed_batches:
        pi = len(unique)
        V[pi] = [(-eta) % p, 1]
        for k in sorted(z):
            if k not in fixed_batches:
                continue
            for j in range(len(z[k])):
                U[pi] = (U[pi] + fixed_batches[k][j] * theta_acc) % p
                poly_map[pi].append((k, j))
                theta_acc = theta_acc * theta % p
    return verify_fri(proof, params, hasher, commitments, theta, poly_map,
                      U, V, transcript)
