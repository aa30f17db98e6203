"""Batched FRI commitment scheme.

Counterpart of `commitments/fri.py` of the JAX package: the reference's
`basic_batched_fri` protocol
(`commitments/detail/polynomial/basic_fri.hpp`): same parameters (nested
domains D, step_list, λ queries, optional grinding), same coset-ordered
Merkle leaf layout (`basic_fri.hpp:364-524`), same fold recurrence
(`fold_polynomial.hpp:68-93`), same commit/query transcript order
(`basic_fri.hpp:675-930`) and verification algebra (`:932-1155`), so that
prover/verifier transcripts stay bit-equivalent, with the bulk work on the
device:

- folds are batched DFS butterflies on device (a few elementwise launches
  per fold; the w^-i tables are cached per domain);
- Merkle leaf/level hashing is the Poseidon kernel (or host byte hashes for
  keccak/sha2 combos);
- the verifier's x_index recovery replaces the reference's O(N) linear
  domain search (`basic_fri.hpp:782-786`) with O(log² N) index math;
- all λ query positions are drawn first, then evaluations are gathered from
  device tensors in one pass (transcript-equivalent: the query loop draws
  exactly one challenge per query and nothing else).

There is one path where the JAX package has a fused and an eager one, and no
mesh branch. Every proof container holds host ints and bytes only.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from ..fields.params import FieldSpec
from ..ops import limbs as L
from ..poly.domain import Domain, calculate_domain_set
from ..poly.polynomial import PolyDFS
from ..transcript.fiat_shamir import Transcript
from .batched import eval_coeffs
from .merkle import MerkleTree, make_hasher

class PhaseClock:
    """Seconds between marks, the device drained at each mark. A smoke run
    or a profile hands one to `proof_eval` and reads `seconds`; without one
    `proof_eval` waits for the device only where it needs a value."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = {}
        self._t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        t = self._now()
        self.seconds[name] = t - self._t
        self._t = t


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FRIParams:
    fs: FieldSpec
    max_degree: int            # 2^k - 1
    D: list[Domain]            # nested domains, |D[0]| = 2^(k+expand)
    step_list: list[int]
    lambda_: int = 40
    expand_factor: int = 2
    use_grinding: bool = False
    grinding_parameter: int = 0xFFFF   # mask (uint32 PoW variant)
    merkle_hash: str = "poseidon"
    transcript_hash: str = "keccak_256"

    @property
    def r(self) -> int:
        return sum(self.step_list)

    def get_params(self) -> dict:
        """JSON-ish parameter dump (`lpc.hpp:275-298` get_params)."""
        return {
            "field": self.fs.name,
            "max_degree": self.max_degree,
            "domain_size": self.D[0].n,
            "r": self.r,
            "step_list": list(self.step_list),
            "lambda": self.lambda_,
            "expand_factor": self.expand_factor,
            "use_grinding": self.use_grinding,
            "grinding_parameter": self.grinding_parameter,
            "merkle_hash": self.merkle_hash,
            "transcript_hash": self.transcript_hash,
        }

    def transcript_repr(self) -> str:
        return (f"LPC:r={self.r},m=2,max_degree={self.max_degree},"
                f"steps={self.step_list},lambda={self.lambda_},"
                f"grinding={self.use_grinding}")

    @classmethod
    def build(cls, fs: FieldSpec, degree_log: int, expand_factor: int = 2,
              lambda_: int = 40, step_list: Optional[list[int]] = None,
              **kw) -> "FRIParams":
        if step_list is None:
            step_list = [1] * (degree_log - 1)
        r = sum(step_list)
        D = calculate_domain_set(fs, degree_log + expand_factor, r)
        return cls(fs=fs, max_degree=(1 << degree_log) - 1, D=D,
                   step_list=step_list, lambda_=lambda_,
                   expand_factor=expand_factor, **kw)

    def check(self) -> bool:
        sl = self.step_list
        return (bool(sl) and all(0 < s <= 10 for s in sl) and sl[-1] == 1
                and len(self.D) >= self.r)


# ---------------------------------------------------------------------------
# proof containers (mirror basic_fri.hpp:240-296)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InitialProof:
    values: list[list[tuple[int, int]]]   # [poly][j] -> (y_min, y_max)
    path: list                            # merkle siblings
    leaf_index: int


@dataclasses.dataclass
class RoundProof:
    y: list[tuple[int, int]]
    path: list
    leaf_index: int


@dataclasses.dataclass
class QueryProof:
    initial_proof: dict[int, InitialProof]
    round_proofs: list[RoundProof]


@dataclasses.dataclass
class FRIProof:
    fri_roots: list
    final_polynomial: list[int]           # coefficients, host ints
    query_proofs: list[QueryProof]
    proof_of_work: Optional[int] = None


# ---------------------------------------------------------------------------
# index math (basic_fri.hpp:348-664)
# ---------------------------------------------------------------------------

def get_paired_index(i: int, domain_size: int) -> int:
    return (i + domain_size // 2) % domain_size


def get_folded_index(i: int, domain_size: int, fri_step: int) -> int:
    for _ in range(fri_step):
        domain_size //= 2
        i %= domain_size
    return i


def coset_enum(x_index: int, fri_step: int, domain_size: int) -> list[tuple[int, int]]:
    """The reference's s_indices enumeration (`calculate_s`,
    `basic_fri.hpp:582-614`): pairs (i, paired(i)) in the order
    [x, x+N/4, x+N/8, x+N/8+N/4, ...]."""
    coset = 1 << fri_step
    s = [(x_index, get_paired_index(x_index, domain_size))]
    base = domain_size // 4
    prev_half = 1
    while len(s) < coset // 2:
        for j in range(prev_half):
            if len(s) >= coset // 2:
                break
            i0 = (base + s[j][0]) % domain_size
            s.append((i0, get_paired_index(i0, domain_size)))
        base //= 2
        prev_half <<= 1
    return s


def get_correct_order(x_index: int, domain_size: int, fri_step: int,
                      s_indices: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """`get_correct_order` (`basic_fri.hpp:616-664`): maps leaf-layout
    positions to (query s-position, which-of-pair)."""
    coset = 1 << fri_step
    ordered = [get_folded_index(x_index, domain_size, fri_step)]
    base = domain_size // 4
    prev_half = 1
    while len(ordered) < coset // 2:
        for j in range(prev_half):
            if len(ordered) >= coset // 2:
                break
            ordered.append((base + ordered[j]) % domain_size)
        base //= 2
        prev_half <<= 1
    lookup = {}
    for pos, (a, b) in enumerate(s_indices):
        lookup[(a, b)] = (pos, 0)
        lookup.setdefault((b, a), (pos, 1))
    out = []
    for oi in ordered:
        key = (oi, get_paired_index(oi, domain_size))
        if key not in lookup:
            raise AssertionError("order mismatch")
        out.append(lookup[key])
    return out


def domain_index_of(d: Domain, x: int) -> int:
    """Find j with w^j == x in O(log² N) (replaces the linear scan at
    `basic_fri.hpp:782-786`)."""
    p = d.fs.p
    j = 0
    cur = x % p
    for k in range(d.log_n):
        # cur = w^(j_rem) with j_rem having bits k.. of j; test parity of bit k
        e = pow(cur, d.n >> (k + 1), p)
        if e != 1:
            j |= 1 << k
            cur = cur * pow(d.omega, (d.n - (1 << k)) % d.n, p) % p
    # after stripping every bit, cur = x * w^{-j} must be exactly 1
    assert cur == 1 and pow(d.omega, j, p) == x % p, \
        "challenge point is not in the evaluation domain"
    return j


# ---------------------------------------------------------------------------
# precommit: coset-ordered leaves -> Merkle tree (basic_fri.hpp:364-524)
# ---------------------------------------------------------------------------

class Precommitment:
    """Merkle tree + resident evaluation tensor (B, NL, N) for query serving."""

    def __init__(self, tree: MerkleTree, values: torch.Tensor,
                 domain_size: int, fri_step: int):
        self.tree = tree
        self.values = values
        self.domain_size = domain_size
        self.fri_step = fri_step

    def root(self):
        return self.tree.root()


@functools.lru_cache(maxsize=None)
def _leaf_order_indices(domain_size: int, fri_step: int) -> np.ndarray:
    """(leafs, coset) int array: leaf row l holds f at these domain indices,
    in the reference's consume order [s0, pair(s0), s1, pair(s1), ...]:
    `coset_enum(l, fri_step, domain_size)` for every leaf l at once, the
    same recurrence on a numpy vector of all leaves."""
    coset = 1 << fri_step
    leafs = domain_size // coset
    firsts = [np.arange(leafs, dtype=np.int64)]     # s[j][0] for every leaf
    base = domain_size // 4
    prev_half = 1
    while len(firsts) < coset // 2:
        for j in range(prev_half):
            if len(firsts) >= coset // 2:
                break
            firsts.append((base + firsts[j]) % domain_size)
        base //= 2
        prev_half <<= 1
    out = np.empty((leafs, coset), dtype=np.int64)
    for j, first in enumerate(firsts):
        out[:, 2 * j] = first
        out[:, 2 * j + 1] = (first + domain_size // 2) % domain_size
    out.setflags(write=False)
    return out


def precommit(polys: list[PolyDFS], D: Domain, fri_step: int,
              params: FRIParams) -> Precommitment:
    fs = params.fs
    polys = [pl.resize(D.n) for pl in polys]
    values = torch.stack([pl.v for pl in polys], dim=0)  # (B, NL, N)
    idx = _leaf_order_indices(D.n, fri_step)            # (leafs, coset)
    leafs, coset = idx.shape
    # column c of every leaf, then the next column: (coset * leafs,)
    flat = torch.from_numpy(np.ascontiguousarray(idx.T).reshape(-1)) \
        .to(values.device)
    gathered = values.index_select(-1, flat)            # (B, NL, coset*leafs)
    rows = gathered.reshape(len(polys), fs.nl, coset, leafs) \
        .permute(0, 2, 1, 3).reshape(-1, fs.nl, leafs)   # (B*coset, NL, leafs)
    hasher = make_hasher(fs, params.merkle_hash)
    tree = MerkleTree(hasher, leaf_rows_dev=rows)
    return Precommitment(tree, values, D.n, fri_step)


# ---------------------------------------------------------------------------
# fold (fold_polynomial.hpp:68-93)
# ---------------------------------------------------------------------------

_OMEGA_INV_TABLES: dict = {}    # (field, device) -> (n, table of w_n^-i)


def _omega_inv_powers(fs: FieldSpec, n: int, device: str) -> torch.Tensor:
    """(NL, n/2) table w_n^-i, i < n/2, on `device`. The table of a domain
    is the even-indexed half of the table of the domain twice its size, so
    the largest domain asked for so far holds the table (built by doubling,
    on the device) and every smaller one is a strided view of it."""
    held = _OMEGA_INV_TABLES.get((fs, device))
    if held is None or held[0] < n:
        w_inv = pow(fs.root_of_unity(n), -1, fs.p)
        held = (n, L.powers(fs, w_inv, max(n // 2, 1), device))
        _OMEGA_INV_TABLES[(fs, device)] = held
    return held[1][:, ::held[0] // n]


def _fold_dfs_arr(fs, f: PolyDFS, alpha_arr, D: Domain) -> PolyDFS:
    """fold with alpha as a (NL, 1) Montgomery tensor."""
    f = f.resize(D.n)
    n = D.n
    device = f.device
    acc = L.mont_mul(fs, _omega_inv_powers(fs, n, str(device)), alpha_arr)
    one = L.ones_mont(fs, (1,), device)
    a = f.v[..., : n // 2]
    b = f.v[..., n // 2:]
    lo = L.mont_mul(fs, L.add(fs, one, acc), a)
    hi = L.mont_mul(fs, L.sub(fs, one, acc), b)
    half_inv = L.const_mont(fs, pow(2, -1, fs.p), (1,), device)
    out = L.mont_mul(fs, L.add(fs, lo, hi), half_inv)
    return PolyDFS(fs, out, max(1, (f.deg + 1) // 2))


def fold_dfs(params: FRIParams, f: PolyDFS, alpha: int, D: Domain) -> PolyDFS:
    """f_folded[i] = 2^-1 ((1 + α w^-i) f[i] + (1 - α w^-i) f[i + N/2]),
    evals over the half-size domain."""
    fs = params.fs
    return _fold_dfs_arr(fs, f, L.const_mont(fs, alpha, (1,), f.device), D)


# ---------------------------------------------------------------------------
# transcript absorption of roots
# ---------------------------------------------------------------------------

def absorb_root(transcript: Transcript, params: FRIParams, root) -> None:
    if isinstance(root, bytes):
        transcript.absorb(root)
    else:
        # field digests absorb natively on field-sponge transcripts
        transcript.absorb_field(params.fs, root)


# ---------------------------------------------------------------------------
# proof_eval (basic_fri.hpp:675-930)
# ---------------------------------------------------------------------------

def proof_eval(g: dict[int, list[PolyDFS]], combined_Q: PolyDFS,
               precommitments: dict[int, Precommitment],
               combined_Q_precommitment: Precommitment,
               params: FRIParams, transcript: Transcript,
               clock: Optional[PhaseClock] = None) -> FRIProof:
    """`clock`, where given, is marked after the commit phase and after the
    query phase."""
    fs = params.fs
    assert params.check()

    # --- commit phase ---
    f = combined_Q
    precommitment = combined_Q_precommitment
    fri_trees: list[Precommitment] = []
    fri_roots = []
    alphas: list[int] = []
    fs_list: list = []      # folded f per outer round (device values at D[t])
    t = 0
    for i, step in enumerate(params.step_list):
        fs_list.append(f)
        fri_trees.append(precommitment)
        root = precommitment.root()
        fri_roots.append(root)
        absorb_root(transcript, params, root)
        step_alphas = [transcript.challenge(fs) for _ in range(step)]
        alphas.extend(step_alphas)
        for alpha in step_alphas:
            f = fold_dfs(params, f, alpha, params.D[t])
            t += 1
        if i != len(params.step_list) - 1:
            precommitment = precommit([f], params.D[t],
                                      params.step_list[i + 1], params)
    fs_list.append(f)
    final_polynomial = f.coefficients().to_ints()
    while len(final_polynomial) > 1 and final_polynomial[-1] == 0:
        final_polynomial.pop()

    if clock is not None:
        clock.mark("fri_commit_phase")

    # --- grinding ---
    pow_value = None
    if params.use_grinding:
        from .proof_of_work import generate as pow_generate
        pow_value = pow_generate(transcript, params.grinding_parameter)

    # --- query phase ---
    # Draw all query positions first (one challenge per query, nothing else
    # touches the transcript), then serve values from device arrays.
    query_xs = []
    for _ in range(params.lambda_):
        c = transcript.challenge(fs)
        x = pow(c, (fs.p - 1) // params.D[0].n, fs.p)
        query_xs.append(domain_index_of(params.D[0], x))

    # --- batched value gathers ---------------------------------------------
    # Serving λ queries with per-scalar L.decode calls costs λ×|coset|×B
    # device→host round-trips. The query phase of `basic_fri.hpp:675-930` is
    # pure memory traffic, so gather every index all λ queries will touch in
    # ONE device gather (+ one small host pull) per value table.
    d0 = params.D[0].n
    cosets0 = [coset_enum(xi % d0, params.step_list[0], d0)
               for xi in query_xs]
    need0 = sorted({j for cs in cosets0 for pair in cs for j in pair})
    vals0: dict[int, list[dict[int, int]]] = {}
    if need0:
        for k, polys in g.items():
            pre = precommitments[k]
            idx0 = torch.tensor(need0, dtype=torch.int64,
                                device=pre.values.device)
            taken = pre.values.index_select(-1, idx0)
            got = taken.permute(1, 0, 2)              # (NL, B, K)
            flat = L.decode(fs, got)                  # row-major over (B, K)
            K = len(need0)
            vals0[k] = [dict(zip(need0, flat[pi * K:(pi + 1) * K]))
                        for pi in range(len(polys))]

    # per-round folded-table needs across all queries
    round_needs: list[set] = [set() for _ in params.step_list]
    xi_rounds: list[list[int]] = []
    for x_index0 in query_xs:
        xi, t = x_index0, 0
        per_round = []
        for i, step in enumerate(params.step_list):
            xi %= params.D[t].n
            per_round.append(xi)
            t += step
            if i < len(params.step_list) - 1:
                next_n = params.D[t].n
                for pair in coset_enum(xi % next_n,
                                       params.step_list[i + 1], next_n):
                    round_needs[i].update(pair)
        xi_rounds.append(per_round)

    round_vals: list[dict[int, int]] = []
    t = 0
    for i, step in enumerate(params.step_list):
        t += step
        if i < len(params.step_list) - 1 and round_needs[i]:
            next_n = params.D[t].n
            fnext = fs_list[i + 1].resize(next_n)
            need = sorted(round_needs[i])
            got = fnext.v.index_select(-1, torch.tensor(
                need, dtype=torch.int64, device=fnext.device))
            round_vals.append(dict(zip(need, L.decode(fs, got))))
        else:
            round_vals.append({})

    # batched Merkle paths: one gather-per-level per TREE instead of one
    # scalar decode per (query, level)
    init_leaf_idx = [get_folded_index(xi % d0, d0, params.step_list[0])
                     for xi in query_xs]
    init_paths = {k: precommitments[k].tree.proofs(init_leaf_idx)
                  for k in g}
    round_leaf_idx: list[list[int]] = []
    t = 0
    for i, step in enumerate(params.step_list):
        dsize = params.D[t].n
        round_leaf_idx.append([get_folded_index(xr[i], dsize, step)
                               for xr in xi_rounds])
        t += step
    round_paths = [fri_trees[i].tree.proofs(round_leaf_idx[i])
                   for i in range(len(params.step_list))]

    query_proofs = []
    for qi, x_index0 in enumerate(query_xs):
        s_indices = cosets0[qi]

        # initial proofs per batch
        initial_proof: dict[int, InitialProof] = {}
        for k, polys in g.items():
            vals = []
            for pi in range(len(polys)):
                tbl = vals0[k][pi]
                vals.append([(tbl[min(i0, i1)], tbl[max(i0, i1)])
                             for (i0, i1) in s_indices])
            initial_proof[k] = InitialProof(
                values=vals, path=init_paths[k][qi],
                leaf_index=init_leaf_idx[qi])

        # round proofs
        round_proofs = []
        t = 0
        for i, step in enumerate(params.step_list):
            xi = xi_rounds[qi][i]
            leaf_idx = round_leaf_idx[i][qi]
            rp_path = round_paths[i][qi]
            t += step
            if i < len(params.step_list) - 1:
                next_n = params.D[t].n
                xi_next = xi % next_n
                s_idx_next = coset_enum(xi_next, params.step_list[i + 1],
                                        next_n)
                tbl = round_vals[i]
                y = [(tbl[min(i0, i1)], tbl[max(i0, i1)])
                     for (i0, i1) in s_idx_next]
            else:
                dprev = params.D[t - 1]
                xi_l = xi % dprev.n
                xx = pow(dprev.element(xi_l), 2, fs.p)
                ind = 0 if (xi_l % (dprev.n // 2)) < dprev.n // 4 else 1
                # the final polynomial is host ints already: Horner there
                pair = [0, 0]
                pair[ind] = eval_coeffs(fs.p, final_polynomial, xx)
                pair[1 - ind] = eval_coeffs(fs.p, final_polynomial,
                                            (-xx) % fs.p)
                y = [tuple(pair)]
            round_proofs.append(RoundProof(y=y, path=rp_path,
                                           leaf_index=leaf_idx))
        query_proofs.append(QueryProof(initial_proof=initial_proof,
                                       round_proofs=round_proofs))

    if clock is not None:
        clock.mark("fri_query_phase")
    return FRIProof(fri_roots=fri_roots, final_polynomial=final_polynomial,
                    query_proofs=query_proofs, proof_of_work=pow_value)


# ---------------------------------------------------------------------------
# verify_eval (basic_fri.hpp:932-1155) — host scalar
# ---------------------------------------------------------------------------

def _line_eval(s: int, y0: int, y1: int, alpha: int, p: int) -> int:
    """Evaluate at alpha the line through (s, y0), (-s, y1)."""
    inv2s = pow(2 * s % p, -1, p)
    return ((y0 * (alpha + s) - y1 * (alpha - s)) % p) * inv2s % p


def verify_eval(proof: FRIProof, params: FRIParams,
                commitments: dict[int, object], theta: int,
                poly_ids: list[list[tuple[int, int]]],
                combined_U: list[int],
                denominators: list[list[int]],   # coeff lists of V_p
                transcript: Transcript) -> bool:
    fs = params.fs
    p = fs.p
    assert params.check()
    assert len(combined_U) == len(denominators) == len(poly_ids)

    # degree check
    import math as _m
    max_deg_bound = 2 ** (int(_m.log2(params.max_degree + 1)) - params.r + 1) - 1
    if len(proof.final_polynomial) - 1 > max_deg_bound:
        return False

    alphas = []
    for i in range(len(params.step_list)):
        absorb_root(transcript, params, proof.fri_roots[i])
        for _ in range(params.step_list[i]):
            alphas.append(transcript.challenge(fs))

    if params.use_grinding:
        from .proof_of_work import verify as pow_verify
        if not pow_verify(transcript, proof.proof_of_work,
                          params.grinding_parameter):
            return False

    hasher = make_hasher(fs, params.merkle_hash)
    fp = proof.final_polynomial

    def eval_poly(coeffs: list[int], x: int) -> int:
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % p
        return acc

    for query_proof in proof.query_proofs:
        domain_size = params.D[0].n
        coset_size = 1 << params.step_list[0]
        c = transcript.challenge(fs)
        x = pow(c, (p - 1) // domain_size, p)
        x_index = domain_index_of(params.D[0], x)

        s_indices = coset_enum(x_index, params.step_list[0], domain_size)
        s_vals = [(params.D[0].element(a), params.D[0].element(b))
                  for a, b in s_indices]
        order = get_correct_order(x_index, domain_size, params.step_list[0],
                                  s_indices)

        # --- initial merkle checks ---
        for k, ip in query_proof.initial_proof.items():
            if commitments[k] != _path_root(hasher, ip, order):
                return False

        # --- combined-Q reconstruction ---
        theta_acc = 1
        y = [[0, 0] for _ in range(coset_size // 2)]
        for pi in range(len(poly_ids)):
            Q = [[0, 0] for _ in range(coset_size // 2)]
            for (bk, bj) in poly_ids[pi]:
                vals = query_proof.initial_proof[bk].values[bj]
                for j in range(coset_size // 2):
                    Q[j][0] = (Q[j][0] + vals[j][0] * theta_acc) % p
                    Q[j][1] = (Q[j][1] + vals[j][1] * theta_acc) % p
                theta_acc = theta_acc * theta % p
            for j in range(coset_size // 2):
                id0 = 0 if s_indices[j][0] < s_indices[j][1] else 1
                id1 = 1 - id0
                den0 = eval_poly(denominators[pi], s_vals[j][id0])
                den1 = eval_poly(denominators[pi], s_vals[j][id1])
                Q[j][0] = (Q[j][0] - combined_U[pi]) * pow(den0, -1, p) % p
                Q[j][1] = (Q[j][1] - combined_U[pi]) * pow(den1, -1, p) % p
                y[j][0] = (y[j][0] + Q[j][0]) % p
                y[j][1] = (y[j][1] + Q[j][1]) % p

        # --- round checks ---
        t = 0
        for i, step in enumerate(params.step_list):
            coset_size = 1 << step
            dsize = params.D[t].n
            x_index %= dsize
            x = params.D[t].element(x_index)
            s_indices = coset_enum(x_index, step, dsize)
            order = get_correct_order(x_index, dsize, step, s_indices)
            # merkle check on y-leaf
            leaf_row = []
            for (pos, _pair) in order:
                leaf_row.extend([y[pos][0], y[pos][1]])
            rp = query_proof.round_proofs[i]
            d = hasher.leaf_hash_rows_host(leaf_row)
            root = _fold_path(hasher, d, rp.leaf_index, rp.path)
            if root != proof.fri_roots[i]:
                return False

            # colinearity folds within this round
            for step_i in range(step - 1):
                dsize = params.D[t].n
                x_index %= dsize
                x = params.D[t].element(x_index)
                s_indices = coset_enum(x_index, step, dsize)
                s_next = coset_enum((x_index % params.D[t + 1].n),
                                    step, params.D[t + 1].n)
                y_next = [[0, 0] for _ in range(len(y) // 2)]
                for yi in range(len(y_next)):
                    i0 = 0 if s_indices[2 * yi][0] < s_indices[2 * yi][1] else 1
                    s_ch = params.D[t].element(s_indices[2 * yi][i0])
                    left = _line_eval(s_ch, y[2 * yi][0], y[2 * yi][1],
                                      alphas[t], p)
                    i0 = 0 if s_indices[2 * yi + 1][0] < s_indices[2 * yi + 1][1] else 1
                    s_ch = params.D[t].element(s_indices[2 * yi + 1][i0])
                    right = _line_eval(s_ch, y[2 * yi + 1][0],
                                       y[2 * yi + 1][1], alphas[t], p)
                    if s_next[yi][0] < s_next[yi][1]:
                        y_next[yi] = [left, right]
                    else:
                        y_next[yi] = [right, left]
                y = y_next
                t += 1
            # final colinear check of this round
            dsize = params.D[t].n
            x_index %= dsize
            x = params.D[t].element(x_index)
            s_indices = coset_enum(x_index, step, dsize)
            i0 = 0 if s_indices[0][0] < s_indices[0][1] else 1
            s_ch = params.D[t].element(s_indices[0][i0])
            interp = _line_eval(s_ch, y[0][0], y[0][1], alphas[t], p)
            ind = 0 if (s_indices[0][i0] % (dsize // 2)) < dsize // 4 else 1
            if interp != rp.y[0][ind] % p:
                return False
            y = [list(v) for v in rp.y]
            t += 1
            if i < len(params.step_list) - 1:
                x_index %= params.D[t].n
        t -= 1  # reference leaves t at last used index

        # --- final polynomial check ---
        x_index %= params.D[t].n
        x = params.D[t].element(x_index)
        xx = x * x % p
        ind = 0 if (x_index % (params.D[t].n // 2)) < params.D[t].n // 4 else 1
        if y[0][ind] % p != eval_poly(fp, xx):
            return False
        if y[0][1 - ind] % p != eval_poly(fp, (-xx) % p):
            return False
    return True


def proof_eval_single(f: PolyDFS, pre: Precommitment, params: FRIParams,
                      transcript: Transcript) -> FRIProof:
    """Single-poly convenience wrapper (`commitments/polynomial/fri.hpp:99-121`)."""
    return proof_eval({0: [f]}, f, {0: pre}, pre, params, transcript)


def verify_eval_single(proof: FRIProof, root, params: FRIParams,
                       transcript: Transcript) -> bool:
    """Single-poly verify (`fri.hpp:124-152`): theta=1, U=0, V=1."""
    return verify_eval(proof, params, {0: root}, theta=1,
                       poly_ids=[[(0, 0)]], combined_U=[0],
                       denominators=[[1]], transcript=transcript)


def _path_root(hasher, ip: InitialProof, order) -> object:
    leaf_row = []
    for pv in ip.values:
        for (pos, _pair) in order:
            leaf_row.extend([pv[pos][0], pv[pos][1]])
    d = hasher.leaf_hash_rows_host(leaf_row)
    return _fold_path(hasher, d, ip.leaf_index, ip.path)


def _fold_path(hasher, digest, idx: int, path: list):
    for sib in path:
        digest = hasher.node_hash_host(digest, sib) if idx % 2 == 0 \
            else hasher.node_hash_host(sib, digest)
        idx //= 2
    return digest
