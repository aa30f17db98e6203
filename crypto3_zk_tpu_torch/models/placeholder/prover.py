"""Placeholder prover.

Counterpart of `models/placeholder/prover.py` of the JAX package:
`placeholder_prover::process` (`placeholder/prover.hpp:133-217`) with the
same commitment/transcript order:

  absorb(vk) -> scheme.setup -> commit(VARIABLE_VALUES) -> permutation
  argument -> lookup argument -> commit(PERMUTATION) -> gates argument ->
  8 alpha challenges -> quotient T (coset division) -> split ->
  commit(QUOTIENT) -> challenge y -> evaluation points -> scheme.proof_eval.

The prover runs where the preprocessed polynomials live.
"""
from __future__ import annotations

import torch

from ...arithmetization import plonk as PK
from ...commitments.fri import PhaseClock
from ...ops import limbs as L
from ...ops import ntt as N
from ...poly.domain import get_domain
from ...poly.polynomial import PolyDFS, polynomial_sum
from ...transcript.poseidon_transcript import make_transcript
from ...utils.profiling import span, spanned
from . import common as C
from .arguments import (PolynomialTable, gates_prove_eval,
                        permutation_prove_eval)
from .lookup_argument import lookup_prove_eval
from .preprocessor import (PrivatePreprocessedData, PublicPreprocessedData,
                           _absorb_commitment)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def generate_evaluation_points(scheme, common, constraint_system: PK.ConstraintSystem,
                               desc: PK.TableDescription, challenge: int,
                               is_lookup_enabled: bool, fs) -> None:
    """Shared by prover (`prover.hpp:346-417`) and verifier
    (`verifier.hpp:62-140`): identical point sets keep theta-ordering
    bit-equal."""
    p = fs.p
    omega = common.basic_domain.omega
    w_cols = desc.witness_columns
    p_cols = desc.public_input_columns
    c_cols = desc.constant_columns
    s_cols = desc.selector_columns

    for i in range(w_cols + p_cols):
        for rotation in common.columns_rotations[i]:
            scheme.append_eval_point(
                C.VARIABLE_VALUES_BATCH,
                challenge * pow(omega, rotation % (p - 1), p) % p,
                poly_id=i)

    has_copy = len(constraint_system.copy_constraints) > 0
    if is_lookup_enabled or has_copy:
        scheme.append_eval_point(C.PERMUTATION_BATCH, challenge)
    if has_copy:
        scheme.append_eval_point(C.PERMUTATION_BATCH, challenge * omega % p,
                                 poly_id=0)
    if is_lookup_enabled:
        scheme.append_eval_point(C.PERMUTATION_BATCH,
                                 challenge * omega % p,
                                 poly_id=common.permutation_parts)
        scheme.append_eval_point(C.LOOKUP_BATCH, challenge)
        scheme.append_eval_point(C.LOOKUP_BATCH, challenge * omega % p)
        scheme.append_eval_point(
            C.LOOKUP_BATCH,
            challenge * pow(omega, desc.usable_rows_amount, p) % p)

    scheme.append_eval_point(C.QUOTIENT_BATCH, challenge)

    # fixed values: id/sigma/q_last/q_blind then constants+selectors
    start_index = len(common.permuted_columns) * 2 + 2
    for i in range(start_index):
        scheme.append_eval_point(C.FIXED_VALUES_BATCH, challenge, poly_id=i)
    scheme.append_eval_point(C.FIXED_VALUES_BATCH, challenge * omega % p,
                             poly_id=start_index - 2)
    scheme.append_eval_point(C.FIXED_VALUES_BATCH, challenge * omega % p,
                             poly_id=start_index - 1)
    for ind in range(c_cols + s_cols):
        for rotation in common.columns_rotations[w_cols + p_cols + ind]:
            scheme.append_eval_point(
                C.FIXED_VALUES_BATCH,
                challenge * pow(omega, rotation % (p - 1), p) % p,
                poly_id=start_index + ind)


@spanned("zk.placeholder.quotient")
def quotient_chunks(fs, F_dfs: list[PolyDFS], alphas: list[int], n: int,
                    n_chunks_real: int, split_size: int) -> list[PolyDFS]:
    """`prover.hpp:219-266`: the alpha-weighted sum of F, its coefficients,
    T = F / (x^n - 1) by `ntt.divide_by_vanishing`, split into `split_size`
    chunks of n coefficients (zero past the real ones), each transformed
    back onto the basic domain."""
    dev = F_dfs[0].device
    F_cons = polynomial_sum([F_dfs[i].scale(alphas[i])
                             for i in range(len(F_dfs))])
    f_coeffs = F_cons.coefficients()
    m = _next_pow2(max(f_coeffs.n + 1, 2 * n))
    padded = torch.nn.functional.pad(f_coeffs.c, (0, m - f_coeffs.n))
    T_coeffs = N.divide_by_vanishing(fs, padded, n)
    basic = get_domain(fs, n)
    chunks = []
    for k in range(split_size):
        if k < n_chunks_real and (k + 1) * n <= T_coeffs.shape[-1]:
            chunk = T_coeffs[..., k * n:(k + 1) * n]
        elif k < n_chunks_real:
            chunk = torch.nn.functional.pad(
                T_coeffs[..., k * n:], (0, (k + 1) * n - T_coeffs.shape[-1]))
        else:
            chunk = L.zeros(fs, (n,), dev)
        chunks.append(PolyDFS(fs, basic.fft(chunk), n))
    return chunks


@spanned("zk.placeholder.prove")
def prove(params: C.PlaceholderParams,
          preprocessed_public: PublicPreprocessedData,
          preprocessed_private: PrivatePreprocessedData,
          desc: PK.TableDescription,
          constraint_system: PK.ConstraintSystem,
          commitment_scheme,
          clock: PhaseClock | None = None,
          transcript=None, device=None) -> C.PlaceholderProof:
    """A proof, made on `device` (default: the card), where the
    preprocessed polynomials must lie. `commitment_scheme` (LPC or KZG)
    holds the committed FIXED_VALUES batch and nothing else (the `fork()` of
    the one `process_public` filled). `clock`,
    where given, is marked after each phase (`variable_commit`,
    `permutation_argument`, the lookup argument's steps and
    `lookup_argument`, `permutation_commit`, `gates_argument`, `quotient`,
    `quotient_commit`, then the scheme's `proof_eval`'s); without one nothing
    waits for the device but what needs a value. The steps are spans
    under `zk.placeholder.prove` (PERF.md, section 3). `transcript`, where
    given, is the fresh transcript to prove with (the caller then draws the
    next challenge from it); by default one of `params.transcript_hash`."""
    def mark(name):
        if clock is not None:
            clock.mark(name)

    fs = params.fs
    common = preprocessed_public.common_data
    n = common.basic_domain.n
    is_lookup_enabled = len(constraint_system.lookup_gates) > 0
    has_copy = len(constraint_system.copy_constraints) > 0

    if transcript is None:
        transcript = make_transcript(params.transcript_hash, fs, b"")
    transcript.absorb(common.vk.constraint_system_with_params_hash)
    _absorb_commitment(transcript, fs, common.vk.fixed_values_commitment)
    commitment_scheme.setup(transcript, common.commitment_scheme_data)

    table = PolynomialTable(preprocessed_private.witnesses,
                            preprocessed_public.public_inputs,
                            preprocessed_public.constants,
                            preprocessed_public.selectors)
    dev = table.device
    if dev.type != L.resolve_device(device).type:
        raise ValueError(f"the preprocessed polynomials lie on {dev}, "
                         f"not on the device asked for")

    proof = C.PlaceholderProof(commitments={})

    # 2. commit witness + public input columns
    with span("zk.placeholder.variable_commit"):
        commitment_scheme.append_to_batch(C.VARIABLE_VALUES_BATCH,
                                          table.witnesses)
        commitment_scheme.append_to_batch(C.VARIABLE_VALUES_BATCH,
                                          table.public_inputs)
        proof.commitments[C.VARIABLE_VALUES_BATCH] = \
            commitment_scheme.commit(C.VARIABLE_VALUES_BATCH)
        _absorb_commitment(transcript, fs,
                           proof.commitments[C.VARIABLE_VALUES_BATCH])
    mark("variable_commit")

    F_dfs: list[PolyDFS] = [PolyDFS.constant(fs, 0, n, dev)
                            for _ in range(C.F_PARTS)]

    # 4. permutation argument
    if has_copy:
        perm = permutation_prove_eval(params, constraint_system,
                                      preprocessed_public, desc, table,
                                      commitment_scheme, transcript)
        F_dfs[0], F_dfs[1], F_dfs[2] = perm.F_dfs
        mark("permutation_argument")

    # 5. lookup argument
    if is_lookup_enabled:
        lookup_res = lookup_prove_eval(params, constraint_system,
                                       preprocessed_public, desc, table,
                                       commitment_scheme, transcript, clock)
        F_dfs[3], F_dfs[4], F_dfs[5], F_dfs[6] = lookup_res.F_dfs
        proof.commitments[C.LOOKUP_BATCH] = lookup_res.lookup_commitment
        mark("lookup_argument")

    if has_copy or is_lookup_enabled:
        with span("zk.placeholder.permutation_commit"):
            proof.commitments[C.PERMUTATION_BATCH] = \
                commitment_scheme.commit(C.PERMUTATION_BATCH)
            _absorb_commitment(transcript, fs,
                               proof.commitments[C.PERMUTATION_BATCH])
        mark("permutation_commit")

    # 6. gates argument
    one_poly = PolyDFS.constant(fs, 1, n, dev)
    mask_polynomial = (one_poly - preprocessed_public.q_last
                       - preprocessed_public.q_blind)
    F_dfs[7] = gates_prove_eval(params, constraint_system, table,
                                common.basic_domain, common.max_gates_degree,
                                mask_polynomial, transcript)
    mark("gates_argument")

    # 7. quotient polynomial
    alphas = transcript.challenges(fs, C.F_PARTS)
    # static chunk geometry (`detail::split_polynomial`)
    f_deg = max(pl.deg for pl in F_dfs)
    t_deg_bound = max(f_deg - n, 1)
    n_chunks_real = -(-t_deg_bound // n)
    split_size = max(
        (len(preprocessed_public.identity_polynomials) + 2) * (n - 1),
        (constraint_system.lookup_poly_degree_bound() + 1) * (n - 1),
        (common.max_gates_degree + 1) * (n - 1))
    split_size = -(-split_size // n)
    if common.max_quotient_chunks != 0 \
            and split_size > common.max_quotient_chunks:
        split_size = common.max_quotient_chunks
    T_chunks = quotient_chunks(fs, F_dfs, alphas, n, n_chunks_real,
                               split_size)
    mark("quotient")

    with span("zk.placeholder.quotient_commit"):
        commitment_scheme.append_to_batch(C.QUOTIENT_BATCH, T_chunks)
        proof.commitments[C.QUOTIENT_BATCH] = \
            commitment_scheme.commit(C.QUOTIENT_BATCH)
        _absorb_commitment(transcript, fs,
                           proof.commitments[C.QUOTIENT_BATCH])
    mark("quotient_commit")

    # 8. evaluation proof
    challenge = transcript.challenge(fs)
    generate_evaluation_points(commitment_scheme, common, constraint_system,
                               desc, challenge, is_lookup_enabled, fs)
    eval_proof = commitment_scheme.proof_eval(transcript, clock)
    proof.eval_proof = C.EvalProof(challenge=challenge, eval_proof=eval_proof)
    return proof
