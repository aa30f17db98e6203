"""Placeholder verifier (`placeholder/verifier.hpp:142-400`) — host scalars.
Counterpart of `models/placeholder/verifier.py` of the JAX package.

Rebuilds the transcript, checks public-input consistency via the Lagrange
sum formula, re-derives F[0..7] from opened values, delegates the batched
opening check to the commitment scheme, and checks
F_consolidated(y) == Z(y) * T_consolidated(y).
"""
from __future__ import annotations

from ...arithmetization import plonk as PK
from ...transcript.poseidon_transcript import make_transcript
from . import common as C
from .arguments import gates_verify_eval, permutation_verify_eval
from .lookup_argument import lookup_verify_eval
from .preprocessor import CommonData, _absorb_commitment
from .prover import generate_evaluation_points


def verify(params: C.PlaceholderParams,
           common: CommonData,
           proof: C.PlaceholderProof,
           desc: PK.TableDescription,
           constraint_system: PK.ConstraintSystem,
           commitment_scheme,
           public_input: list[list[int]] | None = None,
           transcript=None) -> bool:
    """Whether `proof` holds for the circuit, `common` and `public_input`.
    `commitment_scheme` is a fresh verifier-side scheme. `transcript`,
    where given, is the fresh transcript to verify with (the caller then
    draws the next challenge from it); by default one of
    `params.transcript_hash`."""
    fs = params.fs
    p = fs.p
    z = proof.eval_proof.eval_proof.z

    # public-input consistency (`verifier.hpp:150-176`)
    if public_input is not None:
        omega = common.basic_domain.omega
        challenge = proof.eval_proof.challenge
        numerator = (pow(challenge, desc.rows_amount, p) - 1) % p
        numerator = numerator * pow(desc.rows_amount, -1, p) % p
        if constraint_system.public_input_sizes and \
                len(constraint_system.public_input_sizes) != desc.public_input_columns:
            return False
        for i in range(len(public_input)):
            value = 0
            max_size = len(public_input[i])
            if constraint_system.public_input_sizes:
                max_size = min(max_size,
                               constraint_system.public_input_sizes[i])
            omega_pow = 1
            for j in range(max_size):
                value = (value + public_input[i][j] * omega_pow
                         * pow((challenge - omega_pow) % p, -1, p)) % p
                omega_pow = omega_pow * omega % p
            value = value * numerator % p
            if value != z.get(C.VARIABLE_VALUES_BATCH,
                              desc.witness_columns + i, 0):
                return False

    w_cols, p_cols = desc.witness_columns, desc.public_input_columns
    c_cols, s_cols = desc.constant_columns, desc.selector_columns

    if transcript is None:
        transcript = make_transcript(params.transcript_hash, fs, b"")
    transcript.absorb(common.vk.constraint_system_with_params_hash)
    _absorb_commitment(transcript, fs, common.vk.fixed_values_commitment)
    commitment_scheme.setup(transcript, common.commitment_scheme_data)

    _absorb_commitment(transcript, fs,
                       proof.commitments[C.VARIABLE_VALUES_BATCH])

    challenge_y = proof.eval_proof.challenge
    perm_size = len(common.permuted_columns)
    special_selector_values = [
        common.lagrange_0_at(challenge_y),
        z.get(C.FIXED_VALUES_BATCH, 2 * perm_size, 0),
        z.get(C.FIXED_VALUES_BATCH, 2 * perm_size + 1, 0),
    ]

    F = [0] * C.F_PARTS
    has_copy = len(constraint_system.copy_constraints) > 0
    is_lookup_enabled = len(constraint_system.lookup_gates) > 0

    if has_copy:
        S_id = [z.get(C.FIXED_VALUES_BATCH, i, 0) for i in range(perm_size)]
        S_sigma = [z.get(C.FIXED_VALUES_BATCH, perm_size + i, 0)
                   for i in range(perm_size)]
        f_vals = []
        for perm_i in range(perm_size):
            i = common.permuted_columns[perm_i]
            zero_index = common.columns_rotations[i].index(0)
            if i < w_cols + p_cols:
                f_vals.append(z.get(C.VARIABLE_VALUES_BATCH, i, zero_index))
            else:
                idx = i - w_cols - p_cols + perm_size * 2 + 2
                f_vals.append(z.get(C.FIXED_VALUES_BATCH, idx, zero_index))
        perm_partitions = [z.get(C.PERMUTATION_BATCH, i, 0)
                           for i in range(1, common.permutation_parts)]
        perm_F = permutation_verify_eval(
            fs, common, S_id, S_sigma, special_selector_values,
            challenge_y, f_vals,
            z.get(C.PERMUTATION_BATCH, 0, 0),
            z.get(C.PERMUTATION_BATCH, 0, 1),
            perm_partitions, transcript)
        F[0], F[1], F[2] = perm_F

    # evaluation map for gate/lookup checks
    columns_at_y: dict = {}
    for i in range(w_cols):
        for j, rotation in enumerate(common.columns_rotations[i]):
            columns_at_y[(i, rotation, PK.WITNESS)] = \
                z.get(C.VARIABLE_VALUES_BATCH, i, j)
    for i in range(p_cols):
        for j, rotation in enumerate(common.columns_rotations[w_cols + i]):
            columns_at_y[(i, rotation, PK.PUBLIC_INPUT)] = \
                z.get(C.VARIABLE_VALUES_BATCH, w_cols + i, j)
    for i in range(c_cols):
        for j, rotation in enumerate(
                common.columns_rotations[w_cols + p_cols + i]):
            columns_at_y[(i, rotation, PK.CONSTANT)] = \
                z.get(C.FIXED_VALUES_BATCH, i + perm_size * 2 + 2, j)
    for i in range(s_cols):
        for j, rotation in enumerate(
                common.columns_rotations[w_cols + p_cols + c_cols + i]):
            columns_at_y[(i, rotation, PK.SELECTOR)] = \
                z.get(C.FIXED_VALUES_BATCH, i + perm_size * 2 + 2 + c_cols, j)

    if is_lookup_enabled:
        special_selector_values_shifted = [
            z.get(C.FIXED_VALUES_BATCH, 2 * perm_size, 1),
            z.get(C.FIXED_VALUES_BATCH, 2 * perm_size + 1, 1),
        ]
        lookup_parts_values = [
            z.get(C.PERMUTATION_BATCH, i, 0)
            for i in range(common.permutation_parts + 1,
                           common.permutation_parts + common.lookup_parts)]
        lookup_F = lookup_verify_eval(
            params, common, special_selector_values,
            special_selector_values_shifted, constraint_system,
            challenge_y, columns_at_y,
            [z.z[C.LOOKUP_BATCH][i] for i in range(len(z.z[C.LOOKUP_BATCH]))],
            [z.get(C.PERMUTATION_BATCH, common.permutation_parts, j)
             for j in range(2)],
            lookup_parts_values,
            proof.commitments[C.LOOKUP_BATCH], transcript)
        F[3], F[4], F[5], F[6] = lookup_F

    if has_copy or is_lookup_enabled:
        _absorb_commitment(transcript, fs,
                           proof.commitments[C.PERMUTATION_BATCH])

    # gates argument
    mask_value = (1 - special_selector_values[1]
                  - special_selector_values[2]) % p
    F[7] = gates_verify_eval(fs, constraint_system.gates, columns_at_y,
                             challenge_y, mask_value, transcript)

    alphas = transcript.challenges(fs, C.F_PARTS)
    _absorb_commitment(transcript, fs, proof.commitments[C.QUOTIENT_BATCH])

    challenge = transcript.challenge(fs)
    if challenge != proof.eval_proof.challenge:
        return False

    # commitment scheme batch registration + eval points. The reference
    # verifier receives a COPY of the preprocessing-time scheme which already
    # carries the FIXED_VALUES batch registration + fixed mark
    # (`preprocessor.hpp:487-489`); register it explicitly here.
    commitment_scheme.set_batch_size(
        C.FIXED_VALUES_BATCH, len(z.z[C.FIXED_VALUES_BATCH]))
    commitment_scheme.mark_batch_as_fixed(C.FIXED_VALUES_BATCH)
    commitment_scheme.set_batch_size(
        C.VARIABLE_VALUES_BATCH, len(z.z[C.VARIABLE_VALUES_BATCH]))
    if is_lookup_enabled or has_copy:
        commitment_scheme.set_batch_size(
            C.PERMUTATION_BATCH, len(z.z[C.PERMUTATION_BATCH]))
    commitment_scheme.set_batch_size(
        C.QUOTIENT_BATCH, len(z.z[C.QUOTIENT_BATCH]))
    if is_lookup_enabled:
        commitment_scheme.set_batch_size(
            C.LOOKUP_BATCH, len(z.z[C.LOOKUP_BATCH]))
    generate_evaluation_points(commitment_scheme, common, constraint_system,
                               desc, challenge, is_lookup_enabled, fs)

    commitments = dict(proof.commitments)
    commitments[C.FIXED_VALUES_BATCH] = common.vk.fixed_values_commitment
    if not commitment_scheme.verify_eval(proof.eval_proof.eval_proof,
                                         commitments, transcript):
        return False

    # final identity
    F_consolidated = 0
    for i in range(C.F_PARTS):
        F_consolidated = (F_consolidated + alphas[i] * F[i]) % p
    T_consolidated = 0
    for i in range(len(z.z[C.QUOTIENT_BATCH])):
        T_consolidated = (T_consolidated + z.get(C.QUOTIENT_BATCH, i, 0)
                          * pow(challenge, desc.rows_amount * i, p)) % p
    Z_at = common.Z_at(challenge)
    return F_consolidated == Z_at * T_consolidated % p
