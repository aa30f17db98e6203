"""Placeholder shared definitions (counterpart of
`models/placeholder/common.py` of the JAX package; host only).

Batch ids and proof containers (`placeholder/proof.hpp:37-93`), params
(`placeholder/params.hpp:41-63`), and the circuit+params transcript
initialization hash (`detail/transcript_initialization_context.hpp:49-130` —
here a canonical textual serialization hashed with the transcript hash; the
reference marshals with its own binary format, so cross-implementation
byte-compat of THIS hash is out of scope, while everything downstream of it
follows the same transcript chain).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ...arithmetization import plonk as PK
from ...fields.params import FieldSpec
from ...transcript.hashes import get_hash

FIXED_VALUES_BATCH = 0
VARIABLE_VALUES_BATCH = 1
PERMUTATION_BATCH = 2
QUOTIENT_BATCH = 3
LOOKUP_BATCH = 4

F_PARTS = 8


@dataclasses.dataclass
class PlaceholderParams:
    fs: FieldSpec
    transcript_hash: str = "keccak_256"
    max_quotient_chunks: int = 0


@dataclasses.dataclass
class EvalProof:
    challenge: int
    eval_proof: object  # LPCProof (or other scheme proof)


@dataclasses.dataclass
class PlaceholderProof:
    commitments: dict[int, object]
    eval_proof: Optional[EvalProof] = None


def _expr_repr(e: PK.Expr) -> str:
    if isinstance(e, PK.Var):
        return f"v({e.type},{e.index},{e.rotation})"
    if isinstance(e, PK.Const):
        return f"c({e.v})"
    if isinstance(e, PK.BinOp):
        return f"({_expr_repr(e.l)}{e.op}{_expr_repr(e.r)})"
    if isinstance(e, PK.Pow):
        return f"({_expr_repr(e.base)}^{e.exp})"
    raise TypeError(e)


def constraint_system_with_params_hash(
        params: PlaceholderParams,
        constraint_system: PK.ConstraintSystem,
        desc: PK.TableDescription,
        commitment_params_repr: str,
        delta: int,
        application_id: str = "Default application dependent transcript initialization string",
) -> bytes:
    if params.transcript_hash == "poseidon":
        from ...transcript.hashes import sha2_256 as h
    else:
        h, _ = get_hash(params.transcript_hash)
    parts = [
        f"field={params.fs.p:#x}",
        f"rows={desc.rows_amount},usable={desc.usable_rows_amount}",
        f"cols={desc.witness_columns},{desc.public_input_columns},"
        f"{desc.constant_columns},{desc.selector_columns}",
        f"delta={delta}",
        f"commitment={commitment_params_repr}",
        f"app={application_id}",
        "gates=" + ";".join(
            f"{g.selector_index}:" + ",".join(_expr_repr(c) for c in g.constraints)
            for g in constraint_system.gates),
        "copies=" + ";".join(
            f"{a.type}{a.index}@{a.rotation}~{b.type}{b.index}@{b.rotation}"
            for a, b in constraint_system.copy_constraints),
        "lookup_gates=" + ";".join(
            f"{g.tag_index}:" + "|".join(
                f"{c.table_id}:" + ",".join(_expr_repr(e) for e in c.lookup_input)
                for c in g.constraints)
            for g in constraint_system.lookup_gates),
        "lookup_tables=" + ";".join(
            f"{t.tag_index}:{t.columns_number}:" + "|".join(
                ",".join(f"{v.type}{v.index}" for v in opt)
                for opt in t.lookup_options)
            for t in constraint_system.lookup_tables),
        "pub_sizes=" + ",".join(map(str, constraint_system.public_input_sizes)),
    ]
    return h("\n".join(parts).encode())
