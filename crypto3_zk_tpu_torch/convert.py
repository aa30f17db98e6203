"""Carry keys, limb arrays, polynomials and proofs between the JAX package
and this port.

The port imports nothing of the JAX package, so a caller that holds the
reference's objects hands them over as plain Python and numpy values:
`dataclasses.asdict` would deep-copy a proving key, so pass
`{f.name: getattr(key, f.name) for f in dataclasses.fields(key)}`.
Curves and fields travel by name, constraint systems as their constraint
term lists, polynomials as their digit arrays, FRI parameters as the
`get_params()` dict, proofs as plain ints and bytes (`fri_proof_fields`,
`placeholder_proof_fields`), which compare with `==` (`fri_proof_as_plain`,
`lpc_proof_as_plain`, `placeholder_proof_as_plain`). PLONK circuits are
rebuilt node by node from any objects with the reference's attributes
(`plonk_from_reference`). Poseidon parameters are not carried: both
packages derive them from the field.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from .arithmetization import plonk as PK
from .arithmetization import r1cs as R
from .commitments import batched as B
from .commitments import fri as FRI
from .commitments import kzg as KZG
from .commitments import lpc as LPC
from .fields import curves as CV
from .fields import mnt as MNT
from .fields.params import FIELDS
from .models import groth16 as G16
from .models.placeholder import common as PC
from .ops import limbs as L
from .poly.polynomial import Poly, PolyDFS


def curve_by_name(name: str):
    for mod in (CV, MNT):
        for obj in vars(mod).values():
            if isinstance(obj, (CV.CurveSpec, MNT.MNTCurve)) \
                    and obj.name == name:
                return obj
    raise KeyError(f"unknown curve {name!r}")


def _name_of(curve) -> str:
    return curve if isinstance(curve, str) else curve.name


def constraint_system_from_reference(cs) -> R.R1CSConstraintSystem:
    """Rebuild an R1CS from any object with the reference's attributes
    (`primary_input_size`, `auxiliary_input_size`, `constraints` of a/b/c
    linear combinations with `terms`)."""
    out = R.R1CSConstraintSystem(cs.primary_input_size,
                                 cs.auxiliary_input_size)
    for cst in cs.constraints:
        out.add_constraint(*(R.LinearCombination([(int(i), int(c))
                                                  for i, c in part.terms])
                             for part in (cst.a, cst.b, cst.c)))
    return out


def proving_key_from_reference(fields: dict) -> G16.ProvingKey:
    """The port's `ProvingKey` from the reference dataclass's fields."""
    f = dict(fields)
    f["curve"] = curve_by_name(_name_of(f["curve"]))
    f["constraint_system"] = constraint_system_from_reference(
        f["constraint_system"])
    for name in ("A_query", "B_query_g1", "B_query_g2", "H_query", "L_query"):
        f[name] = list(f[name])
    return G16.ProvingKey(**f)


def verification_key_from_reference(fields: dict) -> G16.VerificationKey:
    """The port's `VerificationKey` from the reference dataclass's fields."""
    f = dict(fields)
    f["curve"] = curve_by_name(_name_of(f["curve"]))
    f["gamma_ABC_g1"] = list(f["gamma_ABC_g1"])
    return G16.VerificationKey(**f)


def limbs_from_numpy(fs, arr, device=None) -> torch.Tensor:
    """A reference `(NL, ...)` uint32 digit array -> the port's int32
    tensor, bit for bit."""
    a = np.asarray(arr)
    if a.shape[0] != fs.nl:
        raise ValueError(f"expected {fs.nl} digit planes, got {a.shape[0]}")
    return L.from_numpy(a, device)


# ---------------------------------------------------------------------------
# the commitment layer: polynomials, FRI parameters and proofs
# ---------------------------------------------------------------------------

def poly_from_reference(fs, c_numpy, device=None) -> Poly:
    """A reference `Poly`'s coefficient array `(NL, n)` -> the port's."""
    return Poly(fs, limbs_from_numpy(fs, c_numpy, device))


def poly_dfs_from_reference(fs, v_numpy, deg: int, device=None) -> PolyDFS:
    """A reference `PolyDFS`'s evaluation array `(NL, n)` and degree bound
    -> the port's."""
    return PolyDFS(fs, limbs_from_numpy(fs, v_numpy, device), int(deg))


def fri_params_from_reference(params: dict) -> FRI.FRIParams:
    """The port's `FRIParams` from the reference's `FRIParams.get_params()`
    dict (which carries `step_list`). The domains are rebuilt from the field
    and the sizes, not copied."""
    fs = FIELDS[params["field"]]
    degree_log = (params["max_degree"] + 1).bit_length() - 1
    if (1 << degree_log) - 1 != params["max_degree"]:
        raise ValueError("max_degree is not 2^k - 1")
    out = FRI.FRIParams.build(
        fs, degree_log=degree_log, expand_factor=params["expand_factor"],
        lambda_=params["lambda"], step_list=list(params["step_list"]),
        use_grinding=params["use_grinding"],
        grinding_parameter=params["grinding_parameter"],
        merkle_hash=params["merkle_hash"],
        transcript_hash=params["transcript_hash"])
    if out.D[0].n != params["domain_size"] or out.r != params["r"]:
        raise ValueError("the rebuilt domains differ from the reference's")
    return out


def _plain(x):
    """Nested lists, tuples and dicts of ints and bytes as nested tuples."""
    if isinstance(x, dict):
        return tuple((k, _plain(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, bytes) or x is None:
        return x
    return int(x)


def fri_proof_fields(proof) -> dict:
    """Either package's `FRIProof` (duck-typed) as plain dicts and lists of
    ints and bytes, from which the other package's dataclasses are built:
    `{"fri_roots", "final_polynomial", "proof_of_work", "query_proofs":
    [{"initial_proof": {k: {"values", "path", "leaf_index"}},
    "round_proofs": [{"y", "path", "leaf_index"}]}]}`."""
    return {
        "fri_roots": list(proof.fri_roots),
        "final_polynomial": [int(c) for c in proof.final_polynomial],
        "proof_of_work": proof.proof_of_work,
        "query_proofs": [{
            "initial_proof": {
                k: {"values": [[(int(a), int(b)) for a, b in pv]
                               for pv in ip.values],
                    "path": list(ip.path), "leaf_index": int(ip.leaf_index)}
                for k, ip in qp.initial_proof.items()},
            "round_proofs": [
                {"y": [(int(a), int(b)) for a, b in rp.y],
                 "path": list(rp.path), "leaf_index": int(rp.leaf_index)}
                for rp in qp.round_proofs],
        } for qp in proof.query_proofs],
    }


def fri_proof_from_fields(fields: dict, mod=FRI):
    """A `FRIProof` of the module `mod` (this port's `commitments.fri` by
    default; a test passes the reference's) from `fri_proof_fields`."""
    return mod.FRIProof(
        fri_roots=list(fields["fri_roots"]),
        final_polynomial=list(fields["final_polynomial"]),
        proof_of_work=fields["proof_of_work"],
        query_proofs=[mod.QueryProof(
            initial_proof={k: mod.InitialProof(**ip)
                           for k, ip in qp["initial_proof"].items()},
            round_proofs=[mod.RoundProof(**rp) for rp in qp["round_proofs"]])
            for qp in fields["query_proofs"]])


def fri_proof_as_plain(proof):
    """Either package's `FRIProof` as nested tuples of ints and bytes."""
    return _plain(fri_proof_fields(proof))


def lpc_proof_as_plain(proof):
    """Either package's `LPCProof` as nested tuples: (z table, FRI proof)."""
    return (_plain(proof.z.z), fri_proof_as_plain(proof.fri_proof))


# ---------------------------------------------------------------------------
# PLONK circuits and Placeholder proofs
# ---------------------------------------------------------------------------

def expr_from_reference(e) -> PK.Expr:
    """A reference expression tree (`Var`, `Const`, `BinOp`, `Pow` nodes,
    matched by class name) as the port's."""
    kind = type(e).__name__
    if kind == "Var":
        return PK.Var(int(e.index), int(e.rotation), str(e.type))
    if kind == "Const":
        return PK.Const(int(e.v))
    if kind == "BinOp":
        return PK.BinOp(e.op, expr_from_reference(e.l),
                        expr_from_reference(e.r))
    if kind == "Pow":
        return PK.Pow(expr_from_reference(e.base), int(e.exp))
    raise TypeError(f"not an expression node: {kind}")


def plonk_from_reference(cs, assignment, desc):
    """The port's (ConstraintSystem, Assignment, TableDescription) from the
    reference's objects of the same names."""
    var = expr_from_reference
    out_cs = PK.ConstraintSystem(
        gates=[PK.Gate(int(g.selector_index), [var(c) for c in g.constraints])
               for g in cs.gates],
        copy_constraints=[(var(a), var(b)) for a, b in cs.copy_constraints],
        lookup_gates=[PK.LookupGate(int(g.tag_index), [
            PK.LookupConstraint(int(c.table_id),
                                [var(e) for e in c.lookup_input])
            for c in g.constraints]) for g in cs.lookup_gates],
        lookup_tables=[PK.LookupTable(
            int(t.tag_index), int(t.columns_number),
            [[var(v) for v in opt] for opt in t.lookup_options])
            for t in cs.lookup_tables],
        public_input_sizes=[int(x) for x in cs.public_input_sizes])

    def cols(cc):
        return [[int(x) for x in c] for c in cc]

    out_assignment = PK.Assignment(
        cols(assignment.witnesses), cols(assignment.public_inputs),
        cols(assignment.constants), cols(assignment.selectors))
    out_desc = PK.TableDescription(
        desc.witness_columns, desc.public_input_columns,
        desc.constant_columns, desc.selector_columns,
        desc.usable_rows_amount, desc.rows_amount)
    return out_cs, out_assignment, out_desc


def kzg_params_from_reference(fields: dict) -> KZG.KZGParams:
    """The port's `KZGParams` from the reference's fields (`curve` as an
    object with a `name`, or the name; the G1 and G2 powers as host affine
    points)."""
    return KZG.KZGParams(curve_by_name(_name_of(fields["curve"])),
                         list(fields["commitment_key"]),
                         list(fields["verification_key"]))


def _z_fields(z) -> dict:
    return {int(k): [[int(x) for x in row] for row in rows]
            for k, rows in z.z.items()}


def _z_from_fields(z_fields: dict, batched=B):
    z = batched.EvalStorage()
    z.z = {k: [list(row) for row in rows] for k, rows in z_fields.items()}
    return z


def kzg_proof_fields(proof) -> dict:
    """Either package's `KZGv2Proof` (`{"z", "pi_1", "pi_2"}`) or
    `KZGBDFGProof` (`{"z", "pi"}`) as plain values; points are host affine
    tuples, None for infinity."""
    out = {"z": _z_fields(proof.z)}
    for name in ("pi_1", "pi_2", "pi"):
        if hasattr(proof, name):
            out[name] = getattr(proof, name)
    return out


def kzg_proof_from_fields(fields: dict, kzg=KZG, batched=B):
    """A `KZGv2Proof` or `KZGBDFGProof` of the module `kzg` (this port's by
    default; a test passes the reference's) from `kzg_proof_fields`."""
    z = _z_from_fields(fields["z"], batched)
    if "pi" in fields:
        return kzg.KZGBDFGProof(z=z, pi=fields["pi"])
    return kzg.KZGv2Proof(z=z, pi_1=fields["pi_1"], pi_2=fields["pi_2"])


def placeholder_proof_fields(proof) -> dict:
    """Either package's `PlaceholderProof` over LPC or KZG (duck-typed) as
    plain dicts and lists: `{"commitments": {batch: root or blob},
    "challenge", "z": {batch: [[value per point] per polynomial]}}` and
    `"fri_proof": fri_proof_fields(...)` over LPC, or the openings of
    `kzg_proof_fields` (`"pi_1"`, `"pi_2"` or `"pi"`) over KZG."""
    ev = proof.eval_proof
    out = {
        "commitments": {int(k): v for k, v in proof.commitments.items()},
        "challenge": int(ev.challenge),
        "z": _z_fields(ev.eval_proof.z),
    }
    if hasattr(ev.eval_proof, "fri_proof"):
        out["fri_proof"] = fri_proof_fields(ev.eval_proof.fri_proof)
    else:
        out.update(kzg_proof_fields(ev.eval_proof))
    return out


PORT_MODULES = types.SimpleNamespace(common=PC, lpc=LPC, batched=B, fri=FRI,
                                     kzg=KZG)


def placeholder_proof_from_fields(fields: dict, mod=PORT_MODULES):
    """A `PlaceholderProof` from `placeholder_proof_fields`, built from the
    modules in `mod` (a namespace with `common`, `batched` and `lpc` and
    `fri` or `kzg`: this port's by default; a test passes the
    reference's)."""
    if "fri_proof" in fields:
        eval_proof = mod.lpc.LPCProof(
            z=_z_from_fields(fields["z"], mod.batched),
            fri_proof=fri_proof_from_fields(fields["fri_proof"], mod.fri))
    else:
        eval_proof = kzg_proof_from_fields(fields, mod.kzg, mod.batched)
    return mod.common.PlaceholderProof(
        commitments=dict(fields["commitments"]),
        eval_proof=mod.common.EvalProof(challenge=fields["challenge"],
                                        eval_proof=eval_proof))


def placeholder_proof_as_plain(proof):
    """Either package's `PlaceholderProof` as nested tuples."""
    return _plain(placeholder_proof_fields(proof))
