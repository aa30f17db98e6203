"""Counterpart of `utils/serialization.py` of the JAX package (host only).

Byte serialization of proofs / keys (marshalling layer).

Role of `r1cs_gg_ppzksnark/marshalling.hpp:98-898` and the `.crct`/`.tbl`
persistence story (SURVEY.md §5 checkpoint/resume): big-endian fixed-width
field elements, uncompressed curve points (x||y; all-zero = infinity), and
length-prefixed vectors. Deterministic and self-describing enough for
checkpoint/resume of keys and proofs across sessions.
"""
from __future__ import annotations

import struct

from ..fields import curves as CV
from ..fields.params import FieldSpec


def _u32(v: int) -> bytes:
    return struct.pack(">I", v)


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def bytes_(self, b: bytes):
        self.parts.append(_u32(len(b)))
        self.parts.append(b)

    def field(self, fs: FieldSpec, v: int):
        nb = (fs.bits + 7) // 8
        self.parts.append((v % fs.p).to_bytes(nb, "big"))

    def fields(self, fs: FieldSpec, vs):
        self.parts.append(_u32(len(vs)))
        for v in vs:
            self.field(fs, v)

    def g1(self, curve: CV.CurveSpec, pt):
        nb = (curve.fq.bits + 7) // 8
        if pt is None:
            self.parts.append(b"\x00" * (2 * nb))
        else:
            self.parts.append(pt[0].to_bytes(nb, "big")
                              + pt[1].to_bytes(nb, "big"))

    def g2(self, curve: CV.CurveSpec, pt):
        nb = (curve.fq.bits + 7) // 8
        if pt is None:
            self.parts.append(b"\x00" * (4 * nb))
        else:
            self.parts.append(b"".join(
                v.to_bytes(nb, "big") for v in (*pt[0], *pt[1])))

    def g1_vec(self, curve, pts):
        self.parts.append(_u32(len(pts)))
        for pt in pts:
            self.g1(curve, pt)

    def g2_vec(self, curve, pts):
        self.parts.append(_u32(len(pts)))
        for pt in pts:
            self.g2(curve, pt)

    def out(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        b = self.data[self.off:self.off + n]
        if len(b) != n:
            raise ValueError("truncated")
        self.off += n
        return b

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def bytes_(self) -> bytes:
        return self._take(self.u32())

    def field(self, fs: FieldSpec) -> int:
        nb = (fs.bits + 7) // 8
        return int.from_bytes(self._take(nb), "big")

    def fields(self, fs: FieldSpec) -> list[int]:
        return [self.field(fs) for _ in range(self.u32())]

    def g1(self, curve: CV.CurveSpec):
        """Deserialized points are validated on-curve (cheap). Full subgroup
        membership of attacker-supplied proof elements is enforced again at
        each verifier via `g1_well_formed` (verifier.hpp:164)."""
        nb = (curve.fq.bits + 7) // 8
        raw = self._take(2 * nb)
        x = int.from_bytes(raw[:nb], "big")
        y = int.from_bytes(raw[nb:], "big")
        if x == 0 and y == 0:
            return None
        if not CV.g1_on_curve(curve, (x, y)):
            raise ValueError("deserialized G1 point is off-curve")
        return (x, y)

    def g2(self, curve: CV.CurveSpec):
        nb = (curve.fq.bits + 7) // 8
        raw = self._take(4 * nb)
        vals = [int.from_bytes(raw[i * nb:(i + 1) * nb], "big")
                for i in range(4)]
        if all(v == 0 for v in vals):
            return None
        pt = ((vals[0], vals[1]), (vals[2], vals[3]))
        if not CV.g2_on_curve(curve, pt):
            raise ValueError("deserialized G2 point is off-curve")
        return pt

    def g1_vec(self, curve):
        return [self.g1(curve) for _ in range(self.u32())]

    def g2_vec(self, curve):
        return [self.g2(curve) for _ in range(self.u32())]


# --- Groth16 (r1cs_gg_ppzksnark marshalling) -------------------------------

def groth16_proof_to_bytes(curve: CV.CurveSpec, proof) -> bytes:
    w = Writer()
    w.g1(curve, proof.g_A)
    w.g2(curve, proof.g_B)
    w.g1(curve, proof.g_C)
    return w.out()


def groth16_proof_from_bytes(curve: CV.CurveSpec, data: bytes):
    from ..models.groth16 import Proof
    r = Reader(data)
    return Proof(g_A=r.g1(curve), g_B=r.g2(curve), g_C=r.g1(curve))


def groth16_vk_to_bytes(curve: CV.CurveSpec, vk) -> bytes:
    w = Writer()
    # GT element: 12 Fq coefficients
    fq_nb = (curve.fq.bits + 7) // 8
    flat = []
    for c6 in vk.alpha_g1_beta_g2:
        for c2 in c6:
            flat.extend(c2)
    w.parts.append(b"".join(v.to_bytes(fq_nb, "big") for v in flat))
    w.g2(curve, vk.gamma_g2)
    w.g2(curve, vk.delta_g2)
    w.g1_vec(curve, vk.gamma_ABC_g1)
    return w.out()


def groth16_vk_from_bytes(curve: CV.CurveSpec, data: bytes):
    from ..models.groth16 import VerificationKey
    r = Reader(data)
    fq_nb = (curve.fq.bits + 7) // 8
    flat = [int.from_bytes(r._take(fq_nb), "big") for _ in range(12)]
    gt = tuple(tuple(tuple(flat[6 * i + 2 * j + k] for k in range(2))
                     for j in range(3)) for i in range(2))
    return VerificationKey(curve, gt, r.g2(curve), r.g2(curve),
                           r.g1_vec(curve))


def primary_input_to_bytes(curve: CV.CurveSpec, primary: list[int]) -> bytes:
    w = Writer()
    w.fields(curve.fr, primary)
    return w.out()


def primary_input_from_bytes(curve: CV.CurveSpec, data: bytes) -> list[int]:
    return Reader(data).fields(curve.fr)
