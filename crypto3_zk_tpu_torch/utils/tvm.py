"""Counterpart of `utils/tvm.py` of the JAX package (host only), over the
port's `utils/bincode.py`.

TVM-compatible byte marshalling of Groth16 verifier inputs — the
`verifier_input_serializer/deserializer_tvm` format of
`r1cs_gg_ppzksnark/marshalling.hpp:98-1258`:

- proof: g_A (48 B compressed G1) || g_B (96 B compressed G2) || g_C;
- primary input: count (4 B big-endian) || count x Fr (32 B little-endian);
- verification key: alpha_g1_beta_g2 GT (576 B, 12 x Fq LE) || gamma_g2 ||
  delta_g2 || accumulation vector (first G1, then sparse vector: count,
  count x index (4 B BE), count x G1, domain size);
- verifier_input blob: proof || primary input || verification key.

Point/field byte formats come from `utils/bincode.py` (pinned by the
bellperson vectors); sizes are 4-byte big-endian
(`marshalling.hpp:975-985`). Deserialization rejects off-curve /
wrong-subgroup points (ValueError).
"""
from __future__ import annotations

from . import bincode as BC


def proof_to_bytes(curve, proof) -> bytes:
    return (BC.g1_to_bytes(curve, proof.g_A)
            + BC.g2_to_bytes(curve, proof.g_B)
            + BC.g1_to_bytes(curve, proof.g_C))


def proof_from_bytes(curve, b: bytes):
    from ..models.groth16 import Proof

    nb = (curve.fq.bits + 7) // 8
    if len(b) < 4 * nb:
        raise ValueError("proof blob too short")
    g_A = BC.g1_from_bytes(curve, b[:nb])
    g_B = BC.g2_from_bytes(curve, b[nb:3 * nb])
    g_C = BC.g1_from_bytes(curve, b[3 * nb:4 * nb])
    return Proof(g_A, g_B, g_C), b[4 * nb:]


def primary_input_to_bytes(curve, primary: list[int]) -> bytes:
    out = [BC.size_to_bytes(len(primary))]
    out.extend(BC.fr_to_bytes(curve, v) for v in primary)
    return b"".join(out)


def primary_input_from_bytes(curve, b: bytes):
    n = BC.size_from_bytes(b[:4])
    nb = (curve.fr.bits + 7) // 8
    if len(b) < 4 + n * nb:
        raise ValueError("primary input blob too short")
    vals = [BC.fr_from_bytes(curve, b[4 + i * nb:4 + (i + 1) * nb])
            for i in range(n)]
    return vals, b[4 + n * nb:]


def verification_key_to_bytes(curve, vk) -> bytes:
    """vk fields per `verification_key.hpp`: alpha_g1_beta_g2 (GT),
    gamma_g2, delta_g2, gamma_ABC_g1 (dense list -> accumulation vector
    with indices 0..n-1, `marshalling.hpp:1013-1023`)."""
    out = [BC.fq12_to_bytes(curve, vk.alpha_g1_beta_g2),
           BC.g2_to_bytes(curve, vk.gamma_g2),
           BC.g2_to_bytes(curve, vk.delta_g2)]
    gamma_abc = vk.gamma_ABC_g1
    first, rest = gamma_abc[0], gamma_abc[1:]
    out.append(BC.g1_to_bytes(curve, first))
    out.append(BC.size_to_bytes(len(rest)))
    out.extend(BC.size_to_bytes(i) for i in range(len(rest)))
    out.extend(BC.g1_to_bytes(curve, pt) for pt in rest)
    out.append(BC.size_to_bytes(len(rest)))      # domain_size
    return b"".join(out)


def verification_key_from_bytes(curve, b: bytes):
    from ..models.groth16 import VerificationKey

    nb = (curve.fq.bits + 7) // 8
    gt_nb = 12 * nb
    off = 0
    alpha_beta = BC.fq12_from_bytes(curve, b[off:off + gt_nb])
    off += gt_nb
    gamma_g2 = BC.g2_from_bytes(curve, b[off:off + 2 * nb])
    off += 2 * nb
    delta_g2 = BC.g2_from_bytes(curve, b[off:off + 2 * nb])
    off += 2 * nb
    first = BC.g1_from_bytes(curve, b[off:off + nb])
    off += nb
    count = BC.size_from_bytes(b[off:off + 4])
    off += 4
    indices = [BC.size_from_bytes(b[off + 4 * i:off + 4 * (i + 1)])
               for i in range(count)]
    off += 4 * count
    values = [BC.g1_from_bytes(curve, b[off + nb * i:off + nb * (i + 1)])
              for i in range(count)]
    off += nb * count
    domain = BC.size_from_bytes(b[off:off + 4])
    off += 4
    if sorted(indices) != list(range(count)) or domain < count:
        raise ValueError("non-dense gamma_ABC accumulation vector")
    dense = [None] * count
    for i, v in zip(indices, values):
        dense[i] = v
    vk = VerificationKey(curve, alpha_beta, gamma_g2, delta_g2,
                         [first] + dense)
    return vk, b[off:]


def verifier_input_to_bytes(curve, vk, primary: list[int], proof) -> bytes:
    """proof || primary input || vk (`marshalling.hpp:841-898` order)."""
    return (proof_to_bytes(curve, proof)
            + primary_input_to_bytes(curve, primary)
            + verification_key_to_bytes(curve, vk))


def verifier_input_from_bytes(curve, b: bytes):
    proof, b = proof_from_bytes(curve, b)
    primary, b = primary_input_from_bytes(curve, b)
    vk, b = verification_key_from_bytes(curve, b)
    return vk, primary, proof


# --- linear combinations / constraint system (`marshalling.hpp:1028-1073`) --

def _lc_to_bytes(curve, lc) -> bytes:
    out = [BC.size_to_bytes(len(lc.terms))]
    for idx, coeff in lc.terms:
        out.append(BC.size_to_bytes(idx))
        out.append(BC.fr_to_bytes(curve, coeff))
    return b"".join(out)


def _lc_from_bytes(curve, b: bytes, off: int):
    from ..arithmetization.r1cs import LinearCombination

    nb = (curve.fr.bits + 7) // 8
    n = BC.size_from_bytes(b[off:off + 4])
    off += 4
    terms = []
    for _ in range(n):
        idx = BC.size_from_bytes(b[off:off + 4])
        coeff = BC.fr_from_bytes(curve, b[off + 4:off + 4 + nb])
        terms.append((idx, coeff))
        off += 4 + nb
    return LinearCombination(terms), off


def constraint_system_to_bytes(curve, cs) -> bytes:
    """primary size || auxiliary size || constraint count || per
    constraint: byteblob size || a || b || c."""
    nb = (curve.fr.bits + 7) // 8
    out = [BC.size_to_bytes(cs.primary_input_size),
           BC.size_to_bytes(cs.auxiliary_input_size),
           BC.size_to_bytes(len(cs.constraints))]
    for rc in cs.constraints:
        blob_size = sum(len(l.terms) * (4 + nb) for l in (rc.a, rc.b, rc.c)) \
            + 3 * 4
        out.append(BC.size_to_bytes(blob_size))
        out.extend(_lc_to_bytes(curve, l) for l in (rc.a, rc.b, rc.c))
    return b"".join(out)


def constraint_system_from_bytes(curve, b: bytes, off: int = 0):
    from ..arithmetization.r1cs import R1CSConstraint, R1CSConstraintSystem

    primary = BC.size_from_bytes(b[off:off + 4])
    auxiliary = BC.size_from_bytes(b[off + 4:off + 8])
    count = BC.size_from_bytes(b[off + 8:off + 12])
    off += 12
    constraints = []
    for _ in range(count):
        off += 4                       # per-constraint byteblob size
        a, off = _lc_from_bytes(curve, b, off)
        bb, off = _lc_from_bytes(curve, b, off)
        c, off = _lc_from_bytes(curve, b, off)
        constraints.append(R1CSConstraint(a, bb, c))
    return R1CSConstraintSystem(primary, auxiliary, constraints), off


# --- proving key (`marshalling.hpp:656-738` read / `:1100-1163` write) ------

def proving_key_to_bytes(curve, pk) -> bytes:
    out = [BC.g1_to_bytes(curve, pk.alpha_g1),
           BC.g1_to_bytes(curve, pk.beta_g1),
           BC.g2_to_bytes(curve, pk.beta_g2),
           BC.g1_to_bytes(curve, pk.delta_g1),
           BC.g2_to_bytes(curve, pk.delta_g2),
           BC.size_to_bytes(len(pk.A_query))]
    out.extend(BC.g1_to_bytes(curve, pt) for pt in pk.A_query)
    # B_query as a sparse knowledge-commitment vector (g2 || g1 per entry)
    idxs = [i for i in range(len(pk.B_query_g2))
            if pk.B_query_g2[i] is not None or pk.B_query_g1[i] is not None]
    kc_blob = [BC.size_to_bytes(len(idxs))]
    kc_blob.extend(BC.size_to_bytes(i) for i in idxs)
    for i in idxs:
        kc_blob.append(BC.g2_to_bytes(curve, pk.B_query_g2[i]))
        kc_blob.append(BC.g1_to_bytes(curve, pk.B_query_g1[i]))
    kc_blob.append(BC.size_to_bytes(len(pk.B_query_g2)))   # domain size
    kc = b"".join(kc_blob)
    out.append(BC.size_to_bytes(len(kc)))
    out.append(kc)
    for q in (pk.H_query, pk.L_query):
        out.append(BC.size_to_bytes(len(q)))
        out.extend(BC.g1_to_bytes(curve, pt) for pt in q)
    out.append(constraint_system_to_bytes(curve, pk.constraint_system))
    return b"".join(out)


def proving_key_from_bytes(curve, b: bytes):
    from ..models.groth16 import ProvingKey

    nb = (curve.fq.bits + 7) // 8
    off = 0
    alpha_g1 = BC.g1_from_bytes(curve, b[off:off + nb]); off += nb
    beta_g1 = BC.g1_from_bytes(curve, b[off:off + nb]); off += nb
    beta_g2 = BC.g2_from_bytes(curve, b[off:off + 2 * nb]); off += 2 * nb
    delta_g1 = BC.g1_from_bytes(curve, b[off:off + nb]); off += nb
    delta_g2 = BC.g2_from_bytes(curve, b[off:off + 2 * nb]); off += 2 * nb
    na = BC.size_from_bytes(b[off:off + 4]); off += 4
    A_query = []
    for _ in range(na):
        A_query.append(BC.g1_from_bytes(curve, b[off:off + nb]))
        off += nb
    kc_size = BC.size_from_bytes(b[off:off + 4]); off += 4
    kc_end = off + kc_size
    cnt = BC.size_from_bytes(b[off:off + 4]); off += 4
    idxs = [BC.size_from_bytes(b[off + 4 * i:off + 4 * (i + 1)])
            for i in range(cnt)]
    off += 4 * cnt
    pairs = []
    for _ in range(cnt):
        g2 = BC.g2_from_bytes(curve, b[off:off + 2 * nb]); off += 2 * nb
        g1 = BC.g1_from_bytes(curve, b[off:off + nb]); off += nb
        pairs.append((g2, g1))
    domain = BC.size_from_bytes(b[off:off + 4]); off += 4
    if off != kc_end:
        raise ValueError("kc vector size mismatch")
    B_query_g2 = [None] * domain
    B_query_g1 = [None] * domain
    for i, (g2, g1) in zip(idxs, pairs):
        B_query_g2[i] = g2
        B_query_g1[i] = g1
    queries = []
    for _ in range(2):                     # H_query, L_query
        n = BC.size_from_bytes(b[off:off + 4]); off += 4
        q = []
        for _ in range(n):
            q.append(BC.g1_from_bytes(curve, b[off:off + nb]))
            off += nb
        queries.append(q)
    cs, off = constraint_system_from_bytes(curve, b, off)
    return ProvingKey(curve, cs, alpha_g1, beta_g1, beta_g2, delta_g1,
                      delta_g2, A_query, B_query_g1, B_query_g2,
                      queries[0], queries[1])
