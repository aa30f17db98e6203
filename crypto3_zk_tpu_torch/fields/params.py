"""Field and curve parameters.

TPU-native re-implementation of the math substrate consumed by the reference
zk stack (crypto3-multiprecision / crypto3-algebra; see SURVEY.md §2.0 and
reference usage at e.g. `permutation_argument.hpp:123-133`). The reference is
a C++ template library over arbitrary fields; here each field is a
`FieldSpec` dataclass carrying the modulus plus the derived Montgomery
constants used by the vectorized limb kernels in `ops/limbs.py`.

Limb layout convention (TPU-first): a field element batch is a uint32 array
of shape (NL, *batch) — limb axis FIRST so that per-limb slices are
contiguous vectors that map directly onto the VPU's 8x128 lanes. Limbs are
16-bit digits stored in uint32 lanes so that a 16x16-bit product plus
carries fits exactly in uint32 (CIOS Montgomery without 64-bit multiplies).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

W = 16  # limb width in bits
MASK = (1 << W) - 1


def _limbs_of(x: int, nl: int) -> np.ndarray:
    out = np.zeros(nl, dtype=np.uint32)
    for i in range(nl):
        out[i] = (x >> (W * i)) & MASK
    return out


def limbs_to_int(limbs) -> int:
    x = 0
    for i, v in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        x |= int(v) << (W * i)
    return x


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field GF(p) with Montgomery constants for W-bit limb kernels."""

    name: str
    p: int
    # smallest multiplicative generator (known constant, validated in __post_init__)
    generator: int
    two_adicity: int

    @functools.cached_property
    def bits(self) -> int:
        return self.p.bit_length()

    @functools.cached_property
    def nl(self) -> int:
        """Number of W-bit limbs."""
        return -(-self.bits // W)

    @functools.cached_property
    def R(self) -> int:
        return 1 << (W * self.nl)

    @functools.cached_property
    def R_mod_p(self) -> int:
        return self.R % self.p

    @functools.cached_property
    def R2(self) -> int:
        return (self.R * self.R) % self.p

    @functools.cached_property
    def Rinv(self) -> int:
        return pow(self.R, -1, self.p)

    @functools.cached_property
    def ninv16(self) -> int:
        """-p^{-1} mod 2^W (the CIOS per-digit Montgomery factor)."""
        return (-pow(self.p, -1, 1 << W)) % (1 << W)

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return _limbs_of(self.p, self.nl)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return _limbs_of(self.R2, self.nl)

    @functools.cached_property
    def one_mont_limbs(self) -> np.ndarray:
        return _limbs_of(self.R_mod_p, self.nl)

    def to_limbs(self, x: int) -> np.ndarray:
        return _limbs_of(x % self.p, self.nl)

    def root_of_unity(self, order: int) -> int:
        """Primitive `order`-th root of unity (order must be a power of two
        dividing 2^two_adicity). Mirrors math::evaluation_domain's omega
        (reference: crypto3-math, driven from `r1cs_to_qap.hpp:229-310`)."""
        assert order & (order - 1) == 0, "order must be a power of two"
        assert order <= (1 << self.two_adicity), (order, self.two_adicity)
        g = pow(self.generator, (self.p - 1) >> self.two_adicity, self.p)
        return pow(g, (1 << self.two_adicity) // order, self.p)

    def __post_init__(self):
        assert self.p % 2 == 1
        # generator sanity: must be a quadratic non-residue for p odd prime
        assert pow(self.generator, (self.p - 1) // 2, self.p) == self.p - 1, \
            f"{self.name}: generator {self.generator} is a QR"
        assert (self.p - 1) % (1 << self.two_adicity) == 0

    def __hash__(self):
        return hash((self.name, self.p))


# --- Scalar (Fr) fields -----------------------------------------------------

BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    p=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    generator=7,
    two_adicity=32,
)

ALT_BN128_FR = FieldSpec(
    name="alt_bn128_fr",
    p=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
    two_adicity=28,
)

GOLDILOCKS = FieldSpec(
    name="goldilocks",
    p=(1 << 64) - (1 << 32) + 1,
    generator=7,
    two_adicity=32,
)

MNT4_FR = FieldSpec(  # = MNT6 base field (the PCD cycle, fields/mnt.py)
    name="mnt4_fr",
    p=475922286169261325753349249653048451545124878552823515553267735739164647307408490559963137,
    generator=5,
    two_adicity=34,
)

MNT6_FR = FieldSpec(  # = MNT4 base field
    name="mnt6_fr",
    p=475922286169261325753349249653048451545124879242694725395555128576210262817955800483758081,
    generator=17,
    two_adicity=17,
)

PALLAS_FR = FieldSpec(  # = vesta base field; pallas scalar field
    name="pallas_fr",
    p=0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
    generator=5,
    two_adicity=32,
)

PALLAS_FQ = FieldSpec(  # = pallas base field; vesta scalar field
    name="pallas_fq",
    p=0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
    generator=5,
    two_adicity=32,
)
VESTA_FR = PALLAS_FQ
VESTA_FQ = PALLAS_FR

# --- Base (Fq) fields for curve arithmetic ---------------------------------

BLS12_381_FQ = FieldSpec(
    name="bls12_381_fq",
    p=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    generator=2,
    two_adicity=1,
)

ALT_BN128_FQ = FieldSpec(
    name="alt_bn128_fq",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    generator=3,
    two_adicity=1,
)

FIELDS = {
    f.name: f
    for f in (
        BLS12_381_FR,
        ALT_BN128_FR,
        GOLDILOCKS,
        PALLAS_FR,
        PALLAS_FQ,
        BLS12_381_FQ,
        ALT_BN128_FQ,
    )
}
