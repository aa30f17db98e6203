"""Per-kernel throughput metrics against speed-of-light.

Counterpart of `utils/metrics.py` of the JAX package (host only): structured
per-kernel counters (useful work in field multiplications, bytes moved,
achieved rate, roofline fraction), so that a regression shows up as a
number. Registered kernels report through `record()`; `summary()` yields the
table.

The ceilings are one NVIDIA H100 SXM's, from its data sheet (at the full
700 W power limit): 3.35 TB/s of HBM, 1,979 T int8 operations a second in
the tensor cores (989.5 T multiply-adds), and the integer pipes' 64 lanes a
clock on each of 132 SMs at 1.98 GHz for 32-bit operations. A field
multiplication counts as one word-level CIOS product over 8 words:
8 * 17 multiply-adds, two 32-bit operations each (`chip_smoke.py::mont_ops`).
Override `CHIP` for another card or power limit.
"""
from __future__ import annotations

import dataclasses
import time

CHIP = {
    "hbm_bytes_per_s": 3.35e12,
    "int8_macs_per_s": 989.5e12,
    "u32_ops_per_s": 64 * 132 * 1.98e9,
    "u32_ops_per_field_mul": 2 * 8 * 17,
}


@dataclasses.dataclass
class KernelRecord:
    name: str
    seconds: float
    field_muls: int = 0
    bytes_moved: int = 0

    @property
    def mul_rate(self) -> float:
        return self.field_muls / self.seconds if self.seconds else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Attainable / achieved time under the tighter of the compute and
        memory ceilings."""
        if not self.seconds:
            return 0.0
        t_compute = self.field_muls * CHIP["u32_ops_per_field_mul"] \
            / CHIP["u32_ops_per_s"]
        t_memory = self.bytes_moved / CHIP["hbm_bytes_per_s"]
        attainable = max(t_compute, t_memory)
        return attainable / self.seconds if attainable else 0.0


_records: list[KernelRecord] = []


def record(name: str, seconds: float, field_muls: int = 0,
           bytes_moved: int = 0) -> KernelRecord:
    r = KernelRecord(name, seconds, field_muls, bytes_moved)
    _records.append(r)
    return r


class timed_kernel:
    """with timed_kernel("ntt_2^20", field_muls=..., bytes_moved=...):

    Host clock around the block: a caller timing work on the card drains
    the device inside the block (`torch.cuda.synchronize()`) before it
    ends."""

    def __init__(self, name: str, field_muls: int = 0, bytes_moved: int = 0):
        self.name = name
        self.field_muls = field_muls
        self.bytes_moved = bytes_moved

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record(self.name, time.perf_counter() - self._t0,
               self.field_muls, self.bytes_moved)
        return False


def ntt_cost(n: int, nl: int) -> tuple[int, int]:
    """(field_muls, bytes) for one radix-2 NTT of size n over NL limbs."""
    import math
    log_n = int(math.log2(n))
    return (n // 2) * log_n, 2 * log_n * n * nl * 4


def msm_cost(n: int, c: int, bits: int) -> tuple[int, int]:
    """(field_muls, bytes) for Pippenger: ~2 adds per point per window,
    16 field muls per Jacobian add."""
    windows = -(-bits // c)
    adds = 2 * n * windows
    return adds * 16, adds * 3 * (bits // 16) * 4


def summary() -> list[dict]:
    return [{
        "kernel": r.name,
        "seconds": round(r.seconds, 4),
        "field_muls": r.field_muls,
        "mul_per_s": round(r.mul_rate, 1),
        "roofline_fraction": round(r.roofline_fraction, 4),
    } for r in _records]


def reset() -> None:
    _records.clear()
