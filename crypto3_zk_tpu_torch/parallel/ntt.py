"""Distributed NTT over a mesh (four-step algorithm + all-to-all).

Counterpart of `parallel/ntt.py` of the JAX package. With N = R*C,
n = r*C + c, k = k1*R + k2:

    X[k1*R + k2] = NTT_C over c { w_N^(c*k2) * NTT_R over r { x[r*C + c] } }

so on a 1-D mesh of D ranks sharding the c axis, each rank:

  1. takes its C/D columns and runs size-R NTTs along r (`ops/ntt.py::
     ntt_raw`, kernel 2 on the card);
  2. scales by its twiddle block w_N^(c*k2) (`limbs.mont_mul`, kernel 1);
  3. exchanges blocks in one `all_to_all_single`: it keeps R/D rows of k2
     with every c;
  4. runs size-C NTTs along c;

and one `all_gather` rebuilds the natural-order result on every rank, as
the JAX function returns a global array. Collectives split dimension 0, so
the split axis goes to the front of a contiguous tensor first.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..fields.params import FieldSpec
from ..ops import hopper_field as HF
from ..ops import limbs as L
from ..ops import ntt as NTT
from .context import axis_rank, axis_size


def _twiddle_block(fs: FieldSpec, n: int, rows: int, cols_total: int,
                   col_start: int, cols: int, inverse: bool,
                   device) -> torch.Tensor:
    """(NL, rows, cols) block, entry [k2, j] = w_N^((col_start + j) * k2) in
    Montgomery form: columns of the single-device four-step's (NL, C, R)
    table (`hopper_field._four_step_twiddles`, built once on the device and
    kept)."""
    table = HF._four_step_twiddles(fs, n, rows, cols_total, inverse,
                                   str(device))
    return table[:, col_start:col_start + cols, :].transpose(1, 2)


def split(n: int, d: int) -> tuple[int, int]:
    """(R, C) of the four-step for N = n over d ranks: C = 2^log_c with
    log_c = max(ceil(log2(N) / 2), log2(d)), and d must divide R and C."""
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    if d & (d - 1):
        raise ValueError("mesh axis must be a power of two")
    log_c = max((log_n + 1) // 2, d.bit_length() - 1)
    if log_c > log_n:
        raise ValueError(f"N = {n} is too short for {d} ranks")
    c_total = 1 << log_c
    r_total = n // c_total
    if c_total % d or r_total % d:
        raise ValueError("need D | C and D | R for the all-to-all transpose")
    return r_total, c_total


def distributed_ntt(fs: FieldSpec, x: torch.Tensor, mesh, axis: str = "x",
                    inverse: bool = False) -> torch.Tensor:
    """x: (NL, N) coefficients in natural order, the whole input on every
    rank -> evaluations in natural order, the whole result on every rank.
    The inverse is scaled by 1/N."""
    nl, n = x.shape
    d = axis_size(mesh, axis)
    me = axis_rank(mesh, axis)
    group = mesh.get_group(axis)
    r_total, c_total = split(n, d)
    c_loc, r_loc = c_total // d, r_total // d

    a = x.reshape(nl, r_total, c_total)                 # A[r, c] = x[r*C + c]
    blk = a[:, :, me * c_loc:(me + 1) * c_loc]           # (NL, R, C_loc)
    # step 1: size-R transforms along r
    blk = NTT.ntt_raw(fs, blk.transpose(1, 2).contiguous(), inverse)
    blk = blk.transpose(1, 2)                            # (NL, k2, C_loc)
    # step 2: twiddles w_N^(c * k2)
    blk = L.mont_mul(fs, blk, _twiddle_block(
        fs, n, r_total, c_total, me * c_loc, c_loc, inverse, x.device))
    # step 3: rank s receives rows k2 in [s*R/D, (s+1)*R/D) of every column
    send = blk.reshape(nl, d, r_loc, c_loc).permute(1, 0, 2, 3).contiguous()
    recv = torch.empty_like(send)                        # (D, NL, R/D, C_loc)
    dist.all_to_all_single(recv, send, group=group)
    mine = recv.permute(1, 2, 0, 3).reshape(nl, r_loc, c_total)
    # step 4: size-C transforms along c
    out = NTT.ntt_raw(fs, mine.contiguous(), inverse)   # O[k2, k1] (k2 local)
    parts = [torch.empty_like(out) for _ in range(d)]
    dist.all_gather(parts, out, group=group)
    full = torch.cat(parts, dim=1)                       # (NL, R, C)
    out = full.transpose(1, 2).reshape(nl, n)            # X[k1*R + k2]
    if inverse:
        out = L.mont_mul(fs, out, L.const_mont(fs, pow(n, -1, fs.p), (1,),
                                               x.device))
    return out
