"""Radix-2 NTT / iNTT over prime-field evaluation domains.

Counterpart of `ops/ntt.py` of the JAX package. On the card every transform
goes through `hopper_field.ntt_hopper` (the shared-memory row kernel inside a
four-step split). On the CPU it runs the plain stage loop: one Montgomery
multiply of N/2 lanes plus a modular add and subtract per stage.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.params import FieldSpec
from . import hopper_field as HF
from . import limbs as L

_bitrev_perm = HF.bitrev_perm


class NTTPlan:
    """Cached per-(field, size) constants and twiddle tables w^j, j < n/2
    (Montgomery form, host numpy arrays)."""

    def __init__(self, fs: FieldSpec, log_n: int):
        self.fs = fs
        self.log_n = log_n
        self.n = 1 << log_n
        self.omega = fs.root_of_unity(self.n)
        self.omega_inv = pow(self.omega, -1, fs.p)
        self.n_inv = pow(self.n, -1, fs.p)
        self.bitrev = _bitrev_perm(log_n)

    @functools.cached_property
    def tw_fwd(self) -> np.ndarray:
        return HF._twiddles_np(self.fs, self.log_n, False)

    @functools.cached_property
    def tw_inv(self) -> np.ndarray:
        return HF._twiddles_np(self.fs, self.log_n, True)


@functools.lru_cache(maxsize=None)
def get_plan(fs: FieldSpec, log_n: int) -> NTTPlan:
    return NTTPlan(fs, log_n)


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "NTT size must be a power of two"
    return log_n


def _each_line(fs: FieldSpec, x: torch.Tensor, transform) -> torch.Tensor:
    """`transform` (a function of an (NL, N) tensor) on every line of a
    batched (NL, *batch, N) tensor: the four-step split takes one line at a
    time, as strided views of x (two launches of kernel 2 a line up to
    2^20)."""
    lines = x.reshape(fs.nl, -1, x.shape[-1])
    out = torch.stack([transform(lines[:, i]) for i in range(lines.shape[1])],
                      dim=1)
    return out.reshape(x.shape)


def ntt_raw(fs: FieldSpec, x: torch.Tensor,
            inverse: bool = False) -> torch.Tensor:
    """Unscaled transform along the last axis (no 1/N factor on inverse)."""
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x
    if log_n > HF._MAX_ROW_LOG and x.dim() > 2:
        return _each_line(fs, x, lambda v: HF.ntt_hopper_raw(fs, v, inverse))
    if not x.is_cuda:
        return HF.ntt_rows_plain(fs, x, inverse)
    if log_n <= HF._MAX_ROW_LOG:
        rows = x.reshape(fs.nl, -1, n)
        return HF.ntt_rows_hopper(fs, rows, inverse).reshape(x.shape)
    return HF.ntt_hopper_raw(fs, x, inverse)


def ntt(fs: FieldSpec, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Forward: coefficients -> evaluations on the radix-2 domain (natural
    order: index i holds f(w^i)). Inverse: evaluations -> coefficients.
    Transform along the last axis of (NL, *batch, N), any N = 2^k, on
    either device."""
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x
    if log_n > HF._MAX_ROW_LOG and x.dim() > 2:
        return _each_line(fs, x, lambda v: HF.ntt_hopper(fs, v, inverse))
    if x.is_cuda and x.dim() == 2:
        return HF.ntt_hopper(fs, x, inverse)
    y = ntt_raw(fs, x, inverse)
    if not inverse:
        return y
    return L.mont_mul(fs, y, L.const_mont(fs, get_plan(fs, log_n).n_inv,
                                          (1,) * (y.dim() - 1), x.device))


def sum_reduce(fs: FieldSpec, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Modular sum along an axis by log-depth halving; a length that is not
    a power of two is padded with zeros."""
    if axis < 0:
        axis = x.dim() + axis
    n = x.shape[axis]
    m = 1 << (n - 1).bit_length() if n > 1 else 1
    if m != n:
        pad = list(x.shape)
        pad[axis] = m - n
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)],
                      dim=axis)
    while m > 1:
        m //= 2
        x = L.add(fs, x.narrow(axis, 0, m), x.narrow(axis, m, m))
    return x.squeeze(axis)


@functools.lru_cache(maxsize=64)
def _coset_powers(fs: FieldSpec, gg: int, n: int, device: str):
    return L.powers(fs, gg, n, device)


def coset_scale(fs: FieldSpec, coeffs: torch.Tensor, g: int,
                inverse: bool = False) -> torch.Tensor:
    """Multiply coefficient i by g^i (or g^-i): maps evals on D to evals on
    g*D. The power table is built once per (field, g, n, device)."""
    n = coeffs.shape[-1]
    gg = pow(g, -1, fs.p) if inverse else (g % fs.p)
    pw = _coset_powers(fs, gg, n, str(coeffs.device))
    pw = pw.reshape(pw.shape[:1] + (1,) * (coeffs.dim() - 2) + (n,))
    return L.mont_mul(fs, coeffs, pw)


def coset_ntt(fs: FieldSpec, coeffs: torch.Tensor, g: int) -> torch.Tensor:
    """Evaluate on the coset g*D (where the vanishing polynomial of D is a
    nonzero constant)."""
    return ntt(fs, coset_scale(fs, coeffs, g), inverse=False)


def coset_intt(fs: FieldSpec, evals: torch.Tensor, g: int) -> torch.Tensor:
    return coset_scale(fs, ntt(fs, evals, inverse=True), g, inverse=True)


def divide_by_vanishing(fs: FieldSpec, coeffs: torch.Tensor,
                        n_rows: int) -> torch.Tensor:
    """T = F / (x^n - 1) for F known divisible by the vanishing polynomial:
    F evaluated on the coset g*D_m (where Z never vanishes), one batched
    inverse of Z(g w^i) = g^n w^(i n) - 1, and back. coeffs: (NL, m) with
    m > n_rows a power of two, on either device; returns (NL, m)
    coefficients of T (the top n_rows are zero)."""
    m = coeffs.shape[-1]
    assert m > n_rows and m & (m - 1) == 0
    g = fs.generator
    dev = coeffs.device
    ev = coset_ntt(fs, coeffs, g)
    wn = pow(get_plan(fs, _log2(m)).omega, n_rows, fs.p)
    zv = L.mont_mul(fs, L.powers(fs, wn, m, dev),
                    L.const_mont(fs, pow(g, n_rows, fs.p), (1,), dev))
    zv = L.sub(fs, zv, L.ones_mont(fs, (m,), dev))
    t_ev = L.mont_mul(fs, ev, L.batch_inverse(fs, zv, axis=1))
    return coset_intt(fs, t_ev, g)
