"""Build and load the hand-written CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with `ctypes`; the
builds of all sources start together. Nothing is built when the module is
imported: the first kernel launch (or an explicit `build_all()`) does it.
Libraries are named by a hash of their source and of every header
(`*.cuh`), so a stale build is never loaded.

Every C entry point returns `cudaGetLastError()`; `check` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ELEMENTWISE = [_I, _P, _P, _P, _P, _LL, _LL, _LL, _P, _P, _P]
_SCALAR_MUL = [_I, _P, _P, _P, _LL, _P, _LL, _I, _P]

# source file -> {entry point: argtypes}
SOURCES: dict[str, dict[str, list]] = {
    "mont_mul.cu": {"zk_mont_mul": _ELEMENTWISE, "zk_add": _ELEMENTWISE,
                    "zk_sub": _ELEMENTWISE},
    "ntt_rows.cu": {"zk_ntt_rows": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                                    _I, _I, _I, _P]},
    "inv_scans.cu": {"zk_inv_scans": [_I, _P, _P, _P, _P, _P, _I, _LL, _I, _P],
                     "zk_inv_tail": [_I, _P, _P, _P, _I, _P]},
    "mul3.cu": {"zk_mul3": [_I, _P, _P, _P, _P, _P, _I, _LL, _P]},
    "poseidon.cu": {"zk_poseidon_permute": [_I, _P, _P, _P, _P, _P, _P, _LL,
                                            _I, _P],
                    "zk_poseidon_tree": [_I, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _P]},
    "scalar_mul.cu": {"zk_scalar_mul_g1": _SCALAR_MUL,
                      "zk_scalar_mul_g1_shape": [_I, _P]},
    "scalar_mul_g2.cu": {"zk_scalar_mul_g2": _SCALAR_MUL,
                         "zk_scalar_mul_g2_shape": [_I, _P]},
    "sha256.cu": {"zk_sha256_blocks": [_P, _LL, _I, _P, _P, _P],
                  "zk_sha256_nodes": [_P, _LL, _P, _P, _P]},
    "sha256_leaf.cu": {"zk_sha256_field_rows": [_P, _LL, _I, _I, _LL, _LL,
                                                _P, _P, _P]},
    "mxu_ntt.cu": {"zk_mxu_pass": [_I, _P, _P, _P, _P, _P, _P, _P, _P]},
    # measurement loops, no kernel of a path (`chip_smoke.py` reads the
    # card's integer multiply-add rate and its shift / IMAD.HI streams)
    "rate.cu": {"zk_imad_rate": [_P, _I, _I, _I, _P],
                "zk_int_rate": [_I, _P, _I, _I, _I, _I, _P]},
}

_entry_points: dict[str, object] = {}


def build_dir() -> pathlib.Path:
    """`build/crypto3_zk_tpu_torch/` beside the package."""
    return _PKG.parent / "build" / _PKG.name


def headers() -> bytes:
    """The bytes of every header under `csrc/`, for the libraries' hash."""
    return b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_all(verbose: bool = False) -> float:
    """Compile every source that has no current library (all `nvcc` runs
    start together), load them and bind the entry points. Returns the
    seconds spent; 0.0 when everything was loaded already."""
    if _entry_points:
        return 0.0
    t0 = time.perf_counter()
    build_dir().mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for src in SOURCES:
        path = CSRC / src
        lib = library(src)
        libs[src] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-Xptxas=-v", "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o",
               str(tmp), str(path)]
        procs.append((src, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        if verbose and log:
            print(log)
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src, lib in libs.items():
        dll = ctypes.CDLL(str(lib))
        for name, argtypes in SOURCES[src].items():
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entry_points[name] = fn
    return time.perf_counter() - t0


def library(src: str) -> pathlib.Path:
    """The path of the current library of `src` (`build_all` makes it)."""
    tag = hashlib.sha1(headers() + (CSRC / src).read_bytes()).hexdigest()[:12]
    return build_dir() / f"lib{pathlib.Path(src).stem}-{tag}.so"


def build_log(src: str) -> str:
    """What `nvcc` and `ptxas -v` printed when the current library of
    `src` was built (registers, spills), or "" if it was not kept."""
    log = library(src).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def entry(name: str):
    """The bound C entry point `name`, building the kernels at first use."""
    if not _entry_points:
        build_all()
    return _entry_points[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch "
                           f"(cudaError {code})")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


# digits of the fields that have a kernel instance (`csrc/field.cuh`): 4
# (Goldilocks, p may fill its top word), 16 and 24 (p below 2^(32*NW - 1)),
# and 19 (the MNT4/MNT6 scalar fields, R = 2^304, a half top word)
INSTANCE_DIGITS = (4, 16, 19, 24)


def words(nl: int) -> int:
    """32-bit words the kernels hold a field element of `nl` digits in."""
    return (nl + 1) // 2


def fuse_words(digits):
    """(NL, ...) 16-bit digits (a numpy array) -> (NW, ...) uint32 words,
    digit pairs fused; an odd count's top word has its low digit only."""
    import numpy as np
    d = np.asarray(digits).astype(np.uint32)
    if d.shape[0] % 2:
        d = np.concatenate([d, np.zeros_like(d[:1])])
    return d[0::2] | (d[1::2] << 16)


def field_consts(fs):
    """The field's constants as the kernels take them: NW words of p, NW
    words of R mod p and -p^-1 mod 2^32, as a host `uint32` array. Cached on
    the `FieldSpec`. A field that no instance covers is refused."""
    cached = fs.__dict__.get("_kernel_consts")
    if cached is None:
        if fs.nl not in INSTANCE_DIGITS:
            raise ValueError(
                f"{fs.name}: no kernel instance for {fs.nl} 16-bit digits "
                f"(instances: {INSTANCE_DIGITS})")
        nw = words(fs.nl)
        if fs.nl in (16, 24) and fs.p.bit_length() > 32 * nw - 1:
            raise ValueError(
                f"{fs.name}: the {nw}-word instance's carry chains need the "
                f"top bit of the top word free, and p has "
                f"{fs.p.bit_length()} bits")
        mask = (1 << 32) - 1
        vals = [(fs.p >> (32 * j)) & mask for j in range(nw)]
        vals += [(fs.R_mod_p >> (32 * j)) & mask for j in range(nw)]
        vals.append((-pow(fs.p, -1, 1 << 32)) % (1 << 32))
        cached = (nw, (ctypes.c_uint32 * len(vals))(*vals))
        object.__setattr__(fs, "_kernel_consts", cached)
    return cached
