"""Compile the CUDA kernels for the CPU and run them there.

    from crypto3_zk_tpu_torch.tools import host_kernels
    entry = host_kernels.entry("zk_inv_scans")     # a ctypes function

Each source under `csrc/` is rewritten (only its `<<<...>>>` launches, into
`host_launch(...)`), compiled by `g++ -std=c++20` against the stand-in
`csrc/host/cuda_runtime.h` into `build/crypto3_zk_tpu_torch/host/` (every
source at the first use of any, the compilers running together), and bound
with the same argument types as the real library. The entry points then take
the `data_ptr()` of CPU tensors, and a null stream. What this checks is the
kernels' logic: indexing, strides, shared memory, barriers, and the
arithmetic of `field.cuh` through its host definitions of the carry-chain
functions. It says nothing about what `nvcc` accepts, about races between
warps, or about speed; the port itself never uses it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

from .. import kernels as K

_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;(]*>)?)<<<(.*?)>>>\(", re.S)
_libs: dict[str, ctypes.CDLL] = {}


def rewrite_launches(src: str) -> str:
    """`kernel<<<blocks, threads, smem, stream>>>(args)` ->
    `host_launch(blocks, threads, smem, [&] { kernel(args); })`."""
    out, pos = [], 0
    while True:
        m = _LAUNCH.search(src, pos)
        if not m:
            out.append(src[pos:])
            return "".join(out)
        out.append(src[pos:m.start()])
        depth, end = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[end], 0)
            end += 1
        blocks, threads, smem = [a.strip() for a in m.group(2).split(",")][:3]
        out.append(f"host_launch((long long)({blocks}), (int)({threads}), "
                   f"(size_t)({smem}), [&] {{ {m.group(1)}"
                   f"({src[m.end():end - 1]}); }})")
        pos = end


def compiler() -> str | None:
    return shutil.which("g++")


def _library(source: str):
    """(path of the source's host library, its rewritten text)."""
    text = rewrite_launches((K.CSRC / source).read_text())
    tag = hashlib.sha1(
        (K.CSRC / "field.cuh").read_bytes()
        + (K.CSRC / "host" / "cuda_runtime.h").read_bytes()
        + text.encode()).hexdigest()[:12]
    stem = source.rsplit(".", 1)[0]
    return K.build_dir() / "host" / f"lib{stem}-{tag}.so", text


def build_all() -> None:
    """Compile every source that has no current host library, all `g++`
    runs at once, and load them."""
    (K.build_dir() / "host").mkdir(parents=True, exist_ok=True)
    procs = []
    for source in K.SOURCES:
        lib, text = _library(source)
        if source in _libs or lib.exists():
            continue
        cpp = lib.with_name(lib.name[3:]).with_suffix(".cpp")
        cpp.write_text(text)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((tmp, lib, subprocess.Popen(
            [compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-I", str(K.CSRC / "host"), "-I", str(K.CSRC), "-o", str(tmp),
             str(cpp)])))
    for tmp, lib, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"g++ failed for {lib.name}")
        os.replace(tmp, lib)
    for source in K.SOURCES:
        if source not in _libs:
            dll = ctypes.CDLL(str(_library(source)[0]))
            for name, argtypes in K.SOURCES[source].items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = dll


def entry(name: str):
    """The C entry point `name`, every source compiled for the CPU at the
    first use of any."""
    source = next(s for s, entries in K.SOURCES.items() if name in entries)
    if source not in _libs:
        build_all()
    return getattr(_libs[source], name)
