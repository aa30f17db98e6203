"""Compile the CUDA kernels for the CPU and run them there.

    from crypto3_zk_tpu_torch.tools import host_kernels
    entry = host_kernels.entry("zk_inv_scans")     # a ctypes function

Each source under `csrc/` is rewritten (only its `<<<...>>>` launches, into
`host_launch(...)`), compiled by `g++ -std=c++20` against the stand-in
`csrc/host/cuda_runtime.h` into `build/crypto3_zk_tpu_torch/host/`, and bound
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


def _build(source: str) -> ctypes.CDLL:
    out_dir = K.build_dir() / "host"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = rewrite_launches((K.CSRC / source).read_text())
    tag = hashlib.sha1(
        (K.CSRC / "field.cuh").read_bytes()
        + (K.CSRC / "host" / "cuda_runtime.h").read_bytes()
        + text.encode()).hexdigest()[:12]
    stem = source.rsplit(".", 1)[0]
    lib = out_dir / f"lib{stem}-{tag}.so"
    if not lib.exists():
        cpp = out_dir / f"{stem}-{tag}.cpp"
        cpp.write_text(text)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            [compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-I", str(K.CSRC / "host"), "-I", str(K.CSRC), "-o", str(tmp),
             str(cpp)], check=True)
        os.replace(tmp, lib)
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in K.SOURCES[source].items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def entry(name: str):
    """The C entry point `name`, compiled for the CPU at first use."""
    source = next(s for s, entries in K.SOURCES.items() if name in entries)
    if source not in _libs:
        _libs[source] = _build(source)
    return getattr(_libs[source], name)
