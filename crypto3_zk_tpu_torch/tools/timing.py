"""What the timing tools share (`poseidon_times.py`, `sha256_times.py`,
`mxu_pass_times.py`), and what `chip_smoke.py` reads of it: the card's
name and power limit, `nvcc` builds started all at once, `ptxas -v`'s
registers and spills by kernel, the device time of queued launches, and
the rates of `csrc/rate.cu`'s integer streams. `ptxas_table` and `bind`
run anywhere; the rest needs a CUDA device (`nvcc_all` its toolkit).
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import time

import torch

from .. import kernels as K
from . import sass_mix as SM

# `zk_int_rate`'s modes (csrc/rate.cu), in its order
STREAMS = ("shf", "imad", "shf_imad_hi", "imad_lo", "imad_hi", "shf_imad_lo",
           "lop3", "shf_lop3", "lop3_imad_lo", "iadd3", "iadd3_imad_lo")


def card_name() -> str:
    """The card's name and power limit, as `nvidia-smi` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def nvcc_all(jobs: list, meanwhile=None) -> dict:
    """{name: (library, ptxas log)} of `jobs`, a list of (name, source,
    library, extra nvcc arguments): every `nvcc` run started at once, for
    sm_90a with `-Xptxas=-v` and the source's directory on the include
    path; `meanwhile()`, if given, runs while they compile."""
    procs, t0 = [], time.perf_counter()
    for name, src, lib, extra in jobs:
        pathlib.Path(lib).parent.mkdir(parents=True, exist_ok=True)
        cmd = [K._nvcc(), "-Xptxas=-v", "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", *extra, "-I",
               str(pathlib.Path(src).parent), "-o", str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    if meanwhile is not None:
        meanwhile()
    built = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s (all "
              f"builds started together)", flush=True)
        built[name] = (lib, log)
    return built


def bind(lib, entries: dict) -> dict:
    """{entry: the library's function, typed}: `entries` maps each name to
    its argument types (as `kernels.SOURCES` does); every entry returns an
    int."""
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for entry, argtypes in entries.items():
        fn = getattr(cdll, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return fns


def ptxas_table(log: str, key_of) -> dict:
    """`ptxas -v` output -> {key_of(function): {"registers", "spill_stores",
    "spill_loads", "stack_frame"}} for every function whose mangled name
    `key_of` maps to a key (None: not wanted)."""
    out, key = {}, None
    for line in log.splitlines():
        f = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([^ ']+)", line)
        if f:
            key = key_of(f.group(1))
            if key is not None:
                out.setdefault(key, {})
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[key]["spill_stores"] = int(m.group(1))
            out[key]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[key]["stack_frame"] = int(m.group(1))
    return out


def sample_ms(launch, n_sets: int, reps: int, queued: bool = True) -> float:
    """Mean ms of `reps` calls of `launch(i)`, `i` cycling over the input
    sets. Queued behind a spin kernel (lengthened until it outlasts the
    host's enqueueing) it is device time; else the host's launches are in
    it."""
    launch(0)
    torch.cuda.synchronize()
    spin = 20_000_000 if queued else 0
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(spin)
        start.record()
        for r in range(reps):
            launch(r % n_sets)
        end.record()
        held = not queued or not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        spin *= 4
    raise RuntimeError("the stream drained during a timed loop")


def int_rates(streams=STREAMS, reps: int = 5) -> dict:
    """Lane-instructions a second of `zk_int_rate`'s `streams` (8 blocks of
    256 threads an SM): of the stream's 128 steps a trip (`per_s`) and of
    the instructions its loop body has in the SASS (`sass_per_s`), the
    median of `reps` launches; and each loop's SASS, one trip."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 8 * sms, 256, 2048
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    fn = K.entry("zk_int_rate")
    loops = {}
    for kernel, ins in SM.disassemble(str(K.library("rate.cu"))).items():
        m = re.search(r"int_loop_kernelILi(\d+)E", kernel)
        if m and STREAMS[int(m.group(1))] in streams:
            loops[STREAMS[int(m.group(1))]] = SM.mix(ins, 1)
    rates, sass_rates = {}, {}
    for name in streams:
        def launch(_, mode=STREAMS.index(name)):
            K.check(fn(mode, out.data_ptr(), blocks, threads, iters,
                       0x9E3779B1 - (1 << 32), K.stream_ptr()),
                    "zk_int_rate")
        times = sorted(sample_ms(launch, 1, 1, queued=False)
                       for _ in range(reps))
        trips = blocks * threads * iters / (times[reps // 2] * 1e-3)
        rates[name] = trips * 16 * 8
        # what the loop body really issues a trip (a stream step may
        # compile to more than one instruction)
        sass_rates[name] = trips * loops[name]["loop_body"]
    return {"per_s": rates, "sass_per_s": sass_rates,
            "loop_trip_sass": loops}
