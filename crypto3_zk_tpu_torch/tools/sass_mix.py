"""A kernel's instruction mix from its SASS, and the issue-rate floor it sets.

    python3 -m crypto3_zk_tpu_torch.tools.sass_mix [--kernel sha256_blocks_kernel] [--trips 5]

`cuobjdump -sass` of a built library (`kernels.py`) lists each kernel's
instructions. This module counts them by the pipe that executes them on a
Hopper SM, with a loop's body counted once a trip (the one backward branch
of the kernel; where a kernel has more loops, each is given its count):

- `fma`: the IMAD forms (IMAD, IMAD.MOV, IMAD.IADD, IMAD.SHL, IMAD.WIDE,
  ...) and IMUL, issued to the FMA pipe;
- `alu`: every other vector integer and logic instruction (LOP3, IADD3,
  SHF, LEA, SEL, ISETP, PRMT, MOV, ...), issued to the integer ALU pipe;
- `mem`: loads, stores and constant loads (LDG, STG, LDC, LDS, ...);
- `uniform`: instructions of the uniform datapath (U...), one a warp;
- `control`: branches, barriers, EXIT, S2R and the like.

The floor of a launch is the largest of three times, each over the card's
SMs at its highest SM clock (`nvidia-smi --query-gpu=clocks.max.sm`): the
`alu` lanes at 64 a clock an SM, the `fma` lanes at 64 a clock an SM, and
all the instructions at the four schedulers' issue rate, 4 warps (128
lanes) a clock an SM (CUDA C++ Programming Guide, arithmetic instruction
throughput, compute capability 9.0).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_MEM = ("LDG", "STG", "LDC", "LDS", "STS", "LD", "ST", "LDL", "STL", "ATOM",
        "RED", "LDGSTS")
_CONTROL = ("BRA", "EXIT", "BSSY", "BSYNC", "BAR", "S2R", "CS2R", "RET",
            "CALL", "WARPSYNC", "NOP", "YIELD", "DEPBAR", "MEMBAR", "ERRBAR",
            "CCTL", "BPT", "JMP", "BREAK")
LANES_ALU = 64          # integer ALU lanes a clock an SM
LANES_FMA = 64          # IMAD lanes a clock an SM
LANES_ISSUE = 128       # 4 schedulers x one warp instruction a clock


def pipe(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base.startswith("U"):
        return "uniform"
    if base in ("IMAD", "IMUL"):
        return "fma"
    if base in _MEM:
        return "mem"
    if base in _CONTROL:
        return "control"
    return "alu"


def parse(text: str) -> dict[str, list[tuple[int, str, str]]]:
    """{mangled kernel name: [(address, opcode, operands), ...]} of every
    kernel in `cuobjdump -sass` output, NOPs dropped."""
    out: dict[str, list] = {}
    current = None
    for line in text.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            out[current] = []
            continue
        m = _LINE.search(line)
        if current is None or m is None or m.group(2) == "NOP":
            continue
        out[current].append((int(m.group(1), 16), m.group(2),
                             m.group(3).strip()))
    return out


def disassemble(library: str) -> dict[str, list[tuple[int, str, str]]]:
    """`parse` of `cuobjdump -sass` of a shared library (the toolkit's
    `cuobjdump`, beside `nvcc`)."""
    import pathlib

    from .. import kernels as K
    cuobjdump = str(pathlib.Path(K._nvcc()).with_name("cuobjdump"))
    return parse(subprocess.run([cuobjdump, "-sass", library],
                                capture_output=True, text=True,
                                check=True).stdout)


def loops(instructions: list[tuple[int, str, str]]) -> list[tuple[int, int]]:
    """(start, end) address of each loop, in order of its start: a backward
    branch and its target; a branch to itself (the end of a kernel) is not
    a loop."""
    found = set()
    for addr, op, operands in instructions:
        if op.startswith("BRA"):
            target = re.search(r"0x([0-9a-f]+)", operands)
            if target and int(target.group(1), 16) < addr:
                found.add((int(target.group(1), 16), addr))
    return sorted(found)


def mix(instructions: list[tuple[int, str, str]], trips) -> dict:
    """Instructions a thread runs, by pipe. `trips` is an int, the number of
    times the body of the kernel's one loop runs, or a list with one count
    a loop in the order `loops` gives (a loop's body in all, in one thread:
    an inner loop's count is not multiplied by its outer loop's); each
    instruction counts as often as the innermost loop that holds it."""
    spans = loops(instructions)
    if isinstance(trips, int):
        if len(spans) > 1:
            raise ValueError(f"{len(spans)} loops: give a count for each")
        if trips > 1 and not spans:
            raise ValueError("no loop to run more than once")
        trips = [trips] * len(spans)
    if len(trips) != len(spans):
        raise ValueError(f"{len(spans)} loops, {len(trips)} counts")
    counts = {"alu": 0, "fma": 0, "mem": 0, "uniform": 0, "control": 0}
    opcodes: dict[str, int] = {}
    for addr, op, _ in instructions:
        inner = [(end - start, t) for (start, end), t in zip(spans, trips)
                 if start <= addr <= end]
        n = min(inner)[1] if inner else 1
        counts[pipe(op)] += n
        base = op.split(".")[0]
        opcodes[base] = opcodes.get(base, 0) + n
    counts["total"] = sum(counts.values())
    counts["loop_body"] = sum(1 for a, _, _ in instructions
                              if any(s <= a <= e for s, e in spans))
    counts["top_opcodes"] = dict(sorted(opcodes.items(),
                                        key=lambda kv: -kv[1])[:8])
    return counts


def floor_ms(per_thread: dict, threads: int, sms: int,
             clock_hz: float) -> tuple[float, str]:
    """(ms, what bounds it) for `threads` threads of the mix."""
    cands = {"alu": per_thread["alu"] / LANES_ALU,
             "fma": per_thread["fma"] / LANES_FMA,
             "issue": per_thread["total"] / LANES_ISSUE}
    by = max(cands, key=cands.get)
    return cands[by] * threads / sms / clock_hz * 1e3, by


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def kernel_mix(source: str, kernel: str, trips) -> dict:
    """The mix of `kernel` (a substring of its mangled name) in the current
    library of `source` (built by `kernels.build_all`)."""
    from .. import kernels as K
    lib = K.library(source)
    found = [v for k, v in disassemble(str(lib)).items() if kernel in k]
    if len(found) != 1:
        raise ValueError(f"{kernel}: {len(found)} matches in {lib}")
    return mix(found[0], trips)


def main(argv=None) -> int:
    import torch

    from .. import kernels as K
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="sha256.cu")
    ap.add_argument("--kernel", default="sha256_blocks_kernel")
    ap.add_argument("--trips", type=int, default=1)
    ap.add_argument("--threads", type=int, default=1 << 18)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sass_mix: no CUDA device")
    K.build_all()
    per = kernel_mix(args.source, args.kernel, args.trips)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms, by = floor_ms(per, args.threads, sms, max_sm_clock_hz())
    print(json.dumps({"kernel": args.kernel, "per_thread": per,
                      "floor_ms": ms, "floor_by": by}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
