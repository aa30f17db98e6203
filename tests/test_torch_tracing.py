"""The port's span layer (`utils/profiling.py`), on the CPU: off, entering a
span (or a function under `spanned`) opens no profiler range; on, under a
CPU `torch.profiler`, the product-chain proof of `test_torch_groth16.py`
opens the documented `zk.*` spans in the documented nesting; and the proof made with spans on is
the proof made with them off. (Placeholder's spans are checked by
`zkbench/tests/test_zkbench_spans.py` on each benchmark cell at a small
size, and the mesh test proves its single-device proof with spans on.)"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crypto3_zk_tpu_torch.arithmetization import r1cs as TR
from crypto3_zk_tpu_torch.fields import curves as TCV
from crypto3_zk_tpu_torch.models import groth16 as TG16
from crypto3_zk_tpu_torch.utils import profiling as PR
from test_torch_groth16 import NCONS, TOXIC, ZK_RS, product_chain

import torch_threads  # noqa: F401  one torch thread a worker

PROVE = "zk.groth16.prove"
MSMS = [f"zk.groth16.msm.{q}" for q in ("A", "B1", "B2", "H", "L")]


class _Counting:
    """A stand-in for `torch.profiler.record_function` that counts."""
    made = 0

    def __init__(self, name):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_spans_off_open_no_profiler_range(monkeypatch):
    monkeypatch.setattr(_Counting, "made", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)

    @PR.spanned("zk.test.call")
    def call(x, y=0):
        """A spanned function."""
        return x + y

    assert not PR._ON
    with PR.span("zk.test.outer"), PR.span("zk.test.inner"):
        assert call(1, y=2) == 3
    assert _Counting.made == 0
    with pytest.raises(ValueError), PR.spans_on():
        with PR.span("zk.test.outer"), PR.span("zk.test.inner"):
            assert call(1) == 1
            raise ValueError
    assert _Counting.made == 3 and not PR._ON
    assert call.__name__ == "call" and call.__doc__ == "A spanned function."


def _nested(events) -> list[tuple[str, str | None]]:
    """(name, parent name) of the `zk.*` ranges, in start order."""
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events if e.name().startswith("zk.")),
                   key=lambda s: (s[1], -s[2]))
    out, stack = [], []
    for name, a, b in spans:
        while stack and not (stack[-1][1] <= a and b <= stack[-1][2]):
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, a, b))
    return out


@pytest.fixture(scope="module")
def traced():
    """The product chain's proof made under a CPU profiler with spans on,
    and made again with spans off."""
    cs, primary, aux = product_chain(TR, TCV.ALT_BN128.fr.p, NCONS)
    kp = TG16.generate(TCV.ALT_BN128, cs, toxic=TOXIC, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof, PR.spans_on():
        on = TG16.prove(kp.pk, primary, aux, zk_rs=ZK_RS, device="cpu")
    off = TG16.prove(kp.pk, primary, aux, zk_rs=ZK_RS, device="cpu")
    return _nested(prof.profiler.kineto_results.events()), on, off


def test_groth16_spans_nest_as_documented(traced):
    nested, _, _ = traced
    top = [n for n, parent in nested if parent is None]
    assert top == [PROVE]
    under_prove = [n for n, parent in nested if parent == PROVE]
    assert under_prove == ["zk.groth16.witness_map", *MSMS,
                           "zk.groth16.assembly"]
    parents = {n: parent for n, parent in nested}
    assert parents["zk.limbs.encode"] == "zk.groth16.witness_map"
    assert parents["zk.limbs.decode"] == "zk.groth16.witness_map"
    assert {n for n, _ in nested} <= {
        PROVE, "zk.groth16.witness_map", *MSMS,
        "zk.groth16.assembly", "zk.limbs.encode", "zk.limbs.decode"}


def test_proof_is_the_same_with_spans_on_and_off(traced):
    _, on, off = traced
    assert (on.g_A, on.g_B, on.g_C) == (off.g_A, off.g_B, off.g_C)
    assert on.g_A is not None and on.g_C is not None
