"""The import guard: no run loads a module whose top-level name is `jax`,
`jaxlib`, `flax` or `crypto3_zk_tpu` (names compared whole, so the port
`crypto3_zk_tpu_torch` is allowed), and the reference loads nothing of the
port either."""
import ast
import pathlib
import subprocess
import sys

from zkbench import harness

HERE = pathlib.Path(__file__).resolve().parent.parent


def test_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxtyping", "crypto3_zk_tpu",
             "crypto3_zk_tpu.ops", "crypto3_zk_tpu_torch", "flax.linen",
             "jaxlib", "flaxen"]
    assert harness.banned_modules(names) == [
        "crypto3_zk_tpu", "crypto3_zk_tpu.ops", "flax.linen", "jax",
        "jax.numpy", "jaxlib"]


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(harness.BANNED), path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert not _imports(path) & set(harness.BANNED
                                        + ("crypto3_zk_tpu_torch", "torch")), \
            path


def test_a_run_and_its_judgement_load_no_banned_module():
    """A whole run on the CPU in a fresh process, then its loaded modules;
    and the reference's judgement alone loads nothing of the port."""
    script = (
        "import sys, time; sys.path.insert(0, sys.argv[1])\n"
        "from zkbench import harness\n"
        "r = harness.run_cell('groth16_bn254.c16', 5, 0.1, False,\n"
        "    time.perf_counter(), device='cpu', circuit={'constraints': 14},\n"
        "    log=lambda m: None)\n"
        "assert r['correct'], r\n"
        "print(harness.banned_modules())\n"
        "from zkbench.systems import groth16\n"
        "from zkbench.reference import groth16 as ref, placeholder\n")
    out = subprocess.run([sys.executable, "-c", script, str(HERE.parent)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import zkbench.reference.placeholder, zkbench.reference.groth16\n"
        "from zkbench.reference import bn254\n"
        "assert bn254.g1_mul(bn254.G1, bn254.R) is None\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "      & {'torch', 'crypto3_zk_tpu_torch', 'jax', 'crypto3_zk_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", script, str(HERE.parent)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
