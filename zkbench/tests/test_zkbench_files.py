"""Every workload, configuration and metric file loads by its name, and
`BENCHMARK.json` agrees with them; a cell and a metric added as files are
found with no other file of the harness edited."""
import json
import re
import shutil
import subprocess
import sys

from zkbench import harness

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_cells_and_configs_load_by_name():
    names = {c["name"] for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        w = harness.load_json("workloads", cell["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert w[key] == cell[key], (cell["name"], key)
        assert w["config"] in names
        c = harness.load_json("configs", w["config"])
        assert harness.system_module(c["system"]).Service
    for entry in BENCH["configs"]:
        c = harness.load_json("configs", entry["name"])
        assert entry["file"] == f"zkbench/configs/{entry['name']}.json"
        assert entry["source"] == c["source"]
        assert entry["reduced"] == c["reduced"]
        assert all(key in c for key in c["reduced"])
        assert c["limits"]


def test_every_metric_has_a_reader_and_its_cells_exist():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_each_cell_reports_what_its_layer_metrics_move():
    """Every cell reports `setup_s`, another end-to-end metric and a
    per-layer one, and every per-layer metric's cells report the
    end-to-end metric that it moves."""
    for cell in (w["name"] for w in BENCH["workloads"]):
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
        layer = harness.cell_metrics(BENCH, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, cell
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


def test_a_metric_split_by_cell_reads_as_its_original():
    run = harness.Run({}, {}, 0, 1.0, 6.0, [1.0, 2.0, 3.0], None, {})
    for m in BENCH["per_layer"]:
        base, _, part = m["name"].partition(".")
        if part and (harness.HERE / "metrics" / f"{base}.py").exists():
            assert harness.metric_module(m["name"]).read(run) == \
                harness.metric_module(base).read(run)


def test_benchmark_json_keeps_its_format_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["zkbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for group in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in BENCH[group]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [x["name"] for x in BENCH[group]]
        assert len(group_names) == len(set(group_names))
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m and len(m["layer"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    """Copy the benchmark, add a cell, a traffic of its own and a metric as
    new files (and their entries in BENCHMARK.json), and let the copy's
    harness find them by name."""
    shutil.copytree(ROOT / "zkbench", tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cell = json.loads((ROOT / "zkbench/workloads/groth16_bn254.c16.json")
                      .read_text())
    cell.update(name="groth16_bn254.c10", traffic="c10",
                why="a dummy cell for the test")
    cell["circuit"]["constraints"] = 1022
    (tmp_path / "zkbench/workloads/groth16_bn254.c10.json").write_text(
        json.dumps(cell))
    (tmp_path / "zkbench/metrics/dummy_count.py").write_text(
        "def read(run):\n    return len(run.proof_seconds)\n")
    bench["workloads"].append({k: cell[k] for k in ("name", "config",
                                                    "traffic", "chips",
                                                    "why")})
    bench["per_layer"].append({"name": "dummy_count", "unit": "proofs",
                               "better": "higher", "source": "host_clock",
                               "layer": "prover service", "moves": "proof_s",
                               "workloads": ["groth16_bn254.c10"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p.relative_to(ROOT / "zkbench"): p.read_bytes()
              for p in (ROOT / "zkbench").rglob("*.py")}
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from zkbench import harness\n"
        "b = harness.load_benchmark()\n"
        "w = harness.load_json('workloads', 'groth16_bn254.c10')\n"
        "ms = [m['name'] for m in harness.cell_metrics(b, w['name'], True)]\n"
        "run = harness.Run({}, w, 0, 1.0, 2.0, [1.0, 1.0], None, {})\n"
        "print(w['circuit']['constraints'], ms,\n"
        "      harness.metric_module('dummy_count').read(run))\n")
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         capture_output=True, text=True, check=True,
                         cwd=tmp_path).stdout
    assert "1022" in out and "dummy_count" in out and out.strip()[-1] == "2"
    for rel, data in before.items():
        assert (tmp_path / "zkbench" / rel).read_bytes() == data
