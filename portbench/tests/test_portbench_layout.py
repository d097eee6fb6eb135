"""BENCHMARK.json against the contract's shape, every part found by name,
a part added by a file alone, and the last line of a run."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness, loop, run

from conftest import CHECKOUT, CPU_DEVICES, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"] == f"portbench/configs/{c['name']}.json"
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.loads((CHECKOUT / c["file"]).read_text())["reduced"] == c["reduced"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert any(m["name"] != "setup_s" for m in harness.metrics_of(BENCH, w["name"],
                                                                       "end_to_end"))
        assert harness.metrics_of(BENCH, w["name"], "per_layer")
    assert len(cells) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_part_of_a_cell_found_by_name(cell):
    c = loop.Cell(BENCH, cell)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["name"] == c.workload["traffic"]
    assert harness.program_path(c.config["program"]).is_file()
    assert hasattr(c.reference, "sweep") and c.system_cls.__name__ == "System"
    assert c.config["chips"] == c.workload["chips"] == len(c.devices)
    for m in harness.metrics_of(BENCH, cell, "per_layer"):
        assert callable(harness.load_module("layers", m["name"]).read)


def test_a_missing_part_fails_loudly():
    with pytest.raises(harness.MissingPart, match="no traffic named 'nowhere'"):
        harness.load_json("traffic", "nowhere")
    with pytest.raises(harness.MissingPart, match="no layers named"):
        harness.load_module("layers", "nothing.here")
    with pytest.raises(harness.MissingPart, match="no workload"):
        harness.find_cell(BENCH, "no.such-cell")


def test_an_added_file_is_found_without_editing(tmp_path, monkeypatch):
    # a copy of the benchmark's folder with one more traffic mix and one
    # more layer reader, and a cell that names them
    root = tmp_path / "portbench"
    shutil.copytree(CHECKOUT / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((root / "traffic" / "loop.json").read_text())
    mix.update(name="loop-16", block_sweeps=16)
    (root / "traffic" / "loop-16.json").write_text(json.dumps(mix))
    (root / "layers" / "sweeps_a_block.loop").mkdir()      # a stray folder is ignored
    (root / "layers" / "blocks_seen.loop.py").write_text(
        "def read(t):\n    return 42.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "jacobi3d-512.loop16", "config": "jacobi3d-512",
                               "traffic": "loop-16", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "blocks_seen.loop", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "kernel",
                               "moves": "gcells_per_s", "workloads": ["jacobi3d-512.loop16"]})
    monkeypatch.setattr(harness, "HERE", root)
    cell = loop.Cell(bench, "jacobi3d-512.loop16", grid=TINY, devices=["cpu"])
    assert cell.traffic["block_sweeps"] == 16
    got = loop.run(cell, 5, 0.05, False, 0.0, lambda *a: None)
    assert got["window"].sweeps % 16 == 0 and all(c["cells_off"] == 0
                                                   for c in got["checks"].values())
    names = [m["name"] for m in harness.metrics_of(bench, cell.name, "per_layer")]
    assert names == ["blocks_seen.loop"]
    assert harness.load_module("layers", "blocks_seen.loop").read(None) == 42.0


@pytest.mark.parametrize("change,match", [({"loop": "open"}, "runs only loop 'closed'"),
                                          ({"callers": 4}, "runs only callers 1"),
                                          ({"warm_blocks": 1}, "warm_blocks")])
def test_a_traffic_the_loop_does_not_run_is_refused(tmp_path, monkeypatch, change, match):
    root = tmp_path / "portbench"
    shutil.copytree(CHECKOUT / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((root / "traffic" / "loop.json").read_text())
    mix.update(name="other", **change)
    (root / "traffic" / "other.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "jacobi3d-512.other", "config": "jacobi3d-512",
                               "traffic": "other", "chips": 1, "why": "a test"})
    monkeypatch.setattr(harness, "HERE", root)
    with pytest.raises(ValueError, match=match):
        loop.Cell(bench, "jacobi3d-512.other", grid=TINY, devices=["cpu"])


def test_held_bytes_count_each_storage_once():
    import torch

    a = torch.zeros(10, dtype=torch.float32)
    b = torch.zeros(6, dtype=torch.float64)

    class Sharded:
        shards = {(0,): a[2:], (1,): b}

    assert loop.held_bytes([a, None, a[:3], Sharded()]) == {"cpu": 40 + 48}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CPU_DEVICES))
def test_the_last_lines_keys(cell, trace):
    c = loop.Cell(BENCH, cell, grid=TINY, devices=CPU_DEVICES[cell])
    got = loop.run(c, 2**31 + 3, 0.05, bool(trace), 0.0, lambda *a: None)
    out = json.loads(json.dumps(run.result(BENCH, c, got, bool(trace))))
    keys = list(out)
    assert keys[:3] == ["correct", "attempted", "failed"] and keys[-1] == "checks"
    assert {"metrics", "device"} <= set(keys)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(got["memory"]) == {"set-up", "loop", "window", "check holds"}
    assert got["memory"]["check holds"]["cpu"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    want = ({m["name"] for m in harness.metrics_of(BENCH, cell, "end_to_end")} if not trace
            else set())
    assert set(out["metrics"]) >= want
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


ARGS = ("--workload", "jacobi3d-512.loop", "--seed", "7", "--seconds", "1", "--trace", "0")


def test_run_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _run(CHECKOUT, *ARGS)
    assert r.returncode == 2 and r.stdout == ""
    assert "needs 1 CUDA card" in r.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, *ARGS)
    assert r.returncode != 0 and r.stdout == ""
