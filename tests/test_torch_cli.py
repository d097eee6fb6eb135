"""The port's CLI (`soda_tpu_torch/cli/sodac.py`) on the CPU.

`--device cpu` runs every kernel's plain version; the card's run is in
`chip_smoke.py`.  Checks: `--dump-plan` is JSON with the reference's keys
and the kernels' own; `--report` prints the plan report and the knobs
accepted but inert on the card; `--cpp-golden` writes the golden runner,
which g++ compiles and which agrees with the NumPy reference bit for bit
(integers) through `compile_and_run` and as the written binary; `--tcse
-v` logs the adds; `--backend eager|numpy`, `--unroll-iterate` and the
host tiling run and pass; bad flags exit with a message naming the flag;
`--benchmark` is refused before anything runs where it cannot time the
card.  The mesh flags: `--mesh 2,2 --device cpu --run` (and with named
axes, overlap, a cadence, host tiles) run on CPU shards and pass;
`--report --mesh` prints the modeled exchange over the shard's own bytes;
`--benchmark --mesh`, a bad `--link-model` and a mesh the grid cannot hold
are refused.  Tolerance: the CLI's own gate (`compare_outputs`).
"""

import json
import logging
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from soda_tpu_torch.backend import cpp
from soda_tpu_torch.cli import sodac
from soda_tpu_torch.frontend.parser import parse_file
from soda_tpu_torch.utils.testing import compare_outputs, oracle, rand_inputs

ROOT = pathlib.Path(__file__).resolve().parents[1]
SODA = ROOT / "tests" / "soda"


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("the golden runner needs g++")


def _main(capsys, *args):
    rc = sodac.main([str(SODA / args[0]), *args[1:]])
    return rc, capsys.readouterr()


def test_dump_plan_is_json_with_the_reference_keys(capsys, tmp_path):
    rc, out = _main(capsys, "denoise2p.soda", "--grid-shape", "64,256", "--dump-plan")
    assert rc == 0
    j = json.loads(out.out[out.out.index("{"):])
    assert {"program", "grid_shape", "groups", "notes", "ideal_bytes_per_cell",
            "sweeps_total"} <= set(j)
    g = j["groups"][0]
    assert {"stages", "outputs", "external_inputs", "sweeps", "grid",
            "hbm_bytes_per_call", "useful_cells_per_call", "bytes_per_cell_update",
            "kernel", "tile", "bz", "rings", "smem_bytes", "threads", "load", "sync",
            "levels", "slots_per_sm", "waves", "block", "windows", "direct",
            "modeled_seconds"} <= set(g)
    assert g["kernel"] == "linebuffer2d" and g["sweeps"] > 1 and g["rings"]
    path = tmp_path / "plan.json"
    rc, _ = _main(capsys, "smooth1d.soda", "--grid-shape", "300", "--dump-plan", str(path))
    j = json.loads(path.read_text())
    assert rc == 0 and j["groups"][0]["kernel"] == "windows"
    assert j["groups"][0]["block"] and j["groups"][0]["windows"]


def test_report_prints_the_bound_and_the_inert_knobs(capsys):
    rc, out = _main(capsys, "gauss5x5.soda", "--grid-shape", "37,45", "--report",
                    "--unroll-factor", "4", "--dram-out", "1,2")
    assert rc == 0
    text = out.out
    assert "plan report: gauss5x5 (37, 45)" in text and "3.35 TB/s" in text
    assert "accepted-inert: unroll factor 4" in text
    assert "accepted-inert: burst width 512" in text
    assert "accepted-inert: dram channel lists" in text
    assert "v5e" not in text.lower() and "819" not in text


def test_cpp_golden_compiles_and_matches_the_oracle(gxx, capsys, tmp_path):
    src = tmp_path / "golden.cpp"
    rc, out = _main(capsys, "accum64.soda", "--grid-shape", "13,21", "--cpp-golden",
                    str(src), "--xocl-header", str(tmp_path / "k.h"))
    assert rc == 0 and f"wrote C++ golden runner: {src}" in out.out
    p = parse_file(SODA / "accum64.soda")
    assert src.read_text() == cpp.generate(p, (13, 21))
    assert "#define SODA_DIM_1 21" in (tmp_path / "k.h").read_text()
    ins, ps = rand_inputs(p, (13, 21), np.random.default_rng(81))
    gold = oracle(p, ins, ps)
    assert compare_outputs(p, cpp.compile_and_run(p, ins, ps), gold, 0)
    assert compare_outputs(p, cpp.NativeOracle(p, (13, 21)).run(ins, ps), gold, 0)
    # the written source as a binary of its own
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(tmp_path / "golden"),
                    str(src)], check=True, capture_output=True)
    args = [str(tmp_path / "golden")]
    for n in p.input_names:
        ins[n].tofile(tmp_path / f"{n}.bin")
        args.append(str(tmp_path / f"{n}.bin"))
    args += [str(tmp_path / f"{n}.out") for n in p.output_names]
    subprocess.run(args, check=True, capture_output=True)
    got = {n: np.fromfile(tmp_path / f"{n}.out", dtype=gold[n].dtype).reshape(13, 21)
           for n in p.output_names}
    assert compare_outputs(p, got, gold, 0)


def test_tcse_logs_the_adds_and_runs(capsys, caplog):
    caplog.set_level(logging.INFO, logger="soda_tpu_torch")
    rc, out = _main(capsys, "gauss5x5.soda", "--grid-shape", "37,45", "--tcse", "-v",
                    "--device", "cpu", "--run")
    assert rc == 0 and "OK" in out.out and "__cse" in out.out
    assert "tcse: 24 adds -> 8" in caplog.text


@pytest.mark.parametrize("backend", ["eager", "numpy", "cuda"])
def test_backends_run_on_the_cpu(capsys, backend):
    rc, out = _main(capsys, "sobel2d.soda", "--grid-shape", "21,40", "--backend",
                    backend, "--device", "cpu", "--run")
    assert rc == 0 and f"({backend}, cpu)" in out.out
    assert ("OK" in out.out) == (backend != "numpy")


def test_unroll_iterate_and_knob_overrides(capsys):
    rc, out = _main(capsys, "jacobi2d.soda", "--grid-shape", "21,40", "--iterate", "4",
                    "--unroll-iterate", "2", "--device", "cpu", "--run")
    assert rc == 0 and "OK" in out.out and "t1__it0" in out.out
    assert "iterate=2" in out.out


@pytest.mark.parametrize("tile,sweeps,rim_note", [
    ("50,0", "1", False), ("auto", "auto", True), ("64,96", "2", True)])
def test_host_tiling_runs_on_the_cpu(capsys, tile, sweeps, rim_note):
    rc, out = _main(capsys, "jacobi2d.soda", "--grid-shape", "200,300", "--host-tile",
                    tile, "--host-tile-sweeps", sweeps, "--hbm-budget", "400000",
                    "--device", "cpu", "--run", "--report")
    assert rc == 0 and "OK" in out.out
    assert "host tiling:" in out.out and "read amplification" in out.out
    assert ("outside the rim" in out.out) == rim_note


def test_bad_flags_exit_with_a_message_naming_the_flag(capsys):
    with pytest.raises(SystemExit) as e:
        sodac.main([str(SODA / "jacobi2d.soda"), "--host-tile", "auto",
                    "--host-tile-sweeps", "3x"])
    assert e.value.code == 2
    assert "--host-tile-sweeps" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="--host-tile: sweeps_per_pass 3 must divide"):
        sodac.main([str(SODA / "jacobi2d.soda"), "--grid-shape", "64,64", "--host-tile",
                    "32,0", "--host-tile-sweeps", "3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="need --hbm-budget"):
        sodac.main([str(SODA / "jacobi2d.soda"), "--grid-shape", "64,64", "--host-tile",
                    "auto", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --host-tile"):
        sodac.main([str(SODA / "jacobi2d.soda"), "--host-tile-sweeps", "2"])


@pytest.mark.parametrize("extra", [["--host-tile", "auto"], ["--backend", "numpy"],
                                   ["--device", "cpu"]])
def test_benchmark_is_refused_before_running(capsys, extra):
    with pytest.raises(SystemExit, match="--benchmark"):
        sodac.main([str(SODA / "blur.soda"), "--grid-shape", "21,40", "--benchmark",
                    "--run", *extra])
    assert "executed" not in capsys.readouterr().out


def test_torch_driver_runs_the_program(capsys, tmp_path):
    drv = tmp_path / "driver.py"
    rc, out = _main(capsys, "blur.soda", "--grid-shape", "21,40", "--torch-driver", str(drv))
    assert rc == 0 and f"wrote PyTorch driver: {drv}" in out.out
    r = subprocess.run([sys.executable, str(drv), "--device", "cpu"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("blur_y (21, 40) uint16")


@pytest.mark.parametrize("extra", [
    ["--mesh", "2,2"],
    ["--mesh", "dcn:2,x:2", "--mesh-overlap", "--sweeps-per-exchange", "1"],
    ["--mesh", "4", "--mesh-local-backend", "eager", "--link-model", "nvlink=400:4e-6"],
    ["--mesh", "2x2", "--host-tile", "24,0,0", "--host-tile-sweeps", "1"],
])
def test_mesh_runs_on_cpu_shards(capsys, monkeypatch, extra):
    from soda_tpu_torch.parallel import mesh

    # --link-model recalibrates the module's links: keep it to this test
    monkeypatch.setattr(mesh, "LINK_MODEL", dict(mesh.LINK_MODEL))
    rc, out = _main(capsys, "jacobi3d.soda", "--grid-shape", "40,13,30", "--device", "cpu",
                    "--run", *extra)
    assert rc == 0 and "OK" in out.out and "(cuda mesh, cpu)" in out.out
    assert "B between shards" in out.out


def test_mesh_report_divides_by_the_shards_own_bytes(capsys):
    from soda_tpu_torch.parallel import host_tile

    rc, out = _main(capsys, "jacobi3d.soda", "--grid-shape", "64,64,64", "--mesh", "4,2",
                    "--report")
    assert rc == 0
    xbytes, shard = host_tile.model_mesh_exchange(
        parse_file(SODA / "jacobi3d.soda"), (64, 64, 64), (4, 2), None, 1)
    assert shard == (18, 34, 64)
    line = next(ln for ln in out.out.splitlines() if ln.startswith("  mesh:"))
    assert "shards of 18x34x64 over 4x2 devices" in line and "modeled nvlink" in line
    assert f"({100 * xbytes / (18 * 34 * 64 * 4):.2f}% of the shard's state bytes" in line
    rc, out = _main(capsys, "jacobi2d.soda", "--grid-shape", "200,300", "--mesh",
                    "dcn:2,x:2", "--host-tile", "100,0", "--report")
    assert rc == 0 and "  mesh per tile: shards of " in out.out
    assert "modeled ib+nvlink halo exchange" in out.out


def test_mesh_flags_refused_before_running(capsys, monkeypatch):
    from soda_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "LINK_MODEL", dict(mesh.LINK_MODEL))
    jacobi = str(SODA / "jacobi2d.soda")
    with pytest.raises(SystemExit, match="--benchmark .* drop --mesh"):
        sodac.main([jacobi, "--mesh", "2,2", "--benchmark"])
    with pytest.raises(SystemExit, match="bad --link-model entry 'ib=fast'"):
        sodac.main([jacobi, "--mesh", "2,2", "--link-model", "ib=fast", "--device", "cpu",
                    "--run"])
    with pytest.raises(SystemExit, match="cannot shard a grid of rank 2"):
        sodac.main([jacobi, "--mesh", "2,2,2", "--device", "cpu", "--run"])
    with pytest.raises(SystemExit, match="--mesh-overlap needs --mesh"):
        sodac.main([jacobi, "--mesh-overlap", "--device", "cpu", "--run"])
    with pytest.raises(SystemExit, match="--sweeps-per-exchange: 3 values for 2 mesh axes"):
        sodac.main([jacobi, "--grid-shape", "64,64", "--mesh", "2,2", "--sweeps-per-exchange",
                    "4,2,1", "--device", "cpu", "--run"])
    assert "executed jacobi2d" not in capsys.readouterr().out
