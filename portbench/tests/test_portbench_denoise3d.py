"""The cell `denoise3d-512.loop`: its parts, its bound, its three readers,
and its loop at a tiny grid on the port's plain path with the check, the
control and each fault."""

import pytest
import torch

from portbench import check, control, harness, loop

from conftest import TINY

BENCH = harness.load_benchmark()
PEAK = harness.peak_of("NVIDIA H100 80GB HBM3")
CELL = "denoise3d-512.loop"
CELLS = 512 ** 3


def test_the_cell_runs_denoise3d_with_rhs_a_field():
    c = loop.Cell(BENCH, CELL)
    assert c.config["program"] == "denoise3d" and c.grid == (512, 512, 512)
    assert c.config["iterate"] == 1 and c.config["entry"] == "build_fn"
    assert set(c.fields) == {"rhs"} and c.config["reduced"] == []
    assert c.reference.HALO == 2 and hasattr(c.reference, "sweep_at")
    names = [m["name"] for m in harness.metrics_of(BENCH, CELL, "per_layer")]
    assert names == ["kernel_ms.denoise", "denoise3d_roofline", "planned_b_per_cell.denoise"]


def test_the_bound_is_the_bytes():
    count = harness.load_json("roofline", "denoise3d")
    assert (count["bytes_per_cell"], count["float32_ops_per_cell"]) == (12, 39)
    bound = harness.bound_ms(count, CELLS, 1, PEAK)
    assert bound == pytest.approx(0.4808, abs=5e-5)
    ops_ms = 39 * CELLS / PEAK["float32_ops_per_s"] * 1e3
    assert ops_ms == pytest.approx(0.0781, abs=5e-5) and ops_ms < bound


def test_the_kernel_readers():
    t = loop.Trace(CELL, CELLS, 1, harness.load_json("roofline", "denoise3d"), PEAK,
                   kernel_ms=1.9)
    read = lambda name: harness.load_module("layers", name).read(t)
    assert read("kernel_ms.denoise") == 1.9
    assert read("denoise3d_roofline") == pytest.approx(100 * 0.48077 / 1.9, rel=1e-4)
    t.kernel_ms = None
    assert read("denoise3d_roofline") is None


def test_the_planned_bytes_reader(monkeypatch):
    from soda_tpu_torch.backend import cuda, linebuffer
    from soda_tpu_torch.utils import trace

    t = loop.Trace(CELL, CELLS, 1, {}, PEAK)
    read = harness.load_module("layers", "planned_b_per_cell.denoise").read
    cuda.reset_launches()
    assert read(t) is None                     # no launch: the plain path on the CPU
    # 2000 calls of one launch each in the slice, 32 more after it
    monkeypatch.setattr(linebuffer, "LAUNCHES", 2032)
    monkeypatch.setattr(linebuffer, "PLANNED_BYTES", 2032 * 1_854_037_504)
    monkeypatch.setattr(trace, "totals", lambda: {
        "soda.fn": trace.Total(2000, 1.0, 0.5), "soda.kernel": trace.Total(2000, 0.5, 0.5)})
    assert read(t) == pytest.approx(1_854_037_504 / CELLS)
    monkeypatch.delattr(cuda, "planned_bytes")
    assert read(t) is None                     # a program without the counter


def test_the_reference_equals_the_ports_plain_path():
    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.frontend.parser import parse_file

    ref = harness.load_module("reference", "denoise3d")
    p = parse_file(harness.program_path("denoise3d"))
    g = torch.Generator().manual_seed(7)
    u, rhs = torch.rand(TINY, generator=g), torch.rand(TINY, generator=g)
    y = cuda.build_fn(p, grid_shape=TINY)({"u": u, "rhs": rhs}, {})["unew"]
    for chunk in (64, 7, 1):
        got = check.compare_sweep(ref, lambda a, b: u[a:b], lambda a, b: y[a:b], TINY[0],
                                  TINY[1:], chunk, torch.float32, "cpu",
                                  {"rhs": lambda a, b: rhs[a:b]})
        assert got == {"cells_off": 0, "max_gap": 0.0}


@pytest.mark.parametrize("mode,correct", [("program", True), ("control", False),
                                          ("unchanged", False), ("altered", False),
                                          ("half", False)])
def test_the_check_the_control_and_the_faults(mode, correct):
    seed = 2**31 + 18
    got = control.readings(CELL, [seed], 0.05, mode, grid=TINY, devices=["cpu"],
                           log=lambda *a: None)[seed]
    assert got["correct"] is correct, got
    if correct:
        assert set(got["checks"].values()) == {0}
    else:
        assert min(got["checks"].values()) > 0
