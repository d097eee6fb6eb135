"""The cell `hpgmg-jacobi-512.loop`: its parts, its bound, its four
readers, and its loop at a tiny grid on the port's plain path with the
check, the control (the reference in float32) and each fault."""

import pytest
import torch

from portbench import check, control, harness, loop

from conftest import TINY

BENCH = harness.load_benchmark()
PEAK = harness.peak_of("NVIDIA H100 80GB HBM3")
CELL = "hpgmg-jacobi-512.loop"
CELLS = 512 ** 3
FIELDS = ("rhs", "alpha", "beta_i", "beta_j", "beta_k")


def test_the_cell_runs_hpgmg_in_float64_with_five_fields():
    c = loop.Cell(BENCH, CELL)
    assert c.config["program"] == "hpgmg_jacobi" and c.grid == (512, 512, 512)
    assert c.config["dtype"] == "float64" and c.inputs.dtype == torch.float64
    assert c.config["iterate"] == 1 and c.config["entry"] == "build_fn"
    assert c.config["chips"] == 1 and c.config["mesh"] is None
    assert set(c.fields) == set(FIELDS) and c.config["reduced"] == []
    assert {n: (s.low, s.high) for n, s in c.fields.items()} == {
        "rhs": (0, 1), "alpha": (0.5, 1.5), "beta_i": (0.5, 1.5), "beta_j": (0.5, 1.5),
        "beta_k": (0.5, 1.5)}
    assert c.reference.HALO == 1 and hasattr(c.reference, "sweep")
    assert control.lower_dtype(c.config["dtype"]) == torch.float32
    names = [m["name"] for m in harness.metrics_of(BENCH, CELL, "per_layer")]
    assert names == ["kernel_ms.hpgmg", "hpgmg_roofline", "planned_b_per_cell.hpgmg",
                     "tma_copy_b.hpgmg"]


def test_the_bound_is_the_bytes():
    count = harness.load_json("roofline", "hpgmg_jacobi")
    assert (count["bytes_per_cell"], count["float32_ops_per_cell"]) == (56, 64)
    bound = harness.bound_ms(count, CELLS, 1, PEAK)
    assert bound == pytest.approx(2.24364, abs=5e-6)
    ops_ms = 64 * CELLS / PEAK["float32_ops_per_s"] * 1e3
    assert ops_ms == pytest.approx(0.1282, abs=5e-5) and bound / ops_ms > 17


def test_the_kernel_readers():
    t = loop.Trace(CELL, CELLS, 1, harness.load_json("roofline", "hpgmg_jacobi"), PEAK,
                   kernel_ms=2.8)
    read = lambda name: harness.load_module("layers", name).read(t)
    assert read("kernel_ms.hpgmg") == 2.8
    assert read("hpgmg_roofline") == pytest.approx(100 * 2.24364 / 2.8, rel=1e-4)
    t.kernel_ms = None
    assert read("hpgmg_roofline") is None


def test_the_planned_bytes_and_tma_copy_readers(monkeypatch):
    from soda_tpu_torch.backend import cuda, linebuffer
    from soda_tpu_torch.utils import trace

    t = loop.Trace(CELL, CELLS, 1, {}, PEAK)
    planned = harness.load_module("layers", "planned_b_per_cell.hpgmg").read
    box = harness.load_module("layers", "tma_copy_b.hpgmg").read
    cuda.reset_launches()
    assert planned(t) is None and box(t) is None    # no launch: the plain path on the CPU
    # 2000 calls of one launch each in the slice, 32 more after it
    monkeypatch.setattr(linebuffer, "LAUNCHES", 2032)
    monkeypatch.setattr(linebuffer, "PLANNED_BYTES", 2032 * 7_966_661_504)
    monkeypatch.setattr(linebuffer, "TMA_COPIES", 2032 * 1_585_152)
    monkeypatch.setattr(linebuffer, "TMA_BYTES", 2032 * 6_921_125_888)
    monkeypatch.setattr(trace, "totals", lambda: {
        "soda.fn": trace.Total(2000, 1.0, 0.5), "soda.kernel": trace.Total(2000, 0.5, 0.5)})
    assert planned(t) == pytest.approx(7_966_661_504 / CELLS)
    assert box(t) == pytest.approx(6_921_125_888 / 1_585_152)
    monkeypatch.delattr(cuda, "tma_copies")
    assert box(t) is None                      # a program without the counter
    cuda.reset_launches()


def _fields(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.rand(TINY, generator=g, dtype=torch.float64) + (0 if n == "rhs" else 0.5)
            for n in FIELDS}


def test_the_reference_equals_the_ports_plain_path():
    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.frontend.parser import parse_file

    ref = harness.load_module("reference", "hpgmg_jacobi")
    p = parse_file(harness.program_path("hpgmg_jacobi"))
    fields = _fields(7)
    x = torch.rand(TINY, generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    y = cuda.build_fn(p, grid_shape=TINY)({"x": x, **fields}, {})["xn"]
    for chunk in (64, 7, 1):
        got = check.compare_sweep(ref, lambda a, b: x[a:b], lambda a, b: y[a:b], TINY[0],
                                  TINY[1:], chunk, torch.float64, "cpu",
                                  {n: (lambda a, b, t=t: t[a:b]) for n, t in fields.items()})
        assert got == {"cells_off": 0, "max_gap": 0.0}


@pytest.mark.parametrize("mode,correct", [("program", True), ("control", False),
                                          ("unchanged", False), ("altered", False),
                                          ("half", False)])
def test_the_check_the_control_and_the_faults(mode, correct):
    seed = 2**31 + 23
    got = control.readings(CELL, [seed], 0.05, mode, grid=TINY, devices=["cpu"],
                           log=lambda *a: None)[seed]
    assert got["correct"] is correct, got
    if correct:
        assert set(got["checks"].values()) == {0}
    else:
        assert min(got["checks"].values()) > 0
