"""The readers of the program's own spans and device intervals
(`program_trace.py`, `layers/wrapper_us.loop.py`, `layers/exchange_ms.mesh.py`,
`layers/shard_kernel_ms.mesh.py`): None, never 0, where nothing was
recorded or the program has no tracing; otherwise the mean a call, and on
the mesh the mean of the cards."""

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness, loop, run

from conftest import CPU_DEVICES, TINY

NEW = ("wrapper_us.loop", "exchange_ms.mesh", "shard_kernel_ms.mesh")


@pytest.fixture
def trace():
    from soda_tpu_torch.utils import trace

    trace.reset()
    yield trace
    trace.reset()


def _read(name):
    return harness.load_module("layers", name).read(None)


def test_nothing_recorded_reads_none(trace):
    assert [_read(n) for n in NEW] == [None, None, None]


def test_a_program_without_tracing_reads_none(monkeypatch):
    import soda_tpu_torch.utils

    monkeypatch.delattr(soda_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "soda_tpu_torch.utils.trace", None)
    assert [_read(n) for n in NEW] == [None, None, None]


def test_the_recorded_spans_and_intervals_read_a_call(trace, capsys):
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            with trace.span("soda.mesh.call"), trace.span("soda.kernel"):
                pass
    k = trace.totals()["soda.kernel"]
    assert _read("wrapper_us.loop") == pytest.approx(k.total_s / 4 * 1e6)
    trace._device.update({("exchange", "cuda:0"): [4, 2.0], ("exchange", "cuda:1"): [4, 3.0],
                          ("local", "cuda:0"): [4, 30.0], ("local", "cuda:1"): [4, 31.0]})
    assert _read("exchange_ms.mesh") == pytest.approx((0.5 + 0.75) / 2)
    assert _read("shard_kernel_ms.mesh") == pytest.approx((7.5 + 7.75) / 2)
    err = capsys.readouterr().err
    assert "exchange_ms.mesh by card: {'cuda:0': 0.5, 'cuda:1': 0.75}" in err


@pytest.mark.parametrize("cell", ["jacobi3d-512.loop", "jacobi3d-2048.mesh-loop"])
def test_the_cpu_plain_path_leaves_the_new_metrics_out(cell, trace):
    bench = harness.load_benchmark()
    c = loop.Cell(bench, cell, grid=TINY, devices=CPU_DEVICES[cell])
    got = loop.run(c, 2**31 + 5, 0.05, True, 0.0, lambda *a: None)
    out = run.result(bench, c, got, True)
    assert not set(out["metrics"]) & set(NEW)
    spans = trace.totals()
    assert "soda.kernel" not in spans and trace.device_ms() == {}
    if cell == "jacobi3d-2048.mesh-loop":
        calls = spans["soda.mesh.call"].count
        assert calls > 0 and spans["soda.mesh.exchange"].count == calls
        assert spans["soda.fn"].count == 4 * calls
    else:
        assert spans["soda.fn"].count > 0 and "soda.mesh.call" not in spans


def test_each_new_metric_reads_its_own_cells():
    bench = harness.load_benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    assert per_layer["wrapper_us.loop"]["workloads"] == ["jacobi3d-512.loop",
                                                         "jacobi2d-16384.loop"]
    for name in NEW[1:]:
        assert per_layer[name]["workloads"] == ["jacobi3d-2048.mesh-loop"]
