"""The program's timing spans and device intervals (`utils/trace.py`).

Off (no profiler recording) a span is one shared no-op object; on, it is a
named range in the profiler's trace and a row of `trace.totals()`.
Device intervals are CUDA events on the mesh's cards: on the CPU they
record nothing, so their bookkeeping is checked here with stand-in events,
and the one test marked `gpu` checks them on the card:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_trace.py

This file imports neither jax nor soda_tpu.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from soda_tpu_torch.backend import cuda
from soda_tpu_torch.cli import sodac
from soda_tpu_torch.frontend.parser import parse_file
from soda_tpu_torch.parallel.mesh import build_sharded_fn, make_mesh
from soda_tpu_torch.utils import trace
from soda_tpu_torch.utils.testing import CORPUS

SHAPE = (12, 16, 20)


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    yield
    trace.reset()


def _program():
    return parse_file(CORPUS / "jacobi3d.soda")


def _x():
    return torch.rand(SHAPE, generator=torch.Generator().manual_seed(5))


def _on():
    return profile(activities=[ProfilerActivity.CPU])


class _Event:
    """A CUDA event's stand-in: done or not, at a time in ms."""

    def __init__(self, at: float, done: bool = True):
        self.at, self.done = at, done

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.done = True

    def elapsed_time(self, end) -> float:
        assert self.done and end.done
        return end.at - self.at


def test_off_a_span_is_one_shared_object_and_records_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} recorded with no profiler")

    monkeypatch.setattr(trace, "_record", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    off = trace.span("soda.fn")
    assert trace.span("soda.kernel") is off
    assert trace.device_interval("local", torch.device("cuda", 0)) is off
    with trace.span("soda.fn"):
        with trace.span("soda.kernel"):
            pass
    fn = cuda.build_fn(_program(), grid_shape=SHAPE)
    fn({"t0": _x()}, {})
    assert trace.totals() == {} and trace.device_ms() == {}


def test_device_interval_records_nothing_on_cpu_devices():
    with _on():
        assert torch.autograd.profiler._is_profiler_enabled
        with trace.device_interval("local", torch.device("cpu"), torch.device("cpu")):
            pass
    assert trace._pending == [] and trace.device_ms() == {}


def _spans(path) -> dict[str, list[tuple[float, float]]]:
    """The `soda.*` ranges of a Chrome trace, each a `cpu_op` event."""
    events = json.loads(path.read_text())["traceEvents"]
    out: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("soda."):
            assert e["cat"] == "cpu_op", e
            out.setdefault(e["name"], []).append((float(e["ts"]),
                                                  float(e["ts"]) + float(e["dur"])))
    return out


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_spans_sit_in_the_chrome_trace_nested_as_the_program_calls(tmp_path):
    p = _program()
    fn = cuda.build_fn(p, grid_shape=SHAPE)
    sharded = build_sharded_fn(p, make_mesh([2, 2], devices=["cpu"] * 4), grid_shape=SHAPE)
    with _on() as prof:
        fn({"t0": _x()}, {})
        sharded({"t0": _x()}, {})
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = _spans(path)
    assert set(spans) == {"soda.fn", "soda.mesh.call", "soda.mesh.exchange"}
    (call,) = spans["soda.mesh.call"]
    (exchange,) = spans["soda.mesh.exchange"]
    assert _inside(exchange, call)
    in_call = [s for s in spans["soda.fn"] if _inside(s, call)]
    assert len(in_call) == 4 and len(spans["soda.fn"]) == 5     # a shard each, and fn's own
    assert all(not _inside(s, exchange) for s in in_call)
    got = trace.totals()
    assert got["soda.fn"].count == 5 and got["soda.mesh.call"].count == 1
    assert got["soda.mesh.call"].self_s < got["soda.mesh.call"].total_s
    assert "soda.kernel" not in got          # the CPU's plain path


def test_totals_count_one_soda_fn_a_call_and_no_soda_kernel_on_the_plain_path():
    fn = cuda.build_fn(_program(), grid_shape=SHAPE)
    x = _x()
    with _on():
        for _ in range(3):
            x = fn({"t0": x}, {})["t1"]
    got = trace.totals()
    assert set(got) == {"soda.fn"} and got["soda.fn"].count == 3
    assert got["soda.fn"].total_s > 0 and got["soda.fn"].self_s == got["soda.fn"].total_s


def test_self_time_is_the_total_less_the_child_spans(monkeypatch):
    clock = iter([0.0, 1.0, 4.0, 5.0, 6.0, 10.0])
    monkeypatch.setattr(trace, "_clock", lambda: next(clock))
    with _on():
        with trace.span("outer"):
            with trace.span("inner"):
                pass
            with trace.span("inner"):
                pass
    got = trace.totals()
    assert got["outer"] == trace.Total(1, 10.0, 6.0)
    assert got["inner"] == trace.Total(2, 4.0, 4.0)


def test_intervals_resolve_by_kind_and_card_and_fold_once_too_many_are_pending(monkeypatch):
    stamps = iter(float(t) for t in range(1000))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: f"stream of {d}")
    monkeypatch.setattr(trace, "_event", lambda stream: _Event(next(stamps) * 0.5))
    monkeypatch.setattr(trace, "PENDING_MAX", 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with _on():
        with trace.device_interval("exchange", *cards):    # ms 0 to 1, 0.5 to 1.5
            pass
        assert len(trace._pending) == 2
        with trace.device_interval("local", cards[1]):      # 2 to 2.5: 3 pending, fold
            pass
        assert trace._pending == []
        with trace.device_interval("local", cards[1]):      # 3 to 3.5
            pass
    trace._pending[0][3].done = False     # not yet run: folded only when waited for
    assert trace.device_ms() == {"exchange": {"cuda:0": (1, 1.0), "cuda:1": (1, 1.0)},
                                 "local": {"cuda:1": (2, 1.0)}}
    assert trace._pending == []


def test_reset_launches_clears_the_spans_and_the_intervals():
    with _on():
        with trace.span("soda.fn"):
            pass
    trace._pending.append(("local", "cuda:0", _Event(0.0), _Event(2.0)))
    trace._device[("exchange", "cuda:0")] = [1, 3.0]
    assert trace.totals()
    cuda.reset_launches()
    assert trace.totals() == {} and trace._pending == [] and trace.device_ms() == {}
    assert set(cuda.launch_counts().values()) == {0}


def test_profile_prints_the_span_table(capsys, tmp_path):
    rc = sodac.main([str(CORPUS / "jacobi3d.soda"), "--grid-shape", "24,32,40",
                     "--device", "cpu", "--mesh", "2,2", "--run",
                     "--profile", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert (tmp_path / "jacobi3d.trace.json").exists()
    table = out[out.index("span "):].splitlines()
    assert table[0].split() == ["span", "count", "total", "ms", "self", "ms"]
    rows = {line.split()[0]: line.split()[1:] for line in table[1:]}
    assert rows["soda.mesh.call"][0] == "1" and rows["soda.fn"][0] == "4"
    assert rows["soda.mesh.exchange"][0] == "1"
    # the counters of the run's launches: none on CPU shards
    assert "z-march stages on chip: 0" in table and "planned device-memory bytes: 0" in table
    assert ("march launches (rank-2 cascades, z-march): "
            "{'columns': 0, 'rings': 0, 'columns3d': 0, 'rings3d': 0}") in table


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the H100 (README.md)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_a_sharded_call_on_the_card_times_local_and_exchange(cuda_device):
    p = _program()
    sharded = build_sharded_fn(p, make_mesh([1, 1], devices=[cuda_device]), grid_shape=SHAPE)
    x = _x().to(cuda_device)
    sharded({"t0": x}, {})          # builds kernel 1 outside the profile
    torch.cuda.synchronize()
    cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        sharded({"t0": x}, {})
    got = trace.device_ms()
    assert set(got) == {"exchange", "local"}
    for kind in got:
        (n, ms), = got[kind].values()
        assert list(got[kind]) == ["cuda:0"] and n == 1 and ms > 0
    assert trace.totals()["soda.kernel"].count == 1
