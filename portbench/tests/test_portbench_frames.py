"""The frame feed and the cell `blur-2048x4096.frame`: call k takes frame k
mod N and no output is fed back, a state-fed traffic runs the calls it
always ran, the uint16 blur reference against the port's plain path, the
control and each fault caught on every check, the bound and the readers.

The cell's files are in place, but its entries are not in BENCHMARK.json:
the run-to-run spread of a one-frame block follows the host's speed (see
PERF.md).  ENTRIES holds them as a later change would add them, and the
tests run the cell from BENCHMARK.json with them added."""

import json

import pytest
import torch

from portbench import check, control, harness, inputs, loop, run

from conftest import CHECKOUT, TINY_2D

CELL = "blur-2048x4096.frame"
ENTRIES = {
    "configs": [{"name": "blur-2048x4096",
                 "source": "Chi et al., SODA: Stencil with Optimized Dataflow Architecture, "
                           "ICCAD 2018 (blur); soda_tpu benchmarks/run_all.py CONFIGS row "
                           "(blur, (2048, 4096), None)",
                 "file": "portbench/configs/blur-2048x4096.json", "reduced": [],
                 "why": "a two-stage separable 3x3 blur of 8.4 Mpixel uint16 frames: kernel 2, "
                        "the rank-2 row-march, both stages in one launch, int32 sums of the "
                        "full 16-bit range"}],
    "workloads": [{"name": CELL, "config": "blur-2048x4096", "traffic": "frame", "chips": 1,
                   "why": "a uint16 frame stream on one card: a ring of 16 new 16 MiB frames "
                          "read from HBM, one caller, a sync after every call: kernel 2 and the "
                          "wrapper's host time; mesh bypassed"}],
    "per_layer": [{"name": "kernel_ms.frame", "unit": "ms", "better": "lower",
                   "source": "device_trace", "layer": "kernel", "moves": "gcells_per_s",
                   "workloads": [CELL]},
                  {"name": "rowmarch2d_roofline", "unit": "%", "better": "higher",
                   "source": "device_trace", "layer": "kernel", "moves": "gcells_per_s",
                   "workloads": [CELL]}],
    # the one-card loop's readers, whose lists the cell joins
    "joins": ["enqueue_ms.loop", "idle_pct.loop", "wrapper_us.loop"],
}


def with_cell(bench: dict) -> dict:
    """`bench` with the cell's entries, unless it has them already."""
    bench = json.loads(json.dumps(bench))
    if any(w["name"] == CELL for w in bench["workloads"]):
        return bench
    for key in ("configs", "workloads", "per_layer"):
        bench[key] += json.loads(json.dumps(ENTRIES[key]))
    for m in bench["per_layer"]:
        if m["name"] in ENTRIES["joins"]:
            m["workloads"].append(CELL)
    return bench


BENCH = with_cell(harness.load_benchmark())


@pytest.fixture
def bench(monkeypatch):
    """harness.load_benchmark() gives BENCHMARK.json with the cell."""
    monkeypatch.setattr(harness, "load_benchmark", lambda: BENCH)
    return BENCH


PEAK = harness.peak_of("NVIDIA H100 80GB HBM3")
# two chunks of the check's 256 rows, the last one short
SMALL = (300, 48)
SEED = 2**31 + 41


def _recording(cell):
    """`cell` with its system recording every call's (input, output)."""
    calls = []

    class Recording(cell.system_cls):
        def call(self, x):
            y = super().call(x)
            calls.append((x, y))
            return y

    cell.system_cls = Recording
    return calls


def test_the_entries_keep_the_contracts_shape():
    config = json.loads((CHECKOUT / ENTRIES["configs"][0]["file"]).read_text())
    assert config["name"] == "blur-2048x4096" and config["reduced"] == []
    assert ENTRIES["configs"][0]["source"] == config["source"]
    for entry in ENTRIES["configs"] + ENTRIES["workloads"]:
        assert 1 <= len(entry["why"]) <= 200
    assert len(ENTRIES["configs"][0]["source"]) <= 200
    names = [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(harness.load_module("layers", m["name"]) for m in ENTRIES["per_layer"])


def test_the_cell_runs_blur_on_a_ring_of_frames():
    c = loop.Cell(BENCH, CELL)
    assert c.config["program"] == "blur" and c.grid == (2048, 4096)
    assert c.inputs.dtype == torch.uint16 and (c.inputs.low, c.inputs.high) == (0, 65536)
    assert c.config["iterate"] == 1 and c.config["entry"] == "build_fn" and not c.fields
    assert c.config["reduced"] == [] and c.workload["chips"] == 1
    assert (c.feed, c.frames, c.traffic["block_sweeps"]) == ("frames", 16, 1)
    assert c.reference.HALO == 1
    assert harness.program_path("blur").read_text() == (
        CHECKOUT / "tests" / "soda" / "blur.soda").read_text()
    names = {m["name"] for m in harness.metrics_of(BENCH, CELL, "per_layer")}
    assert names == {"kernel_ms.frame", "rowmarch2d_roofline", "enqueue_ms.loop",
                     "idle_pct.loop", "wrapper_us.loop"}


@pytest.mark.parametrize("trace", [False, True])
def test_the_frame_feed_gives_call_k_frame_k_mod_n(trace):
    c = loop.Cell(BENCH, CELL, grid=SMALL, devices=["cpu"])
    calls = _recording(c)
    got = loop.run(c, SEED, 0.05, trace, 0.0, lambda *a: None)
    n = c.frames
    frames = [inputs.grid(SMALL, inputs.frame_seed(SEED, k), c.inputs, "cpu") for k in range(n)]
    assert all(not torch.equal(frames[i], frames[j]) for i in range(n) for j in range(i))
    assert len(calls) >= 1 + c.traffic["warm_blocks"] + got["window"].calls
    if trace:                    # the profiled slice went through the feed too
        assert len(calls) >= c.traffic["trace"]["profile_blocks"] + got["window"].calls
    outputs = set()
    for k, (x, y) in enumerate(calls):
        assert torch.equal(x, frames[k % n]), k
        assert id(x) not in outputs, f"call {k} took an output"
        outputs.add(id(y))
    # the ring is made once: every call of a frame takes the same tensor
    assert all(calls[k][0] is calls[k % n][0] for k in range(len(calls)))
    assert all(v["cells_off"] == 0 for v in got["checks"].values())


@pytest.mark.parametrize("trace", [False, True])
def test_a_state_fed_traffic_runs_the_calls_it_ran(trace):
    c = loop.Cell(BENCH, "jacobi2d-16384.loop", grid=TINY_2D, devices=["cpu"])
    assert (c.feed, c.frames) == ("state", None)
    calls = _recording(c)
    got = loop.run(c, SEED, 0.05, trace, 0.0, lambda *a: None)
    assert torch.equal(calls[0][0], inputs.grid(TINY_2D, SEED, c.inputs, "cpu"))
    for k in range(1, len(calls)):
        assert calls[k][0] is calls[k - 1][1], f"call {k} did not take call {k - 1}'s output"
    per_block = c.traffic["block_sweeps"]
    window = got["window"].calls
    assert window % per_block == 0
    # the first call, the warm blocks, the window and, traced, the slice
    slice_calls = c.traffic["trace"]["profile_blocks"] * per_block if trace else 0
    assert len(calls) == 1 + c.traffic["warm_blocks"] * per_block + window + slice_calls
    assert all(v["cells_off"] == 0 for v in got["checks"].values())


def test_frame_seeds_are_distinct_and_uint16_spans_its_range():
    seeds = {inputs.frame_seed(s, k) for s in (0, 1, 2**31 + 5) for k in range(16)}
    assert len(seeds) == 48
    spec = loop.Cell(BENCH, CELL).inputs
    g = inputs.grid(SMALL, inputs.frame_seed(3, 0), spec, "cpu")
    v = g.to(torch.int32)
    assert g.dtype == torch.uint16 and int(v.min()) >= 0 and int(v.max()) <= 65535
    assert int((v > 32767).sum()) > g.numel() // 3          # past int16's range
    assert torch.equal(inputs.planes(SMALL, inputs.frame_seed(3, 0), 40, 290, spec, "cpu"),
                       g[40:290])


def _port_blur(x):
    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.frontend.parser import parse_file

    p = parse_file(harness.program_path("blur"))
    return cuda.build_fn(p, grid_shape=tuple(x.shape), iterate=1)({"input": x}, {})["blur_y"]


def _near_the_top(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(65536 - 700, 65536, shape, generator=g, dtype=torch.int32).to(
        torch.uint16)


@pytest.mark.parametrize("chunk", [256, 7, 1])
def test_the_reference_equals_the_ports_plain_path_near_65535(chunk):
    ref = harness.load_module("reference", "blur")
    x = _near_the_top(SMALL, 5)
    y = _port_blur(x)
    assert y.dtype == torch.uint16
    got = check.compare_sweep(ref, lambda a, b: x[a:b], lambda a, b: y[a:b], SMALL[0],
                              SMALL[1:], chunk, torch.uint16, "cpu")
    assert got == {"cells_off": 0, "max_gap": 0.0}
    y[150, 20] = int(y[150, 20]) ^ 1
    assert check.compare_sweep(ref, lambda a, b: x[a:b], lambda a, b: y[a:b], SMALL[0],
                               SMALL[1:], chunk, torch.uint16, "cpu")["cells_off"] == 1


def test_sums_in_16_bits_would_wrap_on_these_inputs():
    """The inputs reach the top of the range, so a blur that added in 16
    bits (wrapping mod 65536) differs from the reference almost everywhere."""
    ref = harness.load_module("reference", "blur")
    x = _near_the_top((12, 16), 9)
    want = ref.sweep(torch.nn.functional.pad(x.to(torch.int32), (0, 0, 1, 1)).to(torch.uint16))
    w = torch.nn.functional.pad(x.to(torch.int64), (0, 2))
    bx = ((w[:, :-2] + w[:, 1:-1] + w[:, 2:]) % 65536) // 3
    b = torch.nn.functional.pad(bx, (0, 0, 1, 1))
    wrapped = ((b[:-2] + b[1:-1] + b[2:]) % 65536) // 3
    assert int((wrapped != want.to(torch.int64)).sum()) > want.numel() // 2


def test_the_reference_truncates_and_stores_blur_x_in_uint16():
    ref = harness.load_module("reference", "blur")
    x = torch.tensor([[0, 0, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0]], dtype=torch.uint16)
    # blur_x row 1: (1+1+0)/3 = 0, (1+0+0)/3 = 0: nothing survives truncation
    assert not ref.sweep(x).to(torch.int32).any()
    x = torch.tensor([[0, 0], [65535, 65535], [65535, 65535], [65535, 65535], [0, 0]],
                     dtype=torch.uint16)
    got = ref.sweep(x).to(torch.int32).tolist()
    # blur_x: 131070 / 3 = 43690 at column 0, 65535 / 3 = 21845 at column 1
    assert got == [[29126, 14563], [43690, 21845], [29126, 14563]]


def test_the_bound_is_the_bytes():
    count = harness.load_json("roofline", "blur")
    assert (count["bytes_per_cell"], count["float32_ops_per_cell"]) == (4, 0)
    cells = 2048 * 4096
    bound = harness.bound_ms(count, cells, 1, PEAK)
    assert bound == pytest.approx(4 * cells / 3.35e12 * 1e3)
    assert bound == pytest.approx(0.01002, abs=5e-6)


def test_the_kernel_readers():
    t = loop.Trace(CELL, 2048 * 4096, 1, harness.load_json("roofline", "blur"), PEAK,
                   kernel_ms=0.025)
    read = lambda name: harness.load_module("layers", name).read(t)
    assert read("kernel_ms.frame") == 0.025
    assert read("rowmarch2d_roofline") == pytest.approx(100 * 0.0100160 / 0.025, rel=1e-4)
    t.kernel_ms = None
    assert read("kernel_ms.frame") is None and read("rowmarch2d_roofline") is None
    t.kernel_ms, t.peak = 0.025, None
    assert read("rowmarch2d_roofline") is None


def test_the_control_is_the_reference_in_uint8():
    assert control.lower_dtype("uint16") == torch.uint8
    ref = harness.load_module("reference", "blur")
    x = _near_the_top(SMALL, 2)
    whole = check.sweep_in_chunks(ref, x, 256, torch.uint16)
    low = check.sweep_in_chunks(ref, x, 256, torch.uint8)
    assert low.dtype == torch.uint16 and torch.equal(whole, _port_blur(x))
    assert int((low != whole).sum()) > x.numel() // 2


@pytest.mark.parametrize("mode", ["control", "unchanged", "altered", "half"])
def test_the_control_and_each_fault_fail_every_check(bench, mode):
    got = control.readings(CELL, [SEED], 0.05, mode, grid=SMALL, devices=["cpu"],
                           log=lambda *a: None)[SEED]
    # the start, three sampled calls and the last: every check it reaches
    assert len(got["checks"]) == 5 and not got["correct"], got
    assert min(got["checks"].values()) > 0, got


def test_the_program_is_correct_on_every_check(bench):
    got = control.readings(CELL, [SEED + 1], 0.05, "program", grid=SMALL, devices=["cpu"],
                           log=lambda *a: None)[SEED + 1]
    assert got["correct"] and len(got["checks"]) == 5
    assert set(got["checks"].values()) == {0} and got["widest"] == 0.0


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_lines_keys(trace):
    c = loop.Cell(BENCH, CELL, grid=SMALL, devices=["cpu"])
    got = loop.run(c, 2**31 + 3, 0.05, bool(trace), 0.0, lambda *a: None)
    out = json.loads(json.dumps(run.result(BENCH, c, got, bool(trace))))
    assert list(out)[:3] == ["correct", "attempted", "failed"] and list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0
    if not trace:
        assert set(out["metrics"]) == {"gcells_per_s", "block_p95_ms", "setup_s"}
    # the ring is the traffic's own, the check holds frames and outputs
    assert got["memory"]["check holds"]["cpu"] >= 5 * 300 * 48 * 2


@pytest.mark.gpu
@pytest.mark.parametrize("mode,correct", [("program", True), ("control", False),
                                          ("unchanged", False), ("altered", False),
                                          ("half", False)])
def test_readings_of_the_frame_cell_on_the_card(card, bench, mode, correct):
    got = control.readings(CELL, [5, 2**31 + 1], 0.2, mode, grid=(512, 1024),
                           devices=["cuda:0"], log=lambda *a: None)
    assert all(g["correct"] is correct for g in got.values()), got
    if not correct:
        assert all(min(g["checks"].values()) > 0 for g in got.values()), got
