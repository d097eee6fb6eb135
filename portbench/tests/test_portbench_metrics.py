"""The benchmark's arithmetic: the rate, the tail, the spread, the
roofline count, the reference and the seeded inputs."""

import numpy as np
import pytest
import torch

from portbench import check, devtrace, harness, inputs


def test_rate_is_all_work_over_all_time():
    w = harness.Window()
    # a fast block and a slow one: the mean of the blocks' own rates
    # (0.5 * (8/1 + 8/3)) would read 5.33 sweeps a second, not 4
    w.add(10.0, 11.0, 8)
    w.add(11.0, 14.0, 8)
    assert w.seconds == 4.0
    assert w.gcells_per_s(10**9) == pytest.approx(16 / 4)
    with pytest.raises(ValueError):
        harness.rate(1, 0)


def test_p95_over_every_block():
    rng = np.random.default_rng(3)
    blocks = list(rng.exponential(3.7, 997))
    w = harness.Window()
    t = 0.0
    for ms in blocks:
        w.add(t, t + ms / 1e3, 8)
        t += ms / 1e3
    assert w.block_p95_ms() == pytest.approx(float(np.percentile(blocks, 95)), rel=1e-9)
    assert len(w.blocks_ms) == 997
    assert harness.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        harness.percentile([], 95)


def test_roofline_count_of_jacobi3d_at_512():
    count = harness.load_json("roofline", "jacobi3d")
    peak = harness.peak_of("NVIDIA H100 80GB HBM3")
    cells = 512 ** 3
    bound = harness.bound_ms(count, cells, 1, peak)
    assert bound == pytest.approx(0.3205, abs=5e-5)
    ops_ms = count["float32_ops_per_cell"] * cells / peak["float32_ops_per_s"] * 1e3
    assert ops_ms == pytest.approx(0.014, abs=5e-4) and ops_ms < bound   # bytes bound it
    assert harness.bound_ms(count, cells, 4, peak) == pytest.approx(4 * bound)
    assert harness.peak_of("cpu") is None and harness.bound_ms(count, cells, 1, None) is None


def _numpy_loop(x):
    n0, n1, n2 = x.shape
    out = np.zeros_like(x)
    c = np.float32(0.142857)

    def at(i, j, k):
        ok = 0 <= i < n0 and 0 <= j < n1 and 0 <= k < n2
        return x[i, j, k] if ok else np.float32(0)

    for i in range(n0):
        for j in range(n1):
            for k in range(n2):
                s = np.float32(at(i, j, k) + at(i, j, k + 1))
                for t in (at(i, j, k - 1), at(i, j + 1, k), at(i, j - 1, k),
                          at(i + 1, j, k), at(i - 1, j, k)):
                    s = np.float32(s + t)
                out[i, j, k] = np.float32(s * c)
    return out


def test_reference_against_a_numpy_loop_with_zero_outside():
    ref = harness.load_module("reference", "jacobi3d")
    x = torch.rand((5, 4, 6), generator=torch.Generator().manual_seed(7))
    block = torch.nn.functional.pad(x, (0, 0, 0, 0, ref.HALO, ref.HALO))
    got = ref.sweep(block)
    want = _numpy_loop(x.numpy())
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_reference_in_chunks_equals_whole():
    ref = harness.load_module("reference", "jacobi3d")
    x = torch.rand((11, 5, 7), generator=torch.Generator().manual_seed(1))
    whole = ref.sweep(torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1)))
    assert torch.equal(check.sweep_in_chunks(ref, x, 3, torch.float32), whole)
    low = check.sweep_in_chunks(ref, x, 4, torch.bfloat16)
    assert low.dtype == torch.float32 and not torch.equal(low, whole)


def test_reference_equals_the_ports_plain_path():
    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.frontend.parser import parse_file

    ref = harness.load_module("reference", "jacobi3d")
    p = parse_file(harness.program_path("jacobi3d"))
    x = torch.rand((9, 7, 11), generator=torch.Generator().manual_seed(3))
    y = cuda.build_fn(p, grid_shape=(9, 7, 11), iterate=1)({"t0": x}, {})["t1"]
    src = lambda a, b: check.zero_outside(lambda lo, hi: x[lo:hi], a, b, 9, (7, 11),
                                          torch.float32, "cpu")
    got = check.compare_sweep(ref, src, lambda a, b: y[a:b], 9, (7, 11), 4, torch.float32,
                              "cpu")
    assert got == {"cells_off": 0, "max_gap": 0.0}
    y[4, 3, 5] += 1
    assert check.compare_sweep(ref, src, lambda a, b: y[a:b], 9, (7, 11), 4, torch.float32,
                               "cpu")["cells_off"] == 1


F32 = inputs.Spec.of({"dtype": "float32",
                      "inputs": {"dist": "uniform", "low": 0, "high": 1, "slab_planes": 4}})


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_inputs_made_again_plane_by_plane(seed):
    shape = (13, 4, 5)
    g = inputs.grid(shape, seed, F32, "cpu")
    assert g.dtype == torch.float32 and float(g.min()) >= 0 and float(g.max()) < 1
    assert torch.equal(inputs.planes(shape, seed, 3, 10, F32, "cpu"), g[3:10])
    edge = inputs.planes(shape, seed, -2, 2, F32, "cpu")
    assert torch.equal(edge[:2], torch.zeros(2, 4, 5)) and torch.equal(edge[2:], g[:2])
    tail = inputs.planes(shape, seed, 12, 15, F32, "cpu")
    assert torch.equal(tail[0], g[12]) and not tail[1:].any()
    assert not torch.equal(g, inputs.grid(shape, seed + 1, F32, "cpu"))


@pytest.mark.parametrize("dtype,low,high", [("uint16", 0, 4096), ("int32", -7, 9),
                                            ("float64", -2.0, 3.0), ("float32", 0, 1)])
def test_inputs_take_the_configs_dtype_and_range(dtype, low, high):
    spec = inputs.Spec.of({"dtype": dtype, "inputs": {"dist": "uniform", "low": low,
                                                      "high": high, "slab_planes": 3}})
    g = inputs.grid((7, 6, 5), 2**32 + 1, spec, "cpu")
    assert g.dtype == getattr(torch, dtype)
    v = g.double()
    assert float(v.min()) >= low and float(v.max()) < high and len(v.unique()) > 10
    assert torch.equal(inputs.planes((7, 6, 5), 2**32 + 1, 2, 6, spec, "cpu"), g[2:6])


@pytest.mark.parametrize("config,match", [
    ({"dtype": "float32", "inputs": {"dist": "normal", "low": 0, "high": 1,
                                     "slab_planes": 4}}, "makes only"),
    ({"dtype": "float33", "inputs": {"dist": "uniform", "low": 0, "high": 1,
                                     "slab_planes": 4}}, "no torch dtype"),
    ({"dtype": "int32", "inputs": {"dist": "uniform", "low": 3, "high": 3,
                                   "slab_planes": 4}}, "empty range")])
def test_inputs_refuse_what_the_generator_cannot_make(config, match):
    with pytest.raises(ValueError, match=match):
        inputs.Spec.of(config)


def test_trace_reduction_busy_gaps_and_breakdown():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.block", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 30, "pid": 0,
         "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 60, "dur": 30, "pid": 0,
         "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 30, "dur": 20, "pid": 1,
         "args": {"device": 1}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "portbench.block", "ts": 0,
         "dur": 100, "pid": 0, "args": {"device": 0}},
    ]
    got = devtrace.reduce(ev, [0, 1])
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == {0: pytest.approx(60e-6), 1: pytest.approx(20e-6)}
    assert got["device_ops"][0] == ["k1", pytest.approx(30e-6)]    # 60 us over 2 cards
    gaps = dict(got["idle_gaps"])
    # card 0 idles 0-10, 40-60, 90-100; card 1 0-30, 50-100; the gap 40-60
    # is during the synchronise, the rest in the block's own span
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(20e-6 / 2)
    assert gaps["portbench.block"] == pytest.approx((10 + 10 + 30 + 50) * 1e-6 / 2)
    assert devtrace.reduce(ev[:3], [0]) is None       # no device record
    assert devtrace.reduce(ev[1:], [0]) is None       # no window
