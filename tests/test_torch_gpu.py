"""The line-buffer kernels (1: 3-D z-march, 2: 2-D row-march), the fused
`iterate` cascades (`backend/sweeps.py`; rank 2 in the column march,
`backend/columns2d.py`, where it fits) and the windows kernel
(`backend/windows.py`, kernel 4) on the card against their plain version,
and the cascades and the windows kernel against the line-buffer kernels;
host tiling and the mesh (`parallel/mesh.py`, shards on one card), apart
and together, against the whole-grid kernels, and the mesh's grids kept
on the card between calls (`parallel/sharded.py`); the entry points
(`entry.py`) on the card.

Marked `gpu`; each test asks the `cuda_device` fixture for a card and skips
without one.  This file imports neither jax nor soda_tpu's TPU backends, so
it runs on the card's machine, which has no jax:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Gates: integers bit-exact; half bit-exact against the plain version (one
correctly rounded operation at a time on both sides); fused cascades bit
for bit against the chained kernels (the same operations in the same
order, no FMA); floats through
`compare_outputs` (f32 1e-4, f32 libm 2e-3, f64 1e-4) against the plain
PyTorch version on the card and against the port's NumPy reference, on
the whole grid; the windows kernel bit for bit against the line-buffer
kernel on programs that call no libm (the same operations in the same
order).
"""

import numpy as np
import pytest
import torch

from soda_tpu_torch.backend import cuda, eager, linebuffer, linebuffer2d, sweeps, windows
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse, parse_file
from soda_tpu_torch.plan.planner import fused_depths, plan
from soda_tpu_torch.utils.testing import (CORPUS, INT3D_SOURCES, RANK3_CORPUS,
                                          STAR3D_R8, compare_outputs, oracle,
                                          pinned_plan, rand_inputs)

torch.set_num_threads(1)

NAMES = list(RANK3_CORPUS) + list(INT3D_SOURCES)
ITERATE = ("jacobi2d", "seidel2d", "residual2d", "denoise2p", "jacobi2d_i64", "heat3d")


def _launches() -> int:
    return (linebuffer.LAUNCHES + linebuffer2d.LAUNCHES + sweeps.LAUNCHES
            + windows.LAUNCHES)


def _want(p, pl) -> int:
    return len(pl.groups) * max(p.iterate, 1) // pl.groups[0].sweeps


def _program(name):
    if name in INT3D_SOURCES:
        return parse(INT3D_SOURCES[name])
    return parse_file(CORPUS / f"{name}.soda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the H100 (README.md)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(32, 64, 128), (13, 37, 45)])
def test_kernel_matches_plain_and_oracle(cuda_device, name, shape):
    p = _program(name)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(10))
    before = _launches()
    got = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device))
    torch.cuda.synchronize()
    assert _launches() - before == _want(p, plan(p, shape))
    plain = to_numpy(p, eager.run(p, ins, ps, device=cuda_device))
    assert compare_outputs(p, got, plain, 0)
    assert compare_outputs(p, got, oracle(p, ins, ps), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 512, 512), (1026, 1026, 2048)])
def test_tma_fed_march_at_the_benchmark_sizes(cuda_device, shape):
    """Kernel 1 fed by TMA at the benchmark's sizes (jacobi3d 512^3, and
    the mesh cell's 1026 x 1026 x 2048 shard), bit for bit against the
    plain version computed slab by slab on the card (each slab with a
    plane of halo); its one launch is on the TMA feed."""
    p = _program("jacobi3d")
    fn = cuda.build_fn(p, grid_shape=shape)
    assert [g.feed for g in fn.plan.groups] == ["tma"]
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(shape, generator=gen, device=cuda_device)
    cuda.reset_launches()
    got = fn({"t0": x}, {})["t1"]
    torch.cuda.synchronize()
    assert cuda.feed_counts() == {"tma": 1, "scalar": 0}
    for a in range(0, shape[0], 64):
        lo, hi = max(a - 1, 0), min(a + 65, shape[0])
        plain = eager.run(p, {"t0": x[lo:hi]}, {}, device=cuda_device)["t1"]
        n = min(64, shape[0] - a)
        assert torch.equal(got[a:a + n], plain[a - lo:a - lo + n]), a


@pytest.mark.gpu
def test_kernel_on_many_tiles_and_chunks(cuda_device):
    p = _program("denoise3d")
    shape = (37, 70, 90)
    the_plan = plan(p, shape, tile=(8, 32), bz=8)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(11))
    got = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device, the_plan=the_plan))
    plain = to_numpy(p, eager.run(p, ins, ps, device=cuda_device))
    assert compare_outputs(p, got, plain, 0)


@pytest.mark.gpu
def test_wrapper_checks_dtype_and_contiguity(cuda_device):
    p = _program("jacobi3d")
    g = plan(p, (8, 16, 32)).groups[0]
    k = linebuffer.GroupKernel(p, g)
    x = torch.zeros((8, 16, 32), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        k({"t0": x}, {})
    y = torch.zeros((8, 32, 16), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k({"t0": y}, {})
    z = torch.zeros((8, 16, 32), device=cuda_device)
    with pytest.raises(ValueError, match="also an input"):
        k({"t0": z}, {}, out={"t1": z})


@pytest.mark.gpu
def test_iterate_ping_pong_keeps_the_feedback_input(cuda_device):
    p = _program("heat3d")
    ins, _ = rand_inputs(p, (16, 24, 40), np.random.default_rng(12))
    tins, _ = to_torch(p, ins, {}, cuda_device)
    keep = tins["heat_in"].clone()
    got = to_numpy(p, cuda.run(p, tins, {}, device=cuda_device, iterate=5))
    assert torch.equal(tins["heat_in"], keep)
    gold = oracle(p, ins, {}, iterate=5)
    assert compare_outputs(p, got, gold, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["blur", "smooth_half", "accum64", "mathfn_f64"])
@pytest.mark.parametrize("shape", [(64, 256), (37, 45), (7, 13)])
def test_row_march_matches_plain_and_oracle(cuda_device, name, shape):
    p = _program(name)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(15))
    before = _launches()
    got_t = cuda.run(p, ins, ps, device=cuda_device)
    torch.cuda.synchronize()
    assert _launches() - before == _want(p, plan(p, shape))
    plain_t = eager.run(p, ins, ps, device=cuda_device)
    got, plain = to_numpy(p, got_t), to_numpy(p, plain_t)
    for k in got:
        if p.tensors[k].type.is_int or p.tensors[k].type.width == 16:
            assert np.array_equal(got[k].view(np.uint8), plain[k].view(np.uint8)), k
    assert compare_outputs(p, got, plain, 0)
    assert compare_outputs(p, got, oracle(p, ins, ps), 0)


@pytest.mark.gpu
def test_row_march_on_many_strips_and_chunks(cuda_device):
    p = _program("sobel2d")
    shape = (301, 1003)
    the_plan = plan(p, shape, tile=(2, 32), bz=8)
    assert the_plan.groups[0].grid[0] * the_plan.groups[0].grid[1] > 1000
    ins, ps = rand_inputs(p, shape, np.random.default_rng(16))
    got = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device, the_plan=the_plan))
    plain = to_numpy(p, eager.run(p, ins, ps, device=cuda_device))
    assert np.array_equal(got["mag"], plain["mag"])
    assert np.array_equal(got["mag"], oracle(p, ins, ps)["mag"])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ITERATE)
@pytest.mark.parametrize("grid", ["aligned", "odd"])
def test_fused_cascade_equals_chained_bit_for_bit_and_plain(cuda_device, name, grid):
    p = _program(name)
    shape = {(2, "aligned"): (64, 256), (2, "odd"): (37, 45),
             (3, "aligned"): (32, 64, 128), (3, "odd"): (13, 37, 45)}[(p.rank, grid)]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(17))
    chained = cuda.run(p, ins, ps, device=cuda_device, sweeps=1)
    plain = to_numpy(p, eager.run(p, ins, ps, device=cuda_device))
    gold = oracle(p, ins, ps)
    depths = fused_depths(p, shape)
    assert depths and p.iterate % depths[-1] == 0
    for d in depths:
        pl = plan(p, shape, sweeps=d)
        before = sweeps.LAUNCHES
        got = cuda.run(p, ins, ps, device=cuda_device, sweeps=d)
        torch.cuda.synchronize()
        assert sweeps.LAUNCHES - before == _want(p, pl)
        for k in got:
            assert torch.equal(_bits(got[k]), _bits(chained[k])), (d, k)
        assert compare_outputs(p, to_numpy(p, got), plain, 0)
        assert compare_outputs(p, to_numpy(p, got), gold, 0)


@pytest.mark.gpu
def test_fused_cascade_on_many_tiles_and_chunks(cuda_device):
    p = _program("heat3d")
    shape = (37, 70, 90)
    pl = plan(p, shape, sweeps=4, tile=(8, 32), bz=8)
    assert pl.groups[0].sweeps == 4 and np.prod(pl.groups[0].grid) > 50
    ins, ps = rand_inputs(p, shape, np.random.default_rng(18))
    got = cuda.run(p, ins, ps, device=cuda_device, the_plan=pl)
    chained = cuda.run(p, ins, ps, device=cuda_device, sweeps=1)
    assert torch.equal(got["heat_out"], chained["heat_out"])
    assert compare_outputs(p, to_numpy(p, got), oracle(p, ins, ps), 0)


@pytest.mark.gpu
def test_column_march_at_the_benchmark_size(cuda_device):
    """jacobi2d 16384^2 x 8, a call of the cell `jacobi2d-16384.loop`: one
    launch of the column march (`cuda.march_counts()`), bit for bit against
    the rings' cascade at the same depth and against 8 chained one-sweep
    calls."""
    p = _program("jacobi2d")
    shape = (16384, 16384)
    fn = cuda.build_fn(p, grid_shape=shape)
    assert [(g.sweeps, g.march) for g in fn.plan.groups] == [(8, "columns")]
    rings = cuda.build_fn(p, pinned_plan(p, shape, {"sweeps": 8, "march": "rings"}))
    assert rings.plan.groups[0].march == "rings"
    chained = cuda.build_fn(p, grid_shape=shape, sweeps=1)
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    x = torch.randn(shape, generator=gen, device=cuda_device)
    cuda.reset_launches()
    got = fn({"t0": x}, {})["t1"]
    torch.cuda.synchronize()
    assert cuda.march_counts() == {"columns": 1, "rings": 0}
    assert torch.equal(_bits(got), _bits(rings({"t0": x}, {})["t1"]))
    assert torch.equal(_bits(got), _bits(chained({"t0": x}, {})["t1"]))


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1, 7, 300, 4099])
@pytest.mark.parametrize("block", [None, (32,)])
def test_rank1_windows_kernel_matches_plain_and_oracle(cuda_device, length, block):
    p = _program("smooth1d")
    ins, ps = rand_inputs(p, (length,), np.random.default_rng(19))
    before = windows.LAUNCHES
    got = cuda.run(p, ins, ps, device=cuda_device, block=block)
    torch.cuda.synchronize()
    assert windows.LAUNCHES - before == 1
    plain = eager.run(p, ins, ps, device=cuda_device)
    assert torch.equal(_bits(got["w_out"]), _bits(plain["w_out"]))
    assert np.array_equal(to_numpy(p, got)["w_out"], oracle(p, ins, ps)["w_out"])


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,block", [
    ("jacobi3d", (13, 37, 45), (4, 8, 32)), ("denoise3d", (13, 37, 45), (4, 8, 32)),
    ("divneg_i16", (13, 37, 45), (2, 4, 32)), ("blur", (37, 45), (8, 32)),
    ("accum64", (37, 45), (8, 32)), ("smooth_half", (37, 45), (8, 32)),
    ("mathfn2d", (37, 45), (8, 32)), ("conv5x5", (37, 45), (4, 32))])
def test_pinned_windows_kernel_matches_plain_and_line_buffer(cuda_device, name, shape, block):
    p = _program(name)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(20))
    pl = plan(p, shape, block=block)
    assert [g.kernel for g in pl.groups] == ["windows"] * len(pl.groups)
    before = windows.LAUNCHES
    got = cuda.run(p, ins, ps, device=cuda_device, block=block)
    torch.cuda.synchronize()
    assert windows.LAUNCHES - before == _want(p, pl)
    plain = eager.run(p, ins, ps, device=cuda_device)
    lb = cuda.run(p, ins, ps, device=cuda_device, sweeps=1)
    for k in got:
        if not p.tensors[k].type.is_float or p.tensors[k].type.width == 16:
            assert torch.equal(_bits(got[k]), _bits(plain[k])), k
        if not p.uses_libm_transcendentals():
            assert torch.equal(_bits(got[k]), _bits(lb[k])), k
    assert compare_outputs(p, to_numpy(p, got), to_numpy(p, plain), 0)
    assert compare_outputs(p, to_numpy(p, got), oracle(p, ins, ps), 0)


@pytest.mark.gpu
def test_radius8_star_falls_back_to_windows_on_the_card(cuda_device):
    p = parse(STAR3D_R8)
    shape = (40, 45, 51)
    pl = plan(p, shape)
    assert [g.kernel for g in pl.groups] == ["windows"] and pl.groups[0].direct == ["u"]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(21))
    got = cuda.run(p, ins, ps, device=cuda_device)
    plain = eager.run(p, ins, ps, device=cuda_device)
    lb = cuda.run(p, ins, ps, device=cuda_device, smem_budget=227 * 1024)
    assert torch.equal(_bits(got["v"]), _bits(plain["v"]))
    assert torch.equal(_bits(got["v"]), _bits(lb["v"]))
    assert compare_outputs(p, to_numpy(p, got), oracle(p, ins, ps), 0)


@pytest.mark.gpu
def test_windows_wrapper_checks_dtype_and_raises(cuda_device):
    p = _program("smooth1d")
    k = windows.GroupKernel(p, plan(p, (300,)).groups[0])
    x = torch.zeros(300, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        k({"w_in": x}, {})


@pytest.mark.gpu
def test_rank1_windows_kernel_past_2_to_31_cells(cuda_device):
    """64-bit offsets: smooth1d on 2^31 + 4099 cells (8 GiB per array).  The
    cells at both ends and on both sides of 2^31 equal the plain version on
    slices of the input that hold every tap they read, bit for bit."""
    p = _program("smooth1d")
    n = 2**31 + 4099
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    x = torch.randn(n, generator=gen, device=cuda_device)
    before = windows.LAUNCHES
    got = cuda.run(p, {"w_in": x}, device=cuda_device)["w_out"]
    torch.cuda.synchronize()
    assert windows.LAUNCHES - before == 1
    for a, b in [(0, 4096), (2**31 - 4096, 2**31 + 4096), (n - 4096, n)]:
        lo, hi = max(a - 2, 0), min(b + 2, n)
        want = eager.run(p, {"w_in": x[lo:hi].contiguous()}, device=cuda_device)["w_out"]
        assert torch.equal(_bits(got[a:b]), _bits(want[a - lo:b - lo])), (a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name,grid,tiles,nf", [
    ("jacobi2d", (300, 520), (64, 0), 1), ("jacobi2d", (300, 520), (64, 256), None),
    ("blur", (301, 517), (64, 128), None), ("jacobi3d", (40, 50, 130), (16, 16, 0), None),
    ("residual2d", (200, 264), (48, 0), 2)])
@pytest.mark.parametrize("in_flight", [1, 2])
def test_host_tiled_on_the_card(cuda_device, name, grid, tiles, nf, in_flight):
    """Host tiling with its copy and compute streams: bit for bit against
    the whole-grid kernels on the whole grid and against
    the same tiles on the CPU's plain versions (`compare_outputs`)."""
    from soda_tpu_torch.parallel.host_tile import run_host_tiled

    p = _program(name)
    ins, ps = rand_inputs(p, grid, np.random.default_rng(91))
    stats = {}
    before = _launches()
    got = run_host_tiled(p, ins, ps, tiles=tiles, sweeps_per_pass=nf,
                         in_flight=in_flight, stats=stats)
    assert _launches() > before and stats["in_flight"] == in_flight
    assert stats["h2d_bytes"] > 0 and stats["d2h_bytes"] > 0
    whole = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device))
    for k in whole:
        assert np.array_equal(got[k].view(np.uint8), whole[k].view(np.uint8)), k
    cpu = run_host_tiled(p, ins, ps, tiles=tiles, sweeps_per_pass=nf, device="cpu")
    assert compare_outputs(p, got, cpu, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cadence", [1, None])
def test_host_tiled_over_a_mesh_on_the_card(cuda_device, cadence):
    """Host tiling with each tile sharded over four shards of the card: the
    kernel launches equal the shards' group calls; bit for bit against the
    whole-grid kernels on the whole grid at one sweep an exchange, outside
    `valid_rim()` at the automatic cadence; and against the same tiles over
    CPU shards (`compare_outputs`)."""
    from soda_tpu_torch.parallel import mesh
    from soda_tpu_torch.parallel.host_tile import run_host_tiled

    p = _program("jacobi2d")
    grid, tiles = (300, 520), (64, 0)
    ins, ps = rand_inputs(p, grid, np.random.default_rng(95))
    stats = {}
    before = _launches()
    got = run_host_tiled(p, ins, ps, tiles=tiles, sweeps_per_exchange=cadence, stats=stats,
                         mesh=mesh.make_mesh([2, 2], devices=[cuda_device] * 4))
    assert _launches() - before == stats["mesh_group_calls"] > 0
    assert stats["mesh_exchange_bytes"] > 0 and np.prod(stats["n_tiles"]) > 1
    whole = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device))
    rim = 0 if cadence == 1 else p.valid_rim()
    inner = tuple(slice(rim, g - rim) for g in grid)
    for k in whole:
        assert np.array_equal(got[k][inner].view(np.uint8), whole[k][inner].view(np.uint8)), k
    cpu = run_host_tiled(p, ins, ps, tiles=tiles, sweeps_per_exchange=cadence,
                         mesh=mesh.make_mesh([2, 2], devices=["cpu"] * 4))
    assert compare_outputs(p, got, cpu, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [False, True])
def test_resident_grids_on_one_card(cuda_device, overlap):
    """Three chained calls with `ShardedGrid`s in and out on four shards of
    the card: no byte scattered or gathered, every group call a launch,
    the first output never written by the later calls, and the result bit
    for bit against `run_sharded` at three times the sweeps (the same
    schedule) and against the same loop on CPU shards (`compare_outputs`)."""
    from soda_tpu_torch.parallel import mesh
    from soda_tpu_torch.parallel.sharded import gather_grid, shard_grid

    p = _program("jacobi3d")
    grid = (20, 21, 40)
    ins, ps = rand_inputs(p, grid, np.random.default_rng(96))
    results = {}
    for where in (cuda_device, "cpu"):
        m = mesh.make_mesh([2, 2], devices=[where] * 4)
        fn = mesh.build_sharded_fn(p, m, grid_shape=grid, sweeps_per_exchange=1,
                                   overlap=overlap)
        g = {"t0": shard_grid(ins["t0"], m, fn.dims)}
        before = _launches()
        first = fn(g, ps)["t1"]
        kept = gather_grid(first, "cpu")
        out = first
        for _ in range(2):
            out = fn({"t0": out}, ps)["t1"]
        assert fn.stats["scatter_bytes"] == fn.stats["gather_bytes"] == 0
        if where != "cpu":
            torch.cuda.synchronize()
            assert _launches() - before == 3 * fn.stats["group_calls"] > 0
        assert torch.equal(gather_grid(first, "cpu"), kept)
        results[str(where)] = gather_grid(out, "cpu").numpy()
        want = mesh.run_sharded(p, ins, ps, mesh=m, iterate=3, sweeps_per_exchange=1,
                                overlap=overlap)["t1"].cpu().numpy()
        assert np.array_equal(results[str(where)].view(np.uint8), want.view(np.uint8))
    assert compare_outputs(p, {"t1": results[str(cuda_device)]}, {"t1": results["cpu"]}, 0)


@pytest.mark.gpu
def test_resident_calls_keep_no_buffer_on_the_cards(cuda_device):
    """jacobi3d on a [2, 2] mesh over every visible card (repeated where
    there are fewer than four), two resident calls: each card then holds no
    more than the input, the grid laid out from it and the grid returned
    (each storage rounded up to the allocator's 512 B): the sharded fn
    keeps no buffer of its own between calls."""
    from soda_tpu_torch.parallel import mesh
    from soda_tpu_torch.parallel.sharded import shard_grid

    p = _program("jacobi3d")
    grid = (64, 72, 128)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    before = {d: torch.cuda.memory_allocated(d) for d in cards}
    x = torch.rand(grid, device=cuda_device)
    m = mesh.make_mesh([2, 2], devices=(cards * 4)[:4])
    fn = mesh.build_sharded_fn(p, m, grid_shape=grid)
    start = shard_grid(x, m, fn.dims)
    out = start
    for _ in range(2):
        out = fn({"t0": out}, {})["t1"]
    held = {}
    for t in [x, *start.shards.values(), *out.shards.values()]:
        st = t.untyped_storage()
        held[(t.device, st.data_ptr())] = -(-st.nbytes() // 512) * 512
    for d in cards:
        torch.cuda.synchronize(d)
        own = sum(n for (dev, _), n in held.items() if dev == d)
        assert torch.cuda.memory_allocated(d) - before[d] <= own, d


@pytest.mark.gpu
def test_entry_points_on_the_card(cuda_device):
    """`entry()` runs its sweep through kernel 1 on the card, within 1e-4
    of the plain version; `dryrun_multichip(4)` passes its own checks with
    its shards on the visible cards, every group call a launch."""
    from soda_tpu_torch import entry

    fn, (x,) = entry.entry()
    assert x.device.type == "cuda"
    before = linebuffer.LAUNCHES
    got = fn(x)
    torch.cuda.synchronize()
    assert linebuffer.LAUNCHES - before == 1
    plain = eager.run(_program("jacobi3d"), {"t0": x}, {}, device=x.device)["t1"]
    assert float((got - plain).abs().max()) <= 1e-4
    for r in entry.dryrun_multichip(4).values():
        assert sum(r["launches"].values()) == r["group_calls"] > 0


@pytest.mark.gpu
def test_build_fn_writes_into_buffers_made_once(cuda_device):
    p = _program("residual2d")
    ins, ps = rand_inputs(p, (96, 136), np.random.default_rng(92))
    tins, tps = to_torch(p, ins, ps, cuda_device)
    fn = cuda.build_fn(p, grid_shape=(96, 136), sweeps=1)
    bufs = fn.alloc(cuda_device)
    got = fn(tins, tps, bufs=bufs)
    assert any(got[k].data_ptr() == b[k].data_ptr() for b in bufs for k in got)
    want = fn(tins, tps)
    assert all(torch.equal(got[k], want[k]) for k in got)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gauss5x5", "erode2d", "seidel2d"])
@pytest.mark.parametrize("shape", [(64, 256), (37, 45)])
def test_tcse_programs_on_the_card(cuda_device, name, shape):
    """The rewritten program's kernels against its plain version and its
    oracle on the whole grid, and against the original's kernels outside
    the rewritten program's rim."""
    from soda_tpu_torch.optimize import tcse

    p = _program(name)
    q = tcse.apply(p)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(93))
    got = to_numpy(q, cuda.run(q, ins, ps, device=cuda_device))
    assert compare_outputs(q, got, to_numpy(q, eager.run(q, ins, ps, device=cuda_device)), 0)
    assert compare_outputs(q, got, oracle(q, ins, ps), 0)
    orig = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device))
    assert compare_outputs(p, got, orig, q.valid_rim())


@pytest.mark.gpu
@pytest.mark.parametrize("name,grid,sizes,kw", [
    ("jacobi2d", (64, 96), [4], {"sweeps_per_exchange": 1}),
    ("jacobi2d", (100, 251), [4], {}),
    ("jacobi3d", (20, 21, 40), [2, 2], {}),
    ("blur", (67, 93), [4], {}),
    ("residual2d", (64, 96), [2, 2], {"sweeps_per_exchange": {"ax0": 4, "ax1": 2}}),
])
@pytest.mark.parametrize("overlap", [False, True])
def test_mesh_of_shards_on_one_card(cuda_device, name, grid, sizes, kw, overlap):
    """Every shard's local evaluation launches the kernels; the result
    equals the whole-grid kernels bit for bit outside the rim (on the whole
    grid for a single-stage program at one sweep an exchange) and the same
    mesh of CPU shards (`compare_outputs`)."""
    from soda_tpu_torch.parallel import mesh

    p = _program(name)
    ins, ps = rand_inputs(p, grid, np.random.default_rng(94))
    n = int(np.prod(sizes))
    m = mesh.make_mesh(sizes, devices=[cuda_device] * n)
    st = {}
    before = _launches()
    got = mesh.run_sharded(p, ins, ps, mesh=m, overlap=overlap, stats=st, **kw)
    torch.cuda.synchronize()
    assert _launches() - before == st["group_calls"] > 0
    assert st["exchange_bytes"] > 0 and got[p.output_names[0]].device == cuda_device
    whole = cuda.run(p, ins, ps, device=cuda_device)
    one = max(p.iterate, 1) == 1 or kw.get("sweeps_per_exchange") == 1
    rim = 0 if one and len(p.stage_order()) == 1 else p.valid_rim()
    inner = tuple(slice(rim, g - rim) for g in grid)
    for k in whole:
        assert torch.equal(_bits(got[k][inner].contiguous()),
                           _bits(whole[k][inner].contiguous())), k
    cpu = mesh.run_sharded(p, ins, ps, axis_sizes=sizes, devices=["cpu"] * n,
                           overlap=overlap, **kw)
    assert compare_outputs(p, to_numpy(p, got), to_numpy(p, cpu), 0)


def _denoise3d_inputs(shape, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return {"u": torch.rand(shape, generator=g, device=device),
            "rhs": torch.rand(shape, generator=g, device=device)}


@pytest.mark.gpu
def test_denoise3d_at_512_is_one_launch_of_three_stages_equal_to_the_reference(cuda_device):
    """The benchmark's multi-stage configuration on the main path: a call
    is one TMA-fed launch of kernel 1 computing three stages and moving the
    plan's bytes, bit for bit against the benchmark's reference computed on
    the card in blocks of 64 planes."""
    from portbench import harness

    ref = harness.load_module("reference", "denoise3d")
    p = parse_file(harness.program_path("denoise3d"))
    shape, h = (512, 512, 512), ref.HALO
    x = _denoise3d_inputs(shape, cuda_device, 18)
    fn = cuda.build_fn(p, grid_shape=shape)
    fn(x, {})
    torch.cuda.synchronize()
    cuda.reset_launches()
    got = fn(x, {})["unew"]
    torch.cuda.synchronize()
    (g,) = fn.plan.groups
    assert (g.stages, g.feed) == (["grad", "w", "unew"], "tma")
    assert sum(cuda.launch_counts().values()) == cuda.feed_counts()["tma"] == 1
    assert cuda.stage_count() == 3 and cuda.planned_bytes() == g.hbm_bytes_per_call

    def block(t, a, b):
        out = torch.zeros((b - a, *shape[1:]), device=cuda_device)
        out[max(a, 0) - a:min(b, shape[0]) - a] = t[max(a, 0):min(b, shape[0])]
        return out

    for z in range(0, shape[0], 64):
        want = ref.sweep_at(block(x["u"], z - h, z + 64 + h), z - h, shape[0],
                            block(x["rhs"], z - h, z + 64 + h))
        assert torch.equal(_bits(got[z:z + 64]), _bits(want)), z


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,dims", [([2, 2], [0, 1]), ([4], [0])])
def test_a_multi_stage_program_on_shards_of_one_card_equals_the_whole_grid(cuda_device,
                                                                           sizes, dims):
    """denoise3d kept on four shards of the card for three calls, u fed
    back and rhs fixed: bit for bit the whole-grid kernel's result on the
    whole grid, its faces included (an edge shard's window lies inside the
    grid)."""
    from soda_tpu_torch.parallel import mesh
    from soda_tpu_torch.parallel.sharded import gather_grid, shard_grid

    p = _program("denoise3d")
    grid = (64, 64, 128)
    x = _denoise3d_inputs(grid, cuda_device, 19)
    m = mesh.make_mesh(sizes, devices=[cuda_device] * 4)
    fn = mesh.build_sharded_fn(p, m, grid_shape=grid, dims=dims)
    whole = cuda.build_fn(p, grid_shape=grid)
    g = {n: shard_grid(t, m, fn.dims) for n, t in x.items()}
    u = x["u"]
    for _ in range(3):
        g["u"] = fn(g, {})["unew"]
        u = whole({"u": u, "rhs": x["rhs"]}, {})["unew"]
        assert torch.equal(_bits(gather_grid(g["u"], cuda_device)), _bits(u))
