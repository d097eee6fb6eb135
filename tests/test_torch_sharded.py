"""A grid kept on the mesh between calls (`soda_tpu_torch/parallel/sharded.py`
and the `ShardedGrid` path of `parallel/mesh.py::build_sharded_fn`), held
against `soda_tpu/parallel/mesh.py`'s jitted `shard_map` step on the
8-device CPU mesh that `tests/conftest.py` forces; the port's shards are
`["cpu"] * n`.  Inputs are made from a numpy seed.

- `shard_grid` -> `gather_grid` is bit for bit on even and uneven grids of
  rank 1-3 in f32, int64, uint64 at its extremes and `half`, and the pad
  rows read zero.
- Three resident calls (`fn`'s output fed back in): each returned shard
  equals the reference's block on the same mesh position after every
  call (`addressable_shards` of the jitted step fed its own output), on
  grids every mesh axis divides and programs of 32-bit types and narrower;
  the gathered grid on uneven grids and 64-bit programs, whose reference
  crosses its `shard_map` as plane pairs and comes back whole.  Integers
  bit for bit, floats within `compare_outputs`, as
  `tests/test_torch_mesh.py` holds the mesh to the reference.  The loop
  also equals the port's whole-tensor path (`run_sharded` at iterate x 3,
  the same cadence) bit for bit, and the whole-grid run bit for bit on
  the whole grid at one sweep an exchange for a single-stage program,
  outside `valid_rim()` otherwise.
- A returned grid is never written by the next call, with the synchronous
  and the overlap schedules.
- A `ShardedGrid` of another mesh, other dims, another grid or another
  dtype, and a mix of grids and tensors, are refused naming both layouts.
- The stats: the resident path scatters and gathers 0 bytes and exchanges
  the model's bytes; the whole-tensor path scatters and gathers the grid's
  storage bytes, by source device; `run_sharded` and host tiling over a
  mesh count the host as the only source.
"""

import math
import pathlib

import jax
import numpy as np
import pytest
import torch

from soda_tpu.frontend import parser as lark_parser
from soda_tpu.parallel import mesh as ref_mesh
from soda_tpu_torch.backend import cuda
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.parallel import host_tile, mesh
from soda_tpu_torch.parallel.sharded import (RUNS_MAX, ShardedGrid, copy_runs,
                                             gather_grid, narrow, shard_grid)
from soda_tpu_torch.utils.device import NoCudaDevice
from soda_tpu_torch.utils.testing import compare_outputs, u64_inputs

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in (
    "jacobi2d", "jacobi3d", "blur", "denoise2p", "jacobi2d_i64", "smooth1d")}
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}

# name -> (program, grid, mesh sizes, sharded dims, iterate a call, cadence)
LOOPS = {
    "jacobi2d-8": ("jacobi2d", (64, 96), [8], [0], 2, 1),
    "jacobi3d-2x4": ("jacobi3d", (16, 32, 48), [2, 4], [0, 1], 1, 1),
    "blur-2x4": ("blur", (64, 64), [2, 4], [1, 0], 1, 1),
    "denoise2p-4-cadence-2": ("denoise2p", (64, 128), [4], [0], 4, 2),
    "jacobi2d_i64-4": ("jacobi2d_i64", (64, 96), [4], [0], 2, 1),
    "jacobi2d-uneven-8": ("jacobi2d", (100, 252), [8], [0], 2, 1),
    "smooth1d-uneven-8": ("smooth1d", (999,), [8], [0], 1, 1),
}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _np(t):
    """A CPU tensor's values as numpy (uint64 through its int64 view)."""
    return t.view(torch.int64).numpy().view(np.uint64) if t.dtype == torch.uint64 else t.numpy()


def _cpu_mesh(sizes):
    return mesh.make_mesh(sizes, None, ["cpu"] * math.prod(sizes))


def _port_fn(name, grid, sizes, dims, it, cadence, overlap=False):
    return mesh.build_sharded_fn(PROGRAMS[name], _cpu_mesh(sizes), grid_shape=grid,
                                 dims=dims, iterate=it, sweeps_per_exchange=cadence,
                                 overlap=overlap)


def _inputs(name, grid, seed=21):
    return u64_inputs(PROGRAMS[name], grid, np.random.default_rng(seed))


def _wide(p) -> bool:
    return any(t.type.width == 64 for t in p.tensors.values())


def _feed(p, ins, outs):
    """The next call's inputs: the first output into the first input, the
    auxiliary inputs as they were."""
    return {**ins, p.input_names[0]: outs[p.output_names[0]]}


@pytest.mark.parametrize("shape,sizes,dims,dtype", [
    ((64,), [8], [0], np.float32),
    ((999,), [8], [0], np.float32),
    ((37, 45), [2, 4], [0, 1], np.int64),
    ((37, 45), [4, 2], [1, 0], np.uint64),
    ((16, 24, 40), [2, 4], [0, 1], np.float16),
    ((13, 21, 19), [2, 2, 2], [2, 0, 1], np.uint64),
    ((5, 128), [8], [0], np.float32),        # three shards wholly padding
])
def test_shard_then_gather_is_bit_for_bit_and_pads_read_zero(shape, sizes, dims, dtype):
    rng = np.random.default_rng(3)
    if dtype == np.uint64:
        x = rng.integers(0, 2**64 - 1, shape, dtype=np.uint64, endpoint=True)
        x.flat[:2] = (0, 2**64 - 1)
    elif np.dtype(dtype).kind == "i":
        x = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64, endpoint=True)
    else:
        x = rng.standard_normal(shape).astype(dtype)
    m = _cpu_mesh(sizes)
    stats = {}
    g = shard_grid(x, m, dims, stats=stats)
    assert g.grid_shape == shape and g.dims == tuple(dims)
    assert g.shard_shape == tuple(-(-n // sizes[dims.index(d)]) if d in dims else n
                                  for d, n in enumerate(shape))
    assert stats == {"scatter_bytes": x.nbytes, "scatter_from": {"cpu": x.nbytes}}
    # the grid zero-padded up to whole shards: each shard is its block
    padded = np.zeros([n * (sizes[dims.index(d)] if d in dims else 1)
                       for d, n in enumerate(g.shard_shape)], dtype)
    padded[tuple(slice(0, n) for n in shape)] = x
    for idx, s in g.shards.items():
        assert tuple(s.shape) == g.shard_shape and s.device == m.devices[idx]
        at = [0] * len(shape)
        for a, d in enumerate(dims):
            at[d] = idx[a]
        block = tuple(slice(i * n, (i + 1) * n) for i, n in zip(at, g.shard_shape))
        assert np.array_equal(_bits(_np(s)), _bits(padded[block])), idx
    back = gather_grid(g, "cpu", stats=stats)
    assert back.dtype == torch.from_numpy(x).dtype and tuple(back.shape) == shape
    assert np.array_equal(_bits(_np(back)), _bits(x)) and stats["gather_bytes"] == x.nbytes
    # from a tensor on a device of the mesh too, and into a tensor of the caller's
    again = torch.empty_like(back)
    assert gather_grid(shard_grid(torch.from_numpy(x), m, dims), "cpu", out=again) is again
    assert torch.equal(again.view(torch.uint8), back.view(torch.uint8))
    with pytest.raises(ValueError, match="into a .* tensor of"):
        gather_grid(g, "cpu", out=again[:1])


@pytest.mark.parametrize("shape,spans,copied", [
    ((8, 6, 10), {0: (2, 3), 1: (1, 4)}, True),     # 3 runs of a plane's rows
    ((8, 6, 10), {1: (0, 6)}, True),                # contiguous: one copy
    ((70, 70), {1: (5, 60)}, True),                 # 70 runs of a row each
    ((5000, 3), {1: (0, 2)}, False),                # more runs than RUNS_MAX
])
def test_copy_runs_copies_contiguous_runs_or_nothing(shape, spans, copied):
    grid = torch.arange(math.prod(shape), dtype=torch.int64).view(shape)
    dst = narrow(torch.zeros(shape, dtype=torch.int64), spans)
    block = narrow(grid, spans).contiguous()
    assert copy_runs(dst, block) == copied and RUNS_MAX < 5000
    assert torch.equal(dst, block if copied else torch.zeros_like(block))


def _ref_step(name, grid, sizes, dims, it, cadence):
    f = ref_mesh.build_sharded_fn(REF[name], ref_mesh.make_mesh(sizes), grid_shape=grid,
                                  dims=dims, iterate=it, sweeps_per_exchange=cadence)
    # the 64-bit path converts through numpy inside: not jittable, and whole
    return f if _wide(PROGRAMS[name]) else jax.jit(f)


def _ref_blocks(arr, shard_shape, dims):
    """The reference's output blocks by mesh position."""
    blocks = {}
    for sh in arr.addressable_shards:
        idx = tuple((sh.index[d].start or 0) // shard_shape[d] for d in dims)
        assert idx not in blocks
        blocks[idx] = np.asarray(sh.data)
    return blocks


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_three_resident_calls_equal_the_reference_step_fed_its_own_output(case):
    name, grid, sizes, dims, it, cadence = LOOPS[case]
    p, r = PROGRAMS[name], REF[name]
    ins, ps = _inputs(name, grid)
    fn = _port_fn(name, grid, sizes, dims, it, cadence)
    step = _ref_step(name, grid, sizes, dims, it, cadence)
    by_shard = not _wide(p) and all(grid[d] % m == 0 for m, d in zip(sizes, dims))
    m = _cpu_mesh(sizes)
    g = {n: shard_grid(v, m, fn.dims) for n, v in ins.items()}
    ref_ins = dict(ins)
    for call in range(3):
        out = fn(g, ps)
        assert fn.stats["scatter_bytes"] == fn.stats["gather_bytes"] == 0
        assert fn.stats["scatter_from"] == {} and fn.stats["group_calls"] > 0
        ref_out = step(ref_ins, ps)
        for n, og in out.items():
            assert isinstance(og, ShardedGrid) and og.grid_shape == grid
            assert og.shard_shape == fn.shard_shape and og.dims == tuple(dims)
            if by_shard:
                blocks = _ref_blocks(ref_out[n], og.shard_shape, dims)
                assert set(blocks) == set(og.shards)
                for idx, s in og.shards.items():
                    assert compare_outputs(r, {n: s.numpy()}, {n: blocks[idx]}, 0), (call, idx)
            else:
                whole = to_numpy(p, {n: gather_grid(og, "cpu")})
                assert compare_outputs(r, whole, {n: np.asarray(ref_out[n])}, 0), call
        g = _feed(p, g, out)
        ref_ins = _feed(p, ref_ins, {k: np.asarray(v) for k, v in ref_out.items()})
    got = to_numpy(p, {n: gather_grid(v, "cpu") for n, v in out.items()})
    # the whole-tensor path at three times the sweeps and the same cadence
    chained = to_numpy(p, mesh.run_sharded(p, ins, ps, mesh=_cpu_mesh(sizes), dims=dims,
                                           iterate=3 * it, sweeps_per_exchange=cadence))
    whole = to_numpy(p, cuda.run(p, ins, ps, device="cpu", iterate=3 * it))
    exact = cadence == 1 and len(p.stage_order()) == 1
    rim = 0 if exact else p.valid_rim(3 * it)
    inner = tuple(slice(rim, n - rim) for n in grid)
    for k in got:
        assert np.array_equal(_bits(got[k]), _bits(chained[k])), k
        assert np.array_equal(_bits(got[k][inner]), _bits(whole[k][inner])), k


@pytest.mark.parametrize("overlap", [False, True])
def test_a_returned_grid_is_not_written_by_the_next_call(overlap):
    name, grid, sizes, dims = "jacobi3d", (16, 32, 48), [2, 2], [0, 1]
    fn = _port_fn(name, grid, sizes, dims, 1, 1, overlap=overlap)
    ins, _ = _inputs(name, grid, seed=22)
    r1 = fn({"t0": shard_grid(ins["t0"], _cpu_mesh(sizes), dims)}, {})
    kept = {idx: s.clone() for idx, s in r1["t1"].shards.items()}
    r2 = fn({"t0": r1["t1"]}, {})
    r3 = fn({"t0": r1["t1"]}, {})
    for idx, s in r1["t1"].shards.items():
        assert torch.equal(s, kept[idx]), idx
        assert s.data_ptr() != r2["t1"].shards[idx].data_ptr()
        assert torch.equal(r2["t1"].shards[idx], r3["t1"].shards[idx])
    assert not torch.equal(r2["t1"].shards[(0, 0)], kept[(0, 0)])


def test_a_grid_laid_out_for_another_fn_is_refused():
    name, grid = "jacobi2d", (64, 96)
    fn = _port_fn(name, grid, [2, 4], [0, 1], 1, 1)
    x = _inputs(name, grid)[0]["t0"]
    text = r"laid out as grid .* this fn takes the grid \(64, 96\) in shards of \(32, 24\)"
    for g in (shard_grid(x, _cpu_mesh([8]), [0]),                                 # mesh
              shard_grid(x, mesh.make_mesh([2, 4], ["a", "b"], ["cpu"] * 8)),      # names
              shard_grid(x, _cpu_mesh([2, 4]), [1, 0]),                            # dims
              shard_grid(x[:, :90], _cpu_mesh([2, 4]), [0, 1])):                    # grid
        with pytest.raises(ValueError, match=text):
            fn({"t0": g}, {})
    with pytest.raises(ValueError, match="ShardedGrid of torch.float64; this fn takes "
                                         "torch.float32"):
        fn({"t0": shard_grid(x.astype(np.float64), _cpu_mesh([2, 4]), [0, 1])}, {})
    fn2 = _port_fn("denoise2p", grid, [4], [0], 4, 1)
    ins, _ = _inputs("denoise2p", grid)
    with pytest.raises(ValueError, match=r"inputs \['u'\] are ShardedGrids and the others"):
        fn2({"u": shard_grid(ins["u"], _cpu_mesh([4]), [0]),
             "f": torch.from_numpy(ins["f"])}, {})
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            gather_grid(shard_grid(x, _cpu_mesh([8]), [0]), "cuda")


def test_the_stats_of_each_path():
    name, grid, sizes, dims = "blur", (30, 36), [3, 3], [1, 0]
    p = PROGRAMS[name]
    ins, ps = _inputs(name, grid, seed=23)
    fn = _port_fn(name, grid, sizes, dims, 1, 1)
    nbytes = math.prod(grid) * 2
    fn({"input": torch.from_numpy(ins["input"])}, ps)
    whole = dict(fn.stats)
    assert whole["scatter_bytes"] == whole["gather_bytes"] == nbytes
    assert whole["scatter_from"] == {"cpu": nbytes}
    fn({"input": shard_grid(ins["input"], _cpu_mesh(sizes), dims)}, ps)
    assert fn.stats["scatter_bytes"] == fn.stats["gather_bytes"] == 0
    assert fn.stats["exchange_bytes"] == whole["exchange_bytes"]
    assert fn.stats["group_calls"] == whole["group_calls"] > 0
    # one exchange: a middle device's modelled bytes x 2 x the lines (as
    # tests/test_torch_mesh.py::test_exchanged_bytes_equal_the_model)
    per_dev, _ = host_tile.model_mesh_exchange(p, grid, sizes, dims, 1)
    assert fn.stats["exchange_bytes"] == per_dev * 2 * math.prod(sizes) // 3
    stats = {}
    mesh.run_sharded(p, ins, ps, mesh=_cpu_mesh(sizes), dims=dims, stats=stats)
    assert stats["scatter_from"] == {"cpu": nbytes} and stats["gather_bytes"] == nbytes
    # host tiling over a mesh: every tile's window from the host, nothing else
    st = {}
    q = PROGRAMS["jacobi2d"]
    x, _ = _inputs("jacobi2d", (64, 192), seed=24)
    got = host_tile.run_host_tiled(q, x, tiles=(32, 96), sweeps_per_pass=1,
                                   mesh=_cpu_mesh([2, 2]), stats=st)
    win = math.prod(st["ext_shape"]) * 4
    assert st["scatter_from"] == {"cpu": win * math.prod(st["n_tiles"]) * st["passes"]}
    want = to_numpy(q, cuda.run(q, x, {}, device="cpu"))
    assert np.array_equal(_bits(got["t1"]), _bits(want["t1"]))
