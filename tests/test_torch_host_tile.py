"""Host tiling in the port (`soda_tpu_torch/parallel/host_tile.py`), the
cases of `tests/test_host_tile.py`.

- The geometry (`plan_host_tiling`, `choose_host_tiles`,
  `choose_sweeps_per_pass`) equals `soda_tpu`'s over a parametrised set of
  programs, grids, budgets and depths.  The footprint counts the port's
  storage bytes, which equal the reference's for every type below
  (`half` 2 B, 64-bit values 8 B).
- `run_host_tiled(device="cpu")` runs every tile through the plain
  versions of the port's main path.  With one sweep a pass it equals
  `soda_tpu`'s `run_host_tiled` (Pallas in interpret mode, as its own
  tests run it) bit for bit on grids with uneven edge tiles: on the whole
  grid for single-stage programs, outside the rim where the TPU kernel
  evaluates an intermediate stage from zero-padded inputs (blur).  It
  equals the port's whole-grid run bit for bit on the whole grid, with
  deeper passes too: a tile's window on the grid's edge evaluates every
  stage and sweep there as the whole grid does.
- `normalize_tiles` refuses a wrong rank and the entry point refuses a
  grid that disagrees with the inputs; without a card it raises
  `NoCudaDevice`.
- The mesh part: `_shard_ext_shape` and the mesh-aware tile choosers
  equal the reference's; `model_mesh_exchange` charges nf x (lo + hi)
  rows an axis, what the exchange moves (the reference charges 2 x nf x
  max(|lo|, hi), pinned on blur's one-sided creep); `run_host_tiled(mesh=
  ...)` on CPU shards equals the whole-grid run bit for bit at one sweep a
  pass and the reference's within `compare_outputs`; a mesh of more axes
  than the grid, or a mesh dim outside it, raises a ValueError naming
  both.
The overlap of two tiles on the card is checked by `chip_smoke.py`.
"""

import math
import pathlib

import numpy as np
import pytest
import torch

from soda_tpu.frontend import parser as lark_parser
from soda_tpu.parallel import host_tile as ref_tile
from soda_tpu.parallel import mesh as ref_mesh
from soda_tpu.utils.testing import compare_outputs
from soda_tpu_torch.backend import cuda
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.parallel import host_tile, mesh
from soda_tpu_torch.utils.device import NoCudaDevice
from soda_tpu_torch.utils.testing import U64_SOURCES, oracle, rand_inputs, u64_inputs

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
NAMES = ("blur", "sobel2d", "jacobi2d", "jacobi3d", "denoise3d", "residual2d",
         "smooth1d", "accum64", "smooth_half", "erode2d", "heat3d", "poisson3d_f64")
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in NAMES}
SOURCES["u64_2d"] = U64_SOURCES["u64_2d"]
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("name,grid,tiles,nf", [
    ("jacobi2d", (64, 256), (32, 128), None),
    ("jacobi2d", (64, 256), (32, 128), 2),
    ("jacobi2d", (64, 256), (32, 0), None),
    ("residual2d", (40, 150), (20, 80), 1),
    ("heat3d", (20, 30, 140), (8, 16, 70), 2),
    ("denoise3d", (16, 24, 140), (8, 12, 0), None),
    ("smooth1d", (700,), (256,), None),
])
def test_plan_host_tiling_equals_the_reference(name, grid, tiles, nf):
    assert (host_tile.plan_host_tiling(PROGRAMS[name], grid, tiles, nf)
            == ref_tile.plan_host_tiling(REF[name], grid, tiles, nf))


@pytest.mark.parametrize("name,grid", [
    ("jacobi3d", (2048, 2048, 2048)), ("jacobi3d", (1024, 1024, 1024)),
    ("jacobi2d", (32768, 32768)), ("blur", (70, 200)),
    ("accum64", (4096, 4096)), ("smooth_half", (8192, 8192)),
    ("poisson3d_f64", (512, 512, 512)), ("smooth1d", (2**28,)),
])
@pytest.mark.parametrize("budget", [2**14, 2**20, 2**31, 12 * 2**30])
@pytest.mark.parametrize("nf", [None, 1])
def test_choose_host_tiles_equals_the_reference(name, grid, budget, nf):
    p, r = PROGRAMS[name], REF[name]
    try:
        want = ref_tile.choose_host_tiles(r, grid, budget, nf)
    except ValueError:
        with pytest.raises(ValueError, match="cannot tile grid"):
            host_tile.choose_host_tiles(p, grid, budget, nf)
        return
    assert host_tile.choose_host_tiles(p, grid, budget, nf) == want


@pytest.mark.parametrize("name,grid,tiles,budget", [
    ("jacobi2d", (64, 256), (64, 256), None),
    ("jacobi2d", (64, 256), (8, 256), None),
    ("jacobi2d", (64, 64), (4, 4), None),
    ("jacobi2d", (64, 256), None, 64 * 2**10),
    ("jacobi2d", (32768, 32768), None, 2 * 2**30),
    ("residual2d", (4096, 4096), None, 2**24),
    ("heat3d", (512, 512, 512), None, 2**28),
])
def test_choose_sweeps_per_pass_equals_the_reference(name, grid, tiles, budget):
    assert (host_tile.choose_sweeps_per_pass(PROGRAMS[name], grid, tiles, budget)
            == ref_tile.choose_sweeps_per_pass(REF[name], grid, tiles, budget))


@pytest.mark.parametrize("name,grid,tiles", [
    ("erode2d", (40, 150), (16, 64)),
    ("blur", (67, 201), (32, 96)),
    ("jacobi2d", (45, 131), (16, 64)),
    ("jacobi3d", (11, 13, 70), (4, 8, 32)),
    ("u64_2d", (45, 131), (16, 64)),
])
def test_one_sweep_a_pass_equals_the_reference_and_the_whole_grid(name, grid, tiles):
    p, r = PROGRAMS[name], REF[name]
    ins, ps = u64_inputs(p, grid, np.random.default_rng(71))
    stats = {}
    got = host_tile.run_host_tiled(p, ins, ps, tiles=tiles, sweeps_per_pass=1,
                                   device="cpu", stats=stats)
    assert stats["passes"] == max(p.iterate, 1) and stats["sweeps_per_pass"] == 1
    assert all(n > 1 for n in stats["n_tiles"])
    assert any(g % t for g, t in zip(grid, tiles))       # an uneven edge tile
    whole = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    for k in whole:
        assert got[k].dtype == whole[k].dtype
        assert np.array_equal(_bits(got[k]), _bits(whole[k])), k
    ref = ref_tile.run_host_tiled(r, ins, ps, tiles=tiles, sweeps_per_pass=1,
                                  interpret=True)
    rim = 0 if len(p.stage_order()) == 1 else p.valid_rim()
    if rim == 0:
        for k in ref:
            assert np.array_equal(_bits(got[k]), _bits(np.asarray(ref[k]))), k
    else:
        assert compare_outputs(r, got, ref, rim)


@pytest.mark.parametrize("name,grid,tiles,nf", [
    ("jacobi2d", (60, 180), (40, 64), None),
    ("jacobi2d", (60, 180), (40, 64), 2),
    ("residual2d", (40, 150), (20, 80), None),
    ("heat3d", (12, 20, 70), (6, 8, 32), 2),
    ("accum64", (48, 160), (24, 80), None),
    ("smooth_half", (48, 160), (24, 80), None),
    ("smooth1d", (700,), (256,), None),
])
def test_deeper_passes_differ_only_inside_the_rim(name, grid, tiles, nf):
    """Deeper passes equal the whole-grid run bit for bit on the whole
    grid (the name is left from when they differed inside the rim)."""
    p = PROGRAMS[name]
    ins, ps = rand_inputs(p, grid, np.random.default_rng(72))
    got = host_tile.run_host_tiled(p, ins, ps, tiles=tiles, sweeps_per_pass=nf,
                                   device="cpu")
    whole = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    for k in whole:
        assert np.array_equal(_bits(got[k]), _bits(whole[k])), k


# a stage that is not zero on zero inputs: past the grid's edge the
# whole-grid run stores zero for it, which a tile's zero-filled halo would not
OFFSET_SOURCE = """kernel: offset
burst width: 64
iterate: 2
input int32: a(*, *)
local int32: t(0, 0) = a(0, 0) + a(0, 1) + 7
output int32: b(0, 0) = t(-1, 0) + t(1, -1) * 3 - t(0, 0)
"""


@pytest.mark.parametrize("tiles,nf", [((16, 48), 1), ((16, 48), 2), ((30, 0), 2),
                                      ((8, 40), None)])
def test_a_tile_on_the_grid_edge_stores_zero_for_an_intermediate_stage(tiles, nf):
    """The intermediate stage `t` is 7 on zero inputs: a tile's window on
    the grid's edge evaluates it there as the whole grid does (zero past
    the edge), so host tiling equals the whole-grid run and the oracle bit
    for bit on the whole grid, at one sweep a pass and deeper."""
    p = parse(OFFSET_SOURCE)
    x = np.random.default_rng(74).integers(-1000, 1000, (45, 101)).astype(np.int32)
    stats = {}
    got = host_tile.run_host_tiled(p, {"a": x}, tiles=tiles, sweeps_per_pass=nf,
                                   device="cpu", stats=stats)["b"]
    assert math.prod(stats["n_tiles"]) > 1
    whole = to_numpy(p, cuda.run(p, {"a": x}, device="cpu"))["b"]
    assert np.array_equal(got, whole)
    assert np.array_equal(got, oracle(p, {"a": x})["b"])


def test_normalize_tiles_and_the_entry_point_refuse_bad_input():
    assert host_tile.normalize_tiles((64, 256), (0, 300)) == (64, 256)
    with pytest.raises(ValueError, match="rank"):
        host_tile.normalize_tiles((64, 256), (32,))
    with pytest.raises(ValueError, match="must be >= 1"):
        host_tile.normalize_tiles((64, 256), (-3, 8))
    p = PROGRAMS["blur"]
    x = np.zeros((20, 30), np.uint16)
    with pytest.raises(ValueError, match="expected grid shape"):
        host_tile.run_host_tiled(p, {"input": x}, tiles=(8, 8),
                                 grid_shape=(21, 30), device="cpu")
    with pytest.raises(ValueError, match="must divide iterate"):
        host_tile.run_host_tiled(PROGRAMS["jacobi2d"], {"t0": x.astype(np.float32)},
                                 tiles=(8, 8), sweeps_per_pass=3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            host_tile.run_host_tiled(p, {"input": x}, tiles=(8, 8))
        with pytest.raises(NoCudaDevice):
            host_tile.default_hbm_budget()


@pytest.mark.parametrize("name,ext,mesh_shape,mesh_dims,nf", [
    ("blur", (64, 256), (4,), None, 1), ("blur", (64, 256), (2, 2), None, 1),
    ("jacobi3d", (64, 64, 64), (4, 2), None, 1), ("jacobi2d", (64, 256), (4,), None, 8),
    ("heat3d", (32, 32, 64), (2, 2), (1, 2), 2), ("residual2d", (40, 150), (3, 2), (1, 0), 4),
    ("smooth1d", (700,), (8,), None, 1),
])
def test_shard_ext_shape_equals_the_reference(name, ext, mesh_shape, mesh_dims, nf):
    assert (host_tile._shard_ext_shape(PROGRAMS[name], ext, mesh_shape, mesh_dims, nf)
            == ref_tile._shard_ext_shape(REF[name], ext, mesh_shape, mesh_dims, nf))


@pytest.mark.parametrize("name,grid,budget,mesh_shape,mesh_dims", [
    ("jacobi3d", (2048, 2048, 2048), 12 * 2**30, (4, 2), None),
    ("jacobi3d", (1024, 1024, 1024), 2**30, (2, 2), (1, 2)),
    ("jacobi2d", (32768, 32768), 2 * 2**30, (8,), None),
    ("heat3d", (512, 512, 512), 2**28, (2, 2), None),
])
def test_mesh_aware_tile_choice_equals_the_reference(name, grid, budget, mesh_shape,
                                                     mesh_dims):
    p, r = PROGRAMS[name], REF[name]
    got = host_tile.choose_host_tiles(p, grid, budget, 1, None, mesh_shape, mesh_dims)
    assert got == ref_tile.choose_host_tiles(r, grid, budget, 1, None, mesh_shape,
                                             mesh_dims)
    assert math.prod(got) > math.prod(host_tile.choose_host_tiles(p, grid, budget, 1))
    assert (host_tile.choose_sweeps_per_pass(p, grid, None, budget, None, mesh_shape,
                                             mesh_dims)
            == ref_tile.choose_sweeps_per_pass(r, grid, None, budget, None, mesh_shape,
                                               mesh_dims))


def test_model_mesh_exchange_charges_lo_plus_hi():
    # blur's creep is one-sided along its last dim (0, 2): two rows an
    # exchange, where the reference charges 2 x max(|lo|, hi) = 4
    p, r = PROGRAMS["blur"], REF["blur"]
    assert p.chain_creep()[1] == (0, 2)
    got, shard = host_tile.model_mesh_exchange(p, (64, 256), (4,), (1,), 1)
    assert shard == (64, 66) and got == 1 * (0 + 2) * 64 * 2
    assert ref_tile.model_mesh_exchange(r, (64, 256), (4,), (1,), 1)[0] == 2 * got
    # two axes: the first axis's rows span the second's centre, the
    # second's span the first's halos (the exchange's order)
    p3 = PROGRAMS["jacobi3d"]
    got3, shard3 = host_tile.model_mesh_exchange(p3, (64, 64, 64), (4, 2), None, 1)
    assert shard3 == (18, 34, 64)
    assert got3 == (2 * 32 * 64 + 2 * 18 * 64) * 4
    # axes of one device exchange nothing
    assert host_tile.model_mesh_exchange(p3, (64, 64, 64), (1, 1), None, 1)[0] == 0


@pytest.mark.parametrize("name,grid,tiles,sizes,nf", [
    ("jacobi2d", (64, 192), (32, 96), [4], 1),
    ("jacobi2d", (64, 192), (32, 96), [4], None),
    ("accum64", (48, 160), (24, 80), [2, 2], None),
    ("heat3d", (12, 20, 70), (6, 8, 32), [2, 2], 2),
])
def test_host_tiles_over_a_mesh_of_cpu_shards(name, grid, tiles, sizes, nf):
    p, r = PROGRAMS[name], REF[name]
    ins, ps = rand_inputs(p, grid, np.random.default_rng(73))
    n = math.prod(sizes)
    stats = {}
    got = host_tile.run_host_tiled(p, ins, ps, tiles=tiles, sweeps_per_pass=nf,
                                   mesh=mesh.make_mesh(sizes, devices=["cpu"] * n),
                                   stats=stats)
    assert stats["mesh_exchange_bytes"] > 0
    whole = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    rim = 0 if (nf or max(p.iterate, 1)) == 1 else p.valid_rim()
    inner = tuple(slice(rim, g - rim) for g in grid)
    for k in whole:
        assert np.array_equal(_bits(got[k][inner]), _bits(whole[k][inner])), k
    ref = ref_tile.run_host_tiled(r, ins, ps, tiles=tiles, sweeps_per_pass=nf,
                                  mesh=ref_mesh.make_mesh(sizes), interpret=True)
    assert compare_outputs(r, got, ref, rim)


def test_a_mesh_the_grid_cannot_hold_raises_before_tiling():
    p = PROGRAMS["jacobi2d"]
    x = {"t0": np.zeros((64, 96), np.float32)}
    cube = mesh.make_mesh([2, 2, 2], devices=["cpu"] * 8)
    with pytest.raises(ValueError, match=r"mesh of 3 axes \(2, 2, 2\) cannot shard a "
                                         r"grid of rank 2"):
        host_tile.run_host_tiled(p, x, tiles=(32, 48), mesh=cube)
    with pytest.raises(ValueError, match="cannot shard a grid of rank 2"):
        host_tile.choose_host_tiles(p, (64, 96), 2**20, mesh_shape=(2, 2, 2))
    with pytest.raises(ValueError, match="cannot shard a grid of rank 2"):
        host_tile.model_mesh_exchange(p, (64, 96), (2, 2, 2), None, 1)
    with pytest.raises(ValueError, match=r"mesh dims \(2,\) of the mesh \(4,\) must be "
                                         r"distinct dims of a grid of rank 2"):
        host_tile.choose_sweeps_per_pass(p, (64, 96), None, 2**20, mesh_shape=(4,),
                                         mesh_dims=(2,))
