"""Host tiling in the port (`soda_tpu_torch/parallel/host_tile.py`), the
cases of `tests/test_host_tile.py` without the mesh.

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
  evaluates an intermediate stage from zero-padded inputs (blur); and the
  port's whole-grid run bit for bit on the whole grid.  With deeper
  passes it differs from the whole-grid run only inside `valid_rim()`
  (tolerance: `compare_outputs` outside it, integers bit for bit).
- `normalize_tiles` refuses a wrong rank and the entry point refuses a
  grid that disagrees with the inputs; without a card it raises
  `NoCudaDevice`.
The overlap of two tiles on the card is checked by `chip_smoke.py`.
"""

import pathlib

import numpy as np
import pytest
import torch

from soda_tpu.frontend import parser as lark_parser
from soda_tpu.parallel import host_tile as ref_tile
from soda_tpu.utils.testing import compare_outputs
from soda_tpu_torch.backend import cuda
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.parallel import host_tile
from soda_tpu_torch.utils.device import NoCudaDevice
from soda_tpu_torch.utils.testing import rand_inputs

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
NAMES = ("blur", "sobel2d", "jacobi2d", "jacobi3d", "denoise3d", "residual2d",
         "smooth1d", "accum64", "smooth_half", "erode2d", "heat3d", "poisson3d_f64")
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in NAMES}
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
])
def test_one_sweep_a_pass_equals_the_reference_and_the_whole_grid(name, grid, tiles):
    p, r = PROGRAMS[name], REF[name]
    ins, ps = rand_inputs(p, grid, np.random.default_rng(71))
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
    p = PROGRAMS[name]
    ins, ps = rand_inputs(p, grid, np.random.default_rng(72))
    got = host_tile.run_host_tiled(p, ins, ps, tiles=tiles, sweeps_per_pass=nf,
                                   device="cpu")
    whole = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    rim = 0 if (nf or max(p.iterate, 1)) == 1 else p.valid_rim()
    assert compare_outputs(REF[name], got, whole, rim)


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
