"""The windows kernel (`soda_tpu_torch/backend/windows.py`), the port of TPU
kernel 4 (`soda_tpu/backend/pallas.py::build_group_fn`, windows branch).

No card here, so the kernel's generated source is compiled as host C++
(`-DSODA_HOST_EMULATION`, every CTA on one thread) and run:
- against the port's NumPy oracle on the whole grid, on smooth1d (rank 1)
  at lengths 1, 7, 300 and 1025, on jacobi3d, denoise3d (three stages),
  blur (uint16 division), accum64 (int64), poisson_f64, smooth_half and
  mathfn2d (libm) pinned to blocks that cut several CTAs on every axis of
  an odd grid, on inputs read tap by tap from device memory (a budget too
  small for their windows), and on the radius-8 f64 star (`STAR3D_R8`),
  which reaches the kernel through the planner's fallback.  Tolerance:
  bit for bit for every program that calls no libm (the same operations in
  the oracle's order, no FMA); `compare_outputs` (f32 libm 2e-3) for
  mathfn2d;
- against the JAX package's kernel 4 (`pallas.run(..., interpret=True)`,
  whose plan must be "windows") on the same numpy inputs: smooth1d (lifted
  to (1, X) by the JAX package, its default plan), and jacobi3d, denoise3d
  and blur with `block_override`.  Tolerance: `compare_outputs` outside
  `valid_rim()` (the TPU kernel evaluates intermediate stages from
  zero-padded inputs and so differs from the oracle inside the rim, and
  carries 32-bit integer accumulators); on the whole grid for the
  single-stage smooth1d and jacobi3d;
- the slice as a whole: `cuda.run(..., device="cpu")` on smooth1d against
  the JAX package's oracle, bit for bit.
The kernel on the card: `tests/test_torch_gpu.py` and `chip_smoke.py`.
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch

from soda_tpu.backend import pallas as pallas_backend
from soda_tpu.backend.pallas import _lift_rank1
from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.plan.planner import plan as jax_plan
from soda_tpu.utils.testing import compare_outputs, rand_inputs
from soda_tpu_torch.backend import cuda, linebuffer, linebuffer2d, sweeps, windows
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.plan import planner
from soda_tpu_torch.utils.testing import STAR3D_R8, emulate

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
NAMES = ("smooth1d", "jacobi3d", "denoise3d", "blur", "accum64", "poisson_f64",
         "smooth_half", "mathfn2d")
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in NAMES}
SOURCES["star3d_r8"] = STAR3D_R8
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}
# odd grids and blocks that cut several CTAs on every axis, per rank
ODD = {2: ((37, 45), (8, 32)), 3: ((13, 37, 45), (4, 8, 32))}


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _emulate(p, shape, ins, ps, **plan_kw):
    """The plan's groups as host-emulated kernels (`testing.emulate`);
    returns (outputs, plan)."""
    pl = planner.plan(p, shape, **plan_kw)
    return emulate(p, pl, ins, ps), pl


def _check_oracle(name, got, ins, ps):
    p = PROGRAMS[name]
    gold = numpy_interp.run(REF[name], ins, ps)
    if p.uses_libm_transcendentals():
        assert compare_outputs(p, got, gold, 0)
    else:
        for k in gold:
            assert np.array_equal(_bits(got[k]), _bits(gold[k])), k


@pytest.mark.parametrize("length,block", [(1, None), (1, (4,)), (7, None), (7, (4,)),
                                          (300, None), (300, (32,)),
                                          (1025, None), (1025, (128,))])
def test_rank1_emulated_kernel_equals_oracle(gxx, length, block):
    p = PROGRAMS["smooth1d"]
    ins, ps = rand_inputs(p, (length,), np.random.default_rng(41))
    got, pl = _emulate(p, (length,), ins, ps, block=block)
    (g,) = pl.groups
    assert g.kernel == "windows" and g.direct == []
    if block is not None:
        assert g.block == block and g.grid[0] == -(-length // block[0])
    _check_oracle("smooth1d", got, ins, ps)


@pytest.mark.parametrize("name", ["jacobi3d", "denoise3d", "blur", "accum64",
                                  "poisson_f64", "smooth_half", "mathfn2d"])
def test_pinned_emulated_kernel_equals_oracle(gxx, name):
    p = PROGRAMS[name]
    shape, block = ODD[p.rank]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(42))
    got, pl = _emulate(p, shape, ins, ps, block=block)
    assert [g.kernel for g in pl.groups] == ["windows"]
    g = pl.groups[0]
    assert g.block == block and all(n > 1 for n in g.grid[:p.rank])
    assert g.direct == []
    _check_oracle(name, got, ins, ps)


@pytest.mark.parametrize("name,shape,block,budget,held", [
    # denoise3d's two stages that another reads fill 16320 B of a 20000 B
    # budget, so u and rhs are read from device memory
    ("denoise3d", (13, 37, 100), (4, 8, 32), 20000, ["grad", "w"]),
    ("blur", (37, 300), (8, 32), 1200, ["blur_x"]),
    ("smooth1d", (1025,), (128,), 0, []),
])
def test_inputs_read_tap_by_tap_equal_oracle(gxx, name, shape, block, budget, held):
    # the grids are wide enough that some CTAs' windows lie inside them
    # (no bounds checks) and others cross an edge
    p = PROGRAMS[name]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(43))
    got, pl = _emulate(p, shape, ins, ps, block=block, smem_budget=budget)
    (g,) = pl.groups
    assert g.direct == list(p.input_names) and [w.name for w in g.windows] == held
    _check_oracle(name, got, ins, ps)


def test_stages_that_do_not_fit_split_into_chained_windows_groups(gxx):
    # at 8000 B w's extent (8160 B) does not fit beside unew, which reads
    # it at +-1: two windows groups chained through memory, the second
    # reading u and w tap by tap and holding rhs's window
    p = PROGRAMS["denoise3d"]
    shape = (13, 37, 45)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(48))
    got, pl = _emulate(p, shape, ins, ps, block=(4, 8, 32), smem_budget=8000)
    assert [g.stages for g in pl.groups] == [["grad", "w"], ["unew"]]
    assert all(g.kernel == "windows" and g.smem_bytes <= 8000 for g in pl.groups)
    assert pl.groups[1].direct == ["u", "w"]
    assert any("split 3 stages into 2" in n for n in pl.notes)
    _check_oracle("denoise3d", got, ins, ps)


def test_radius8_star_falls_back_and_equals_oracle(gxx):
    p = PROGRAMS["star3d_r8"]
    shape = (20, 21, 23)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(44))
    got, pl = _emulate(p, shape, ins, ps)
    (g,) = pl.groups
    assert g.kernel == "windows" and g.direct == ["u"]
    assert any("windows kernel" in n for n in pl.notes)
    _check_oracle("star3d_r8", got, ins, ps)


@pytest.mark.parametrize("name,shape,jax_block,block", [
    ("smooth1d", (1025,), None, None),
    ("jacobi3d", (16, 24, 40), (8, 8, 40), (4, 8, 32)),
    ("denoise3d", (16, 24, 40), (8, 8, 40), (4, 8, 32)),
    ("blur", (24, 40), (8, 40), (8, 32)),
])
def test_emulated_kernel_matches_jax_windows_kernel(gxx, name, shape, jax_block, block):
    p, ref = PROGRAMS[name], REF[name]
    kw = {} if jax_block is None else {"block_override": jax_block}
    if p.rank == 1:
        jp = jax_plan(_lift_rank1(ref), (1,) + shape)
    else:
        jp = jax_plan(ref, shape, **kw)
    assert [g.strategy for g in jp.groups] == ["windows"]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(45))
    got, pl = _emulate(p, shape, ins, ps, block=block)
    assert [g.kernel for g in pl.groups] == ["windows"]
    jax_out = pallas_backend.run(ref, ins, ps, interpret=True, **kw)
    single = len(p.stage_order()) == 1
    assert compare_outputs(p, got, jax_out, 0 if single else p.valid_rim())


def test_slice_on_the_cpu_path_equals_the_oracle():
    p = PROGRAMS["smooth1d"]
    ins, ps = rand_inputs(p, (4099,), np.random.default_rng(46))
    before = (linebuffer.LAUNCHES, linebuffer2d.LAUNCHES, sweeps.LAUNCHES,
              windows.LAUNCHES)
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    assert (linebuffer.LAUNCHES, linebuffer2d.LAUNCHES, sweeps.LAUNCHES,
            windows.LAUNCHES) == before
    gold = numpy_interp.run(REF["smooth1d"], ins, ps)
    assert np.array_equal(_bits(got["w_out"]), _bits(gold["w_out"]))


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    p = PROGRAMS["denoise3d"]
    shape = (9, 13, 40)
    g = planner.plan(p, shape, block=(4, 8, 32)).groups[0]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(47))
    tins, tps = to_torch(p, ins, ps, "cpu")
    before = windows.LAUNCHES
    k = windows.GroupKernel(p, g)
    out = k(tins, tps)
    assert windows.LAUNCHES == before and k._source is None
    gold = numpy_interp.run(REF["denoise3d"], ins, ps)
    assert compare_outputs(p, to_numpy(p, out), gold, 0)
    x = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        k({"u": x, "rhs": x}, {})
    with pytest.raises(ValueError, match="not a windows plan"):
        windows.GroupKernel(p, planner.plan(p, shape).groups[0])


def test_source_names_its_kernel_and_what_it_replaces():
    p1, p3 = PROGRAMS["smooth1d"], PROGRAMS["star3d_r8"]
    src1 = windows.kernel_source(p1, planner.plan(p1, (300,)).groups[0])
    src3 = windows.kernel_source(p3, planner.plan(p3, (20, 21, 23)).groups[0])
    for src in (src1, src3):
        assert "soda_win_kernel" in src and '#include "windows.cuh"' in src
        assert "build_group_fn" in src and "3.35 TB/s" in src
    # smooth1d's input is windowed; the star's is read tap by tap
    assert "soda_load_window<w_in_E0" in src1 and "soda_ldg(w_in_g" not in src1
    assert "soda_load_window" not in src3 and src3.count("soda_ldg(u_g") == 49
