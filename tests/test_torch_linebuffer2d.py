"""Kernel 2, the 2-D row-march (`soda_tpu_torch/backend/linebuffer2d.py`).

No card here, so the kernel's source is checked three ways:
- the generated `.cu` holds the expected row-ring taps and no `std::` or
  `_Float16`;
- compiled as host C++ (`-DSODA_HOST_EMULATION`: every CTA on one
  thread, barriers trivially kept), the kernel's march runs the real
  strip, chunk, warm-up, ring and masking logic and must equal soda_tpu's
  NumPy oracle on the WHOLE grid, for every rank-2 corpus program of at
  most 64 bits: bit-exact for integers, and under `compare_outputs`
  otherwise (f32 1e-4, f32 libm 2e-3, half 2e-2; f64 libm at 1e-4), on an
  aligned grid, on an odd grid cut into many strips and chunks, and on
  grids smaller than one strip.  Skipped without g++;
- the same source under the hazard emulation (`-DSODA_HAZARD`: row copies
  land at issue, the stages of a step and the work items of a stage run
  in reverse order) on an aligned grid (16-byte row copies) and an odd one
  (element copies), and with the step's wait deleted from the source
  (a mismatch); against the JAX package's row-march (kernel 2, interpret
  mode) outside its rim;
- the wrapper takes the plain version on CPU tensors and counts no launch.
The kernel itself is held against its plain version on the card by
`tests/test_torch_gpu.py` and `chip_smoke.py`.
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch

from soda_tpu.backend import pallas as pallas_backend
from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.plan import planner as jax_planner
from soda_tpu.utils.testing import compare_outputs, rand_inputs
from soda_tpu_torch.backend import linebuffer2d
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.ir.dtypes import torch_dtype
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils.testing import RANK2_CORPUS, build_emulated, pinned_plan

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in RANK2_CORPUS}
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")


@pytest.fixture(scope="module")
def built():
    """The host emulation of every kernel the corpus and hazard cases below
    run, compiled in parallel up front (`build_emulated`)."""
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")

    def kernels(cases):
        return [linebuffer2d.GroupKernel(PROGRAMS[n], g) for n, shape, kw in cases
                for g in pinned_plan(PROGRAMS[n], shape, dict(kw, iterate=1)).groups]

    build_emulated(kernels([(n, shape, kw) for n in RANK2_CORPUS
                            for shape, kw in CORPUS_GRIDS]
                           + [(n, shape, {}) for n in SMALL_GRID_PROGRAMS
                              for shape in SMALL_GRIDS]))
    build_emulated(kernels(
        [(n, *HAZARD_GRIDS[grid]) for n in RANK2_CORPUS for grid in HAZARD_GRIDS]
        + [(n, shape, dict(kw, sync="barrier")) for n in MULTI_LEVEL
           for shape, kw in HAZARD_GRIDS.values()]), hazard=True)


def test_corpus_rank2_list_is_every_rank2_program_but_accum128():
    rank2 = {p.stem for p in SODA.glob("*.soda") if parse(p.read_text()).rank == 2}
    assert rank2 - set(RANK2_CORPUS) == {"accum128"}
    assert set(RANK2_CORPUS) <= rank2 and len(RANK2_CORPUS) == 22


def test_blur_source_taps_the_row_rings():
    p = PROGRAMS["blur"]
    g = plan(p, (64, 256)).groups[0]
    src = linebuffer2d.kernel_source(p, g)
    # a column run loads each tap of its rows from the ring once
    for ox in (0, 1, 2):
        assert (f"input_r[((pb + (0) - input_YLO) & (input_D - 1)) * input_C"
                f" + (lx + ({ox}) - input_XA)]") in src
    for oy in (-1, 0, 1):
        assert (f"blur_x_r[((pb + ({oy}) - blur_x_YLO) & (blur_x_D - 1)) * "
                f"blur_x_C + (lx + (0) - blur_x_XA)]") in src
    # the input rows: the first step's, then each next step's, 16 bytes a copy
    assert g.load == "vector"
    assert src.count("soda_fetch_rows_v<RB, input_C, NT>(") == 2
    assert "soda_fetch_rows_s" not in src.split("#ifndef SODA_HOST_EMULATION")[0]
    assert "// stage blur_x (ring, level 1)" in src
    assert "// outputs ['blur_y'] (level 2)" in src
    body = src.split("#ifndef SODA_HOST_EMULATION")[0]
    assert "std::" not in body and "c_div(" in body
    assert '#include "linebuffer2d.cuh"' in src
    # one wait a step, and no barrier between the stages
    loop = body.split("for (int st = -WSTEPS;")[1]
    assert loop.count("soda_step_wait();") == 1 and "SODA_SYNC" not in body
    # ring depths are powers of two of at least lag + (w + level) * RB for
    # each consumer: the input is copied a step ahead (w = 1) and read by
    # blur_x (level 1); blur_x (level 1, w = 0) is read by blur_y (level 2)
    # 2 rows below its leading one
    rb = g.tile[0]
    assert g.levels == {"blur_x": 1, "blur_y": 2}
    need = {"input": 0 + (1 + 1) * rb, "blur_x": 2 + (0 + 2) * rb}
    for r in g.rings:
        assert r.depth & (r.depth - 1) == 0
        assert r.depth >= need[r.name] > r.depth // 2


def test_smooth_half_source_uses_soda_half():
    p = PROGRAMS["smooth_half"]
    src = linebuffer2d.kernel_source(p, plan(p, (64, 256)).groups[0])
    assert "const soda_half* __restrict__ h_in_g" in src
    assert "soda_half* __restrict__ h_out_g" in src
    assert "_Float16" not in src


def _emulate(name, shape, seed, hazard=False, edit=None, **plan_kw):
    """The plan's groups as host-emulated kernels (`hazard`: under the
    hazard emulation; `edit`: a change to each generated source; `plan_kw`
    as `pinned_plan` takes them, `sync` included)."""
    p = PROGRAMS[name]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(seed))
    tins, tps = to_torch(p, ins, ps, "cpu")
    values = dict(tins)
    # one sweep: the iterate programs' fused cascades are tests/test_torch_sweeps.py's
    for g in pinned_plan(p, shape, dict(plan_kw, iterate=1)).groups:
        k = linebuffer2d.GroupKernel(p, g)
        if edit is not None:
            k._source = edit(k.source)
        entry = k.build(emulate=True, hazard=hazard).lib.soda_launch
        outs = {o: torch.empty(shape, dtype=torch_dtype(p.tensors[o].type))
                for o in g.outputs}
        k.launch(entry, values, tps, outs, 0)
        values.update(outs)
    got = to_numpy(p, {o: values[o] for o in p.output_names})
    return got, numpy_interp.run(REF[name], ins, ps, iterate=1)


def _check(p, got, gold):
    exact = not any(p.tensors[k].type.is_float for k in gold)
    if exact or not p.uses_libm_transcendentals():
        for k in gold:
            assert np.array_equal(got[k], gold[k]), k
    else:
        assert compare_outputs(p, got, gold, 0)


CORPUS_GRIDS = (((32, 256), {}),                           # planner's choice, aligned
                ((37, 45), {"tile": (2, 32), "bz": 8}))    # many strips and chunks, odd


@pytest.mark.parametrize("name", RANK2_CORPUS)
@pytest.mark.parametrize("shape,plan_kw", CORPUS_GRIDS)
def test_host_emulated_kernel_matches_oracle_on_whole_grid(built, name, shape, plan_kw):
    p = PROGRAMS[name]
    got, gold = _emulate(name, shape, seed=5, **plan_kw)
    _check(p, got, gold)


SMALL_GRID_PROGRAMS = ("blur", "sobel2d", "smooth_half", "accum64", "mathfn_f64",
                       "dilate2d")
SMALL_GRIDS = ((7, 13), (1, 3), (5, 300))


@pytest.mark.parametrize("name", SMALL_GRID_PROGRAMS)
@pytest.mark.parametrize("shape", SMALL_GRIDS)
def test_host_emulated_kernel_on_grids_smaller_than_a_strip_or_chunk(built, name, shape):
    got, gold = _emulate(name, shape, seed=6)
    _check(PROGRAMS[name], got, gold)


# an aligned grid whose rows are copied 16 bytes at a time, and an odd one
# copied element by element, each cut into several strips and chunks
HAZARD_GRIDS = {"aligned": ((64, 256), {"tile": (4, 64), "bz": 16}),
                "odd": ((37, 45), {"tile": (2, 32), "bz": 8})}


@pytest.mark.parametrize("name", RANK2_CORPUS)
@pytest.mark.parametrize("grid", sorted(HAZARD_GRIDS))
def test_hazard_emulated_kernel_matches_oracle_on_whole_grid(built, name, grid):
    """Row copies landing at issue and each step's stages (and each stage's
    work items) in reverse order: a copy or a stage that overwrote a row
    still read in its step, or a stage that read a row written in its own
    step, would show here."""
    shape, kw = HAZARD_GRIDS[grid]
    load = plan(PROGRAMS[name], shape, iterate=1, **kw).groups[0].load
    assert load == ("vector" if grid == "aligned" else "scalar")
    got, gold = _emulate(name, shape, seed=9, hazard=True, **kw)
    _check(PROGRAMS[name], got, gold)


# the corpus programs whose groups have stages that read other stages: the
# ones where the two orders of a step's stages differ
MULTI_LEVEL = sorted(
    n for n in RANK2_CORPUS
    if any(max(g.levels.values()) > 1 for g in plan(
        PROGRAMS[n], HAZARD_GRIDS["odd"][0], iterate=1, **HAZARD_GRIDS["odd"][1]).groups))


@pytest.mark.parametrize("name", MULTI_LEVEL)
@pytest.mark.parametrize("grid", sorted(HAZARD_GRIDS))
def test_hazard_emulated_barrier_sync_matches_oracle(built, name, grid):
    """Every stage at level 1 with a barrier after each (`sync="barrier"`,
    pinned through `pinned_plan`): copies land at issue and each stage's
    work items run in reverse order; the stages keep their order, which
    the barriers give."""
    shape, kw = HAZARD_GRIDS[grid]
    assert {g.sync for g in pinned_plan(PROGRAMS[name], shape, dict(
        kw, iterate=1, sync="barrier")).groups} == {"barrier"}
    got, gold = _emulate(name, shape, seed=12, hazard=True, sync="barrier", **kw)
    _check(PROGRAMS[name], got, gold)


def test_barrier_sync_source_has_a_barrier_between_stages():
    p = PROGRAMS["blur"]
    # the planner orders a step's stages; `plan()` takes no order
    assert plan(p, (64, 256), tile=(8, 128), bz=16).groups[0].sync == "skew"
    with pytest.raises(TypeError):
        plan(p, (64, 256), sync="barrier")
    g = pinned_plan(p, (64, 256), {"tile": (8, 128), "bz": 16,
                                   "sync": "barrier"}).groups[0]
    assert g.levels == {"blur_x": 1, "blur_y": 1}
    body = linebuffer2d.kernel_source(p, g).split("#ifndef SODA_HOST_EMULATION")[0]
    loop = body.split("for (int st = -WSTEPS;")[1]
    # blur_x, a barrier, then blur_y (no reversed copy), then the wait
    assert loop.count("SODA_SYNC();") == 1 and "SODA_HAZARD" not in loop
    assert loop.index("// stage blur_x") < loop.index("SODA_SYNC();") < loop.index(
        "// outputs ['blur_y']") < loop.index("soda_step_wait();")
    assert "DRAIN = 0;" in body
    assert MULTI_LEVEL and "blur" in MULTI_LEVEL and "conv5x5" not in MULTI_LEVEL


def _without_step_wait(src: str) -> str:
    step = src.split("for (int st = -WSTEPS;")
    assert step[1].count("    soda_step_wait();\n") == 1
    return step[0] + "for (int st = -WSTEPS;" + step[1].replace("    soda_step_wait();\n", "")


@pytest.mark.parametrize("grid", sorted(HAZARD_GRIDS))
def test_deleting_the_step_wait_breaks_the_emulated_kernel(gxx, grid):
    """The host emulation lands a row copy at the step's wait: with the
    wait deleted from the source, the rows never reach the rings."""
    shape, kw = HAZARD_GRIDS[grid]
    got, gold = _emulate("blur", shape, seed=10, **kw)
    assert np.array_equal(got["blur_y"], gold["blur_y"])
    got, gold = _emulate("blur", shape, seed=10, edit=_without_step_wait, **kw)
    assert not np.array_equal(got["blur_y"], gold["blur_y"])


def test_blur_matches_the_jax_row_march_outside_its_rim(gxx):
    """The new march against the JAX package's kernel 2 (its row-march,
    `_linebuffer.py::build_linebuffer2d_group_fn`, in interpret mode) on
    the same numpy inputs: equal outside `valid_rim()`, where the TPU
    kernel's constant-extent evaluation differs from the oracle by design,
    and equal to the oracle on the whole grid."""
    shape = (48, 128)
    ref, p = REF["blur"], PROGRAMS["blur"]
    jax_plan = jax_planner.plan(ref, shape, vmem_budget=4 * 2**20)
    assert jax_plan.groups[0].strategy == "linebuffer"
    got, gold = _emulate("blur", shape, seed=11, tile=(4, 64), bz=16)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(11))
    jax_out = pallas_backend.run(ref, ins, ps, the_plan=jax_plan, interpret=True)
    assert compare_outputs(p, got, jax_out, p.valid_rim())
    assert np.array_equal(got["blur_y"], gold["blur_y"])


def test_host_emulated_split_groups_match_oracle(gxx):
    # 8 KiB: the rings of the one-wait march (an input copied a step ahead,
    # stages skewed by level) are deeper than a march with synchronous row
    # loads and a barrier per stage needs, which split at 6 KiB
    name = "mathfn_f64"
    pl = plan(PROGRAMS[name], (21, 70), smem_budget=8 * 1024, tile=(4, 32), bz=8)
    assert len(pl.groups) > 1
    assert {g.kernel for g in pl.groups} == {"linebuffer2d"}
    got, gold = _emulate(name, (21, 70), seed=7, smem_budget=8 * 1024,
                         tile=(4, 32), bz=8)
    assert compare_outputs(PROGRAMS[name], got, gold, 0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    p = PROGRAMS["sobel2d"]
    shape = (12, 40)
    g = plan(p, shape).groups[0]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(8))
    tins, tps = to_torch(p, ins, ps, "cpu")
    before = linebuffer2d.LAUNCHES
    k = linebuffer2d.GroupKernel(p, g)
    out = k(tins, tps)
    assert linebuffer2d.LAUNCHES == before and k._source is None
    plain = linebuffer2d.group_plain(p, g, tins, tps)
    assert torch.equal(out["mag"], plain["mag"])
    gold = numpy_interp.run(REF["sobel2d"], ins, ps)
    assert np.array_equal(to_numpy(p, out)["mag"], gold["mag"])
    x = torch.empty(shape, device="meta", dtype=torch.uint16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k({"img": x}, {})
