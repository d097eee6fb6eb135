"""The Hopper planner (`soda_tpu_torch/plan/planner.py`) against soda_tpu's
planner and against its own byte and shared-memory model.

Tolerance: none (plans are integers); the runs at the end compare with the
NumPy oracle bit-exact (jacobi-style f32 sums in the same order) or under
`compare_outputs`.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.plan.planner import plan as jax_plan
from soda_tpu.utils.testing import compare_outputs, rand_inputs
from soda_tpu_torch.backend import cuda
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.frontend.parser import parse, parse_file
from soda_tpu_torch.plan import planner
from soda_tpu_torch.utils import report
from soda_tpu_torch.utils.testing import STAR3D_R8, U64_SOURCES

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
RANK3 = ["jacobi3d", "denoise3d", "gradmag3d", "orient3d", "heat3d",
         "poisson3d_f64"]


@pytest.mark.parametrize("name", RANK3)
@pytest.mark.parametrize("shape", [(16, 24, 128), (13, 37, 45)])
def test_grouping_equals_jax_planner(name, shape):
    p = parse_file(SODA / f"{name}.soda")
    ours = planner.plan(p, shape)
    ref = jax_plan(lark_parser.parse_file(SODA / f"{name}.soda"), shape)
    # a fused group's stages are its cascade of sweep copies (`name__itK`
    # for every sweep but the last, which keeps the program's names)
    assert ([([s for s in g.stages if "__it" not in s], g.external_inputs, g.outputs)
             for g in ours.groups]
            == [(g.stages, g.external_inputs, g.outputs) for g in ref.groups])
    for g in ours.groups:
        assert max(p.iterate, 1) % g.sweeps == 0
        assert g.stages == planner.cascade(p, g.sweeps).stage_order()
    assert ours.sweeps_total == max(p.iterate, 1)


def test_denoise3d_rings_follow_the_group_spans():
    p = parse_file(SODA / "denoise3d.soda")
    g = planner.plan(p, (64, 64, 64), tile=(16, 32), bz=8).groups[0]
    rings = {r.name: (r.depth, r.rows, r.cols) for r in g.rings}
    # u spans +-2 (tapped at +-1 by grad, which w and then unew tap at
    # +-1).  One wait a step: grad, w and unew at levels 1, 2, 3, each a
    # step behind the stage it reads.  A ring keeps at least lag + (w +
    # L_c) planes for each consumer c: the lag (its leading plane down to
    # the lowest c reads), w = the steps an input's planes are in flight
    # or 1 - L for a stage, and c's level.  The inputs are fed by TMA 3
    # steps ahead (the deepest that keeps four CTAs an SM: 4 would leave
    # three) and keep their own depths; the stages' rings a power of two.
    # u: unew (level 3) reads -1 against u's leading +2: 3 + 3 + 3 = 9;
    # rhs: unew reads 0: 0 + 3 + 3 = 6; grad: w (level 2) reads 0 at its
    # own leading plane: 0 + 0 + 2 -> 2; w: unew reads -1 against +1:
    # 2 - 1 + 3 -> 4.  u's rows are whole 16-byte chunks from column -4
    # (36 -> 40 columns); unew is not a ring
    assert rings == {"u": (9, 20, 40), "rhs": (6, 16, 32),
                     "grad": (2, 18, 34), "w": (4, 18, 34)}
    assert g.levels == {"grad": 1, "w": 2, "unew": 3} and g.sync == "skew"
    assert g.load == "vector" and [r.col0 for r in g.rings] == [-4, 0, -1, -1]
    assert (g.feed, g.ahead, g.ctas_per_sm) == ("tma", 3, 4)
    assert g.warm == 4
    # a fed ring's slots are 128-byte aligned (u: 3200 B, rhs: 2048 B);
    # after the rings, an 8-byte mbarrier for each of its slots
    fed = [r for r in g.rings if r.pitch]
    assert [(r.name, r.pitch * r.elem_bytes % 128, r.offset % 128) for r in fed] == [
        ("u", 0, 0), ("rhs", 0, 0)]
    assert g.smem_bytes == max(r.bar + 8 * r.depth for r in fed)
    assert g.grid == (2, 4, 8)


def test_bytes_count_tile_halos_and_z_warmup():
    p = parse_file(SODA / "jacobi3d.soda")
    g = planner.plan(p, (16, 64, 64), tile=(16, 32), bz=8).groups[0]
    # per dim: cells each tile loads, halo 1 on both sides, clipped to grid
    z = (8 + 1) + (1 + 8)            # two z-chunks of 8 planes
    y = (16 + 1) * 2 + (16 + 2) * 2  # four y-tiles of 16 rows
    # two x-tiles of 32 columns, each row copied in whole 16-byte chunks
    # from column -4 to 35 (the halo of 1 widened to 4 a side), clipped
    x = (32 + 4) * 2
    assert g.load == "vector" and g.rings[0].col0 == -4 and g.rings[0].cols == 40
    assert g.hbm_bytes_per_call == z * y * x * 4 + 16 * 64 * 64 * 4
    assert g.useful_cells_per_call == 16 * 64 * 64
    ideal = planner.plan(p, (16, 64, 64)).ideal_bytes_per_cell
    assert ideal == 8.0
    assert g.hbm_bytes_per_call / g.useful_cells_per_call > ideal


def test_full_size_plan_fills_the_card_within_shared_memory():
    p = parse_file(SODA / "jacobi3d.soda")
    g = planner.plan(p, (512, 512, 512)).groups[0]
    assert g.smem_bytes <= planner.SMEM_BUDGET
    assert np.prod(g.grid) >= 2 * planner.NUM_SMS
    # tile (32, 128) (the TMA feed's widest), chunks of 64 planes; a ring
    # row is 136 columns, the tile and its halo of 1 widened to whole
    # 16-byte chunks: the planned bytes count every column copied (8.554
    # B/cell against 8 ideal; 8.826 at (32, 64))
    assert (g.tile, g.bz, g.grid, g.feed) == ((32, 128), 64, (4, 16, 8), "tma")
    z = 65 * 2 + 66 * 6              # 8 chunks, the two at the edges clipped
    y = 33 * 2 + 34 * 14             # 16 tiles of 32 rows
    x = 132 * 2 + 136 * 2            # 4 tiles of 128 columns
    assert g.hbm_bytes_per_call == z * y * x * 4 + 512**3 * 4
    assert g.hbm_bytes_per_call / g.useful_cells_per_call < 8.56


def test_small_budget_splits_into_chained_groups_that_still_match():
    p = parse_file(SODA / "denoise3d.soda")
    pl = planner.plan(p, (12, 20, 40), smem_budget=12 * 1024)
    assert len(pl.groups) > 1
    assert any("split" in n for n in pl.notes)
    assert all(g.smem_bytes <= 12 * 1024 for g in pl.groups)
    ins, ps = rand_inputs(p, (12, 20, 40), np.random.default_rng(3))
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu", the_plan=pl))
    gold = numpy_interp.run(lark_parser.parse_file(SODA / "denoise3d.soda"), ins, ps)
    assert compare_outputs(p, got, gold, 0)


def test_stage_that_cannot_fit_is_refused():
    """A stage whose rings fit no line-buffer tile runs in the windows
    kernel (its input read tap by tap); only a grid that no windows block
    can launch (more than 65535 rows of CTAs) is refused."""
    p = parse_file(SODA / "jacobi3d.soda")
    g = planner.plan(p, (16, 16, 16), smem_budget=1024).groups[0]
    assert g.kernel == "windows" and g.direct == ["t0"] and g.smem_bytes == 0
    tall = parse_file(SODA / "jacobi2d.soda")
    with pytest.raises(ValueError, match="does not fit"):
        planner.plan(tall, (2**21, 3), smem_budget=64, sweeps=1)


def test_rank_two_is_refused_naming_the_roadmap():
    """Rank 2 plans to kernel 2 and rank 1 to the windows kernel (kernel 4);
    nothing is refused."""
    assert planner.plan(parse_file(SODA / "jacobi2d.soda"), (64, 64)).rank == 2
    p = parse_file(SODA / "smooth1d.soda")
    pl = planner.plan(p, (256,))
    (g,) = pl.groups
    assert pl.rank == 1 and g.kernel == "windows" and g.block == (4096,)
    assert [w.name for w in g.windows] == ["w_in"] and g.direct == []
    assert [w.extent for w in g.windows] == [(4100,)]
    assert g.grid == (1, 1, 1) and "windows" in pl.describe()
    assert planner.plan(p, (2**28,)).groups[0].grid == (2**16, 1, 1)


def test_sweeps_nondivisor_adjusted_not_underexecuted():
    """Requested sweeps that don't divide iterate are planned as a divisor,
    never silently under-executing sweeps (iterate=10, sweeps=3 -> 9 bug)."""
    src = ("kernel: t\niterate: 10\ninput float: a(16, 16, *)\n"
           "output float: b(0, 0, 0) = (a(-1, 0, 0) + a(0, 0, 0) + a(0, 1, 1)) / 3.0f\n")
    p = parse(src)
    pl = planner.plan(p, (10, 12, 40), sweeps=3)
    assert 10 % pl.groups[0].sweeps == 0
    assert any("requested sweeps 3" in n for n in pl.notes)
    x = np.random.default_rng(4).standard_normal((10, 12, 40)).astype(np.float32)
    got = to_numpy(p, cuda.run(p, {"a": x}, device="cpu", the_plan=pl))
    gold = numpy_interp.run(lark_parser.parse(src), {"a": x})
    assert np.array_equal(got["b"], gold["b"])


def test_build_fn_rejects_non_divisor_plan():
    """A caller-provided plan whose kernel depth does not divide the
    executed iterate raises instead of silently under-executing."""
    p = parse_file(SODA / "heat3d.soda")
    pl = planner.plan(p, (8, 16, 32))
    pl.groups[0] = dataclasses.replace(pl.groups[0], sweeps=4)  # divides 4
    cuda.build_fn(p, the_plan=pl)
    with pytest.raises(ValueError, match="does not divide"):
        cuda.build_fn(p, the_plan=pl, iterate=6)


def test_blur_row_rings_follow_the_group_spans():
    p = parse_file(SODA / "blur.soda")
    g = planner.plan(p, (64, 256), tile=(8, 128), bz=16).groups[0]
    assert g.kernel == "linebuffer2d"
    # input is tapped at x 0..2 by blur_x, which blur_y taps at y -1..1:
    # both rings span 3 rows, but a ring keeps only the rows from the
    # lowest a consumer reads in a step up to the highest written in it:
    # blur_x (level 1) reads input at its own leading rows (lag 0) while
    # the next step's rows are copied in (0 + 2 RB -> 16); blur_y (level
    # 2, a step behind blur_x) reads blur_x 2 rows below its leading one
    # (2 + 2 RB = 18 -> 32).  The input's rows are whole 16-byte chunks
    # (130 -> 136 columns), copied 16 bytes at a time
    rings = {r.name: (r.depth, r.rows, r.cols) for r in g.rings}
    assert rings == {"input": (16, 1, 136), "blur_x": (32, 1, 128)}
    assert g.load == "vector" and g.levels == {"blur_x": 1, "blur_y": 2}
    assert g.warm == 2 and g.grid == (2, 4, 1)
    assert g.smem_bytes == sum(-(-r.nbytes // 16) * 16 for r in g.rings)


def test_row_march_bytes_count_strip_halos_and_warmup():
    p = parse_file(SODA / "blur.soda")
    g = planner.plan(p, (64, 256), tile=(8, 128), bz=16).groups[0]
    rows = 17 + 18 + 18 + 17      # four chunks of 16 rows, halo 1 each side, clipped
    # two strips of 128 columns, x halo 2 on the right in whole 16-byte
    # chunks (130 -> 136 columns; the second strip's clipped to the grid)
    cols = 136 + 128
    assert g.hbm_bytes_per_call == rows * cols * 2 + 64 * 256 * 2
    assert g.useful_cells_per_call == 64 * 256


@pytest.mark.parametrize("name,shape", [("blur", (2048, 4096)),
                                        ("blur", (16384, 16384)),
                                        ("conv5x5", (16384, 16384)),
                                        ("mathfn_f64", (2048, 2048))])
def test_at_size_row_plans_fill_the_card_within_shared_memory(name, shape):
    p = parse_file(SODA / f"{name}.soda")
    pl = planner.plan(p, shape)
    for g in pl.groups:
        assert g.smem_bytes <= planner.SMEM_BUDGET
        assert np.prod(g.grid) >= 2 * planner.NUM_SMS
    plan_b = sum(g.hbm_bytes_per_call for g in pl.groups) / np.prod(shape)
    assert plan_b < pl.ideal_bytes_per_cell * 1.08


def test_block_pins_the_windows_kernel():
    p = parse_file(SODA / "denoise3d.soda")
    pl = planner.plan(p, (13, 37, 45), block=(4, 8, 32))
    (g,) = pl.groups
    assert g.kernel == "windows" and g.block == (4, 8, 32) and g.grid == (2, 5, 4)
    # the stages unew reads are held over their extents, then the inputs
    assert [(w.name, w.extent) for w in g.windows] == [
        ("grad", (6, 10, 34)), ("w", (6, 10, 34)), ("u", (8, 12, 36)),
        ("rhs", (4, 8, 32))]
    assert g.smem_bytes == sum(-(-w.nbytes // 16) * 16 for w in g.windows)
    assert any("block (4, 8, 32) pinned" in n for n in pl.notes)
    # an iterate program pinned to windows runs chained one-sweep calls
    h = parse_file(SODA / "heat3d.soda")
    ph = planner.plan(h, (13, 37, 45), block=(4, 8, 32))
    assert [g.sweeps for g in ph.groups] == [1] and ph.sweeps_total == 4
    with pytest.raises(ValueError, match="one sweep per call"):
        planner.plan(h, (13, 37, 45), block=(4, 8, 32), sweeps=2)
    with pytest.raises(ValueError, match="pin the line buffer"):
        planner.plan(p, (13, 37, 45), block=(4, 8, 32), tile=(8, 32))
    with pytest.raises(ValueError, match="positive sizes"):
        planner.plan(p, (13, 37, 45), block=(4, 8))


@pytest.mark.parametrize("budget,kernel", [(planner.SMEM_BUDGET, "windows"),
                                           (227 * 1024, "linebuffer3d")])
def test_radius8_star_falls_back_to_windows_at_the_default_budget(budget, kernel):
    p = parse(STAR3D_R8)
    assert p.radius() == 8
    assert sum(len(v) for v in p.tensors["v"].window().values()) == 49
    pl = planner.plan(p, (512, 512, 512), smem_budget=budget)
    (g,) = pl.groups
    assert g.kernel == kernel and g.smem_bytes <= budget
    if kernel == "windows":
        # no window of u fits 96 KB: read tap by tap, no shared memory
        assert g.direct == ["u"] and g.smem_bytes == 0
        assert any("no line-buffer tile of stage 'v'" in n for n in pl.notes)
        assert np.prod(g.grid) >= 2 * planner.NUM_SMS
    rep = report.analyze(pl)
    assert rep.bound_by == "bytes"
    assert abs(rep.bound_ms - 16 * 2**27 / 3.35e12 * 1e3) < 1e-12


def test_small_budget_makes_jacobi3d_fall_back():
    # a budget of 6687 B leaves no tile for the line buffer's ring of four
    # planes (the smallest tile, 8 x 32: 10 rows of 40 columns, whole
    # 16-byte chunks, 1600 B a slot padded to 1664 for the TMA feed, and
    # four 8-byte mbarriers: 6688 B): the stage runs in the windows
    # kernel, in the largest block whose window fits
    p = parse_file(SODA / "jacobi3d.soda")
    assert planner.plan(p, (16, 16, 16), smem_budget=6688).groups[0].kernel == "linebuffer3d"
    pl = planner.plan(p, (16, 16, 16), smem_budget=6687)
    (g,) = pl.groups
    assert g.kernel == "windows" and g.direct == [] and g.smem_bytes <= 6687
    ins, ps = rand_inputs(p, (16, 16, 16), np.random.default_rng(5))
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu", the_plan=pl))
    gold = numpy_interp.run(lark_parser.parse_file(SODA / "jacobi3d.soda"), ins, ps)
    assert np.array_equal(got["t1"], gold["t1"])


@pytest.mark.parametrize("sweeps", [None, 4])
def test_rank1_iterate_plans_chained_one_sweep_calls(sweeps):
    src = ("kernel: it1\niterate: 4\ninput float: a(64)\n"
           "output float: b(0) = (a(-1) + a(0) + a(1)) / 3.0f\n")
    p = parse(src)
    assert p.rank not in planner.AUTO_SWEEPS_MAX
    pl = planner.plan(p, (300,), sweeps=sweeps)
    assert [(g.kernel, g.sweeps) for g in pl.groups] == [("windows", 1)]
    assert pl.sweeps_total == 4 and planner.fused_depths(p, (300,)) == []
    assert any("4 chained call(s)" in n for n in pl.notes)
    x = np.random.default_rng(6).standard_normal(300).astype(np.float32)
    got = to_numpy(p, cuda.run(p, {"a": x}, device="cpu", sweeps=sweeps))
    assert np.array_equal(got["b"], numpy_interp.run(lark_parser.parse(src), {"a": x})["b"])


@pytest.mark.parametrize("name,shape,block", [("smooth1d", (4099,), None),
                                              ("smooth1d", (2**28,), None),
                                              ("blur", (37, 45), (8, 32)),
                                              ("jacobi3d", (512, 512, 512), (8, 8, 64)),
                                              ("denoise3d", (13, 37, 45), (4, 8, 32))])
def test_windows_bytes_per_cell_are_at_least_the_ideal(name, shape, block):
    p = parse_file(SODA / f"{name}.soda")
    pl = planner.plan(p, shape, block=block)
    (g,) = pl.groups
    assert g.kernel == "windows"
    cells = int(np.prod(shape))
    assert g.hbm_bytes_per_call >= pl.ideal_bytes_per_cell * cells
    # every input cell at least once, every output cell once
    assert g.useful_cells_per_call == cells * len(g.outputs)
    assert g.cell_ops_per_call >= pl.ops_per_cell * cells


def _pinned(name, shape, pin):
    from soda_tpu_torch.utils.testing import pinned_plan

    p = parse_file(SODA / f"{name}.soda")
    return pinned_plan(p, shape, pin).groups[0]


def test_rank3_rings_load_path_and_sync_are_pinned():
    """Kernel 1's rings: at least lag + (w + L_c) planes for each consumer
    c (`planner._ring_layout`); where the grid's rows are whole 16-byte
    chunks (`load` "vector") an input is fed by TMA, w steps ahead, in
    rows widened to whole 16-byte chunks and a ring of its own depth, else
    by element copies ("scalar") in a power of two; one wait a step
    (`sync` "skew") where the tile fits, else a barrier after each
    stage."""
    g = planner.plan(parse_file(SODA / "jacobi3d.soda"), (512, 512, 512)).groups[0]
    # the input is read at -1 by t1 (level 1) against its leading +1 and
    # copied a step ahead (a second would leave two CTAs an SM, not
    # three): 2 + 1 + 1 = 4 planes of 34 rows of 136 columns
    assert [(r.name, r.depth, r.rows, r.cols, r.col0) for r in g.rings] == [
        ("t0", 4, 34, 136, -4)]
    assert (g.load, g.sync, g.levels, g.threads) == ("vector", "skew", {"t1": 1}, 256)
    # 18,496 B a plane, padded to 18,560; four mbarriers
    assert g.smem_bytes == 4 * 18560 + 4 * 8
    assert ("feed=tma, ahead=1, load=vector, sync=skew, threads=256, ctas/SM=3"
            in g.describe())
    # an odd grid: element copies, a ring row exactly the tile and its halo
    g = _pinned("jacobi3d", (13, 37, 45), {"tile": (8, 32), "bz": 8})
    assert g.load == "scalar" and [(r.depth, r.cols, r.col0) for r in g.rings] == [
        (4, 34, -1)]
    # uint64: 16-byte chunks of two cells
    u = parse(U64_SOURCES["u64_3d"])
    g = planner.plan(u, (512, 512, 512)).groups[0]
    assert g.load == "vector" and (g.rings[0].col0, g.rings[0].cols) == (
        -2, g.tile[1] + 4)
    # denoise3d with a barrier after each stage: every stage at level 1,
    # shallower rings (the inputs 4 steps ahead: u 3 + 4 + 1 = 8, rhs 0 +
    # 4 + 1 = 5; grad 0 + 0 + 1 = 1, w 2 + 0 + 1 = 3 -> 4)
    g = _pinned("denoise3d", (64, 64, 64), {"tile": (16, 32), "bz": 8, "sync": "barrier"})
    assert g.sync == "barrier" and set(g.levels.values()) == {1} and g.ahead == 4
    assert {r.name: r.depth for r in g.rings} == {"u": 8, "rhs": 5, "grad": 1, "w": 4}


@pytest.mark.parametrize("sync", ["skew", "barrier"])
def test_rank3_cascade_levels_and_rings(sync):
    """heat3d x 4: copy k at level k + 1 (skew) or all at level 1
    (barrier); every copy's ring 4 planes either way (lag 2, plus the skew
    or the level, rounded up), the input's 5 (lag 2, its planes 2 steps in
    flight, the first copy's level)."""
    g = _pinned("heat3d", (64, 64, 64), {"sweeps": 4, "sync": sync})
    assert g.sweeps == 4 and g.sync == sync and g.warm == 8
    want = ({s: k + 1 for k, s in enumerate(g.stages)} if sync == "skew"
            else dict.fromkeys(g.stages, 1))
    assert g.levels == want
    assert (g.feed, g.ahead) == ("tma", 2)
    assert [r.depth for r in g.rings] == [5, 4, 4, 4]


def test_rank3_rings_keep_their_own_depth_where_powers_of_two_do_not_fit():
    """The radius-8 f64 star's ring needs 16 + 1 + 1 = 18 planes: 18 fit
    (16, 32) in 227 KB, one CTA an SM, so its planes are one step in
    flight; a plane's slot is a remainder, not a mask.  At the default
    budget it falls back to the windows kernel."""
    p = parse(STAR3D_R8)
    g = planner.plan(p, (512, 512, 512), smem_budget=227 * 1024).groups[0]
    assert g.kernel == "linebuffer3d" and [r.depth for r in g.rings] == [18]
    assert (g.feed, g.ahead, g.ctas_per_sm) == ("tma", 1, 1)
    assert g.tile == (16, 32) and g.smem_bytes == 18 * 32 * 48 * 8 + 18 * 8
    assert planner.plan(p, (512, 512, 512)).groups[0].kernel == "windows"
