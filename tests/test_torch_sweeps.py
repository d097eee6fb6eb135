"""Fused `iterate` sweeps (`soda_tpu_torch/backend/sweeps.py`), the port of
TPU kernel 3 (`soda_tpu/backend/pallas.py::_build_strips_group_fn`).

A fused group is the cascade of nf sweep copies (`optimize/unroll.py`) run
by the line-buffer marches.  No card here, so:
- the fused kernel's generated source is compiled as host C++
  (`-DSODA_HOST_EMULATION`, every CTA on one thread) and run for each of
  the six `iterate` corpus programs, at the planner's depth and at depth =
  iterate, on an odd grid cut into several strips and chunks and on a grid
  smaller than one strip; it must equal the port's NumPy oracle on the
  whole grid and the chained one-sweep kernels (emulated the same way),
  bit for bit on every output (these programs call no libm, so the f32
  operations are the oracle's, in its order);
- the rank-2 cascades of jacobi2d x 8, residual2d x 4 and jacobi2d_i64 x
  20 under the row-march's hazard emulation (copies land at issue, a
  step's stages and a stage's work items in reverse order) on an aligned
  grid (16-byte row copies) and an odd one, with a chunk shorter than the
  warm-up, bit for bit against the oracle; heat3d x 4 and x 2 under the
  z-march's, likewise;
- the same emulated kernel is held against the JAX package's kernel 3
  (`pallas.run(..., interpret=True)`, whose plan must be "strips") on the
  same numpy inputs, outside `valid_rim()` with `compare_outputs`: inside
  the rim the TPU kernel differs from the oracle by design;
- the slice as a whole (`cuda.run(device="cpu")`) against the JAX
  package's oracle on the whole grid, the wrapper's CPU path, the planner,
  the report's bound and the CLI's `--sweeps`.
The fused kernel on the card: `tests/test_torch_gpu.py` and `chip_smoke.py`.
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch

from soda_tpu.backend import pallas as pallas_backend
from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.plan.planner import plan as jax_plan
from soda_tpu.utils.testing import compare_outputs, rand_inputs
from soda_tpu_torch.backend import cuda, linebuffer, linebuffer2d, sweeps
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.cli import sodac
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.optimize.unroll import FeedbackTypeError, unroll_iterate
from soda_tpu_torch.plan import planner
from soda_tpu_torch.utils import report
from soda_tpu_torch.utils.testing import build_emulated, emulate, pinned_plan

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
NAMES = ("jacobi2d", "seidel2d", "residual2d", "denoise2p", "jacobi2d_i64", "heat3d")
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in NAMES}
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}
# an odd grid cut into several strips (tiles) and chunks, and a grid
# smaller than one strip, per rank
ODD = {2: ((37, 45), {"tile": (2, 32), "bz": 8}),
       3: ((13, 37, 45), {"tile": (8, 32), "bz": 8})}
TINY = {2: ((7, 13), {}), 3: ((7, 11, 13), {})}


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")


@pytest.fixture(scope="module")
def built():
    """The host emulation of every fused and chained kernel the emulated
    cases below run, compiled in parallel up front (`build_emulated`)."""
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")

    def kernels(cases):
        return [cuda.group_kernel(PROGRAMS[n], g) for n, shape, kw in cases
                for g in pinned_plan(PROGRAMS[n], shape, kw).groups]

    plain = []
    for n in NAMES:
        rank, it = PROGRAMS[n].rank, PROGRAMS[n].iterate
        for shape, kw in (ODD[rank], TINY[rank]):
            plain += [(n, shape, kw), (n, shape, dict(kw, sweeps=it)),
                      (n, shape, dict(ODD[rank][1], sweeps=1))]
    build_emulated(kernels(plain + [(n, shape, {}) for n, shape in JAX_ROWS]))
    build_emulated(kernels([(n, shape, dict(_cascade_kw(n, kw), sync=sync))
                            for n in HAZARD_CASCADES for shape, kw in HAZARD_SHAPES
                            for sync in ("skew", "barrier")]
                           + [("heat3d", shape, dict(kw, sweeps=nf, sync=sync))
                              for shape, kw in HAZARD_SHAPES_3D for nf in (2, 4)
                              for sync in ("skew", "barrier")]), hazard=True)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _emulate(p, shape, ins, ps, hazard=False, **plan_kw):
    """The plan's groups as host-emulated kernels (`hazard`: under the
    row-march's hazard emulation), `iterate / nf` calls with the feedback
    of `cuda.build_fn` (`testing.emulate`); returns (outputs, plan)."""
    pl = pinned_plan(p, shape, plan_kw)
    return emulate(p, pl, ins, ps, hazard=hazard), pl


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("grid", ["odd", "tiny"])
@pytest.mark.parametrize("depth", ["planner", "iterate"])
def test_host_emulated_fused_kernel_equals_oracle_and_chained(built, name, grid, depth):
    p = PROGRAMS[name]
    shape, kw = (ODD if grid == "odd" else TINY)[p.rank]
    if depth == "iterate":
        kw = dict(kw, sweeps=p.iterate)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(31))
    got, pl = _emulate(p, shape, ins, ps, **kw)
    nf = pl.groups[0].sweeps
    assert len(pl.groups) == 1 and nf > 1 and p.iterate % nf == 0
    if depth == "iterate":
        assert nf == p.iterate
    if grid == "odd":
        assert pl.groups[0].grid[0] * pl.groups[0].grid[1] * pl.groups[0].grid[2] > 4
    else:
        assert pl.groups[0].grid == (1, 1, 1)
    gold = numpy_interp.run(REF[name], ins, ps)
    chained, cpl = _emulate(p, shape, ins, ps, sweeps=1, **ODD[p.rank][1])
    assert cpl.groups[0].sweeps == 1
    for k in gold:
        assert np.array_equal(_bits(got[k]), _bits(gold[k])), k
        assert np.array_equal(_bits(got[k]), _bits(chained[k])), k


HAZARD_CASCADES = ("jacobi2d", "residual2d", "jacobi2d_i64")
HAZARD_SHAPES = (((64, 256), {"tile": (4, 64), "bz": 4}),
                 ((37, 45), {"tile": (2, 32), "bz": 4}))


def _cascade_kw(name, kw):
    """The whole `iterate` in one call; jacobi2d_i64's 20 int64 rings fit
    the budget one row a step."""
    kw = dict(kw, sweeps=PROGRAMS[name].iterate)
    return dict(kw, tile=(1, 32)) if name == "jacobi2d_i64" else kw


@pytest.mark.parametrize("name", HAZARD_CASCADES)
@pytest.mark.parametrize("shape,kw", HAZARD_SHAPES)
@pytest.mark.parametrize("sync", ["skew", "barrier"])
def test_hazard_emulated_rank2_cascade_equals_oracle(built, name, shape, kw, sync):
    """The whole `iterate` in one fused call (nf = iterate), each chunk
    shorter than the cascade's warm-up (2 x nf rows), with a step's copies
    skewed by level (one wait a step) or all at level 1 with a barrier
    after each (pinned through `pinned_plan`)."""
    p = PROGRAMS[name]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(36))
    got, pl = _emulate(p, shape, ins, ps, hazard=True, sync=sync, **_cascade_kw(name, kw))
    (g,) = pl.groups
    assert g.sweeps == p.iterate and g.bz < g.warm and g.sync == sync
    assert max(g.levels.values()) == (len(g.stages) if sync == "skew" else 1)
    assert g.load == ("vector" if shape[1] == 256 else "scalar")
    gold = numpy_interp.run(REF[name], ins, ps)
    for k in gold:
        assert np.array_equal(_bits(got[k]), _bits(gold[k])), k


# a grid whose planes are copied 16 bytes at a time and an odd one, each
# cut into several tiles, in chunks of 4 planes (the warm-up of 2 x nf
# planes is 4 at nf 2 and 8 at nf 4)
HAZARD_SHAPES_3D = (((16, 24, 128), {"tile": (8, 32), "bz": 4}),
                    ((13, 37, 45), {"tile": (8, 32), "bz": 4}))


@pytest.mark.parametrize("shape,kw", HAZARD_SHAPES_3D)
@pytest.mark.parametrize("nf", [2, 4])
@pytest.mark.parametrize("sync", ["skew", "barrier"])
def test_hazard_emulated_rank3_cascade_equals_oracle(built, shape, kw, nf, sync):
    """heat3d's cascade in kernel 1's z-march, the planes of the next step
    in flight: copy k a step behind copy k - 1 (one wait a step) or all
    at level 1 with a barrier after each; copies land at issue and a
    step's copies (skew) and a copy's work items run in reverse order."""
    p = PROGRAMS["heat3d"]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(38))
    got, pl = _emulate(p, shape, ins, ps, hazard=True, sweeps=nf, sync=sync, **kw)
    (g,) = pl.groups
    assert g.kernel == "linebuffer3d" and g.sweeps == nf and g.sync == sync
    assert g.bz <= g.warm and max(g.levels.values()) == (nf if sync == "skew" else 1)
    assert g.load == ("vector" if shape[2] == 128 else "scalar")
    gold = numpy_interp.run(REF["heat3d"], ins, ps)
    for k in gold:
        assert np.array_equal(_bits(got[k]), _bits(gold[k])), k


JAX_ROWS = (
    ("jacobi2d", (200, 384)),        # tests/test_backends.py:332
    ("residual2d", (48, 128)),       # tests/test_backends.py:247
    ("residual2d", (50, 128)),
    ("seidel2d", (48, 128)),
    ("denoise2p", (48, 128)),
    ("jacobi2d_i64", (64, 128)),
    ("heat3d", (16, 16, 128)),       # 8 planes leave none outside the rim of 4
)


@pytest.mark.parametrize("name,shape", JAX_ROWS)
def test_fused_kernel_matches_jax_strips_kernel_outside_the_rim(built, name, shape):
    p, ref = PROGRAMS[name], REF[name]
    assert jax_plan(ref, shape).groups[0].strategy == "strips"
    ins, ps = rand_inputs(p, shape, np.random.default_rng(32))
    got, pl = _emulate(p, shape, ins, ps)
    assert pl.groups[0].sweeps > 1
    jax_out = pallas_backend.run(ref, ins, ps, interpret=True)
    assert compare_outputs(p, got, jax_out, p.valid_rim())
    assert compare_outputs(p, got, numpy_interp.run(ref, ins, ps), 0)


def test_jacobi2d_x8_cascade_matches_jax_strips_kernel_outside_the_rim(gxx):
    """The whole iterate 8 in one call of the one-wait row-march (eight
    copies, each a step behind the one before) against the JAX package's
    kernel 3 on the same numpy inputs."""
    p, ref, shape = PROGRAMS["jacobi2d"], REF["jacobi2d"], (200, 384)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(37))
    got, pl = _emulate(p, shape, ins, ps, sweeps=8)
    assert pl.groups[0].sweeps == 8 and max(pl.groups[0].levels.values()) == 8
    jax_out = pallas_backend.run(ref, ins, ps, interpret=True)
    assert compare_outputs(p, got, jax_out, p.valid_rim())
    assert np.array_equal(got["t1"], numpy_interp.run(ref, ins, ps)["t1"])


@pytest.mark.parametrize("name", NAMES)
def test_slice_on_the_cpu_path_equals_the_oracle(name):
    """The main path's CPU route (plan, fused group's plain version,
    iterate / nf calls) on an odd grid; no launch is counted."""
    p = PROGRAMS[name]
    shape = (19, 45) if p.rank == 2 else (9, 13, 40)
    assert planner.plan(p, shape).groups[0].sweeps > 1
    ins, ps = rand_inputs(p, shape, np.random.default_rng(33))
    before = (linebuffer.LAUNCHES, linebuffer2d.LAUNCHES, sweeps.LAUNCHES)
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    assert (linebuffer.LAUNCHES, linebuffer2d.LAUNCHES, sweeps.LAUNCHES) == before
    gold = numpy_interp.run(REF[name], ins, ps)
    for k in gold:
        assert np.array_equal(_bits(got[k]), _bits(gold[k])), k


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    p = PROGRAMS["residual2d"]
    shape = (12, 40)
    g = planner.plan(p, shape).groups[0]
    assert g.sweeps == 4 and g.outputs == ["t1", "res"]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(34))
    tins, tps = to_torch(p, ins, ps, "cpu")
    before = sweeps.LAUNCHES
    k = sweeps.GroupKernel(p, g)
    out = k(tins, tps)
    assert sweeps.LAUNCHES == before and k._source is None
    gold = numpy_interp.run(REF["residual2d"], ins, ps)
    for n in gold:
        assert np.array_equal(to_numpy(p, out)[n], gold[n]), n
    x = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        k({"t0": x}, {})
    with pytest.raises(ValueError, match="at least 2 sweeps"):
        sweeps.GroupKernel(p, planner.plan(p, shape, sweeps=1).groups[0])


def test_fused_source_names_its_kernel_and_says_what_it_replaces():
    p3, p2 = PROGRAMS["heat3d"], PROGRAMS["jacobi2d"]
    src3 = sweeps.kernel_source(p3, planner.plan(p3, (16, 24, 40), sweeps=4).groups[0])
    src2 = sweeps.kernel_source(p2, planner.plan(p2, (24, 40)).groups[0])
    assert "soda_sw3d_kernel" in src3 and "soda_lb3d_kernel" not in src3
    assert "soda_sw2d_kernel" in src2 and "soda_lb2d_kernel" not in src2
    for src in (src3, src2):
        assert "_build_strips_group_fn" in src and "3.35 TB/s" in src
    # copy k reads copy k-1 through its ring; the last copy writes the output
    assert ("// stage heat_out__it2 (ring, level 3)" in src3
            and "// outputs ['heat_out'] (level 4)" in src3)
    # the input rows of the first step, then of each next step
    assert src2.count("soda_fetch_rows_v<RB, t0_C, NT>(") == 2


def test_rings_are_sized_by_lag():
    # heat3d at nf = 4: the input spans (-4, 4) but each copy reads the one
    # before it at -1..1 around its own leading plane (lag 2); each copy
    # lags the one it reads by a step (level k + 1 reads level k: +1):
    # every copy's ring 2 + 1 + 1 = 4 planes; the input's planes are fed
    # by TMA 2 steps ahead (+2): 2 + 2 + 1 = 5, its own depth
    p = PROGRAMS["heat3d"]
    g = planner.plan(p, (64, 64, 64), sweeps=4).groups[0]
    assert g.sweeps == 4 and g.warm == 8 and g.sync == "skew"
    assert [r.name for r in g.rings] == ["heat_in", "heat_out__it0",
                                         "heat_out__it1", "heat_out__it2"]
    assert (g.feed, g.ahead) == ("tma", 2)
    assert [r.depth for r in g.rings] == [5, 4, 4, 4]
    assert g.spans["heat_in"] == ((-4, 4),) * 3
    # rank 2: a power of two of at least lag + (w + level) * RB rows for
    # each consumer: the input (copied a step ahead, w = 1) and each copy
    # (w = 1 - its level) are read by the next copy, 2 rows below their
    # leading one: 2 + 2 * 4 = 10 -> 16
    q = PROGRAMS["jacobi2d"]
    g2 = planner.plan(q, (64, 256), sweeps=8, tile=(4, 128), bz=32).groups[0]
    assert {r.depth for r in g2.rings} == {16} and len(g2.rings) == 8
    assert g2.sync == "skew"
    assert g2.levels == {s: k + 1 for k, s in enumerate(g2.stages)}
    # with a barrier after each copy, every copy is at level 1: the input
    # still needs 2 + 2 * 4 = 10 -> 16 rows, each copy 2 + 4 = 6 -> 8
    g3 = pinned_plan(q, (64, 256), {"sweeps": 8, "tile": (4, 128), "bz": 32,
                                    "sync": "barrier"}).groups[0]
    assert set(g3.levels.values()) == {1}
    assert {r.name: r.depth for r in g3.rings} == {
        "t0": 16, **{f"t1__it{k}": 8 for k in range(7)}}


@pytest.mark.parametrize("name,shape", [("jacobi2d", (2048, 2048)),
                                        ("jacobi2d", (16384, 16384)),
                                        ("heat3d", (512, 512, 512)),
                                        ("jacobi2d_i64", (2048, 2048)),
                                        ("residual2d", (8192, 8192))])
def test_at_size_fused_plans_fit_fill_and_count_sweeps(name, shape):
    p = PROGRAMS[name]
    pl = planner.plan(p, shape)
    (g,) = pl.groups
    assert g.sweeps > 1 and p.iterate % g.sweeps == 0
    assert g.smem_bytes <= planner.SMEM_BUDGET
    assert np.prod(g.grid) >= 2 * planner.NUM_SMS
    assert g.useful_cells_per_call == np.prod(shape) * g.sweeps * len(g.outputs)
    assert any("auto sweeps" in n for n in pl.notes)
    # the chosen depth has the least modeled time per sweep of those that
    # fit, up to the rank's cap
    cap = planner.AUTO_SWEEPS_MAX[p.rank]
    per_sweep = {d: planner.plan(p, shape, sweeps=d).groups[0].modeled_seconds / d
                 for d in planner.fused_depths(p, shape) if d <= cap}
    assert g.sweeps in per_sweep
    assert per_sweep[g.sweeps] == min(per_sweep.values())
    # fusing moves fewer bytes per sweep than the chained calls
    one = planner.plan(p, shape, sweeps=1).groups[0]
    assert g.hbm_bytes_per_call / g.sweeps < one.hbm_bytes_per_call


@pytest.mark.parametrize("it", [1, 5, 6, 7, 12])
def test_fused_depth_divides_the_executed_iterate(it):
    p = PROGRAMS["jacobi2d"]
    shape = (21, 40)
    pl = planner.plan(p, shape, iterate=it)
    assert it % pl.groups[0].sweeps == 0 and pl.sweeps_total == it
    x = np.random.default_rng(35).standard_normal(shape).astype(np.float32)
    got = to_numpy(p, cuda.run(p, {"t0": x}, device="cpu", iterate=it))
    gold = numpy_interp.run(REF["jacobi2d"], {"t0": x}, iterate=it)
    assert np.array_equal(got["t1"], gold["t1"])


def test_requested_depth_is_honoured_adjusted_or_reduced():
    p = PROGRAMS["jacobi2d"]
    assert planner.plan(p, (64, 256), sweeps=4).groups[0].sweeps == 4
    pl = planner.plan(p, (64, 256), sweeps=3)
    assert pl.groups[0].sweeps == 2
    assert any("requested sweeps 3 adjusted to divisor 2" in n for n in pl.notes)
    one = planner.plan(p, (64, 256), sweeps=1)
    assert one.groups[0].sweeps == 1 and one.groups[0].stages == ["t1"]
    # a cascade too deep for the budget is cut to the deepest that fits
    small = planner.plan(p, (64, 256), sweeps=8, smem_budget=4 * 1024)
    assert small.groups[0].sweeps == 4 and small.groups[0].smem_bytes <= 4 * 1024
    assert any("reduced fused sweeps 8 to 4" in n for n in small.notes)
    assert "sweeps=" in small.describe()
    # no fused depth fits: one sweep per call, split into chained groups
    p3 = PROGRAMS["residual2d"]
    tight = planner.plan(p3, (40, 300), smem_budget=768)
    assert all(g.sweeps == 1 for g in tight.groups) and len(tight.groups) > 1


def test_feedback_types_must_match():
    # a one-sweep program may read float and write double; asked to run
    # two sweeps (an `iterate` override), its cascade cannot feed back
    src = ("kernel: k\ninput float: a(16, *)\n"
           "output double: b(0, 0) = a(0, 1) + a(0, -1)\n")
    p = parse(src)
    assert unroll_iterate(p) is p
    with pytest.raises(FeedbackTypeError, match="feeds back"):
        planner.cascade(p, 2)
    # the planner plans it as chained one-sweep calls, with a note
    pl = planner.plan(p, (16, 40), iterate=2)
    assert [g.sweeps for g in pl.groups] == [1]
    assert any("feeds back" in n and "one sweep per call" in n for n in pl.notes)


def test_report_bound_per_call_and_per_program():
    p = PROGRAMS["jacobi2d"]
    cells = 16384 * 16384
    rep = report.analyze(planner.plan(p, (16384, 16384)))
    assert rep.sweeps == 8 and rep.calls == 1
    assert abs(rep.bytes_bound_ms - 8 * cells / 3.35e12 * 1e3) < 1e-9
    assert abs(rep.ops_bound_ms - 8 * 5 * cells / 67e12 * 1e3) < 1e-9
    assert rep.bound_by == "bytes" and rep.bound_ms == rep.bytes_bound_ms
    assert rep.program_bound_ms == rep.bound_ms
    r = report.rates(rep, 2e-3, "not measured")
    assert abs(r["ms_per_sweep"] - 0.25) < 1e-12
    assert abs(r["achieved_gbps_at_ideal_bytes"] - 8 * cells / 2e-3 / 1e9) < 1e-6
    two = report.analyze(planner.plan(p, (16384, 16384), sweeps=2))
    assert two.calls == 4 and two.program_bound_ms == 4 * two.bound_ms
    # operations bound a program with many operations per byte
    heavy = parse("kernel: h\niterate: 4\ninput float: a(16, *)\noutput float: "
                  "b(0, 0) = sqrt(exp(a(0, 1)) + exp(a(0, -1)) + log(a(1, 0) + 2.0f)"
                  " + sin(a(-1, 0)) + cos(a(0, 0)) + tanh(a(0, 0) * 3.0f))\n")
    rh = report.analyze(planner.plan(heavy, (4096, 4096)))
    assert rh.bound_by == "operations" and rh.bound_ms == rh.ops_bound_ms


@pytest.mark.parametrize("src,ops", [
    # f32: 3 adds, a multiply; f64 twice that; integers carried in int64 four times
    ("input float: a(16, *)\noutput float: b(0, 0) = (a(0, 1) + a(0, -1) + a(1, 0) + a(-1, 0)) * 0.25f", 4),
    ("input double: a(16, *)\noutput double: b(0, 0) = (a(0, 1) + a(0, -1) + a(1, 0) + a(-1, 0)) * 0.25", 8),
    ("input int64: a(16, *)\noutput int64: b(0, 0) = (a(0, 1) + a(0, -1) + a(1, 0) + a(-1, 0)) / 4", 16),
    # integers carried in int32 (the range analysis proves it) twice
    ("input uint16: a(16, *)\noutput uint16: b(0, 0) = (a(0, 1) + a(0, -1) + a(1, 0) + a(-1, 0)) / 4", 8),
    # an int32 product that leaves int32 keeps int64 carriers: four times
    ("input int32: a(16, *)\noutput int32: b(0, 0) = a(0, 1) * a(0, -1) + a(1, 0)", 8),
    # a float compare weighs 1 though its result is an int; the select 1
    ("input float: a(16, *)\noutput float: b(0, 0) = a(0, 1) > a(0, 0) ? a(0, 1) : a(0, 0)", 2),
])
def test_operations_are_weighted_by_their_type(src, ops):
    p = parse("kernel: k\n" + src + "\n")
    pl = planner.plan(p, (64, 256))
    assert pl.ops_per_cell == ops
    assert report.analyze(pl).ops_per_cell == ops


def test_cli_sweeps_flag(capsys):
    rc = sodac.main([str(SODA / "jacobi2d.soda"), "--grid-shape", "21,40",
                     "--device", "cpu", "--sweeps", "4", "--run"])
    out = capsys.readouterr().out
    assert rc == 0 and "OK" in out and "sweeps=4" in out
    assert "2 kernel call(s) x 4 fused sweeps" in out
    rc = sodac.main([str(SODA / "heat3d.soda"), "--grid-shape", "9,13,40",
                     "--device", "cpu", "--sweeps", "1", "--run"])
    out = capsys.readouterr().out
    assert rc == 0 and "sweeps=1" in out and "4 chained call(s)" in out
    with pytest.raises(SystemExit):
        sodac.main([str(SODA / "heat3d.soda"), "--sweeps", "0"])
