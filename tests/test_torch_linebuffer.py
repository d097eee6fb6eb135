"""The line-buffer kernel module (`soda_tpu_torch/backend/linebuffer.py`).

No card here, so the kernel's source is checked four ways:
- the generated `.cu` holds the expected ring taps and no `std::` call;
- compiled as host C++ (`-DSODA_HOST_EMULATION`: every CTA on one
  thread, barriers trivially kept), the kernel's march runs the real tile,
  chunk, ring and masking logic and must equal the NumPy oracle on the
  WHOLE grid: bit-exact for integer and linear f32 programs, and under
  `compare_outputs` (f32 libm at 2e-3) otherwise.  Skipped without g++;
- the same source under the hazard emulation (`-DSODA_HAZARD`: plane
  copies land at issue, the stages of a step and the work items of a
  stage run in reverse order) for every rank-3 program (the corpus,
  `INT3D_SOURCES` and u64_3d over the whole uint64 range), on a grid whose
  planes are copied 16 bytes at a time, on an odd one copied element by
  element and with chunks shorter than the warm-up, in both orders of a
  step's stages, and with rings of depths that are not powers of two;
  with the step's wait deleted from the source (a mismatch); against the
  JAX package's z-march (kernel 1, interpret mode) outside its rim;
- the TMA feed (plans whose rows are whole 16-byte chunks) under both
  emulations: boxes cut at each of the six faces, chunks of one plane,
  five row types, two inputs, heat3d's cascade; a ring one slot
  shallower, a copy issued into a slot still read and a box off 16-byte
  alignment each fail;
- the wrapper takes the plain version on CPU tensors, counts no launch,
  refuses other devices and checks a vector plan's rows.
The kernel itself is held against its plain version on the card by
`tests/test_torch_gpu.py` and `chip_smoke.py`.
"""

import ast
import pathlib
import re
import shutil

import numpy as np
import pytest
import torch

from soda_tpu.backend import pallas as pallas_backend
from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.plan import planner as jax_planner
from soda_tpu.utils.testing import compare_outputs, rand_inputs
from soda_tpu_torch.backend import columns3d, cuda, linebuffer
from soda_tpu_torch.backend.cuda_codegen import DeviceGen
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.ir.dtypes import torch_dtype
from soda_tpu_torch.plan import planner
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils.testing import (INT3D_SOURCES, RANK3_CORPUS, U64_SOURCES,
                                          build_emulated, pinned_plan, u64_inputs)

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in RANK3_CORPUS}
SOURCES.update(INT3D_SOURCES)
# the port's functions take the port parser's programs, soda_tpu's the lark
# parser's
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}
# the hazard cases add full-width uint64 (inputs over the whole range)
PROGRAMS["u64_3d"] = parse(U64_SOURCES["u64_3d"])
REF["u64_3d"] = lark_parser.parse(U64_SOURCES["u64_3d"])
HAZARD_PROGRAMS = sorted(PROGRAMS)
SOURCES_ONLY = sorted(SOURCES)

# a grid whose planes are copied 16 bytes at a time, an odd one copied
# element by element, each cut into several tiles and chunks, and chunks
# of one plane, shorter than every program's warm-up
HAZARD_GRIDS = {"vector": ((16, 24, 128), {"tile": (8, 32), "bz": 8}),
                "scalar": ((13, 37, 45), {"tile": (8, 32), "bz": 8}),
                "short": ((16, 24, 128), {"tile": (8, 32), "bz": 1})}
# budgets under which denoise3d's power-of-two rings do not fit the tile
# (8, 32) but their own depths do, in each order of a step's stages
EXACT = {"skew": 26000, "barrier": 20000}


def _multi_level(name: str) -> bool:
    return any(max(g.levels.values()) > 1 for g in plan(
        PROGRAMS[name], (13, 37, 45), iterate=1, **HAZARD_GRIDS["scalar"][1]).groups)


# the programs whose groups have stages that read other stages: the ones
# where the two orders of a step's stages differ
MULTI_LEVEL = [n for n in HAZARD_PROGRAMS if _multi_level(n)]
HAZARD_CASES = [(n, grid, "skew") for n in HAZARD_PROGRAMS for grid in HAZARD_GRIDS]
HAZARD_CASES += [(n, grid, "barrier") for n in MULTI_LEVEL for grid in HAZARD_GRIDS]
# the column z-march (`columns3d.py`) of the same programs on the same grids
COLUMN_CASES = [(n, grid) for n in MULTI_LEVEL for grid in HAZARD_GRIDS]


def _hazard_kw(grid: str, sync: str, exact: bool = False) -> tuple[tuple, dict]:
    shape, kw = HAZARD_GRIDS[grid]
    kw = dict(kw, sync=sync)
    if exact:
        kw.update(bz=4, smem_budget=EXACT[sync])
    return shape, kw


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
        return [cuda.group_kernel(PROGRAMS[n], g) for n, shape, kw in cases
                for g in pinned_plan(PROGRAMS[n], shape, dict(kw, iterate=1)).groups]

    build_emulated(kernels([(n, shape, kw) for n in SOURCES_ONLY
                            for shape, kw in CORPUS_GRIDS]))
    build_emulated(kernels([(n, *_hazard_kw(grid, sync)) for n, grid, sync in HAZARD_CASES]
                           + [("denoise3d", *_hazard_kw(grid, sync, True))
                              for grid in ("vector", "scalar") for sync in EXACT]
                           + [(n, HAZARD_GRIDS[grid][0],
                               dict(HAZARD_GRIDS[grid][1], march="columns3d"))
                              for n, grid in COLUMN_CASES]),
                   hazard=True)


def test_jacobi3d_source_taps_the_input_ring():
    p = PROGRAMS["jacobi3d"]
    g = plan(p, (64, 64, 64)).groups[0]
    src = linebuffer.kernel_source(p, g)
    # a column run loads each tap of its rows once, from the plane slot
    # computed once per step (a remainder: a TMA-fed ring keeps its own
    # depth)
    tag = {-1: "m1", 0: "0", 1: "1"}
    for oz in (-1, 0, 1):
        assert f"const int __s_t0_{tag[oz]} = (pl + ({oz}) - t0_ZLO) % t0_D;" in src
    for oz, oy, ox in [(0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0),
                       (0, -1, 0), (1, 0, 0), (-1, 0, 0)]:
        assert (f"t0_r[__s_t0_{tag[oz]} * t0_PS + "
                f"(pb + ({oy}) - t0_YLO) * t0_C + (lx + ({ox}) - t0_XA)]") in src
    # the input planes: one TMA copy a plane by thread 0, the first AHEAD
    # steps' before the march and then AHEAD steps ahead, each into a
    # slot with its own mbarrier, which every thread waits on
    assert (g.load, g.feed, g.ahead) == ("vector", "tma", 1)
    assert src.count("soda_tma_plane(t0_r + f * t0_PS, t0_m, t0_b + f, ") == 2
    assert "const __grid_constant__ soda_tmap t0_m" in src
    assert "soda_tmap_encode(&t0_m, t0_g, (int)sizeof(*t0_g), d0, d1, d2, t0_C, t0_R)" in src
    body = src.split("#ifndef SODA_HOST_EMULATION")[0]
    assert "soda_fetch_plane_s" not in body and "& (t0_D - 1)" not in body
    assert "0.142857" in body and "std::" not in body
    assert '#include "linebuffer3d.cuh"' in src
    # one barrier a step (no cp.async wait), then the wait on the slot of
    # the step's leading plane; no barrier between the stages
    loop = body.split("for (int zs = -WARM;")[1]
    assert loop.count("SODA_SYNC();") == 1 and loop.count("soda_bar_wait(") == 1
    assert "soda_step_wait" not in body
    assert "// outputs ['t1'] (level 1), runs of 8 row(s)" in src


def test_denoise3d_source_rings_every_tapped_stage():
    # the z-march's rings, pinned (the planner's column z-march is
    # `test_column_z_march_source_carries_the_column_taps`)
    p = PROGRAMS["denoise3d"]
    src = linebuffer.kernel_source(p, pinned_plan(p, (64, 64, 64), {"march": "rings3d"}).groups[0])
    for ring in ("u", "rhs", "grad", "w"):
        assert f"constexpr size_t {ring}_OFF" in src
    assert "// stage grad (ring, level 1)" in src and "// stage w (ring, level 2)" in src
    assert "// outputs ['unew'] (level 3)" in src and "unew_r" not in src
    body = src.split("#ifndef SODA_HOST_EMULATION")[0]
    assert "dm::sqrt(" in body and "std::" not in body
    assert "__s_w_m1 = (pl + (-1) - w_ZLO) & (w_D - 1)" in src
    assert "w_r[__s_w_m1 * w_PS" in src


def test_the_column_z_march_has_its_own_wrapper():
    """`cuda.group_kernel` gives a column z-march plan `columns3d.GroupKernel`
    (kernel 1's wrapper, name and counts, with that march's source) and a
    rings plan kernel 1's own wrapper; the rings' generator refuses a
    column plan, and `linebuffer.py` imports nothing of `columns3d.py`."""
    p = PROGRAMS["denoise3d"]
    (g,) = plan(p, (32, 64, 128)).groups
    (r,) = pinned_plan(p, (32, 64, 128), {"march": "rings3d"}).groups
    k, kr = cuda.group_kernel(p, g), cuda.group_kernel(p, r)
    assert type(k) is columns3d.GroupKernel and k.name == kr.name == "lb3d_denoise3d"
    assert type(kr) is linebuffer.GroupKernel
    assert '#include "columns3d.cuh"' in k.source
    assert '#include "linebuffer3d.cuh"' in kr.source
    with pytest.raises(ValueError, match="column z-march"):
        linebuffer.kernel_source(p, g)
    tree = ast.parse(pathlib.Path(linebuffer.__file__).read_text())
    assert not any(isinstance(n, ast.ImportFrom) and "columns3d" in (
        [n.module or ""] + [a.name for a in n.names]) for n in ast.walk(tree))


def test_column_z_march_source_carries_the_column_taps():
    """denoise3d in the column z-march (`columns3d.py`): grad has no ring
    and no exchange buffer (w reads it at its own column), w one exchange
    of two planes (unew reads its in-plane neighbours), u and w at the
    thread's own column come from registers carried a step (u at z - 1 ..
    z + 1 below the leading z + 2, w at z - 1, z), u's and w's in-plane
    taps from the ring and the exchange; one sqrt a column of w's span, one
    barrier a step, the inputs fed by TMA."""
    p = PROGRAMS["denoise3d"]
    (g,) = plan(p, (512, 512, 512)).groups
    assert (g.march, g.tile, g.threads) == ("columns3d", (16, 32), 256)
    src = cuda.group_kernel(p, g).source
    assert '#include "columns3d.cuh"' in src and "soda_lb3d_kernel" in src
    assert "grad_OFF" not in src and "grad_x" not in src and "grad_NSLOT" not in src
    assert "constexpr int w_NSLOT = 2, w_C = 34, w_XPS = 612;" in src
    assert "constexpr int KT = 2, KH = 1;" in src and "S_LO = -4" in src
    regs = src.split("struct soda_regs {")[1].split("};")[0]
    assert ("float u_t0_0, u_t0_1, u_t0_2;" in regs and "float w_t1_0, w_t1_1;" in regs
            and "float u_h0_0, u_h0_1;" in regs and "grad" not in regs)
    body = src.split("// a CTA on the host")[0]
    # unew at a tile column: u at z - 1 carried, w's x-neighbour of the step
    # before from the exchange; u's in-plane tap from the ring's plane s
    assert "const float __u_m1_0_0 = r.u_t0_0;" in body
    assert "const float __w_0_0_1 = w_x[__x_w_1 * w_XPS + (ly + (0) - w_YLO) * w_C" in body
    assert "const float __u_0_1_0 = u_r[__s_u_0 * u_PS + (ly + (1) - u_YLO) * u_C" in body
    assert "dm::sqrt(" in body and "std::" not in body
    march = body.split("SODA_BODY int soda_march(")[1].split("SODA_BODY void soda_body(")[0]
    assert march.count("SODA_STEP_END();") == 1 and "soda_feed(s + AHEAD, c)" in march
    assert body.count("soda_bar_wait(") == 2 and "soda_fetch_plane_s" not in body


def test_half_is_refused_on_the_device_path():
    # half is carried on the device now: as soda_half, rounded after every
    # operation as the golden runner's _Float16 is
    p = parse("kernel: k\ninput half: a(8, 8, *)\n"
              "output half: b(0, 0, 0) = (a(0, 0, 1) + a(0, 0, 0)) * half(0.5f)\n")
    code, t = DeviceGen(p, {"a"}).emit(p.tensors["b"].expr)
    assert str(t) == "half" and "_Float16" not in code
    # the product and the sum each round to half; both taps read the ring
    assert code.startswith("(soda_half)(((soda_half)((")
    assert code.count("((soda_half)(a_r[") == 2
    src = linebuffer.kernel_source(p, plan(p, (8, 8, 32)).groups[0])
    assert "const soda_half* __restrict__ a_g" in src and "_Float16" not in src


def _emulate(name, shape, seed, hazard=False, edit=None, draw=rand_inputs, **plan_kw):
    """The plan's groups as host-emulated kernels (`hazard`: under the
    hazard emulation; `edit`: a change to each generated source; `plan_kw`
    as `pinned_plan` takes them, `sync` included); returns (outputs,
    oracle, plan)."""
    p = PROGRAMS[name]
    ins, ps = draw(p, shape, np.random.default_rng(seed))
    tins, tps = to_torch(p, ins, ps, "cpu")
    values = dict(tins)
    # one sweep: the iterate programs' fused cascades are tests/test_torch_sweeps.py's
    pl = pinned_plan(p, shape, dict(plan_kw, iterate=1))
    for g in pl.groups:
        k = cuda.group_kernel(p, g)
        if edit is not None:
            k._source = edit(k.source)
        entry = k.build(emulate=True, hazard=hazard).lib.soda_launch
        outs = {o: torch.empty(shape, dtype=torch_dtype(p.tensors[o].type))
                for o in g.outputs}
        k.launch(entry, values, tps, outs, 0)
        values.update(outs)
    got = to_numpy(p, {o: values[o] for o in p.output_names})
    return got, numpy_interp.run(REF[name], ins, ps, iterate=1), pl


def _check(p, got, gold):
    """Integers and linear floats bit for bit; libm programs under
    `compare_outputs`."""
    if p.uses_libm_transcendentals() and any(p.tensors[k].type.is_float for k in gold):
        assert compare_outputs(p, got, gold, 0)
    else:
        for k in gold:
            assert np.array_equal(got[k], gold[k]), k


CORPUS_GRIDS = (((16, 24, 128), {}),                          # planner's choice
                ((13, 37, 45), {"tile": (8, 32), "bz": 8}))  # many tiles and chunks


@pytest.mark.parametrize("name", SOURCES_ONLY)
@pytest.mark.parametrize("shape,plan_kw", CORPUS_GRIDS)
def test_host_emulated_kernel_matches_oracle_on_whole_grid(built, name, shape, plan_kw):
    p = PROGRAMS[name]
    got, gold, _ = _emulate(name, shape, seed=5, **plan_kw)
    if p.uses_libm_transcendentals():
        assert compare_outputs(p, got, gold, 0)
    else:
        for k in gold:
            assert np.array_equal(got[k], gold[k]), k


@pytest.mark.parametrize("name,grid,sync", HAZARD_CASES)
def test_hazard_emulated_kernel_matches_oracle_on_whole_grid(built, name, grid, sync):
    """Plane copies landing at issue, and each step's stages (where no
    barrier orders them) and each stage's work items in reverse order: a
    copy or a stage that overwrote a plane still read in its step, or a
    stage that read a plane written in its own step, would show here."""
    shape, kw = _hazard_kw(grid, sync)
    got, gold, pl = _emulate(name, shape, seed=9, hazard=True, draw=u64_inputs, **kw)
    for g in pl.groups:
        assert g.kernel == "linebuffer3d" and g.sync == sync
        assert g.load == ("scalar" if grid == "scalar" else "vector")
        assert g.feed == ("scalar" if grid == "scalar" else "tma")
        assert g.bz < g.warm or grid != "short"
        # a TMA-fed ring keeps its own depth, the others a power of two
        assert all(r.depth & (r.depth - 1) == 0 for r in g.rings if not r.pitch)
    _check(PROGRAMS[name], got, gold)


@pytest.mark.parametrize("grid", ["vector", "scalar"])
@pytest.mark.parametrize("sync", sorted(EXACT))
def test_hazard_emulated_rings_of_exact_depth_match_oracle(built, grid, sync):
    """Where the power-of-two rings exceed the budget, the planner keeps
    each ring's own depth, and a plane's slot is a remainder: denoise3d's
    u ring keeps 7 planes (skew) or 5 (barrier), under the hazard
    emulation."""
    shape, kw = _hazard_kw(grid, sync, exact=True)
    got, gold, pl = _emulate("denoise3d", shape, seed=13, hazard=True, **kw)
    (g,) = pl.groups
    depths = {r.name: r.depth for r in g.rings}
    assert g.sync == sync and depths["u"] == {"skew": 7, "barrier": 5}[sync]
    src = linebuffer.GroupKernel(PROGRAMS["denoise3d"], g).source
    assert "% u_D" in src and "& (u_D - 1)" not in src
    _check(PROGRAMS["denoise3d"], got, gold)


@pytest.mark.parametrize("name,grid", COLUMN_CASES)
def test_hazard_emulated_column_z_march_matches_oracle_on_whole_grid(built, name, grid):
    """The column z-march under the hazard emulation: plane copies landing
    at issue, a CTA's threads taking their turns up to each step's end in
    reverse order; on the TMA feed, the scalar path and chunks of one
    plane, shorter than the warm-up."""
    shape, kw = HAZARD_GRIDS[grid]
    got, gold, pl = _emulate(name, shape, seed=9, hazard=True, draw=u64_inputs,
                             march="columns3d", **kw)
    (g,) = pl.groups
    assert (g.march, g.tile, g.bz) == ("columns3d", kw["tile"], kw["bz"])
    assert g.feed == ("scalar" if grid == "scalar" else "tma")
    assert g.bz < -planner.zcolumn_steps(g.stages, g.external_inputs, g.spans, g.leads)[0] \
        or grid != "short"
    _check(PROGRAMS[name], got, gold)


def _one_exchange_plane(src: str) -> str:
    """Every exchange buffer of one plane: a step's stores overwrite the
    plane the neighbours still read."""
    return re.sub(r"(\w+)_NSLOT = \d+,", r"\1_NSLOT = 1,", src)


def _no_step_end(src: str) -> str:
    """The march without the barrier that ends a step."""
    assert src.count("    SODA_STEP_END();\n") == 1
    return src.replace("    SODA_STEP_END();\n", "")


def _shallower_inputs(src: str) -> str:
    """Every input ring one plane shallower than the planner's."""
    for n, d in re.findall(r"constexpr int (\w+)_D = (\d+),", src):
        src = src.replace(f"constexpr int {n}_D = {d},", f"constexpr int {n}_D = {int(d) - 1},")
    return src


@pytest.mark.parametrize("mutation,grid,hazard", [
    (_one_exchange_plane, "vector", False), (_no_step_end, "vector", False),
    (_shallower_inputs, "vector", True), (_shallower_inputs, "scalar", True)],
    ids=["one-exchange-plane", "no-step-end", "shallower-tma-rings", "shallower-rings"])
def test_column_z_march_mutations_break_the_emulation(gxx, mutation, grid, hazard):
    """An exchange buffer of one plane, a step without its barrier, or an
    input ring one plane shallower shows in denoise3d's column z-march as
    a wrong result (or a wait that would hang on the card); the march as
    planned equals the oracle."""
    shape, kw = HAZARD_GRIDS[grid]
    kw = dict(kw, march="columns3d", hazard=hazard)
    got, gold, _ = _emulate("denoise3d", shape, 25, **kw)
    _check(PROGRAMS["denoise3d"], got, gold)
    assert _breaks("denoise3d", shape, 25, mutation, **kw)


def _without_step_wait(src: str) -> str:
    """The source without the step's wait: the scalar path's
    `soda_step_wait()`, or every wait of the TMA feed on a slot's
    mbarrier."""
    step = src.split("for (int zs = -WARM;")
    if "soda_bar_wait(" in step[1]:
        return step[0] + "for (int zs = -WARM;" + re.sub(r"soda_bar_wait\([^;]*;", ";", step[1])
    assert step[1].count("    soda_step_wait();\n") == 1
    return step[0] + "for (int zs = -WARM;" + step[1].replace("    soda_step_wait();\n", "")


def _breaks(name, shape, seed, edit, **kw) -> bool:
    """True where the emulated kernel with `edit` made to its source fails
    to launch (the emulation found the card would fault or hang) or its
    outputs differ from the oracle."""
    try:
        got, gold, _ = _emulate(name, shape, seed, edit=edit, draw=u64_inputs, **kw)
    except RuntimeError as e:
        assert "failed to launch" in str(e)
        return True
    return any(not np.array_equal(got[k], gold[k]) for k in gold)


@pytest.mark.parametrize("grid", ["vector", "scalar"])
def test_deleting_the_step_wait_breaks_the_emulated_kernel(gxx, grid):
    """The host emulation lands a plane copy at the step's wait (the TMA
    feed's: at the wait on its slot): with the wait deleted from the
    source, the planes never reach the rings."""
    shape, kw = HAZARD_GRIDS[grid]
    got, gold, _ = _emulate("jacobi3d", shape, seed=10, **kw)
    assert np.array_equal(got["t1"], gold["t1"])
    assert _breaks("jacobi3d", shape, 10, _without_step_wait, **kw)


@pytest.mark.parametrize("name", ["jacobi3d", "denoise3d"])
def test_kernel_matches_the_jax_z_march_outside_its_rim(gxx, name):
    """The new march against the JAX package's kernel 1 (its z-march,
    `_linebuffer.py::build_linebuffer_group_fn`, in interpret mode) on the
    same numpy inputs: equal outside `valid_rim()`, where the TPU kernel's
    constant-extent evaluation differs from the oracle by design, and
    equal to the oracle on the whole grid."""
    shape = (12, 16, 128)
    ref, p = REF[name], PROGRAMS[name]
    jax_plan = jax_planner.plan(ref, shape)
    assert [g.strategy for g in jax_plan.groups] == ["linebuffer"]
    got, gold, _ = _emulate(name, shape, seed=11, tile=(8, 32), bz=4)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(11))
    jax_out = pallas_backend.run(ref, ins, ps, the_plan=jax_plan, interpret=True)
    assert compare_outputs(p, got, jax_out, p.valid_rim())
    _check(p, got, gold)


def test_host_emulated_split_groups_match_oracle(gxx):
    # grad and w in the column z-march, unew alone in the windows kernel
    p = PROGRAMS["denoise3d"]
    got, gold, pl = _emulate("denoise3d", (9, 20, 40), seed=6, smem_budget=12000,
                             tile=(8, 32), bz=8)
    assert len(pl.groups) > 1
    assert compare_outputs(p, got, gold, 0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    p = PROGRAMS["denoise3d"]
    shape = (8, 12, 40)
    g = plan(p, shape).groups[0]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(7))
    tins, tps = to_torch(p, ins, ps, "cpu")
    before = linebuffer.LAUNCHES
    out = linebuffer.GroupKernel(p, g)(tins, tps)
    assert linebuffer.LAUNCHES == before
    plain = linebuffer.group_plain(p, g, tins, tps)
    assert torch.equal(out["unew"], plain["unew"])
    gold = numpy_interp.run(REF["denoise3d"], ins, ps)
    assert compare_outputs(p, to_numpy(p, out), gold, 0)


def test_wrapper_refuses_other_devices():
    p = PROGRAMS["jacobi3d"]
    g = plan(p, (8, 8, 8)).groups[0]
    x = torch.empty((8, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        linebuffer.GroupKernel(p, g)({"t0": x}, {})
    assert linebuffer.GroupKernel(p, g)._source is None  # nothing generated


def test_wrapper_checks_a_vector_plans_rows():
    """A plan that copies planes 16 bytes at a time takes rows of whole
    16-byte chunks that start on a 16-byte boundary (`_check_vector_rows`,
    which `__call__` runs on CUDA tensors before a launch)."""
    p = PROGRAMS["jacobi3d"]
    g = plan(p, (8, 8, 32)).groups[0]
    assert g.load == "vector" and plan(p, (8, 8, 30)).groups[0].load == "scalar"
    k = linebuffer.GroupKernel(p, g)
    k._check_vector_rows({"t0": torch.zeros((8, 8, 32))}, (8, 8, 32))
    with pytest.raises(ValueError, match="16-byte chunks"):
        k._check_vector_rows({"t0": torch.zeros((8, 8, 30))}, (8, 8, 30))
    shifted = torch.zeros(8 * 8 * 32 + 1)[1:].view(8, 8, 32)
    with pytest.raises(ValueError, match="16-byte boundary"):
        k._check_vector_rows({"t0": shifted}, (8, 8, 32))


# the TMA feed (`GroupPlan.feed` "tma"): grids whose tiles and chunks are
# cut at every face (20 rows in tiles of 8, 80 columns in tiles of 32, 19
# planes in chunks of 8, the z halo outside the grid at both ends; a
# chunk's copies outnumber its ring's slots, so slots are refilled), and
# chunks of one plane, shorter than every warm-up
TMA_GRIDS = {"faces": ((19, 20, 80), {"tile": (8, 32), "bz": 8}),
             "one-plane": ((5, 20, 80), {"tile": (8, 32), "bz": 1})}
# rows of f32, f64, uint64, int16 and uint16; two inputs (denoise3d)
TMA_PROGRAMS = ("jacobi3d", "poisson3d_f64", "u64_3d", "divneg_i16", "box7_u16", "denoise3d")
TMA_CASES = [(n, grid, hazard) for n in TMA_PROGRAMS for grid in TMA_GRIDS
             for hazard in (False, True)]
# heat3d x 4 as two calls of its cascade of two sweeps
CASCADE = ("heat3d", (19, 20, 80), {"sweeps": 2, "tile": (8, 32), "bz": 8})


def _tma_kernels(hazard: bool) -> list:
    ks = [cuda.group_kernel(PROGRAMS[n], g) for n in TMA_PROGRAMS
          for shape, kw in TMA_GRIDS.values()
          for g in pinned_plan(PROGRAMS[n], shape, dict(kw, iterate=1)).groups]
    name, shape, kw = CASCADE
    ks += [cuda.group_kernel(PROGRAMS[name], g)
           for g in plan(PROGRAMS[name], shape, **kw).groups]
    return ks


@pytest.fixture(scope="module")
def built_tma():
    """The host emulation (and the hazard emulation) of the TMA-fed cases
    below, compiled in parallel up front."""
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")
    build_emulated(_tma_kernels(False))
    build_emulated(_tma_kernels(True), hazard=True)


@pytest.mark.parametrize("name,grid,hazard", TMA_CASES)
def test_tma_fed_march_matches_oracle_on_whole_grid(built_tma, name, grid, hazard):
    """Kernel 1 fed by TMA under host emulation (a copy lands at the wait
    on its slot) and under the hazard emulation (at issue), against the
    oracle on the whole grid: boxes cut at each of the six faces, chunks
    shorter than the warm-up, five row types, two inputs."""
    shape, kw = TMA_GRIDS[grid]
    got, gold, pl = _emulate(name, shape, seed=21, hazard=hazard, draw=u64_inputs, **kw)
    for g in pl.groups:
        assert (g.feed, g.load, g.tile, g.bz) == ("tma", "vector", kw["tile"], kw["bz"])
        assert g.ahead >= 1 and all(r.pitch for r in g.rings if r.name in g.external_inputs)
        # the copies of a long chunk refill its slots
        assert grid != "faces" or all(g.bz + g.warm > r.depth for r in g.rings if r.pitch)
    assert len(pl.groups[0].external_inputs) == (2 if name == "denoise3d" else 1)
    _check(PROGRAMS[name], got, gold)


@pytest.mark.parametrize("hazard", [False, True])
def test_tma_fed_cascade_matches_oracle_on_whole_grid(built_tma, hazard):
    """heat3d x 4 at nf 2: the rank-3 cascade's input ring fed by TMA, its
    copies' rings as before, two calls chained (`utils/testing.py::emulate`)."""
    from soda_tpu_torch.utils.testing import emulate

    name, shape, kw = CASCADE
    p = PROGRAMS[name]
    pl = plan(p, shape, **kw)
    (g,) = pl.groups
    assert (g.sweeps, g.feed) == (2, "tma") and p.iterate == 4
    ins, ps = rand_inputs(p, shape, np.random.default_rng(22))
    got = emulate(p, pl, ins, ps, hazard=hazard)
    _check(p, got, numpy_interp.run(REF[name], ins, ps))


def _ring_define(src: str, key: str) -> int:
    return int(re.search(rf"constexpr int {key} = (-?\d+)", src).group(1))


def _shallower(src: str) -> str:
    """Every TMA-fed ring one slot shallower than the planner's."""
    for n in re.findall(r"constexpr size_t (\w+)_BAR = ", src):
        d = _ring_define(src, f"{n}_D")
        src = src.replace(f"constexpr int {n}_D = {d},", f"constexpr int {n}_D = {d - 1},")
    return src


def _one_step_further(src: str) -> str:
    """The feed one step further ahead than its rings allow: a copy lands
    in a slot the march still reads."""
    k = _ring_define(src, "AHEAD")
    return src.replace(f"constexpr int AHEAD = {k};", f"constexpr int AHEAD = {k + 1};")


def _unaligned(src: str) -> str:
    """The input box starting at the tile's own first halo column, not at a
    16-byte-aligned one."""
    return src.replace("t0_XA = -4,", "t0_XA = -1,")


@pytest.mark.parametrize("name", ["jacobi3d", "denoise3d"])
@pytest.mark.parametrize("mutation", [_shallower, _one_step_further],
                         ids=["shallower-ring", "copy-into-a-slot-still-read"])
def test_tma_feed_mutations_break_the_hazard_emulation(gxx, name, mutation):
    """A ring one slot shallower, or a copy issued into a slot still read,
    shows under the hazard emulation (the copy lands at issue) as a wrong
    result or as a wait that would hang on the card."""
    shape, kw = TMA_GRIDS["faces"]
    got, gold, _ = _emulate(name, shape, seed=23, hazard=True, **kw)
    _check(PROGRAMS[name], got, gold)
    assert _breaks(name, shape, 23, mutation, hazard=True, **kw)


def test_an_unaligned_box_fails_as_on_the_card(gxx):
    """The H100 faults (an illegal instruction) on a TMA box whose first
    column is not 16-byte aligned; the emulation refuses the launch."""
    shape, kw = TMA_GRIDS["faces"]
    src = linebuffer.GroupKernel(PROGRAMS["jacobi3d"], pinned_plan(
        PROGRAMS["jacobi3d"], shape, dict(kw, iterate=1)).groups[0]).source
    assert "t0_XA = -4," in src
    with pytest.raises(RuntimeError, match="failed to launch"):
        _emulate("jacobi3d", shape, seed=24, edit=_unaligned, **kw)


def test_feed_counts_describe_and_reset():
    """`GroupPlan.feed` follows the grid's rows; `cuda.feed_counts()` counts
    the z-march's launches by feed apart from `cuda.launch_counts()`, and
    `cuda.reset_launches()` clears it; the CPU path counts nothing."""
    from soda_tpu_torch.backend import cuda

    p = PROGRAMS["jacobi3d"]
    tma, scalar = plan(p, (8, 8, 32)).groups[0], plan(p, (8, 8, 30)).groups[0]
    assert (tma.feed, scalar.feed, scalar.ahead) == ("tma", "scalar", 0)
    assert f"feed=tma, ahead={tma.ahead}" in tma.describe()
    assert "feed=scalar" in scalar.describe()
    assert plan(p, (8, 8, 32)).to_json()["groups"][0]["feed"] == "tma"
    cuda.reset_launches()
    x = torch.zeros((8, 8, 32))
    linebuffer.GroupKernel(p, tma)({"t0": x}, {})
    assert cuda.feed_counts() == {"tma": 0, "scalar": 0}
    linebuffer.FEED_LAUNCHES["tma"] += 2
    assert cuda.feed_counts() == {"tma": 2, "scalar": 0}
    assert not set(cuda.launch_counts()) & {"tma", "scalar"}
    cuda.reset_launches()
    assert cuda.feed_counts() == {"tma": 0, "scalar": 0}
