"""Programs rewritten by the computation-reuse pass (`--tcse`,
`soda_tpu_torch/optimize/tcse.py`) through the port's kernels.

The rewrite hoists partial sums (and min/max covers) into new `local`
stages named `<stage>__cse<k>`, stored at int32 or int64 from a static
value bound, so the planner sees new multi-stage groups: gauss5x5 becomes
a chain of row and column stages, box9 (`tests/test_tcse.py`'s) a column
sum and a row sum, erode2d a `min` cover, seidel2d (f32, iterate 4) a
fused cascade of hoisted row sums.  No card here, so each plan's kernels
are compiled as host C++ (`-DSODA_HOST_EMULATION`) and run, on an odd grid
cut into several strips and chunks (element-by-element row loads) and on
an aligned grid at the planner's own plan (16-byte row copies), and held
- against the port's NumPy reference of the rewritten program on the whole
  grid (the kernels store zero outside the grid at every stage, as the
  reference does), and against `soda_tpu`'s `tcse.apply` +
  `numpy_interp.run` of the same program on the whole grid;
- against `soda_tpu`'s `numpy_interp.run` of the untransformed program
  outside the rewritten program's `valid_rim()`: the hoisted stages widen
  the border-invalid rim, and the float sums are reassociated.
Tolerance: integers bit for bit; floats within `compare_outputs` (f32
1e-4, relative and absolute).

The hoisted integer widths must agree with the kernels' 32-bit carriers
(`backend/cuda_codegen.py::int32_exact`): an int32 hoist is carried in
int32_t, an int64 hoist never narrower.
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch

from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.optimize import tcse as tcse_orig
from soda_tpu_torch.backend import cuda
from soda_tpu_torch.backend.cuda_codegen import int32_exact
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse, parse_file
from soda_tpu_torch.ir.dtypes import torch_dtype
from soda_tpu_torch.optimize import tcse
from soda_tpu_torch.utils.testing import (INT3D_SOURCES, build_emulated,
                                          compare_outputs, oracle, pinned_plan,
                                          rand_inputs)

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
BOX9 = (
    "kernel: box9\n"
    "input uint16: img(512, *)\n"
    "output uint16: out(0, 0) = (img(-1,-1) + img(-1,0) + img(-1,1)"
    " + img(0,-1) + img(0,0) + img(0,1)"
    " + img(1,-1) + img(1,0) + img(1,1)) / 9\n"
)
SOURCES = {n: (SODA / f"{n}.soda").read_text()
           for n in ("gauss5x5", "erode2d", "seidel2d")}
SOURCES["box9"] = BOX9
NAMES = tuple(SOURCES)
PROGRAMS = {n: tcse.apply(parse(s)) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}
# an odd grid cut into several strips and chunks, and an aligned grid at
# the planner's plan
GRIDS = {"odd": ((37, 45), {"tile": (2, 32), "bz": 8}), "aligned": ((64, 256), {})}


@pytest.fixture(scope="module")
def built():
    """The host emulation of every kernel below, compiled up front."""
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")
    build_emulated([cuda.group_kernel(PROGRAMS[n], g) for n in NAMES
                    for shape, kw in GRIDS.values()
                    for g in pinned_plan(PROGRAMS[n], shape, kw).groups])


def _emulate(p, shape, ins, ps, **plan_kw):
    """The plan's groups as host-emulated kernels, `iterate / nf` calls
    with the feedback of `cuda.build_fn`; returns (outputs, plan)."""
    pl = pinned_plan(p, shape, plan_kw)
    tins, tps = to_torch(p, ins, ps, "cpu")
    it, nf = max(p.iterate, 1), pl.groups[0].sweeps
    kernels = [(cuda.group_kernel(p, g), g) for g in pl.groups]
    entries = [k.build(emulate=True).lib.soda_launch for k, _ in kernels]
    values = dict(tins)
    for c in range(it // nf):
        produced = {}
        for (k, g), entry in zip(kernels, entries):
            outs = {o: torch.empty(shape, dtype=torch_dtype(p.tensors[o].type))
                    for o in g.outputs}
            k.launch(entry, values, tps, outs, 0)
            values.update(outs)
            produced.update(outs)
        if c + 1 < it // nf:
            values = dict(tins)
            values[p.input_names[0]] = produced[p.output_names[0]]
    return to_numpy(p, {o: values[o] for o in p.output_names}), pl


def test_the_rewrite_hoists_stages_in_every_case():
    want_adds = {"gauss5x5": 8, "box9": 4}
    for n in NAMES:
        p, q = parse(SOURCES[n]), PROGRAMS[n]
        assert [s for s in q.stage_order() if "__cse" in s], n
        assert tcse.count_ops(q) < tcse.count_ops(p), n
        if n in want_adds:
            assert tcse.count_adds(q) == want_adds[n]
    assert tcse.count_minmax(PROGRAMS["erode2d"]) < tcse.count_minmax(parse(SOURCES["erode2d"]))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_emulated_tcse_kernels_equal_both_oracles(built, name, grid):
    p, ref = PROGRAMS[name], REF[name]
    shape, kw = GRIDS[grid]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(61))
    got, pl = _emulate(p, shape, ins, ps, **kw)
    if grid == "odd":
        g = pl.groups[0]
        assert g.load == "scalar" and g.grid[0] > 1 and g.grid[1] > 1
    else:
        assert {g.load for g in pl.groups} == {"vector"}
    hoisted = [s for g in pl.groups for s in g.stages if "__cse" in s]
    assert hoisted
    # the rewritten program's oracles, the port's and soda_tpu's, on the whole grid
    assert compare_outputs(p, got, oracle(p, ins, ps), 0)
    assert compare_outputs(p, got, numpy_interp.run(tcse_orig.apply(ref), ins, ps), 0)
    # the untransformed program outside the rewritten program's rim
    assert compare_outputs(p, got, numpy_interp.run(ref, ins, ps), p.valid_rim())


@pytest.mark.parametrize("name", NAMES)
def test_tcse_slice_on_the_cpu_path(name):
    """`cuda.run(..., device="cpu")` on the rewritten program (the plan,
    its groups and the iterate loop, each group's plain version) against
    `soda_tpu`'s rewrite and oracle."""
    p = PROGRAMS[name]
    shape = (37, 45)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(62))
    got = to_numpy(p, cuda.run(p, ins, ps, device="cpu"))
    gold = numpy_interp.run(tcse_orig.apply(REF[name]), ins, ps)
    assert compare_outputs(p, got, gold, 0)


def test_hoisted_widths_agree_with_the_32_bit_carriers():
    progs = {path.stem: parse_file(path) for path in sorted(SODA.glob("*.soda"))
             if path.stem != "accum128"}
    progs.update({n: parse(s) for n, s in INT3D_SOURCES.items()}, box9=parse(BOX9))
    seen = set()
    for n, p in progs.items():
        q = tcse.apply(p)
        for s in q.stage_order():
            t = q.tensors[s].type
            if "__cse" in s and t.is_int:
                seen.add(t.np_dtype().itemsize)
                assert int32_exact(q, q.tensors[s].expr) == (t.np_dtype().itemsize <= 4), (n, s)
    assert seen == {1, 4, 8}   # uint8 covers, int32 and int64 hoists
