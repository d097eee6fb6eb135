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
- the wrapper takes the plain version on CPU tensors and counts no launch.
The kernel itself is held against its plain version on the card by
`tests/test_torch_gpu.py` and `chip_smoke.py`.
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch

from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.utils.testing import compare_outputs, rand_inputs
from soda_tpu_torch.backend import linebuffer2d
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.ir.dtypes import torch_dtype
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils.testing import RANK2_CORPUS

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in RANK2_CORPUS}
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")


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
                f" + (lx + ({ox}) - input_XLO)]") in src
    for oy in (-1, 0, 1):
        assert (f"blur_x_r[((pb + ({oy}) - blur_x_YLO) & (blur_x_D - 1)) * "
                f"blur_x_C + (lx + (0) - blur_x_XLO)]") in src
    assert src.count("soda_load_rows<RB, input_C, NT>(") == 1
    assert "// stage blur_x (ring)" in src and "// outputs ['blur_y']" in src
    body = src.split("#ifndef SODA_HOST_EMULATION")[0]
    assert "std::" not in body and "c_div(" in body
    assert '#include "linebuffer2d.cuh"' in src
    # ring depths are powers of two of at least (lag + RB): the rows from
    # the leading one down to the lowest a consumer reads in the same step
    rb = g.tile[0]
    lags = {"input": 0, "blur_x": 2}
    for r in g.rings:
        assert r.depth & (r.depth - 1) == 0
        assert r.depth >= lags[r.name] + rb


def test_smooth_half_source_uses_soda_half():
    p = PROGRAMS["smooth_half"]
    src = linebuffer2d.kernel_source(p, plan(p, (64, 256)).groups[0])
    assert "const soda_half* __restrict__ h_in_g" in src
    assert "soda_half* __restrict__ h_out_g" in src
    assert "_Float16" not in src


def _emulate(name, shape, seed, **plan_kw):
    p = PROGRAMS[name]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(seed))
    tins, tps = to_torch(p, ins, ps, "cpu")
    values = dict(tins)
    # one sweep: the iterate programs' fused cascades are tests/test_torch_sweeps.py's
    for g in plan(p, shape, iterate=1, **plan_kw).groups:
        k = linebuffer2d.GroupKernel(p, g)
        entry = k.build(emulate=True).lib.soda_launch
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


@pytest.mark.parametrize("name", RANK2_CORPUS)
@pytest.mark.parametrize("shape,plan_kw", [
    ((32, 256), {}),                              # planner's choice, aligned
    ((37, 45), {"tile": (2, 32), "bz": 8}),       # many strips and chunks, odd
])
def test_host_emulated_kernel_matches_oracle_on_whole_grid(gxx, name, shape, plan_kw):
    p = PROGRAMS[name]
    got, gold = _emulate(name, shape, seed=5, **plan_kw)
    _check(p, got, gold)


@pytest.mark.parametrize("name", ["blur", "sobel2d", "smooth_half", "accum64",
                                  "mathfn_f64", "dilate2d"])
@pytest.mark.parametrize("shape", [(7, 13), (1, 3), (5, 300)])
def test_host_emulated_kernel_on_grids_smaller_than_a_strip_or_chunk(gxx, name, shape):
    got, gold = _emulate(name, shape, seed=6)
    _check(PROGRAMS[name], got, gold)


def test_host_emulated_split_groups_match_oracle(gxx):
    name = "mathfn_f64"
    pl = plan(PROGRAMS[name], (21, 70), smem_budget=6 * 1024, tile=(4, 32), bz=8)
    assert len(pl.groups) > 1
    got, gold = _emulate(name, (21, 70), seed=7, smem_budget=6 * 1024,
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
