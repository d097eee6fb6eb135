"""The line-buffer kernel module (`soda_tpu_torch/backend/linebuffer.py`).

No card here, so the kernel's source is checked three ways:
- the generated `.cu` holds the expected ring taps and no `std::` call;
- compiled as host C++ (`-DSODA_HOST_EMULATION`: every CTA on one
  thread, barriers trivially kept), the kernel's march runs the real tile,
  chunk, ring and masking logic and must equal the NumPy oracle on the
  WHOLE grid: bit-exact for integer and linear f32 programs, and under
  `compare_outputs` (f32 libm at 2e-3) otherwise.  Skipped without g++;
- the wrapper takes the plain version on CPU tensors, counts no launch,
  and refuses other devices.
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
from soda_tpu_torch.backend import linebuffer
from soda_tpu_torch.backend.cuda_codegen import DeviceGen
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.ir.dtypes import torch_dtype
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils.testing import INT3D_SOURCES, RANK3_CORPUS

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in RANK3_CORPUS}
SOURCES.update(INT3D_SOURCES)
# the port's functions take the port parser's programs, soda_tpu's the lark
# parser's
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in SOURCES.items()}



@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")


def test_jacobi3d_source_taps_the_input_ring():
    p = PROGRAMS["jacobi3d"]
    src = linebuffer.kernel_source(p, plan(p, (64, 64, 64)).groups[0])
    # a column run loads each tap of its rows once, from the plane slot
    # computed once per step
    tag = {-1: "m1", 0: "0", 1: "1"}
    for oz in (-1, 0, 1):
        assert (f"const int __s_t0_{tag[oz]} = soda_slot(p + ({oz}), z0 + t0_ZLO, "
                f"t0_D);") in src
    for oz, oy, ox in [(0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0),
                       (0, -1, 0), (1, 0, 0), (-1, 0, 0)]:
        assert (f"t0_r[__s_t0_{tag[oz]} * t0_PS + "
                f"(pb + ({oy}) - t0_YLO) * t0_C + (lx + ({ox}) - t0_XLO)]") in src
    assert src.count("soda_load_plane(") == 1
    body = src.split("#ifndef SODA_HOST_EMULATION")[0]
    assert "0.142857" in body and "std::" not in body
    assert '#include "linebuffer3d.cuh"' in src


def test_denoise3d_source_rings_every_tapped_stage():
    p = PROGRAMS["denoise3d"]
    src = linebuffer.kernel_source(p, plan(p, (64, 64, 64)).groups[0])
    for ring in ("u", "rhs", "grad", "w"):
        assert f"constexpr size_t {ring}_OFF" in src
    assert "// stage grad (ring)" in src and "// stage w (ring)" in src
    assert "// outputs ['unew']" in src and "unew_r" not in src
    body = src.split("#ifndef SODA_HOST_EMULATION")[0]
    assert "dm::sqrt(" in body and "std::" not in body
    assert "__s_w_m1 = soda_slot(p + (-1), z0 + w_ZLO, w_D)" in src
    assert "w_r[__s_w_m1 * w_PS" in src


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


def _emulate(name, shape, seed, **plan_kw):
    p = PROGRAMS[name]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(seed))
    tins, tps = to_torch(p, ins, ps, "cpu")
    values = dict(tins)
    # one sweep: the iterate programs' fused cascades are tests/test_torch_sweeps.py's
    for g in plan(p, shape, iterate=1, **plan_kw).groups:
        k = linebuffer.GroupKernel(p, g)
        entry = k.build(emulate=True).lib.soda_launch
        outs = {o: torch.empty(shape, dtype=torch_dtype(p.tensors[o].type))
                for o in g.outputs}
        k.launch(entry, values, tps, outs, 0)
        values.update(outs)
    got = to_numpy(p, {o: values[o] for o in p.output_names})
    return got, numpy_interp.run(REF[name], ins, ps, iterate=1)


@pytest.mark.parametrize("name", list(PROGRAMS))
@pytest.mark.parametrize("shape,plan_kw", [
    ((16, 24, 128), {}),                                  # planner's choice
    ((13, 37, 45), {"tile": (8, 32), "bz": 8}),          # many tiles and chunks
])
def test_host_emulated_kernel_matches_oracle_on_whole_grid(gxx, name, shape, plan_kw):
    p = PROGRAMS[name]
    got, gold = _emulate(name, shape, seed=5, **plan_kw)
    if p.uses_libm_transcendentals():
        assert compare_outputs(p, got, gold, 0)
    else:
        for k in gold:
            assert np.array_equal(got[k], gold[k]), k


def test_host_emulated_split_groups_match_oracle(gxx):
    p = PROGRAMS["denoise3d"]
    got, gold = _emulate("denoise3d", (9, 20, 40), seed=6, smem_budget=16 * 1024,
                         tile=(8, 32), bz=8)
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
