"""32-bit integer carriers (`soda_tpu_torch/backend/cuda_codegen.py`).

The kernels print a stage with int32_t carriers where `int32_exact`
proves that every integer node of its expression lies in int32
(`int_range`, the golden runner's C semantics on int64 carriers); any
other stage keeps int64_t.  No card here, so:
- the intervals are checked on hand-made expressions;
- the carriers are read off generated sources (blur's stage arithmetic has
  no int64_t; accum64 and jacobi2d_i64 keep int64_t);
- every integer rank-2 corpus program, and two hand-made programs (one
  using every integer operator, one whose product overflows int32), runs
  as its row-march compiled to host C++ (`-DSODA_HOST_EMULATION`) on
  inputs at the extremes of their dtypes (all max, all min, alternating),
  bit for bit against the JAX package's NumPy oracle.
"""

import math
import pathlib
import shutil

import numpy as np
import pytest
import torch

from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu_torch.backend import linebuffer2d, sweeps
from soda_tpu_torch.backend.cuda_codegen import int32_exact, int_range
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.ir.dtypes import torch_dtype
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils.testing import RANK2_CORPUS

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
INF = math.inf

# every integer operator the printer narrows, on values that reach the
# extremes of int16 and uint8
OPS16 = """kernel: ops16
input int16: a(64, *)
input uint8: b(64, *)
local int32: c(0, 0) = (a(0, -1) % 7) + (a(0, 1) >> 3) + (int32(b(0, 0)) << 4) - (a(-1, 0) / -5) + (!(a(1, 0) > 0))
output int16: d(0, 0) = int16(((c(0, 0) & 1023) | (c(-1, 0) ^ c(1, 0))) + (~c(0, 0)) + (c(0, 0) > 0 ? -c(0, 0) : abs(c(0, 1))) + max(c(0, 0), c(0, -1)) - min(int32(b(0, 0)), int32(b(1, 0))))
"""
# an int32 product leaves int32: the stage keeps int64 carriers
MUL32 = """kernel: mul32
input int32: x(64, *)
output int32: y(0, 0) = x(0, 0) * x(0, 1) + x(1, 0)
"""
SOURCES = {n: (SODA / f"{n}.soda").read_text() for n in RANK2_CORPUS}
SOURCES.update(ops16=OPS16, mul32=MUL32)
PROGRAMS = {n: parse(s) for n, s in SOURCES.items()}
INTEGER = sorted(n for n, p in PROGRAMS.items()
                 if not any(p.tensors[i].type.is_float for i in p.input_names))


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")


def _expr(expr: str, **inputs: str):
    """A one-stage program whose output is `expr` over `inputs` (name ->
    type); returns (program, the stage's expression)."""
    src = "kernel: k\n" + "".join(f"input {t}: {n}(64, *)\n" for n, t in inputs.items())
    p = parse(src + f"output int64: out(0, 0) = {expr}\n")
    return p, p.tensors["out"].expr


@pytest.mark.parametrize("expr,inputs,want", [
    ("a(0, 0) + a(0, 1) + a(0, 2)", {"a": "uint16"}, (0, 196605)),
    ("(a(0, 0) + a(0, 1) + a(0, 2)) / 3", {"a": "uint16"}, (0, 65535)),
    ("a(0, 0) - a(0, 1)", {"a": "uint8"}, (-255, 255)),
    ("a(0, 0) * a(0, 1)", {"a": "int32"}, (-(2**31 - 1) * 2**31, 2**62)),
    ("a(0, 0) % 7", {"a": "int16"}, (-6, 6)),
    ("a(0, 0) % a(0, 1)", {"a": "uint8"}, (-INF, INF)),     # the modulus may be 0
    ("a(0, 0) / a(0, 1)", {"a": "int8"}, (-INF, INF)),      # the divisor may be 0
    ("a(0, 0) / -5", {"a": "int16"}, (-6553, 6553)),
    ("a(0, 0) >> 3", {"a": "int16"}, (-4096, 4095)),
    ("a(0, 0) << 4", {"a": "uint8"}, (0, 4080)),
    ("a(0, 0) << a(0, 1)", {"a": "uint8"}, (-INF, INF)),    # a count above 31
    ("int16(a(0, 0))", {"a": "uint16"}, (-32768, 32767)),   # masked to 16 bits
    ("uint16(a(0, 0))", {"a": "uint8"}, (0, 255)),          # already fits
    ("int16(f(0, 0))", {"f": "float"}, (-32768, 32767)),
    ("a(0, 0) > 3 ? a(0, 0) : -a(0, 1)", {"a": "int8"}, (-128, 128)),
    ("abs(a(0, 0))", {"a": "int16"}, (0, 32768)),
    ("~a(0, 0)", {"a": "int16"}, (-32768, 32767)),
    ("!a(0, 0)", {"a": "int64"}, (0, 1)),
    ("a(0, 0) < b(0, 0)", {"a": "int64", "b": "float"}, (0, 1)),
    ("a(0, 0) & 255", {"a": "int32"}, (0, 255)),
    ("a(0, 0) | a(0, 1)", {"a": "uint8"}, (0, 255)),
    ("a(0, 0) ^ a(0, 1)", {"a": "int8"}, (-128, 127)),
    ("min(a(0, 0), 3)", {"a": "uint8"}, (0, 3)),
    ("max(a(0, 0), a(0, 1) - 300)", {"a": "uint8"}, (0, 255)),
    ("float(a(0, 0)) * 2.0f", {"a": "uint8"}, None),
])
def test_int_range_on_hand_made_expressions(expr, inputs, want):
    p, e = _expr(expr, **inputs)
    assert int_range(p, e) == want


def test_a_stage_tap_ranges_over_what_the_stage_stores():
    # gaussian2d's gx is uint32 but stores at most 16 x 65535; g_out's sum
    # of five taps of gx therefore fits int32 (with zero outside the grid)
    p = PROGRAMS["gaussian2d"]
    assert int_range(p, p.tensors["gx"].expr) == (0, 16 * 65535)
    assert int32_exact(p, p.tensors["g_out"].expr)
    # a tap of a stage whose expression can leave its type: the type's range
    q = PROGRAMS["ops16"]
    assert int_range(q, q.tensors["d"].expr) == (-32768, 32767)


@pytest.mark.parametrize("name,narrow", [
    ("blur", {"blur_x": True, "blur_y": True}),
    ("sobel2d", {"gx": True, "gy": True, "mag": True}),
    ("accum64", {"acc_out": False}),
    ("jacobi2d_i64", {"t1": False}),
    ("ops16", {"c": True, "d": True}),
    ("mul32", {"y": False}),
])
def test_int32_exact_per_stage(name, narrow):
    p = PROGRAMS[name]
    assert {s: int32_exact(p, p.tensors[s].expr) for s in p.stage_order()} == narrow


def _stage_lines(src: str) -> list[str]:
    return [ln for ln in src.split("#ifndef SODA_HOST_EMULATION")[0].splitlines()
            if "__v" in ln]


def test_blur_stage_arithmetic_has_no_int64():
    p = PROGRAMS["blur"]
    src = linebuffer2d.kernel_source(p, plan(p, (2048, 4096)).groups[0])
    lines = _stage_lines(src)
    assert lines and not any("int64_t" in ln for ln in lines)
    assert any("const int32_t __v = c_div(" in ln and "int32_t(3))" in ln for ln in lines)
    assert any("mask_int32(__v, 16, false)" in ln for ln in lines)


@pytest.mark.parametrize("name", ["accum64", "jacobi2d_i64"])
def test_wide_integer_programs_keep_int64_carriers(name):
    p = PROGRAMS[name]
    g = plan(p, (2048, 2048)).groups[0]
    src = (sweeps.kernel_source(p, g) if g.sweeps > 1
           else linebuffer2d.kernel_source(p, g))
    lines = _stage_lines(src)
    assert lines and all("int32_t" not in ln for ln in lines)
    assert any("const int64_t __v" in ln for ln in lines)


def _extremes(p, shape):
    """Inputs all at their dtype's max, all at its min, and alternating
    between the two cell by cell."""
    out = []
    for pattern in ("max", "min", "alternating"):
        ins = {}
        for n in p.input_names:
            info = np.iinfo(p.tensors[n].type.np_dtype())
            if pattern == "alternating":
                a = np.where(np.indices(shape).sum(0) % 2 == 0, info.max, info.min)
            else:
                a = np.full(shape, getattr(info, pattern))
            ins[n] = a.astype(p.tensors[n].type.np_dtype())
        out.append((pattern, ins))
    return out


@pytest.mark.parametrize("name", INTEGER)
def test_emulated_integer_programs_at_dtype_extremes(gxx, name):
    """One sweep of each integer program through its row-march (host C++),
    on a grid of several strips and chunks, bit for bit against the
    oracle."""
    p, ref = PROGRAMS[name], lark_parser.parse(SOURCES[name])
    assert INTEGER == ["accum64", "blur", "dilate2d", "erode2d", "gauss5x5",
                       "gaussian2d", "jacobi2d_i64", "mul32", "ops16", "sobel2d"]
    shape = (37, 72)
    pl = plan(p, shape, iterate=1, tile=(4, 32), bz=8)
    kernels = []
    for g in pl.groups:
        k = linebuffer2d.GroupKernel(p, g)
        kernels.append((k, g, k.build(emulate=True).lib.soda_launch))
    for pattern, ins in _extremes(p, shape):
        values, tps = to_torch(p, ins, {}, "cpu")
        values = dict(values)
        for k, g, entry in kernels:
            outs = {o: torch.empty(shape, dtype=torch_dtype(p.tensors[o].type))
                    for o in g.outputs}
            k.launch(entry, values, tps, outs, 0)
            values.update(outs)
        got = to_numpy(p, {o: values[o] for o in p.output_names})
        gold = numpy_interp.run(ref, ins, {}, iterate=1)
        for o in gold:
            assert np.array_equal(got[o], gold[o]), (pattern, o)
