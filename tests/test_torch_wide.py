"""Wide integers in the port: full-width uint64 and integers of 65 to 128
bits.

- The unsigned 64-bit carrier (`interp/torch_xp.py::U64`), operation by
  operation, against numpy's uint64 at 0, 1, 2^63 - 1, 2^63, 2^64 - 1 and
  seeded values over the whole range (division and remainder through the
  evaluator's C forms, as the oracle computes them).
- The torch limbs (`interp/torch_wide128.py`), operation by operation,
  against Python ints at 96 and 128 bits, signed and unsigned, and limb
  for limb against the port's numpy copy (`interp/wide128.py`).
- The uint64 programs (`utils/testing.py::U64_SOURCES`) through each
  kernel's host emulation (g++, `-DSODA_HOST_EMULATION`: kernel 1, 2, the
  fused sweeps at the planner's depth and at depth 1, and the windows
  kernel) and through `eager.run`, with inputs over the whole range,
  against the port's oracle and `soda_tpu` on the whole grid, on the same
  numpy inputs: its XLA backend for the one-sweep programs, and its
  oracle for u64_iter, since its XLA backend refuses an `iterate`
  program on uint64 (its scan carry turns int64 into uint64).  Its Pallas
  kernels, in interpret mode once per kernel, are
  tests/test_torch_wide_pallas.py's (about 5 to 10 s each, so that file
  runs beside this one).
- accum128 and the two programs of `soda_tpu`'s tests/test_wide128.py
  through `eager.run`, the port's oracle and its golden runner (g++),
  against `soda_tpu`'s XLA backend and oracle, as object arrays.
- The kernels, the mesh, host tiling and `sodac`'s default backend
  refuse integers wider than 64 bits with a typed error that names
  `--backend eager`.

Tolerance: none; integers are bit for bit, and a cast to float is held
by its bits.
"""

import functools
import pathlib
import shutil
import subprocess
import warnings

import numpy as np
import pytest
import torch

from soda_tpu.backend import xla as xla_backend
from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu_torch.backend import cpp, cuda, eager
from soda_tpu_torch.backend.cuda_codegen import int32_exact, int_range
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.cli import sodac
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.interp import evaluator, numpy_ref
from soda_tpu_torch.interp import torch_wide128 as tw
from soda_tpu_torch.interp import wide128 as nw
from soda_tpu_torch.interp.torch_xp import UINT64, TorchXP, U64, plain
from soda_tpu_torch.ir.types import UnsupportedTypeError
from soda_tpu_torch.parallel import host_tile, mesh
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils import report
from soda_tpu_torch.utils.opcount import typed_ops
from soda_tpu_torch.utils.testing import U64_SOURCES, build_emulated, emulate, u64_inputs
from test_wide128 import SRC_I, SRC_U

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
CSRC = pathlib.Path(__file__).resolve().parents[1] / "soda_tpu_torch" / "csrc"
XP = TorchXP("cpu")
M64 = 2**64 - 1


def _numpy(a) -> np.ndarray:
    """A carrier value, tensor or array as numpy (uint64 kept)."""
    if isinstance(a, U64):
        a = a.astype(np.uint64)
    if isinstance(a, torch.Tensor):
        a = plain(a)
        a = (a.view(torch.int64).numpy().view(np.uint64) if a.dtype == torch.uint64
             else a.numpy())
    return np.asarray(a)


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(_numpy(a)).view(np.uint8)


# ---- the unsigned 64-bit carrier ------------------------------------------

EDGE = np.array([0, 1, 2**63 - 1, 2**63, M64], np.uint64)


@functools.cache
def _operands():
    """Every pair of edge values, then seeded pairs over the whole range."""
    rng = np.random.default_rng(64)
    a, b = (x.ravel() for x in np.meshgrid(EDGE, EDGE))
    r = rng.integers(0, M64, (2, 300), np.uint64, endpoint=True)
    return np.concatenate([a, r[0]]), np.concatenate([b, r[1]])


def _shift_operands():
    """Every value shifted by 0 to 66 and by amounts of 2^63 and up."""
    a, _ = _operands()
    s = np.concatenate([np.arange(67, dtype=np.uint64), EDGE[3:]])
    x, sh = (v.ravel() for v in np.meshgrid(a[:60], s))
    return x, sh


CARRIER_BINARY = {
    "+": (lambda x, a, b: a + b, lambda a, b: a + b),
    "-": (lambda x, a, b: a - b, lambda a, b: a - b),
    "*": (lambda x, a, b: a * b, lambda a, b: a * b),
    "/": (lambda x, a, b: evaluator._c_div(x, a, b), lambda a, b: evaluator._c_div(np, a, b)),
    "%": (lambda x, a, b: evaluator._c_mod(x, a, b), lambda a, b: evaluator._c_mod(np, a, b)),
    "<": (lambda x, a, b: a < b, lambda a, b: a < b),
    "<=": (lambda x, a, b: a <= b, lambda a, b: a <= b),
    ">": (lambda x, a, b: a > b, lambda a, b: a > b),
    ">=": (lambda x, a, b: a >= b, lambda a, b: a >= b),
    "==": (lambda x, a, b: a == b, lambda a, b: a == b),
    "!=": (lambda x, a, b: a != b, lambda a, b: a != b),
    "&": (lambda x, a, b: x.bitwise_and(a, b), np.bitwise_and),
    "|": (lambda x, a, b: x.bitwise_or(a, b), np.bitwise_or),
    "^": (lambda x, a, b: x.bitwise_xor(a, b), np.bitwise_xor),
    "min": (lambda x, a, b: x.minimum(a, b), np.minimum),
    "max": (lambda x, a, b: x.maximum(a, b), np.maximum),
    ">>": (lambda x, a, b: x.right_shift(a, b), np.right_shift),
    "<<": (lambda x, a, b: x.left_shift(a, b), np.left_shift),
}
CASTS_TO = ("float16", "float32", "float64", "int8", "int16", "int32", "int64",
            "uint8", "uint16", "uint32")
CASTS_FROM = ("float16", "float32", "float64", "int8", "int16", "int32", "int64")


@pytest.mark.parametrize("op", [*CARRIER_BINARY, *(f"to_{t}" for t in CASTS_TO),
                                *(f"from_{t}" for t in CASTS_FROM), "neg", "invert"])
def test_uint64_carrier_equals_numpy(op):
    a, b = _shift_operands() if op in (">>", "<<") else _operands()
    ta, tb = (XP.asarray(v).astype(UINT64) for v in (a, b))
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        if op in CARRIER_BINARY:
            f, g = CARRIER_BINARY[op]
            got, want = f(XP, ta, tb), g(a, b)
        elif op.startswith("to_"):
            got, want = ta.astype(np.dtype(op[3:])), a.astype(np.dtype(op[3:]))
        elif op.startswith("from_"):
            # what the evaluator converts: floats truncated through int64
            # (`_trunc_float_to_int`), narrower ints extended by their sign
            x = (a >> np.uint64(2)).view(np.int64).astype(np.dtype(op[5:]))
            if x.dtype.kind == "f":
                x = np.trunc(x[np.abs(x) < 2.0**63])
            got, want = XP.asarray(x).astype(UINT64), x.astype(np.int64).astype(np.uint64)
        else:
            got, want = (-ta, -a) if op == "neg" else (~ta, ~a)
    want = np.asarray(want)
    assert _numpy(got).dtype == want.dtype, op
    assert np.array_equal(_bytes(got), _bytes(want)), op


# ---- the torch limbs against Python ints --------------------------------------


def _wrap(v, signed):
    v = int(v) & ((1 << 128) - 1)
    return v - (1 << 128) if signed and v >> 127 else v


def _rand(rng, n, bits, signed):
    vals = [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]
    if signed:
        vals = [v - (1 << bits) if v >> (bits - 1) else v for v in vals]
    return np.array(vals, dtype=object)


def _limbs(vals, rep):
    return tw.from_pairs(torch.from_numpy(nw.object_to_pairs(vals)), rep, XP)


def _ints(v, signed):
    return nw.pairs_to_object(_bytes(tw.to_pairs(v)).view(np.uint64).reshape(-1, 2),
                              signed)


LIMB_OPS = {   # name -> (the namespace's op, Python's on ints), on (a, b, s)
    "add": (lambda x, a, b, s: a + b, lambda a, b, s: a + b),
    "sub": (lambda x, a, b, s: a - b, lambda a, b, s: a - b),
    "mul": (lambda x, a, b, s: a * b, lambda a, b, s: a * b),
    "neg": (lambda x, a, b, s: -a, lambda a, b, s: -a),
    "invert": (lambda x, a, b, s: ~a, lambda a, b, s: ~a),
    "and": (lambda x, a, b, s: a & b, lambda a, b, s: a & b),
    "or": (lambda x, a, b, s: a | b, lambda a, b, s: a | b),
    "xor": (lambda x, a, b, s: a ^ b, lambda a, b, s: a ^ b),
    "min": (lambda x, a, b, s: x.minimum(a, b), lambda a, b, s: min(a, b)),
    "max": (lambda x, a, b, s: x.maximum(a, b), lambda a, b, s: max(a, b)),
    "abs": (lambda x, a, b, s: x.abs(a), lambda a, b, s: abs(a)),
    "floordiv": (lambda x, a, b, s: x.floor_divide(a, b), lambda a, b, s: a // b),
    "shl": (lambda x, a, b, s: x.left_shift(a, s), lambda a, b, s: a << s),
    "shr": (lambda x, a, b, s: x.right_shift(a, s), lambda a, b, s: a >> s),
    "shl_const": (lambda x, a, b, s: x.left_shift(a, 45), lambda a, b, s: a << 45),
    "shr_const": (lambda x, a, b, s: x.right_shift(a, 77), lambda a, b, s: a >> 77),
    "lt": (lambda x, a, b, s: a < b, lambda a, b, s: a < b),
    "le": (lambda x, a, b, s: a <= b, lambda a, b, s: a <= b),
    "gt": (lambda x, a, b, s: a > b, lambda a, b, s: a > b),
    "ge": (lambda x, a, b, s: a >= b, lambda a, b, s: a >= b),
    "eq": (lambda x, a, b, s: a == b, lambda a, b, s: a == b),
    "ne": (lambda x, a, b, s: a != b, lambda a, b, s: a != b),
    "to_int64": (lambda x, a, b, s: a.astype(np.int64),
                 lambda a, b, s: (a + 2**63) % 2**64 - 2**63),
}
KINDS = ((96, True), (96, False), (128, True), (128, False))


@pytest.mark.parametrize("op", sorted(LIMB_OPS))
def test_torch_limbs_equal_python_ints_and_the_numpy_limbs(op):
    rng = np.random.default_rng(128)
    f, g = LIMB_OPS[op]
    for bits, signed in KINDS:
        rep = "i" if signed else "u"
        a, b = _rand(rng, 80, bits, signed), _rand(rng, 80, bits, signed)
        b[::9] = a[::9]                                   # equal pairs
        if op == "floordiv":
            b = np.array([v or 1 for v in b], dtype=object)
        s = rng.integers(0, 128, 80)
        got = f(tw.Wide128XP(XP), _limbs(a, rep), _limbs(b, rep), XP.asarray(s))
        want = [g(int(x), int(y), int(z)) for x, y, z in zip(a, b, s)]
        if got.rep == "p":                                # compares, narrowing
            assert np.array_equal(got.l.numpy(), np.array(want)), (bits, signed)
        else:
            assert list(_ints(got, signed)) == [_wrap(w, signed) for w in want], (
                bits, signed)
        # limb for limb the port's numpy copy of the original
        na, nb = (nw._object_to_limbs(v, rep, np) for v in (a, b))
        ref = f(nw.Wide128XP(np), na, nb, s)
        if got.rep == "p":
            assert np.array_equal(got.l.numpy(), np.asarray(ref.l))
        else:
            assert all(np.array_equal(x.numpy(), y.astype(np.int64))
                       for x, y in zip(got.l, ref.l))


def test_torch_limbs_convert_floats_as_the_numpy_limbs():
    """int128 <-> f64 (exact to f64 precision) and narrow plain ints in,
    limb for limb and bit for bit with the numpy copy."""
    rng = np.random.default_rng(7)
    f = np.concatenate([rng.standard_normal(50) * 10.0 ** rng.integers(0, 37, 50),
                        [0.0, -0.0, 2.0**64, -2.0**100, 1.5]])
    i = rng.integers(-2**63, 2**63 - 1, 50, endpoint=True)
    for rep in "iu":
        dt_t, dt_n = (tw.INT128, nw.INT128) if rep == "i" else (tw.UINT128, nw.UINT128)
        for x in (f, i):
            got = tw.V.plain(XP.asarray(x), XP).astype(dt_t)
            ref = nw.V.plain(x, np).astype(dt_n)
            assert all(np.array_equal(a.numpy(), b.astype(np.int64))
                       for a, b in zip(got.l, ref.l))
            assert np.array_equal(_bytes(got.astype(np.float64).l),
                                  _bytes(ref.astype(np.float64).l))


# ---- the uint64 programs on each kernel ---------------------------------------

PROGRAMS = {n: parse(s) for n, s in U64_SOURCES.items()}
REF = {n: lark_parser.parse(s) for n, s in U64_SOURCES.items()}
K_BIG = 2**63 + 10_000_000_019     # a param above 2^63
# case -> (program, grid, plan kwargs, the kernel, param k); every kernel's
# grid is cut into at least two CTAs
KERNEL_CASES = {
    "u64_3d-lb3d": ("u64_3d", (6, 9, 40), dict(tile=(4, 32), bz=4), "linebuffer3d", None),
    "u64_2d-lb2d": ("u64_2d", (16, 40), dict(tile=(2, 32), bz=8), "linebuffer2d", None),
    "u64_param-lb2d": ("u64_param", (16, 40), dict(tile=(2, 32), bz=8), "linebuffer2d",
                       10_000_000_019),
    "u64_param-above-2^63": ("u64_param", (16, 40), dict(tile=(2, 32), bz=8),
                             "linebuffer2d", K_BIG),
    "u64_iter-fused": ("u64_iter", (16, 40), {}, "linebuffer2d", None),
    "u64_iter-depth1": ("u64_iter", (16, 40), dict(sweeps=1, tile=(2, 32), bz=8),
                        "linebuffer2d", None),
    "u64_1d-windows": ("u64_1d", (300,), dict(block=(32,)), "windows", None),
    "u64_2d-windows": ("u64_2d", (16, 40), dict(block=(8, 32)), "windows", None),
}


def _inputs(name, grid, k):
    ins, ps = u64_inputs(PROGRAMS[name], grid, np.random.default_rng(11))
    if k is not None:
        ps["k"] = np.uint64(k)
    return ins, ps


def _plan(case):
    name, grid, kw, _, _ = KERNEL_CASES[case]
    return plan(PROGRAMS[name], grid, **kw)


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")
    build_emulated([cuda.group_kernel(PROGRAMS[KERNEL_CASES[c][0]], g)
                    for c in KERNEL_CASES for g in _plan(c).groups])


@functools.cache
def _xla(name, grid, k):
    """`soda_tpu`'s XLA run of a one-sweep uint64 program (once a module)."""
    return xla_backend.run(REF[name], *_inputs(name, grid, k))


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_uint64_programs_through_each_kernel_equal_soda_tpu(built, case):
    name, grid, _, kernel, k = KERNEL_CASES[case]
    p = PROGRAMS[name]
    the_plan = _plan(case)
    assert {g.kernel for g in the_plan.groups} == {kernel}
    assert all(np.prod(g.grid) >= 2 for g in the_plan.groups)
    if name == "u64_iter":
        assert the_plan.groups[0].sweeps == (1 if "depth1" in case else 4)
    ins, ps = _inputs(name, grid, k)
    assert name == "u64_param" or (ins["a"] >= 2**63).any()
    got = emulate(p, the_plan, ins, ps)
    plain_path = to_numpy(p, eager.run(p, ins, ps, device="cpu"))
    oracle = numpy_ref.run(p, ins, ps)
    out = p.output_names[0]
    # soda_tpu's XLA backend for one sweep; its oracle for u64_iter (its
    # XLA backend refuses it; its Pallas kernel: test_torch_wide_pallas.py)
    ref = (numpy_interp.run(REF[name], ins, ps) if p.iterate > 1
           else _xla(name, grid, k))
    for res in (got, plain_path, ref):
        assert res[out].dtype == np.uint64
        assert np.array_equal(res[out], oracle[out]), case


def test_uint64_kernel_source_carries_uint64_t():
    """The printer keeps uint64 in uint64_t (no int32 narrowing), a literal
    above 2^63 is ranged at its value, and the bound weighs an operation
    as an int64 carrier's (4) over 8 B a cell each way."""
    p = PROGRAMS["u64_2d"]
    g = plan(p, (64, 256)).groups[0]
    src = cuda.group_kernel(p, g).source
    assert "const uint64_t* __restrict__ a_g" in src and "uint64_t* __restrict__ o_g" in src
    assert "((uint64_t)(" in src and "mask_int32" not in src.split("#ifndef SODA_HOST")[0]
    assert not int32_exact(p, p.tensors["o"].expr)
    big = parse("kernel: b\ninput uint64: a(8, *)\n"
                "output uint64: o(0, 0) = a(0, 0) ^ uint64(18446744073709551615)\n")
    lit = big.tensors["o"].expr.rhs
    assert int_range(big, lit) == (M64, M64)
    rep = report.analyze(plan(p, (64, 256)))
    assert rep.ideal_bytes_per_cell == 16
    assert typed_ops(p, p.tensors["o"].expr) == 4 * 9


def test_mask_int_round_trips_uint64_bits(tmp_path):
    """`mask_int` takes int64_t: a uint64_t passes through it at width 64
    unchanged (two's complement), as every uint64 store does."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    (tmp_path / "t.cc").write_text(
        '#include "soda_common.cuh"\n#include <cstdio>\n'
        "int main() { const uint64_t v[] = {0ull, 1ull, 9223372036854775807ull,\n"
        "  9223372036854775808ull, 18446744073709551615ull, 12345678901234567890ull};\n"
        "  for (uint64_t x : v) if ((uint64_t)mask_int(x, 64, false) != x) return 1;\n"
        "  return (uint64_t)mask_int(18446744073709551615ull, 32, false) == 4294967295ull"
        " ? 0 : 2; }\n")
    subprocess.run(["g++", "-std=c++17", "-DSODA_HOST_EMULATION", "-I", str(CSRC),
                    "-o", str(tmp_path / "t"), str(tmp_path / "t.cc")], check=True)
    assert subprocess.run([str(tmp_path / "t")]).returncode == 0


# ---- 128 bits end to end ---------------------------------------------------------

W128 = {"accum128": (SODA / "accum128.soda").read_text(), "w128": SRC_U, "w96": SRC_I}


@functools.cache
def _w128(name):
    """The program both ways, seeded inputs over its whole range, and
    soda_tpu's XLA backend and oracle on them (once a module)."""
    src = W128[name]
    p, r = parse(src), lark_parser.parse(src)
    t = p.tensors[p.input_names[0]].type
    ins = {"a": _rand(np.random.default_rng(5), 13 * 21, t.width,
                      t.is_signed).reshape(13, 21)}
    return p, ins, xla_backend.run(r, ins), numpy_interp.run(r, ins)


@pytest.mark.parametrize("name", sorted(W128))
def test_128_bit_programs_through_every_path_equal_soda_tpu(name):
    p, ins, xla_out, gold = _w128(name)
    out = p.output_names[0]
    paths = {"eager": to_numpy(p, eager.run(p, ins, {}, device="cpu")),
             "numpy_ref": numpy_ref.run(p, ins, {}),
             "golden": cpp.NativeOracle(p, (13, 21)).run(ins, {})}
    for k, res in paths.items():
        assert res[out].dtype == object, k
        assert list(res[out].ravel()) == list(gold[out].ravel()), k
        assert list(res[out].ravel()) == list(xla_out[out].ravel()), k
    # the 16-byte layout both ways: words in, words out
    words = cpp.compile_and_run(p, {"a": nw.object_to_pairs(ins["a"])}, pairs=True)[out]
    assert words.shape == (13, 21, 2) and words.dtype == np.uint64
    tw_out = eager.run(p, {"a": torch.from_numpy(nw.object_to_pairs(ins["a"]))},
                       device="cpu")[out]
    assert np.array_equal(_bytes(tw_out), words.view(np.uint8))
    assert list(nw.pairs_to_object(words, p.tensors[out].type.is_signed).ravel()) == list(
        gold[out].ravel())


def test_kernel_paths_refuse_128_bits_naming_the_eager_backend(tmp_path, capsys):
    p = parse(W128["accum128"])
    _, ins, _, _ = _w128("accum128")
    msg = "wider than 64 bits.*--backend eager"
    with pytest.raises(UnsupportedTypeError, match=msg):
        cuda.build_fn(p, grid_shape=(13, 21))
    with pytest.raises(UnsupportedTypeError, match=msg):
        cuda.run(p, ins, device="cpu")
    with pytest.raises(UnsupportedTypeError, match=msg):
        mesh.build_sharded_fn(p, mesh.make_mesh([2], None, ["cpu"] * 2), grid_shape=(13, 21))
    with pytest.raises(UnsupportedTypeError, match=msg):
        host_tile.run_host_tiled(p, ins, tiles=(8, 0), device="cpu")
    argv = [str(SODA / "accum128.soda"), "--grid-shape", "13,21"]
    with pytest.raises(SystemExit, match=msg):
        sodac.main(argv + ["--run"])
    assert sodac.main(argv + ["--device", "cpu", "--backend", "eager", "--run"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
    assert sodac.main(argv + ["--xocl-kernel", str(tmp_path / "k.cpp")]) == 0
    assert "unsigned __int128" in (tmp_path / "k.cpp").read_text()
