"""The port's copies of soda_tpu's framework-free modules, against the
originals.

The port imports nothing of soda_tpu, so it carries its own copies of the
IR, the evaluator and the NumPy oracle, the golden runner (its printer
and the generated runners), the computation-reuse rewrite (`--tcse`), the
span arithmetic and the test helpers.  Each copy is fed programs from the
port's parser and each original programs from the lark parser, on every
corpus program (every one of at most 64 bits where the copy leaves the
wider ones out).

Tolerance: none.  The printers print the same strings, the oracles give
bit-identical arrays, the spans and the random inputs are equal, and the
comparison gates give the same verdicts.
"""

import functools
import pathlib

import numpy as np
import pytest

from soda_tpu.backend import cpp as cpp_orig
from soda_tpu.frontend import parser as lark_parser
from soda_tpu.interp import numpy_interp
from soda_tpu.ir import types as types_orig
from soda_tpu.optimize import tcse as tcse_orig
from soda_tpu.optimize import unroll as unroll_orig
from soda_tpu.plan import planner as planner_orig
from soda_tpu.utils import opcount as opcount_orig
from soda_tpu.utils import testing as testing_orig
from soda_tpu_torch.backend import cpp as cpp_port
from soda_tpu_torch.backend import cpp_gen
from soda_tpu_torch.frontend import parser as port_parser
from soda_tpu_torch.interp import numpy_ref
from soda_tpu_torch.ir import types as types_port
from soda_tpu_torch.ir.types import UnsupportedTypeError
from soda_tpu_torch.optimize import tcse as tcse_port
from soda_tpu_torch.optimize import unroll as unroll_port
from soda_tpu_torch.plan import spans
from soda_tpu_torch.utils import opcount as opcount_port
from soda_tpu_torch.utils import testing as testing_port

SODA = pathlib.Path(__file__).parent / "soda"
CORPUS = sorted(SODA.glob("*.soda"))
SHAPES = {1: (70,), 2: (13, 21), 3: (5, 7, 9)}
ITERATE = [p for p in CORPUS if port_parser.parse_file(p).iterate > 1]


@functools.cache
def _both(path):
    """The port's and the lark parser's program (parsed once a module: the
    rewrites and printers below build new programs and mutate none)."""
    return port_parser.parse_file(path), lark_parser.parse_file(path)


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_printer_copy_prints_what_the_golden_runner_prints(path):
    port, orig = _both(path)
    idx = [f"i{d}" for d in range(port.rank)]
    gp, go = cpp_gen._Gen(port, idx), cpp_orig._Gen(orig, idx)
    for name in port.stage_order():
        cp, tp = gp.emit(port.tensors[name].expr)
        co, to = go.emit(orig.tensors[name].expr)
        assert cp == co and repr(tp) == repr(to), name
        t = port.tensors[name].type
        assert (gp.cast_to("__v", tp, t)
                == go.cast_to("__v", to, orig.tensors[name].type))


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_numpy_reference_equals_the_oracle_bit_for_bit(path):
    port, orig = _both(path)
    ins, ps = testing_orig.rand_inputs(orig, SHAPES[orig.rank],
                                       np.random.default_rng(21))
    if path.stem == "accum128":
        with pytest.raises(UnsupportedTypeError, match="wider than 64 bits"):
            numpy_ref.run(port, ins, ps)
        return
    got, gold = numpy_ref.run(port, ins, ps), numpy_interp.run(orig, ins, ps)
    assert list(got) == list(gold)
    for k in gold:
        assert got[k].dtype == gold[k].dtype
        assert np.array_equal(got[k], gold[k], equal_nan=True), k


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_spans_and_group_io_equal_the_planner_originals(path):
    port, orig = _both(path)
    stages = port.stage_order()
    groups = [stages] + [[s] for s in stages] + [stages[:k] for k in range(2, len(stages))]
    for members in groups:
        io = spans._group_io(port, members)
        assert io == planner_orig._group_io(orig, members)
        assert (spans.group_spans(port, members, io[1])
                == planner_orig.group_spans(orig, members, io[1]))


def test_rand_inputs_and_compare_outputs_equal_the_originals():
    for path in CORPUS:
        port, orig = _both(path)
        shape = SHAPES[port.rank]
        a = testing_port.rand_inputs(port, shape, np.random.default_rng(3))
        b = testing_orig.rand_inputs(orig, shape, np.random.default_rng(3))
        for x, y in zip(a, b):
            assert list(x) == list(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (path, k)
        if path.stem == "accum128":
            continue
        gold = numpy_interp.run(orig, *b)
        for rim in (0, 1):
            for scale in (0.0, 1e-5, 1e-2, 1.0):
                got = {k: (v + np.asarray(scale).astype(v.dtype)
                           if v.dtype.kind == "f" else v + int(scale >= 1e-2))
                       for k, v in gold.items()}
                assert (testing_port.compare_outputs(port, got, gold, rim)
                        == testing_orig.compare_outputs(orig, got, gold, rim)), (path, rim, scale)


@pytest.mark.parametrize("s", ["uint1", "uint8", "int13", "int16", "uint32",
                               "int33", "uint64", "int64", "uint100", "int128",
                               "float", "float32", "double", "half", "float16"])
def test_scalar_types_equal_the_originals(s):
    a, b = types_port.ScalarType.parse(s), types_orig.ScalarType.parse(s)
    assert repr(a) == repr(b) and str(a) == str(b)
    assert (a.np_dtype(), a.cpp_type(), a.storage_width, a.needs_mask, a.is_signed) == (
        b.np_dtype(), b.cpp_type(), b.storage_width, b.needs_mask, b.is_signed)
    for u in ("uint16", "int32", "uint64", "float", "double", "half"):
        assert repr(types_port.promote(a, types_port.ScalarType.parse(u))) == repr(
            types_orig.promote(b, types_orig.ScalarType.parse(u)))


def test_iterate_corpus_is_the_six_fused_programs():
    assert sorted(p.stem for p in ITERATE) == sorted(
        ["jacobi2d", "seidel2d", "residual2d", "denoise2p", "jacobi2d_i64", "heat3d"])


@pytest.mark.parametrize("path", ITERATE, ids=lambda p: p.stem)
def test_unroll_copy_equals_the_original(path):
    port, orig = _both(path)
    it = port.iterate
    for factor in [None] + [d for d in range(2, it) if it % d == 0]:
        a = unroll_port.unroll_iterate(port, factor)
        b = unroll_orig.unroll_iterate(orig, factor)
        assert a.iterate == b.iterate and list(a.tensors) == list(b.tensors)
        assert a.stage_order() == b.stage_order()
        assert (a.input_names, a.output_names) == (b.input_names, b.output_names)
        for n in a.tensors:
            ta, tb = a.tensors[n], b.tensors[n]
            assert repr(ta.type) == repr(tb.type) and ta.is_output == tb.is_output
            assert ta.window() == tb.window(), n
            assert repr(ta.expr) == repr(tb.expr), n


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_expr_ops_copy_equals_the_original(path):
    port, orig = _both(path)
    for name in port.stage_order():
        assert (opcount_port.expr_ops(port.tensors[name].expr)
                == opcount_orig.expr_ops(orig.tensors[name].expr)), name


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_tcse_copy_equals_the_original(path):
    port, orig = _both(path)
    a, b = tcse_port.apply(port), tcse_orig.apply(orig)
    assert a.describe() == b.describe()
    assert a.stage_order() == b.stage_order()
    for f in ("count_adds", "count_muls", "count_minmax", "count_ops"):
        assert getattr(tcse_port, f)(a) == getattr(tcse_orig, f)(b), f
        assert getattr(tcse_port, f)(port) == getattr(tcse_orig, f)(orig), f
    for n in a.tensors:
        assert repr(a.tensors[n].type) == repr(b.tensors[n].type), n
        assert repr(a.tensors[n].expr) == repr(b.tensors[n].expr), n


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_golden_runner_copy_generates_the_original_text(path):
    port, orig = _both(path)
    shape = SHAPES[port.rank]
    if path.stem == "accum128":
        for gen in (cpp_port.generate, cpp_port.generate_shared):
            with pytest.raises(UnsupportedTypeError, match="wider than 64 bits"):
                gen(port, shape)
        return
    for it in (None, 3):
        assert cpp_port.generate(port, shape, it) == cpp_orig.generate(orig, shape, it)
        assert (cpp_port.generate_shared(port, shape, it)
                == cpp_orig.generate_shared(orig, shape, it))
    tp, to = tcse_port.apply(port), tcse_orig.apply(orig)
    assert cpp_port.generate(tp, shape) == cpp_orig.generate(to, shape)
