"""The plain PyTorch path (`soda_tpu_torch/backend/eager.py`) against the
NumPy oracle and soda_tpu's XLA backend, on every corpus program.

Inputs come from `numpy.random.default_rng` (`rand_inputs`) and go to both
packages; accum128 (128-bit integers, the quad-limb path) is held against
the oracle as object arrays of Python ints.  Gates are `soda_tpu.utils.testing.compare_outputs`: integers
bit-exact; f32 at 1e-4, f32 programs with libm transcendentals at 2e-3,
half at 2e-2.  Against the oracle the whole grid is compared (the eager
path has the oracle's semantics); against XLA the border-invalid rim is
excluded (XLA uses 32-bit integer accumulators, docs/SEMANTICS.md).
"""

import pathlib

import numpy as np
import pytest
import torch

from soda_tpu.backend import xla as xla_backend
from soda_tpu.frontend.parser import parse_file
from soda_tpu.interp import numpy_interp
from soda_tpu.utils.testing import compare_outputs, rand_inputs
from soda_tpu_torch.backend import eager
from soda_tpu_torch.frontend.parser import parse_file as port_parse_file
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.interp.torch_xp import TorchXP

torch.set_num_threads(1)

SODA = pathlib.Path(__file__).parent / "soda"
CORPUS = sorted(SODA.glob("*.soda"))
SHAPES = {1: (96,), 2: (56, 48), 3: (12, 14, 16)}


def _io(p, seed=0):
    return rand_inputs(p, SHAPES[p.rank], np.random.default_rng(seed))


def _max_diff(got, gold):
    return {k: float(np.abs(got[k].astype(np.float64)
                            - gold[k].astype(np.float64)).max()) for k in gold}


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_eager_matches_oracle(path):
    p = port_parse_file(path)
    ins, ps = _io(p)
    got = to_numpy(p, eager.run(p, ins, ps, device="cpu"))
    gold = numpy_interp.run(parse_file(path), ins, ps)
    for k in gold:
        assert got[k].dtype == gold[k].dtype and got[k].shape == gold[k].shape
    assert compare_outputs(p, got, gold, 0), _max_diff(got, gold)


@pytest.mark.parametrize("path", [c for c in CORPUS if c.stem != "accum128"],
                         ids=lambda p: p.stem)
def test_eager_matches_xla_backend(path):
    p = port_parse_file(path)
    ins, ps = _io(p, seed=1)
    got = to_numpy(p, eager.run(p, ins, ps, device="cpu"))
    ref = xla_backend.run(parse_file(path), ins, ps)
    assert compare_outputs(p, got, ref, p.valid_rim()), _max_diff(got, ref)


def test_iterate_override_feeds_first_output_back():
    p = port_parse_file(SODA / "heat3d.soda")
    ins, _ = _io(p)
    for it in (1, 3):
        got = to_numpy(p, eager.run(p, ins, {}, device="cpu", iterate=it))
        gold = numpy_interp.run(parse_file(SODA / "heat3d.soda"), ins, {}, iterate=it)
        assert np.array_equal(got["heat_out"], gold["heat_out"])


def test_to_torch_checks_names_ranks_and_param_shapes():
    p = port_parse_file(SODA / "conv5x5.soda")
    ins, ps = _io(p)
    with pytest.raises(ValueError, match="missing input"):
        to_torch(p, {}, ps, "cpu")
    with pytest.raises(ValueError, match="missing param"):
        to_torch(p, ins, {}, "cpu")
    name = p.input_names[0]
    with pytest.raises(ValueError, match="rank"):
        to_torch(p, {name: ins[name][0]}, ps, "cpu")
    pname = next(iter(p.params))
    with pytest.raises(ValueError, match="shape"):
        to_torch(p, ins, {pname: np.zeros(3, np.float32)}, "cpu")


def test_full_width_uint64_is_refused_with_a_typed_error():
    """Full-width uint64 RUNS, bit for bit with the oracle on values
    across the whole range.  The name is kept from when this test pinned
    the refusal that the unsigned carrier (`torch_xp.U64`) lifted."""
    from soda_tpu.frontend.parser import parse as lark_parse
    from soda_tpu_torch.frontend.parser import parse

    src = "kernel: k\ninput uint64: a(8, *)\noutput uint64: b(0, 0) = a(0, 1)\n"
    x = np.random.default_rng(4).integers(0, 2**64 - 1, (4, 4), np.uint64, endpoint=True)
    got = to_numpy(parse(src), eager.run(parse(src), {"a": x}, {}, device="cpu"))["b"]
    assert got.dtype == np.uint64
    assert np.array_equal(got, numpy_interp.run(lark_parse(src), {"a": x})["b"])


def test_torch_namespace_numpy_semantics():
    """The namespace functions the evaluator and mathfns call, against
    numpy on the same values."""
    xp = TorchXP("cpu")
    a = np.array([-7, -1, 0, 3, 9], np.int64)
    b = np.array([2, 3, 5, 2, 4], np.int64)
    ta, tb = xp.asarray(a), xp.asarray(b)
    assert np.array_equal(xp.floor_divide(ta, tb).numpy(), np.floor_divide(a, b))
    assert np.array_equal(xp.right_shift(ta, 1).numpy(), np.right_shift(a, 1))
    assert np.array_equal(xp.left_shift(ta, tb).numpy(), np.left_shift(a, b))
    assert np.array_equal(xp.bitwise_and(ta, 6).numpy(), np.bitwise_and(a, 6))
    f = np.array([-1.5, -0.0, 0.0, 2.5, np.inf], np.float32)
    tf = xp.asarray(f)
    assert np.array_equal(xp.signbit(tf).numpy(), np.signbit(f))
    assert np.array_equal(xp.isinf(tf).numpy(), np.isinf(f))
    assert np.array_equal(xp.copysign(np.float32(1.0), tf).numpy(),
                          np.copysign(np.float32(1.0), f))
    with np.errstate(invalid="ignore"):
        assert np.array_equal(xp.fmod(tf, np.float32(0.7)).numpy(),
                              np.fmod(f, np.float32(0.7)), equal_nan=True)
    assert xp.asarray(0.1666666667, dtype=xp.float64).item() == 0.1666666667
    assert xp.asarray(1.5).astype(np.dtype(np.int16)).dtype == torch.int16
