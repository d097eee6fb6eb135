"""The line-buffer kernels (1: 3-D z-march, 2: 2-D row-march) on the card
against their plain version.

Marked `gpu`; each test asks the `cuda_device` fixture for a card and skips
without one.  This file imports neither jax nor soda_tpu's TPU backends, so
it runs on the card's machine, which has no jax:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Gates: integers bit-exact; half bit-exact against the plain version (one
correctly rounded operation at a time on both sides); floats through
`compare_outputs` (f32 1e-4, f32 libm 2e-3, f64 1e-4) against the plain
PyTorch version on the card and against the port's NumPy reference, on
the whole grid.
"""

import numpy as np
import pytest
import torch

from soda_tpu_torch.backend import cuda, eager, linebuffer, linebuffer2d
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse, parse_file
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils.testing import (CORPUS, INT3D_SOURCES, RANK3_CORPUS,
                                          compare_outputs, oracle, rand_inputs)

torch.set_num_threads(1)

NAMES = list(RANK3_CORPUS) + list(INT3D_SOURCES)


def _program(name):
    if name in INT3D_SOURCES:
        return parse(INT3D_SOURCES[name])
    return parse_file(CORPUS / f"{name}.soda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file on the H100 (README.md)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(32, 64, 128), (13, 37, 45)])
def test_kernel_matches_plain_and_oracle(cuda_device, name, shape):
    p = _program(name)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(10))
    before = linebuffer.LAUNCHES
    got = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device))
    torch.cuda.synchronize()
    assert (linebuffer.LAUNCHES - before
            == len(plan(p, shape).groups) * max(p.iterate, 1))
    plain = to_numpy(p, eager.run(p, ins, ps, device=cuda_device))
    assert compare_outputs(p, got, plain, 0)
    assert compare_outputs(p, got, oracle(p, ins, ps), 0)


@pytest.mark.gpu
def test_kernel_on_many_tiles_and_chunks(cuda_device):
    p = _program("denoise3d")
    shape = (37, 70, 90)
    the_plan = plan(p, shape, tile=(8, 32), bz=8)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(11))
    got = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device, the_plan=the_plan))
    plain = to_numpy(p, eager.run(p, ins, ps, device=cuda_device))
    assert compare_outputs(p, got, plain, 0)


@pytest.mark.gpu
def test_wrapper_checks_dtype_and_contiguity(cuda_device):
    p = _program("jacobi3d")
    g = plan(p, (8, 16, 32)).groups[0]
    k = linebuffer.GroupKernel(p, g)
    x = torch.zeros((8, 16, 32), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        k({"t0": x}, {})
    y = torch.zeros((8, 32, 16), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k({"t0": y}, {})
    z = torch.zeros((8, 16, 32), device=cuda_device)
    with pytest.raises(ValueError, match="also an input"):
        k({"t0": z}, {}, out={"t1": z})


@pytest.mark.gpu
def test_iterate_ping_pong_keeps_the_feedback_input(cuda_device):
    p = _program("heat3d")
    ins, _ = rand_inputs(p, (16, 24, 40), np.random.default_rng(12))
    tins, _ = to_torch(p, ins, {}, cuda_device)
    keep = tins["heat_in"].clone()
    got = to_numpy(p, cuda.run(p, tins, {}, device=cuda_device, iterate=5))
    assert torch.equal(tins["heat_in"], keep)
    gold = oracle(p, ins, {}, iterate=5)
    assert compare_outputs(p, got, gold, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["blur", "smooth_half", "accum64", "mathfn_f64"])
@pytest.mark.parametrize("shape", [(64, 256), (37, 45), (7, 13)])
def test_row_march_matches_plain_and_oracle(cuda_device, name, shape):
    p = _program(name)
    ins, ps = rand_inputs(p, shape, np.random.default_rng(15))
    before = linebuffer2d.LAUNCHES
    got_t = cuda.run(p, ins, ps, device=cuda_device)
    torch.cuda.synchronize()
    assert (linebuffer2d.LAUNCHES - before
            == len(plan(p, shape).groups) * max(p.iterate, 1))
    plain_t = eager.run(p, ins, ps, device=cuda_device)
    got, plain = to_numpy(p, got_t), to_numpy(p, plain_t)
    for k in got:
        if p.tensors[k].type.is_int or p.tensors[k].type.width == 16:
            assert np.array_equal(got[k].view(np.uint8), plain[k].view(np.uint8)), k
    assert compare_outputs(p, got, plain, 0)
    assert compare_outputs(p, got, oracle(p, ins, ps), 0)


@pytest.mark.gpu
def test_row_march_on_many_strips_and_chunks(cuda_device):
    p = _program("sobel2d")
    shape = (301, 1003)
    the_plan = plan(p, shape, tile=(2, 32), bz=8)
    assert the_plan.groups[0].grid[0] * the_plan.groups[0].grid[1] > 1000
    ins, ps = rand_inputs(p, shape, np.random.default_rng(16))
    got = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device, the_plan=the_plan))
    plain = to_numpy(p, eager.run(p, ins, ps, device=cuda_device))
    assert np.array_equal(got["mag"], plain["mag"])
    assert np.array_equal(got["mag"], oracle(p, ins, ps)["mag"])
