"""The line-buffer kernels (1: 3-D z-march, 2: 2-D row-march) and the fused
`iterate` cascades (`backend/sweeps.py`) on the card against their plain
version and, for the cascades, against the chained one-sweep kernels.

Marked `gpu`; each test asks the `cuda_device` fixture for a card and skips
without one.  This file imports neither jax nor soda_tpu's TPU backends, so
it runs on the card's machine, which has no jax:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Gates: integers bit-exact; half bit-exact against the plain version (one
correctly rounded operation at a time on both sides); fused cascades bit
for bit against the chained kernels (the same operations in the same
order, no FMA); floats through
`compare_outputs` (f32 1e-4, f32 libm 2e-3, f64 1e-4) against the plain
PyTorch version on the card and against the port's NumPy reference, on
the whole grid.
"""

import numpy as np
import pytest
import torch

from soda_tpu_torch.backend import cuda, eager, linebuffer, linebuffer2d, sweeps
from soda_tpu_torch.backend.io import to_numpy, to_torch
from soda_tpu_torch.frontend.parser import parse, parse_file
from soda_tpu_torch.plan.planner import fused_depths, plan
from soda_tpu_torch.utils.testing import (CORPUS, INT3D_SOURCES, RANK3_CORPUS,
                                          compare_outputs, oracle, rand_inputs)

torch.set_num_threads(1)

NAMES = list(RANK3_CORPUS) + list(INT3D_SOURCES)
ITERATE = ("jacobi2d", "seidel2d", "residual2d", "denoise2p", "jacobi2d_i64", "heat3d")


def _launches() -> int:
    return linebuffer.LAUNCHES + linebuffer2d.LAUNCHES + sweeps.LAUNCHES


def _want(p, pl) -> int:
    return len(pl.groups) * max(p.iterate, 1) // pl.groups[0].sweeps


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
    before = _launches()
    got = to_numpy(p, cuda.run(p, ins, ps, device=cuda_device))
    torch.cuda.synchronize()
    assert _launches() - before == _want(p, plan(p, shape))
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
    before = _launches()
    got_t = cuda.run(p, ins, ps, device=cuda_device)
    torch.cuda.synchronize()
    assert _launches() - before == _want(p, plan(p, shape))
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


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ITERATE)
@pytest.mark.parametrize("grid", ["aligned", "odd"])
def test_fused_cascade_equals_chained_bit_for_bit_and_plain(cuda_device, name, grid):
    p = _program(name)
    shape = {(2, "aligned"): (64, 256), (2, "odd"): (37, 45),
             (3, "aligned"): (32, 64, 128), (3, "odd"): (13, 37, 45)}[(p.rank, grid)]
    ins, ps = rand_inputs(p, shape, np.random.default_rng(17))
    chained = cuda.run(p, ins, ps, device=cuda_device, sweeps=1)
    plain = to_numpy(p, eager.run(p, ins, ps, device=cuda_device))
    gold = oracle(p, ins, ps)
    depths = fused_depths(p, shape)
    assert depths and p.iterate % depths[-1] == 0
    for d in depths:
        pl = plan(p, shape, sweeps=d)
        before = sweeps.LAUNCHES
        got = cuda.run(p, ins, ps, device=cuda_device, sweeps=d)
        torch.cuda.synchronize()
        assert sweeps.LAUNCHES - before == _want(p, pl)
        for k in got:
            assert torch.equal(_bits(got[k]), _bits(chained[k])), (d, k)
        assert compare_outputs(p, to_numpy(p, got), plain, 0)
        assert compare_outputs(p, to_numpy(p, got), gold, 0)


@pytest.mark.gpu
def test_fused_cascade_on_many_tiles_and_chunks(cuda_device):
    p = _program("heat3d")
    shape = (37, 70, 90)
    pl = plan(p, shape, sweeps=4, tile=(8, 32), bz=8)
    assert pl.groups[0].sweeps == 4 and np.prod(pl.groups[0].grid) > 50
    ins, ps = rand_inputs(p, shape, np.random.default_rng(18))
    got = cuda.run(p, ins, ps, device=cuda_device, the_plan=pl)
    chained = cuda.run(p, ins, ps, device=cuda_device, sweeps=1)
    assert torch.equal(got["heat_out"], chained["heat_out"])
    assert compare_outputs(p, to_numpy(p, got), oracle(p, ins, ps), 0)
