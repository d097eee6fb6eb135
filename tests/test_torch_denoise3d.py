"""denoise3d, the benchmark's multi-stage configuration
(`portbench/configs/denoise3d-512.json`), on the port's main path against
the benchmark's plain reference (`portbench/reference/denoise3d.py`,
loaded by path): `cuda.build_fn` with u the state and rhs a field, bit for
bit on the whole grid, first and last planes included,
- through the plain path (CPU tensors), three chained calls;
- through kernel 1, the wrapper's card branch with the kernel's host
  emulation standing in for the card (`_OnCard`), on a grid whose rows are
  whole 16-byte chunks (the TMA feed) and on an odd one (the scalar feed),
  against the reference with a correctly rounded sqrt, as the kernel and
  torch on the card compute it (torch's CPU sqrt goes through MKL's
  vector math, which is not: 1 ulp off on about 0.7% of cells);
and what a launch counts: one launch of the column z-march
(`columns3d.py`), three stages and the plan's bytes a call for denoise3d,
one launch of the rings and one stage for jacobi3d, the stage count and
the march on the span `soda.kernel`.  Kernel 1 runs on a grid smaller than
one tile and in chunks shorter than its warm-up too, under the host and
the hazard emulation.  Besides, the plain namespace sets up MKL's vector math
from one thread before its first CPU evaluation.

This file imports neither jax nor soda_tpu.
"""

import shutil
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from soda_tpu_torch.backend import cuda, linebuffer
from soda_tpu_torch.frontend.parser import parse_file
from soda_tpu_torch.interp import torch_xp
from soda_tpu_torch.utils import trace
from soda_tpu_torch.utils.testing import CORPUS

TMA_GRID = (13, 20, 24)       # rows of 24 x 4 B: whole 16-byte chunks
ODD_GRID = (11, 13, 21)
SMALL_GRID = (5, 7, 12)       # smaller than one tile in every dim
# kernel 1's cases: (grid, feed, plan pins); the last a chunk of 2 planes,
# shorter than the column z-march's warm-up of 4 steps
KERNEL_CASES = [(TMA_GRID, "tma", {}), (ODD_GRID, "scalar", {}), (SMALL_GRID, "tma", {}),
                (TMA_GRID, "tma", {"bz": 2})]
REF = harness.load_module("reference", "denoise3d")
P = parse_file(harness.program_path("denoise3d"))


def _inputs(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g), torch.rand(shape, generator=g)


def _want(u, rhs):
    """One sweep of the reference over the whole grid, in one block."""
    h = REF.HALO

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, h, h))

    return REF.sweep_at(pad(u), -h, u.shape[0], pad(rhs))


def _rounded_sqrt(t):
    """A correctly rounded sqrt of a CPU tensor (numpy's)."""
    return torch.from_numpy(np.sqrt(t.numpy()))


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_the_programs_are_one():
    assert P.input_names == ["u", "rhs"] and P.output_names == ["unew"]
    assert P.stage_order() == parse_file(CORPUS / "denoise3d.soda").stage_order()


@pytest.mark.parametrize("shape", [TMA_GRID, ODD_GRID])
def test_the_plain_path_equals_the_reference(shape):
    u, rhs = _inputs(shape, 3)
    fn = cuda.build_fn(P, grid_shape=shape)
    for _ in range(3):
        got = fn({"u": u, "rhs": rhs}, {})["unew"]
        assert _same(got, _want(u, rhs))
        u = got
    # the field matters
    assert not _same(fn({"u": u, "rhs": 0 * rhs}, {})["unew"], _want(u, rhs))


CARD = torch.device("cuda", 0)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on cuda:0, so a kernel wrapper takes
    its card branch (the checks, the counts, the span, the launch) and
    launches the kernel's host emulation on its memory."""

    @property
    def device(self):
        return CARD


def _on_card(t):
    return t.contiguous().as_subclass(_OnCard)


@pytest.fixture
def emulated_card(request, monkeypatch):
    """Kernel wrappers built as host emulation (or, with the fixture's
    parameter True, the hazard emulation) and launched on the CPU tensors
    of `_OnCard`s."""
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")
    real_build = linebuffer.GroupKernel.build
    hazard = getattr(request, "param", False)

    def build(self, emulate=False, hazard=hazard):
        built = real_build(self, emulate=True, hazard=hazard)
        self._entry = built.lib.soda_launch
        return built

    monkeypatch.setattr(linebuffer.GroupKernel, "build", build)
    monkeypatch.setattr(torch.cuda, "device", lambda d: trace._OFF)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    cuda.reset_launches()
    yield
    cuda.reset_launches()


def _card_fn(program, shape, **plan_kw):
    """build_fn's fn on `_OnCard`s: the outputs into buffers made once."""
    fn = cuda.build_fn(program, grid_shape=shape, **plan_kw)
    bufs = [{n: _on_card(t) for n, t in b.items()} for b in fn.alloc("cpu")]

    def call(inputs):
        got = fn({n: _on_card(t) for n, t in inputs.items()}, {}, bufs=bufs)
        return {n: t.as_subclass(torch.Tensor).clone() for n, t in got.items()}

    return fn.plan, call


@pytest.mark.parametrize("emulated_card", [False, True], ids=["host", "hazard"],
                         indirect=True)
@pytest.mark.parametrize("shape,feed,pins", KERNEL_CASES)
def test_kernel_1_equals_the_reference(emulated_card, monkeypatch, shape, feed, pins):
    """The column z-march (grad in registers, w through its exchange) on
    the TMA feed and the scalar path, on a grid smaller than one tile and
    in chunks shorter than its warm-up, under the host and the hazard
    emulation."""
    the_plan, call = _card_fn(P, shape, **pins)
    (g,) = the_plan.groups
    assert (g.kernel, g.feed, g.stages) == ("linebuffer3d", feed, ["grad", "w", "unew"])
    assert g.levels == {"grad": 1, "w": 2, "unew": 3}
    assert (g.march, g.leads) == ("columns3d", {"grad": 1, "w": 1, "unew": 0})
    assert g.bz == pins.get("bz", g.bz) and (g.grid == (1, 1, 1) or shape != SMALL_GRID)
    u, rhs = _inputs(shape, 4)
    for _ in range(2):
        got = call({"u": u, "rhs": rhs})["unew"]
        with monkeypatch.context() as m:
            m.setattr(torch, "sqrt", _rounded_sqrt)
            want = _want(u, rhs)
        assert _same(got, want)
        u = got
    assert cuda.launch_counts()["linebuffer3d"] == 2
    assert cuda.feed_counts()[feed] == 2
    assert cuda.march_counts()["columns3d"] == 2


@pytest.mark.parametrize("name,stages,march", [("denoise3d", 3, "columns3d"),
                                               ("jacobi3d", 1, "rings3d")])
def test_a_call_counts_one_launch_its_stages_and_its_planned_bytes(emulated_card, name,
                                                                    stages, march):
    p = P if name == "denoise3d" else parse_file(CORPUS / "jacobi3d.soda")
    the_plan, call = _card_fn(p, TMA_GRID)
    x = {n: t for n, t in zip(p.input_names, _inputs(TMA_GRID, 5))}
    call(x)
    cuda.reset_launches()
    assert (sum(cuda.launch_counts().values()), cuda.stage_count(),
            cuda.planned_bytes(), sum(cuda.march_counts().values())) == (0, 0, 0, 0)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(3):
            call(x)
    (g,) = the_plan.groups
    assert sum(cuda.launch_counts().values()) == cuda.launch_counts()["linebuffer3d"] == 3
    assert cuda.stage_count() == 3 * stages
    assert cuda.planned_bytes() == 3 * g.hbm_bytes_per_call
    # the new march's launches (one a call) apart from the rings'; grad
    # still counts as a stage computed on chip
    assert g.march == march and cuda.march_counts() == {
        "columns": 0, "rings": 0, "columns3d": 3 * (march == "columns3d"),
        "rings3d": 3 * (march == "rings3d")}
    assert trace.totals()["soda.kernel"].count == 3
    args = [e.kwinputs for e in prof.events() if e.name == "soda.kernel"]
    assert args == [{"stages": stages, "march": march}] * 3


def test_the_plain_namespace_sets_up_vector_math_before_its_first_evaluation():
    torch_xp.TorchXP("cpu")
    assert torch_xp.ready_vml.cache_info().currsize == 1
