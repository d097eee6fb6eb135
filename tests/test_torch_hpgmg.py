"""HPGMG-FV's variable-coefficient Jacobi smoother, the benchmark's float64
six-input configuration (`portbench/configs/hpgmg-jacobi-512.json`), on
the port's main path against the benchmark's plain reference
(`portbench/reference/hpgmg_jacobi.py`, loaded by path): `cuda.build_fn`
with x the state and rhs, alpha and the three face coefficients fields,
bit for bit (int64 views) on the whole grid, first and last planes
included,
- through the plain path (CPU tensors), three chained calls, on a grid of
  whole 16-byte rows and on an odd one; the coefficients matter;
- through kernel 1, the wrapper's card branch with the kernel's host (and
  hazard) emulation standing in for the card (`_OnCard`), on the TMA feed
  (six fed rings, three with a halo), the scalar feed, a grid smaller
  than one tile and a chunk shorter than the warm-up;
- through the sharded fn on CPU shards, against the whole-grid path;
and what a launch counts: one launch of the column z-march, two stages,
the plan's bytes and the plan's TMA plane copies (`cuda.tma_copies()`,
held to the copies the emulated kernel makes), and the TMA-fed rings on
the span `soda.kernel` (`fed`: 6 here, 2 on denoise3d, 1 on jacobi3d).

This file imports neither jax nor soda_tpu.
"""

import ctypes
import shutil
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from soda_tpu_torch.backend import cuda, linebuffer
from soda_tpu_torch.frontend.parser import parse_file
from soda_tpu_torch.ir.dtypes import torch_dtype
from soda_tpu_torch.parallel import mesh
from soda_tpu_torch.parallel.sharded import gather_grid, shard_grid
from soda_tpu_torch.utils import trace
from soda_tpu_torch.utils.testing import CORPUS, build_emulated, pinned_plan

TMA_GRID = (13, 20, 24)       # rows of 24 x 8 B: whole 16-byte chunks
ODD_GRID = (11, 13, 21)
SMALL_GRID = (5, 7, 12)       # smaller than one tile in every dim
# kernel 1's cases: (grid, feed, plan pins); the last a chunk of 1 plane,
# shorter than the column z-march's warm-up of 2 steps
KERNEL_CASES = [(TMA_GRID, "tma", {}), (ODD_GRID, "scalar", {}), (SMALL_GRID, "tma", {}),
                (TMA_GRID, "tma", {"bz": 1})]
REF = harness.load_module("reference", "hpgmg_jacobi")
P = parse_file(harness.program_path("hpgmg_jacobi"))
FIELDS = ("rhs", "alpha", "beta_i", "beta_j", "beta_k")


def _inputs(shape, seed):
    """x and rhs uniform on [0, 1), the coefficients on [0.5, 1.5), as the
    configuration draws them."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for n in ("x",) + FIELDS:
        t = torch.rand(shape, generator=g, dtype=torch.float64)
        out[n] = t if n in ("x", "rhs") else t + 0.5
    return out


def _want(ins):
    """One sweep of the reference over the whole grid, in one block."""
    h = REF.HALO

    def pad(t):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, h, h))

    return REF.sweep(pad(ins["x"]), **{n: pad(ins[n]) for n in FIELDS})


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_the_program_reads_six_doubles_and_writes_one():
    assert P.input_names == ["x", *FIELDS] and P.output_names == ["xn"]
    assert P.stage_order() == ["dinv", "xn"] and P.rank == 3
    assert {torch_dtype(P.tensors[n].type) for n in P.tensors} == {torch.float64}


@pytest.mark.parametrize("shape", [TMA_GRID, ODD_GRID])
def test_the_plain_path_equals_the_reference(shape):
    ins = _inputs(shape, 3)
    fn = cuda.build_fn(P, grid_shape=shape)
    for _ in range(3):
        got = fn(ins, {})["xn"]
        assert _same(got, _want(ins))
        ins["x"] = got
    # a face coefficient matters
    assert not _same(fn({**ins, "beta_k": 0 * ins["beta_k"]}, {})["xn"], _want(ins))


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


@pytest.fixture(scope="module")
def built():
    """Every emulated source of this file compiled up front, in parallel."""
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")
    ks = [cuda.group_kernel(P, g) for shape, _, pins in KERNEL_CASES
          for g in pinned_plan(P, shape, pins).groups]
    others = [cuda.group_kernel(p, g) for p in (parse_file(CORPUS / "denoise3d.soda"),
                                                parse_file(CORPUS / "jacobi3d.soda"))
              for g in cuda.build_fn(p, grid_shape=TMA_GRID).plan.groups]
    build_emulated(ks + others, workers=6)
    build_emulated(ks, hazard=True, workers=6)


@pytest.fixture
def emulated_card(built, request, monkeypatch):
    """Kernel wrappers built as host emulation (or, with the fixture's
    parameter True, the hazard emulation) and launched on the CPU tensors
    of `_OnCard`s."""
    real_build = linebuffer.GroupKernel.build
    hazard = getattr(request, "param", False)

    def build(self, emulate=False, hazard=hazard):
        b = real_build(self, emulate=True, hazard=hazard)
        self._entry = b.lib.soda_launch
        return b

    monkeypatch.setattr(linebuffer.GroupKernel, "build", build)
    monkeypatch.setattr(torch.cuda, "device", lambda d: trace._OFF)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    cuda.reset_launches()
    yield
    cuda.reset_launches()


def _card_fn(program, shape, **plan_kw):
    """build_fn's fn on `_OnCard`s: the outputs into buffers made once."""
    fn = cuda.build_fn(program, the_plan=pinned_plan(program, shape, plan_kw))
    bufs = [{n: _on_card(t) for n, t in b.items()} for b in fn.alloc("cpu")]

    def call(inputs):
        got = fn({n: _on_card(t) for n, t in inputs.items()}, {}, bufs=bufs)
        return {n: t.as_subclass(torch.Tensor).clone() for n, t in got.items()}

    return fn.plan, call


@pytest.mark.parametrize("emulated_card", [False, True], ids=["host", "hazard"],
                         indirect=True)
@pytest.mark.parametrize("shape,feed,pins", KERNEL_CASES)
def test_kernel_1_equals_the_reference(emulated_card, shape, feed, pins):
    """The column z-march (dinv in registers, x's in-plane taps and the
    face coefficients' one-sided halos through the rings) on the TMA feed
    and the scalar path, on a grid smaller than one tile and in chunks
    shorter than its warm-up, under the host and the hazard emulation."""
    the_plan, call = _card_fn(P, shape, **pins)
    (g,) = the_plan.groups
    assert (g.kernel, g.feed, g.stages, g.march) == ("linebuffer3d", feed, ["dinv", "xn"],
                                                    "columns3d")
    assert g.bz == pins.get("bz", g.bz) and (g.grid == (1, 1, 1) or shape != SMALL_GRID)
    ins = _inputs(shape, 4)
    for _ in range(2):
        got = call(ins)["xn"]
        assert _same(got, _want(ins))
        ins["x"] = got
    assert cuda.launch_counts()["linebuffer3d"] == 2
    assert cuda.feed_counts()[feed] == 2
    assert cuda.march_counts()["columns3d"] == 2


def _emulated_copies(lib) -> tuple[int, int]:
    """The box copies the emulated TMA feed has made in this process,
    and their bytes (`soda_emu_copies`)."""
    out = (ctypes.c_uint64 * 2)()
    lib.soda_emu_copies(out)
    return out[0], out[1]


@pytest.mark.parametrize("name,stages,march,fed", [("hpgmg_jacobi", 2, "columns3d", 6),
                                                    ("denoise3d", 3, "columns3d", 2),
                                                    ("jacobi3d", 1, "rings3d", 1)])
def test_a_call_counts_one_launch_its_stages_bytes_and_tma_copies(emulated_card, name,
                                                                   stages, march, fed):
    p = P if name == "hpgmg_jacobi" else parse_file(CORPUS / f"{name}.soda")
    the_plan, call = _card_fn(p, TMA_GRID)
    (g,) = the_plan.groups
    x = {n: t.to(torch_dtype(p.tensors[n].type))
         for n, t in zip(p.input_names, _inputs(TMA_GRID, 5).values())}
    call(x)
    lib = cuda.group_kernel(p, g).build(emulate=True).lib
    cuda.reset_launches()
    assert cuda.tma_copies() == {"copies": 0, "bytes": 0}
    before = _emulated_copies(lib)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(3):
            call(x)
    after = _emulated_copies(lib)
    assert sum(cuda.launch_counts().values()) == cuda.launch_counts()["linebuffer3d"] == 3
    assert cuda.stage_count() == 3 * stages
    assert cuda.planned_bytes() == 3 * g.hbm_bytes_per_call
    assert (g.march, g.feed, g.fed) == (march, "tma", fed)
    assert cuda.march_counts()[march] == 3 and cuda.feed_counts()["tma"] == 3
    # the plan's copies, and the kernel's own: every fed ring's chunk and
    # z-halo planes in every CTA, a whole box each
    copies, nbytes = g.tma_copies(TMA_GRID)
    assert cuda.tma_copies() == {"copies": 3 * copies, "bytes": 3 * nbytes}
    assert (after[0] - before[0], after[1] - before[1]) == (3 * copies, 3 * nbytes)
    assert trace.totals()["soda.kernel"].count == 3
    args = [e.kwinputs for e in prof.events() if e.name == "soda.kernel"]
    assert args == [{"stages": stages, "march": march, "fed": fed}] * 3


def test_the_plan_at_512_cubed():
    """One group of two stages in the column z-march, six fed rings, three
    with a one-sided or two-sided halo; 59.36 planned bytes a cell."""
    (g,) = cuda.build_fn(P, grid_shape=(512, 512, 512)).plan.groups
    assert (g.stages, g.march, g.feed, g.tile, g.bz) == (["dinv", "xn"], "columns3d", "tma",
                                                       (16, 32), 64)
    boxes = {r.name: (r.rows, r.cols) for r in g.rings if r.pitch}
    assert boxes == {"x": (18, 36), "beta_i": (16, 34), "beta_j": (17, 32), "alpha": (16, 32),
                     "beta_k": (16, 32), "rhs": (16, 32)}
    assert g.hbm_bytes_per_call / 512 ** 3 == pytest.approx(59.3563, abs=1e-4)
    copies, nbytes = g.tma_copies((512, 512, 512))
    # 512 CTA columns x 8 chunks; each ring its 64 planes a chunk, beta_k one
    # more and x two more (their z-halos)
    assert copies == 512 * 8 * (6 * 64 + 1 + 2)
    assert nbytes / copies == pytest.approx(4366.22, abs=0.01)


@pytest.mark.parametrize("sizes,dims", [([2, 2], [0, 1]), ([4], [0])])
def test_the_sharded_fn_equals_the_whole_grid(sizes, dims):
    """The fields' halos cross the shards, as HPGMG's ghost zones do."""
    shape = (16, 32, 48)
    ins = _inputs(shape, 6)
    whole = cuda.build_fn(P, grid_shape=shape)
    m = mesh.make_mesh(sizes, devices=["cpu"] * 4)
    fn = mesh.build_sharded_fn(P, m, grid_shape=shape, dims=dims)
    state = {n: shard_grid(t, m, fn.dims) for n, t in ins.items()}
    for _ in range(3):
        state["x"] = fn(state, {})["xn"]
        ins["x"] = whole(ins, {})["xn"]
        assert _same(gather_grid(state["x"], "cpu"), ins["x"])
