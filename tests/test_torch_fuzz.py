"""Random programs through the port, held against `soda_tpu` on the same
numpy inputs: the port's counterpart of `tests/test_fuzz.py`, test for
test, with the same seeds and grids (the generators are the port's copies,
`soda_tpu_torch/utils/fuzz.py`, held equal to the originals below).

Each case runs through the port's paths that the original's case
exercises: its NumPy oracle, the plain path (`eager.run(device="cpu")`),
each planned group's kernel as host emulation (`utils/testing.py::
emulate`: g++, `-DSODA_HOST_EMULATION`, `iterate / nf` calls as
`cuda.build_fn` makes them), the golden runner, `tcse.apply` and
`run_host_tiled` (on the CPU); and through `soda_tpu`: `numpy_interp.run`,
its XLA backend where the original runs it, and its Pallas kernels in
interpret mode on the first two seeds of a test (`PALLAS_SEEDS`).
`test_fuzz_backends_agree` adds rank 1, which reaches kernel 4.

Tolerances:
- the port's oracle against `soda_tpu`'s: bit for bit (a copy);
- the port's kernels, plain path, golden runner and host tiling against
  the oracle on the whole grid: integers, and f32 programs that call no
  libm, bit for bit (the same IEEE operations in the same order, no
  contraction); otherwise `utils/testing.py::compare_outputs` at its
  program-derived gate (f32 with libm 2e-3, half 2e-2, else 1e-4);
  the golden runner at the original's 2e-5 where it calls libm;
- against `soda_tpu`'s XLA backend and Pallas kernels: `compare_outputs`
  outside `valid_rim()`, where the TPU kernels differ from the oracle by
  design (zero-filled intermediate stages at constant extent);
- wide programs (`fuzz.gen_wide`: int64, uint64, double, half, with and
  without the marches' hazard emulation): `fuzz.wide_gate`, the
  original's gate, outside `valid_rim()` against `soda_tpu`'s oracle, and
  integers bit for bit on the whole grid.
Where a grid is smaller than its rim (the original skips such a case),
the port is still held against the oracle on the whole grid.  The
half-precision `abs` and `%` of the generated kernels (an overload of
their own in `csrc/soda_common.cuh`) run through all four kernels.
"""

import concurrent.futures
import functools
import importlib
import importlib.util
import multiprocessing
import pathlib
import random
import shutil
import sys

import numpy as np
import pytest
import torch

from soda_tpu.backend import cpp as ref_cpp
from soda_tpu.backend import pallas as ref_pallas
from soda_tpu.backend import xla as ref_xla
from soda_tpu.frontend.parser import parse as ref_parse
from soda_tpu.interp import numpy_interp
from soda_tpu.optimize import tcse as ref_tcse
from soda_tpu.parallel.host_tile import run_host_tiled as ref_host_tiled
from soda_tpu_torch.backend import cpp, cuda, eager
from soda_tpu_torch.backend.io import to_numpy
from soda_tpu_torch.frontend.parser import parse
from soda_tpu_torch.optimize import tcse
from soda_tpu_torch.parallel.host_tile import run_host_tiled
from soda_tpu_torch.plan.planner import plan
from soda_tpu_torch.utils import fuzz
from soda_tpu_torch.utils.fuzz import (gen_minmax_program, gen_program,
                                       gen_signed_chain, gen_two_input_program,
                                       gen_weighted_program, interior, make_input)
from soda_tpu_torch.utils.testing import (build_emulated, compare_outputs, emulate,
                                          kernel_names, oracle)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPY_SEEDS = 60       # seeds a generator copy is held equal to its original over
PALLAS_SEEDS = (0, 1)
VMEM = 2 * 2**20          # the original's vmem budget for its Pallas runs
BACKEND_SHAPES = {1: (500,), 2: (32, 48), 3: (16, 24, 48)}
# wide programs (`fuzz.wide_case` seeds): half with abs through kernel 2
# (125), kernel 1 (165, 60) and the rank-2 cascade (130 at iterate 2, 15
# at 4); int64, uint64 and double through kernels 1 and 2 and cascades at
# iterate 2 and 4, with division, remainder and casts
WIDE_SEEDS = (125, 165, 130, 15, 60, 0, 10, 5, 26, 1, 30, 109, 2, 34, 4, 111)
WINDOW_BLOCKS = {2: (8, 32), 3: (4, 8, 32)}
# `half` programs with abs, min, max and % through kernels 1, 2, 3 (the
# rank-2 cascade at nf 2) and 4 (rank 1)
HALF_SOURCES = {
    "kernel1": ("kernel: h3\ninput half: a(24, 32, *)\n"
                "local half: s(0, 0, 0) = abs(a(0, 0, 1)) - min(a(1, 0, 0), a(0, 1, 0))"
                " + max(a(-1, 0, 0), a(0, -1, -1))\n"
                "output half: out(0, 0, 0) = abs(s(0, 0, -1)) * 0.5 + min(s(1, 1, 0), a(0, 0, 0))"
                " + abs(a(0, 0, 0)) % 0.75\n", (13, 17, 40), {}),
    "kernel2": ("kernel: h2\ninput half: a(64, *)\n"
                "local half: s(0, 0) = abs(a(0, 1)) - min(a(1, 0), a(0, -1)) + max(a(-1, 0), a(2, 2))\n"
                "output half: out(0, 0) = abs(s(0, -1)) * 0.5 + max(s(1, 1), a(0, 0))"
                " + a(0, 0) % 0.75\n", (37, 45), {}),
    "kernel3": ("kernel: h2i\niterate: 2\ninput half: a(64, *)\n"
                "output half: out(0, 0) = abs(a(0, 1)) * 0.25 + min(a(1, 0), a(0, -1))"
                " + max(a(-1, 0), abs(a(0, 0)) % 0.75)\n", (37, 45), {"sweeps": 2}),
    "kernel4": ("kernel: h1\ninput half: a(*)\n"
                "output half: out(0) = abs(a(1)) - min(a(-1), a(2)) + max(a(0), a(-2))"
                " + abs(a(0)) % 0.75\n", (300,), {}),
}
HALF_KERNELS = {"kernel1": "linebuffer3d", "kernel2": "linebuffer2d",
                "kernel3": "sweeps", "kernel4": "windows"}


# ---- the cases, as the original draws them --------------------------------------


def _backends(rank, seed):
    src = gen_program(random.Random(1000 * rank + seed), rank)
    shape = BACKEND_SHAPES[rank]
    return src, shape, {"a": make_input(parse(src), shape, np.random.default_rng(seed))}, None


def _two_inputs(seed):
    src = gen_two_input_program(random.Random(9000 + seed))
    rnp = np.random.default_rng(seed)
    a = rnp.standard_normal((32, 48)).astype(np.float32)
    b = rnp.standard_normal((32, 48)).astype(np.float32)
    return src, (32, 48), {"a": a, "b": b}, None


def _unaligned(seed):
    rng = random.Random(3000 + seed)
    rank = rng.choice([2, 3])
    src = gen_program(rng, rank)
    if rank == 2:
        shape = (rng.randint(24, 70), rng.choice([48, 64, 100, 130]))
    else:
        shape = (rng.randint(12, 30), rng.randint(16, 40), rng.choice([48, 100, 130]))
    return src, shape, {"a": make_input(parse(src), shape, np.random.default_rng(seed))}, None


def _trapezoid(seed):
    rng = random.Random(4000 + seed)
    src = gen_program(rng, 2)
    it = rng.randint(2, 16)
    shape = (64, 64) if it <= 8 else (128, 128)
    return src, shape, {"a": make_input(parse(src), shape, np.random.default_rng(seed))}, it


def _mixed_sign(seed):
    rng = random.Random(1500 + seed)
    rank = rng.choice([2, 3])
    src = gen_signed_chain(rng, rank)
    it = rng.choice([1, 2, 4])
    shape = (64, 96) if rank == 2 else (24, 32, 64)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return src, shape, {"a": x}, it


def _tcse_case(seed):
    src = gen_program(random.Random(7000 + seed), 2)
    return src, (32, 48), {"a": make_input(parse(src), (32, 48), np.random.default_rng(seed))}


def _minmax(seed):
    src = gen_minmax_program(random.Random(8000 + seed))
    x = np.random.default_rng(seed).integers(0, 60000, (32, 48)).astype(np.uint16)
    return src, (32, 48), {"a": x}


def _pinned(rank, seed):
    src = gen_program(random.Random(1000 * rank + seed), rank)
    shape = (37, 45) if rank == 2 else (13, 17, 40)
    return src, shape, {"a": make_input(parse(src), shape, np.random.default_rng(seed))}, None


def _host(seed):
    rng = random.Random(2500 + seed)
    rank = rng.choice([2, 3])
    src = (gen_signed_chain(rng, rank) if rng.random() < 0.5
           else gen_program(rng, rank))
    it = rng.choice([1, 1, 2, 4])
    shape = (64, 96) if rank == 2 else (24, 32, 64)
    tiles = tuple(rng.choice([0, n // 2, n // 3 + 1, n])
                  for n in shape[:-1]) + (rng.choice([0, shape[-1], shape[-1] // 2]),)
    spp = rng.choice([None, 1, it])
    return src, shape, {"a": make_input(parse(src), shape, np.random.default_rng(seed))}, it, \
        tiles, spp


KERNEL_CASES = {
    "backends": [_backends(r, s) for r in (1, 2, 3) for s in range(12)],
    "two_inputs": [_two_inputs(s) for s in range(6)],
    "unaligned": [_unaligned(s) for s in range(8)],
    "trapezoid": [_trapezoid(s) for s in range(6)],
    "mixed_sign": [_mixed_sign(s) for s in range(6)],
}
GOLDEN = ([(gen_program(random.Random(s), 2), (24, 32), s) for s in range(6)]
          + [(gen_program(random.Random(500 + s), 3), (10, 12, 16), s) for s in range(4)])
WEIGHTED = [gen_weighted_program(random.Random(6000 + s)) for s in range(10)]

# `soda_tpu`'s programs, parsed once by its lark parser (`REF`, filled by
# the `built` fixture: about 0.3 s a program, so in 4 processes)
REF: dict = {}


def _ref(src: str):
    if src not in REF:
        REF[src] = ref_parse(src)
    return REF[src]


def _lark_sources() -> list[str]:
    srcs = {c[0] for cases in KERNEL_CASES.values() for c in cases}
    srcs |= {src for src, _, _ in GOLDEN} | set(WEIGHTED)
    srcs |= {_tcse_case(s)[0] for s in range(8)} | {_minmax(s)[0] for s in range(10)}
    srcs |= {_host(s)[0] for s in range(8)} | {_pinned(r, s)[0] for r in (2, 3) for s in (0, 1)}
    srcs |= {fuzz.wide_case(s).source for s in WIDE_SEEDS}
    srcs |= {src for src, _, _ in HALF_SOURCES.values()}
    return sorted(srcs)


def _plan(src, shape, it, **kw):
    p = parse(src)
    return plan(p, shape, iterate=max(p.iterate if it is None else it, 1), **kw)


@pytest.fixture(scope="module")
def built():
    """`soda_tpu`'s parse of every program below (in 4 spawned processes)
    and the host emulation of every kernel below (in threads,
    `build_emulated`), both up front."""
    if shutil.which("g++") is None:
        pytest.skip("host emulation needs g++")

    def kernels(src, the_plan):
        return [cuda.group_kernel(parse(src), g) for g in the_plan.groups]

    ks = [k for cases in KERNEL_CASES.values() for src, shape, _, it in cases
          for k in kernels(src, _plan(src, shape, it))]
    for src, shape, _ in [_tcse_case(s) for s in range(8)] + [_minmax(s) for s in range(10)]:
        q = tcse.apply(parse(src))
        ks += [cuda.group_kernel(q, g) for g in plan(q, shape).groups]
    for rank in (2, 3):
        for s in (0, 1):
            src, shape, _, _ = _pinned(rank, s)
            ks += kernels(src, plan(parse(src), shape, block=WINDOW_BLOCKS[rank]))
    for src, shape, kw in HALF_SOURCES.values():
        ks += kernels(src, plan(parse(src), shape, **kw))
    wide = [k for s in WIDE_SEEDS for c in [fuzz.wide_case(s)]
            for k in kernels(c.source, plan(c.program, c.shape))]
    srcs = _lark_sources()
    with concurrent.futures.ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as pool:
        parsed = pool.map(ref_parse, srcs, chunksize=8)
        build_emulated(ks + wide)
        build_emulated(wide, hazard=True)
        REF.update(zip(srcs, parsed))


# ---- the checks ---------------------------------------------------------------------


def _against_oracle(p, got: dict, gold: dict, what: str) -> None:
    """`got` against the oracle on the whole grid: integers, and programs
    that call no libm, bit for bit; and within `compare_outputs`."""
    for k in gold:
        if not p.uses_libm_transcendentals() or not p.tensors[k].type.is_float:
            assert np.array_equal(got[k], gold[k]), f"{what}: {k}"
    assert compare_outputs(p, got, gold, 0), what


def _port_paths(src, shape, ins, it, the_plan=None, hazard=False) -> tuple:
    """The case through the port's oracle (bit for bit against
    `soda_tpu`'s), its plain path and its kernels' host emulation (each
    against the oracle); returns (program, reference program, oracle
    outputs, emulated outputs)."""
    p, r = parse(src), _ref(src)
    it = max(p.iterate if it is None else it, 1)
    gold = numpy_interp.run(r, ins, iterate=it)
    mine = oracle(p, ins, iterate=it)
    for k in gold:
        assert np.array_equal(mine[k], gold[k], equal_nan=True), f"oracle copy: {k}"
    plain = to_numpy(p, eager.run(p, ins, device="cpu", iterate=it))
    _against_oracle(p, plain, gold, f"plain path:\n{src}")
    the_plan = the_plan or plan(p, shape, iterate=it)
    emu = emulate(p, the_plan, ins, iterate=it, hazard=hazard)
    _against_oracle(p, emu, gold, f"kernels {kernel_names(the_plan)}:\n{src}")
    return p, r, gold, emu


def _against_reference(p, got: dict, ref: dict, rim: int, what: str) -> None:
    """`got` against a `soda_tpu` backend outside `rim` (a grid all rim
    holds nothing to compare)."""
    if interior(next(iter(ref.values())), rim).size:
        assert compare_outputs(p, got, ref, rim), what


# ---- tests/test_fuzz.py's tests ------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_fuzz_backends_agree(built, seed, rank):
    src, shape, ins, it = _backends(rank, seed)
    p, r, gold, emu = _port_paths(src, shape, ins, it)
    rim = p.valid_rim()
    _against_reference(p, emu, ref_xla.run(r, ins), rim, f"xla:\n{src}")
    if seed in PALLAS_SEEDS:
        _against_reference(p, emu, ref_pallas.run(r, ins, interpret=True, vmem_budget=VMEM),
                           rim, f"pallas:\n{src}")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_cpp_bit_exact(built, seed, tmp_path):
    _golden(*GOLDEN[seed], tmp_path)


def _golden(src, shape, seed, tmp_path):
    """The port's golden runner: the original's text, and the oracle's
    values (libm within the original's 2e-5)."""
    p, r = parse(src), _ref(src)
    assert cpp.generate(p, shape) == ref_cpp.generate(r, shape)
    x = make_input(p, shape, np.random.default_rng(seed))
    gold = numpy_interp.run(r, {"a": x})["out"]
    got = cpp.compile_and_run(p, {"a": x}, workdir=tmp_path)["out"]
    if p.uses_libm_transcendentals():
        assert np.allclose(got.astype(np.float64), gold.astype(np.float64),
                           rtol=2e-5, atol=2e-5), f"C++ mismatch:\n{src}"
    else:
        assert np.array_equal(got, gold), f"C++ mismatch:\n{src}"


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_tcse_preserves_semantics(built, seed):
    src, shape, ins = _tcse_case(seed)
    p, r = parse(src), _ref(src)
    q, qr = tcse.apply(p), ref_tcse.apply(r)
    assert q.describe() == qr.describe() and tcse.count_ops(q) == ref_tcse.count_ops(qr)
    a, b = oracle(p, ins)["out"], numpy_interp.run(qr, ins)["out"]
    gq = oracle(q, ins)
    assert np.array_equal(gq["out"], b)
    rim = max(p.valid_rim(), q.valid_rim())
    ga, gb = interior(a, rim).astype(np.float64), interior(b, rim).astype(np.float64)
    if p.tensors["a"].type.is_int:
        assert np.array_equal(ga, gb), f"tcse int mismatch:\n{src}"
    else:
        assert np.allclose(ga, gb, rtol=1e-4, atol=1e-4), f"tcse:\n{src}"
    _against_oracle(q, emulate(q, plan(q, shape), ins), gq, f"rewritten kernels:\n{src}")


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_cpp_bit_exact_3d(built, seed, tmp_path):
    _golden(*GOLDEN[6 + seed], tmp_path)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_two_inputs(built, seed):
    src, shape, ins, it = _two_inputs(seed)
    p, r, gold, emu = _port_paths(src, shape, ins, it)
    if seed in PALLAS_SEEDS:
        _against_reference(p, emu, ref_pallas.run(r, ins, interpret=True, vmem_budget=VMEM),
                           p.valid_rim(), f"two-input pallas:\n{src}")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_unaligned_grids(built, seed):
    src, shape, ins, it = _unaligned(seed)
    p, r, gold, emu = _port_paths(src, shape, ins, it)
    if seed in PALLAS_SEEDS:
        _against_reference(p, emu, ref_pallas.run(r, ins, interpret=True, vmem_budget=VMEM),
                           p.valid_rim(), f"unaligned {shape} pallas:\n{src}")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_trapezoid_iterate(built, seed):
    """Iterated 2-16 sweeps: the fused cascade at the planner's depth,
    `iterate / nf` calls, against the oracle's sweep-by-sweep feedback."""
    src, shape, ins, it = _trapezoid(seed)
    p, r, gold, emu = _port_paths(src, shape, ins, it)
    if seed in PALLAS_SEEDS:
        _against_reference(p, emu, ref_pallas.run(r, ins, interpret=True, iterate=it),
                           p.valid_rim(iterate=it), f"iterate={it} pallas:\n{src}")


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_weighted_tcse_bit_exact(built, seed):
    src = WEIGHTED[seed]
    p, r = parse(src), _ref(src)
    q, qr = tcse.apply(p), ref_tcse.apply(r)
    assert q.describe() == qr.describe()
    assert tcse.count_ops(q) <= tcse.count_ops(p), f"op regression:\n{src}"
    x = np.random.default_rng(seed).integers(0, 1000, (32, 48)).astype(np.int32)
    a, b = oracle(p, {"a": x})["out"], oracle(q, {"a": x})["out"]
    assert np.array_equal(b, numpy_interp.run(qr, {"a": x})["out"])
    rim = max(p.valid_rim(), q.valid_rim())
    assert np.array_equal(interior(a, rim), interior(b, rim)), f"weighted tcse:\n{src}"


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_minmax_tcse_bit_exact(built, seed):
    """The min/max rewrite: the original's text, never more operations,
    bit for bit outside the rim, and the rewritten program through the
    kernels bit for bit against its oracle (and `soda_tpu`'s Pallas)."""
    src, shape, ins = _minmax(seed)
    p, r = parse(src), _ref(src)
    q, qr = tcse.apply(p), ref_tcse.apply(r)
    assert q.describe() == qr.describe()
    assert tcse.count_ops(q) <= tcse.count_ops(p), f"op regression:\n{src}"
    a, b = oracle(p, ins)["out"], oracle(q, ins)
    rim = max(p.valid_rim(), q.valid_rim())
    assert np.array_equal(interior(a, rim), interior(b["out"], rim)), f"minmax tcse:\n{src}"
    got = emulate(q, plan(q, shape), ins)
    assert np.array_equal(got["out"], b["out"]), f"minmax kernels:\n{src}"
    if seed in PALLAS_SEEDS:
        ref = ref_pallas.run(qr, ins, interpret=True)["out"]
        assert np.array_equal(interior(got["out"], rim), interior(ref, rim)), \
            f"minmax pallas:\n{src}"


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_mixed_sign_chains(built, seed):
    src, shape, ins, it = _mixed_sign(seed)
    p, r, gold, emu = _port_paths(src, shape, ins, it)
    if seed in PALLAS_SEEDS:
        _against_reference(p, emu, ref_pallas.run(r, ins, interpret=True, iterate=it,
                                                  vmem_budget=VMEM),
                           p.valid_rim(iterate=it), f"mixed-sign pallas:\n{src}")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_host_tiling(built, seed):
    """Random programs through host tiling on the CPU with the original's
    random tiles and passes, against the whole-grid run bit for bit on the
    whole grid, multi-stage programs and deeper passes too (a window on
    the grid's edge evaluates every stage there as the whole grid does;
    seed 6's intermediate stages once differed past the edge); and against
    `soda_tpu`'s host tiling (Pallas, interpret mode) outside the rim."""
    src, shape, ins, it, tiles, spp = _host(seed)
    x = ins["a"]
    p, r = parse(src), _ref(src)
    what = f"host-tile (tiles={tiles}, spp={spp}, it={it}):\n{src}"
    got = run_host_tiled(p, {"a": x}, tiles=tiles, iterate=it, sweeps_per_pass=spp,
                         device="cpu")
    whole = to_numpy(p, cuda.run(p, {"a": x}, device="cpu", iterate=it))
    rim = p.valid_rim(iterate=it)
    assert np.array_equal(got["out"], whole["out"]), what
    _against_reference(p, got, oracle(p, {"a": x}, iterate=it), rim, what)
    if seed in PALLAS_SEEDS:
        ref = ref_host_tiled(r, {"a": x}, tiles=tiles, iterate=it, sweeps_per_pass=spp,
                             interpret=True, vmem_budget=VMEM)
        _against_reference(p, got, ref, rim, f"pallas {what}")


# ---- wide programs, pinned windows, half's abs and % ------------------------------------


@pytest.mark.parametrize("hazard", [False, True], ids=["emulation", "hazard"])
@pytest.mark.parametrize("seed", WIDE_SEEDS)
def test_fuzz_wide_programs_through_the_kernels(built, seed, hazard):
    """`scripts/fuzz_wide.py`'s seeds through the kernels' host emulation
    (and the marches' hazard emulation) against `soda_tpu`'s oracle at the
    original's gate; integers bit for bit on the whole grid."""
    c = fuzz.wide_case(seed)
    p = c.program
    the_plan = plan(p, c.shape)
    gold = numpy_interp.run(_ref(c.source), c.inputs)["out"]
    got = emulate(p, the_plan, c.inputs, hazard=hazard)["out"]
    assert fuzz.wide_gate(p, c.base, gold, got), f"{kernel_names(the_plan)}:\n{c.source}"
    if c.base in ("int64", "uint64"):
        assert np.array_equal(got, gold), c.source
    assert interior(gold, p.valid_rim()).size


def test_wide_seeds_cover_every_type_kernel_and_depth():
    cases = [fuzz.wide_case(s) for s in WIDE_SEEDS]
    assert {c.base for c in cases} == {"int64", "uint64", "double", "half"}
    half_abs = [c for c in cases if c.base == "half" and "abs(" in c.source]
    assert len(half_abs) >= 4 and {c.program.rank for c in half_abs} == {2, 3}
    names = {k for c in cases for k in kernel_names(plan(c.program, c.shape))}
    assert names == {"linebuffer2d", "linebuffer3d", "sweeps"}
    assert {c.program.iterate for c in cases} >= {2, 4}
    by_seed = {c.seed: kernel_names(plan(c.program, c.shape)) for c in cases}
    assert by_seed[125] == ["linebuffer2d"] and by_seed[165] == ["linebuffer3d"]
    assert by_seed[130] == ["sweeps"]


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("rank", (2, 3))
def test_fuzz_pinned_to_the_windows_kernel(built, rank, seed):
    """Random programs pinned to the windows kernel (`block=`) on odd
    grids that cut several CTAs a dim, against the oracle on the whole
    grid and `soda_tpu`'s XLA backend outside the rim."""
    src, shape, ins, it = _pinned(rank, seed)
    p = parse(src)
    the_plan = plan(p, shape, block=WINDOW_BLOCKS[rank])
    assert kernel_names(the_plan) == ["windows"] * len(the_plan.groups)
    p, r, gold, emu = _port_paths(src, shape, ins, it, the_plan)
    _against_reference(p, emu, ref_xla.run(r, ins), p.valid_rim(), f"xla:\n{src}")


@pytest.mark.parametrize("name", sorted(HALF_SOURCES))
def test_half_abs_min_max_and_remainder_through_each_kernel(built, name):
    """A `half` operand of abs and `%` resolves to one overload (it did not
    build under the host emulation: `abs(soda_half)` was ambiguous), and
    the value is the oracle's."""
    src, shape, kw = HALF_SOURCES[name]
    p = parse(src)
    the_plan = plan(p, shape, **kw)
    assert kernel_names(the_plan) == [HALF_KERNELS[name]] * len(the_plan.groups)
    x = (np.random.default_rng(3).standard_normal(shape) * 2).astype(np.float16)
    _port_paths(src, shape, {"a": x}, None, the_plan)


# ---- the generators are the originals' ----------------------------------------------------


@functools.cache
def _orig(path: str):
    """The original module at `path` (a test file or a script), loaded
    under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "orig_" + pathlib.Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GENERATORS = {
    "gen_program": ("tests/test_fuzz.py", "gen_program", gen_program, (1, 2, 3)),
    "gen_two_input_program": ("tests/test_fuzz.py", "gen_two_input_program",
                              gen_two_input_program, ()),
    "gen_weighted_program": ("tests/test_fuzz.py", "gen_weighted_program",
                             gen_weighted_program, ()),
    "gen_minmax_program": ("tests/test_fuzz.py", "gen_minmax_program",
                           gen_minmax_program, ()),
    "gen_signed_chain": ("tests/test_fuzz.py", "gen_signed_chain", gen_signed_chain, (2, 3)),
    "gen_wide": ("scripts/fuzz_wide.py", "gen", fuzz.gen_wide, ()),
    "gen128": ("scripts/fuzz_wide.py", "gen128", fuzz.gen128, ()),
    "gen_mesh": ("scripts/fuzz_mesh.py", "gen", fuzz.gen_mesh, ()),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_copy_equals_the_original(name):
    path, orig_name, copy, ranks = GENERATORS[name]
    orig = getattr(_orig(path), orig_name)
    for seed in range(COPY_SEEDS):
        for args in [(r,) for r in ranks] or [()]:
            assert copy(random.Random(seed), *args) == orig(random.Random(seed), *args), \
                (name, seed, args)


def test_make_input_copy_equals_the_original():
    """The same draw (the original reads only the input's type, which the
    port's program carries under the same names)."""
    orig = _orig("tests/test_fuzz.py").make_input
    for seed in range(COPY_SEEDS):
        p = parse(gen_program(random.Random(seed), 2))
        a = make_input(p, (6, 9), np.random.default_rng(seed))
        b = orig(p, (6, 9), np.random.default_rng(seed))
        assert a.dtype == b.dtype and np.array_equal(a, b), seed


def _recorded(monkeypatch, path: str, argv: list[str], backends: list[str]) -> list:
    """Run an original script's `main` on `argv` and return the inputs it
    hands each of its `backends` (module attributes), in order.  Its
    parser is the port's and its oracle hands the input back (the draws
    are what is compared, not the values; the lark parser takes 0.3 s a
    program)."""
    records: list = []

    def record(p, ins, *a, **kw):
        records.append((ins["a"], kw))
        return {"out": ins["a"]}

    patches = {"soda_tpu.frontend.parser.parse": parse,
               "soda_tpu.interp.numpy_interp.run": lambda p, ins, *a, **kw: {"out": ins["a"]},
               **{b: record for b in backends}}
    for target, fn in patches.items():
        mod, attr = target.rsplit(".", 1)
        monkeypatch.setattr(importlib.import_module(mod), attr, fn)
    monkeypatch.setattr(sys, "argv", argv)
    assert _orig(path).main() in (0, 1)
    return records


def test_wide_cases_equal_the_original_draws(monkeypatch, capsys):
    """`fuzz.wide_case` and `w128_case` give the grid and input that
    `scripts/fuzz_wide.py`'s `main` and `fuzz_128` hand their backends,
    seed for seed (the programs: `test_generator_copy_equals_the_original`)."""
    got = _recorded(monkeypatch, "scripts/fuzz_wide.py", ["fuzz_wide.py", str(COPY_SEEDS)],
                    ["soda_tpu.backend.pallas.run"])
    # main skips a seed whose rim covers its grid before its backend runs
    want = [c for c in map(fuzz.wide_case, range(COPY_SEEDS))
            if interior(c.inputs["a"], c.program.valid_rim()).size]
    assert len(got) == len(want)
    for (x, _), c in zip(got, want):
        assert x.dtype == c.inputs["a"].dtype and np.array_equal(x, c.inputs["a"]), c.seed
    # fuzz_128 hands each seed's input to the golden runner, and every 4th
    # seed's to XLA too
    got = _recorded(monkeypatch, "scripts/fuzz_wide.py",
                    ["fuzz_wide.py", str(COPY_SEEDS), "--w128"],
                    ["soda_tpu.backend.cpp.compile_and_run", "soda_tpu.backend.xla.run"])
    want = [c.inputs["a"] for c in map(fuzz.w128_case, range(COPY_SEEDS))
            for _ in range(2 if c.seed % 4 == 0 else 1)]
    assert len(got) == len(want)
    assert all(np.array_equal(x, y) for (x, _), y in zip(got, want))
    capsys.readouterr()


def test_mesh_cases_equal_the_original_draws(monkeypatch, capsys):
    """`fuzz.mesh_case` gives the grid, input, mesh, cadence, overlap and
    local backend that `scripts/fuzz_mesh.py`'s `main` hands `run_sharded`,
    seed for seed."""
    got = _recorded(monkeypatch, "scripts/fuzz_mesh.py", ["fuzz_mesh.py", str(COPY_SEEDS)],
                    ["soda_tpu.parallel.mesh.run_sharded"])
    assert len(got) == COPY_SEEDS
    for seed, (x, kw) in enumerate(got):
        c = fuzz.mesh_case(seed)
        assert np.array_equal(x, c.inputs["a"]) and x.dtype == c.inputs["a"].dtype, seed
        assert kw["axis_sizes"] == c.axis_sizes and kw["dims"] == c.dims, seed
        assert kw.get("sweeps_per_exchange") == c.sweeps_per_exchange, seed
        assert kw.get("overlap", False) == c.overlap, seed
        assert (kw.get("local_backend") == "pallas") == c.kernel_seed, seed
    capsys.readouterr()
