"""Random stencil programs, their inputs and their gates: the port's
copies of `soda_tpu`'s fuzz generators.

The port imports nothing of `soda_tpu`, and the originals live in its
tests and scripts, so it keeps copies, as it does for `utils/testing.py`:
- from `tests/test_fuzz.py`: `gen_program`, `make_input`,
  `gen_two_input_program`, `gen_weighted_program`, `gen_minmax_program`,
  `gen_signed_chain`;
- from `scripts/fuzz_wide.py`: `gen` (here `gen_wide`), `gen128`, and the
  grids, input draws and gates of its `main` and `fuzz_128`
  (`wide_case`, `wide_gate`, `w128_case`);
- from `scripts/fuzz_mesh.py`: `gen` (here `gen_mesh`), and its `main`'s
  grids, meshes, cadences and gates (`mesh_case`, `mesh_gate`).
The same `random.Random` seed gives the same source text, character for
character, and the same numpy seed the same inputs
(`tests/test_torch_fuzz.py` holds each copy equal to its original).  So
a generator draws from `rng` in the original's order, even where the port
has no use for a draw (the wide integers' two magnitude profiles served
the TPU's 32-bit pair carriers; the port keeps them, since they choose
the program).  Plain Python and numpy: no torch, no jax.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

from ..frontend.parser import parse
from ..ir.program import StencilProgram

# ---- tests/test_fuzz.py ---------------------------------------------------------


def gen_program(rng: random.Random, rank: int) -> str:
    """Random 1-3 stage program over one input of float, int16, uint16 or
    int32: taps within radius 2, scaled taps, min/max, ternaries, shifts,
    masks, smooth libm calls on safe domains, a final division."""
    ftype = rng.choice(["float", "int16", "uint16", "int32"])
    is_float = ftype == "float"
    n_stages = rng.randint(1, 3)
    tile = ", ".join(["64"] * (rank - 1) + ["*"])
    lines = [f"kernel: fuzz", f"input {ftype}: a({tile})"]
    prev = ["a"]

    def off():
        return ", ".join(str(rng.randint(-2, 2)) for _ in range(rank))

    def term(src):
        r = f"{src}({off()})"
        if is_float:
            k = rng.random()
            if k < 0.25:
                return f"{r} * {round(rng.uniform(-2, 2), 3)}f"
            if k < 0.35:
                return f"abs({r})"
            if k < 0.45:
                return f"min({r}, {src}({off()}))"
            if k < 0.55:
                return f"({r} > 0.0f ? {r} : {src}({off()}))"
            if k < 0.65:
                d = f"{src}({off()})"
                return rng.choice([
                    f"atan({r})", f"expm1(tanh({r}))",
                    f"log1p({r} * {r})", f"hypot({r}, {d})"])
            return r
        k = rng.random()
        if k < 0.25:
            return f"{r} * {rng.randint(1, 3)}"
        if k < 0.35:
            return f"max({r}, {src}({off()}))"
        if k < 0.45:
            return f"({r} >> {rng.randint(0, 2)})"
        if k < 0.55:
            return f"({r} > {rng.randint(10, 100)} ? {r} : {src}({off()}))"
        if k < 0.62:
            return f"int32({r} & {2**rng.randint(4, 10) - 1})"
        return r

    for s in range(n_stages):
        src = rng.choice(prev)
        nterms = rng.randint(2, 5)
        expr = " + ".join(term(src) for _ in range(nterms))
        if rng.random() < 0.4:
            expr = f"({expr}) / {rng.choice(['2', '4'] if not is_float else ['2.0f', '4.0f'])}"
        kind = "output" if s == n_stages - 1 else "local"
        name = "out" if kind == "output" else f"s{s}"
        anchor = ", ".join(["0"] * rank)
        lines.append(f"{kind} {ftype}: {name}({anchor}) = {expr}")
        prev.append(name)
    return "\n".join(lines) + "\n"


def make_input(p: StencilProgram, shape, rng_np: np.random.Generator) -> np.ndarray:
    """Input `a` of `p`: standard normal floats, integers in [0, 200)."""
    t = p.tensors["a"].type
    if t.is_float:
        return rng_np.standard_normal(shape).astype(t.np_dtype())
    return rng_np.integers(0, 200, shape).astype(t.np_dtype())


def interior(a: np.ndarray, rim: int) -> np.ndarray:
    """`a` without `rim` cells at each end of every axis."""
    if rim == 0:
        return a
    return a[tuple(slice(rim, -rim) for _ in range(a.ndim))]


def gen_two_input_program(rng: random.Random) -> str:
    """A rank-2 f32 program over two inputs: a weighted sum, then a sum of
    taps of both inputs and the sum."""
    lines = ["kernel: fuzz2", "input float: a(64, *)", "input float: b(64, *)"]

    def off():
        return f"{rng.randint(-2, 2)}, {rng.randint(-2, 2)}"

    expr = " + ".join(
        f"{rng.choice(['a', 'b'])}({off()}) * {round(rng.uniform(-2, 2), 3)}f"
        for _ in range(rng.randint(3, 6)))
    lines.append(f"local float: s0(0, 0) = {expr}")
    expr2 = " + ".join(
        f"{rng.choice(['a', 'b', 's0'])}({off()})" for _ in range(3))
    lines.append(f"output float: out(0, 0) = {expr2}")
    return "\n".join(lines) + "\n"


def gen_weighted_program(rng: random.Random) -> str:
    """A random int32 sum of taps with constant weights, half of them an
    outer product of two weight rows (the weighted `--tcse` surface)."""
    lines = ["kernel: fw", "input int32: a(64, *)"]
    taps = []
    if rng.random() < 0.5:
        wr = [rng.randint(1, 4) for _ in range(rng.randint(2, 4))]
        wc = [rng.randint(1, 4) for _ in range(rng.randint(2, 4))]
        for i, a in enumerate(wr):
            for j, b in enumerate(wc):
                taps.append((a * b, (i - len(wr) // 2, j - len(wc) // 2)))
    else:
        seen = set()
        for _ in range(rng.randint(3, 9)):
            o = (rng.randint(-2, 2), rng.randint(-2, 2))
            if o in seen:
                continue
            seen.add(o)
            taps.append((rng.randint(1, 6), o))
    expr = " + ".join(
        (f"{w} * a({i}, {j})" if w != 1 else f"a({i}, {j})")
        for w, (i, j) in taps)
    lines.append(f"output int32: out(0, 0) = {expr}")
    return "\n".join(lines) + "\n"


def gen_minmax_program(rng: random.Random) -> str:
    """A random uint16 min or max tree over a tap set, half of them
    rectangular (the `--tcse` reuse of idempotent operators)."""
    fn = rng.choice(["min", "max"])
    taps = set()
    if rng.random() < 0.5:
        for i in range(rng.randint(2, 3)):
            for j in range(rng.randint(2, 4)):
                taps.add((i - 1, j - 1))
    else:
        while len(taps) < rng.randint(3, 9):
            taps.add((rng.randint(-2, 2), rng.randint(-2, 2)))
    leaves = [f"a({i}, {j})" for i, j in sorted(taps)]
    expr = leaves[0]
    for leaf in leaves[1:]:
        expr = f"{fn}({expr}, {leaf})"
    return (f"kernel: mm\ninput uint16: a(64, *)\n"
            f"output uint16: out(0, 0) = {expr}\n")


def gen_signed_chain(rng: random.Random, rank: int) -> str:
    """A chain of 2-4 f32 stages whose taps have mixed-sign offsets (a
    stage's halo reaches past the grid on both sides)."""
    n = rng.randint(2, 4)
    tile = ", ".join(["64"] * (rank - 1) + ["*"])
    lines = ["kernel: sc", f"input float: a({tile})"]
    prev = "a"
    for i in range(n):
        offs = [tuple(rng.choice([-2, -1, 1, 2]) for _ in range(rank))
                for _ in range(rng.randint(1, 3))]
        expr = " + ".join(f"{prev}({', '.join(map(str, o))})" for o in offs)
        kind = "output" if i == n - 1 else "local"
        nm = "out" if kind == "output" else f"s{i}"
        anchor = ", ".join(["0"] * rank)
        lines.append(f"{kind} float: {nm}({anchor}) = ({expr}) * 0.4f")
        prev = nm
    return "\n".join(lines) + "\n"


# ---- scripts/fuzz_wide.py ---------------------------------------------------------


def gen_wide(rng: random.Random) -> tuple[str, str, bool]:
    """Random program over int64, uint64, double or half; returns (source,
    base type, low magnitude).  Casts both ways, constant and tap-valued
    shifts, power-of-two and general division and remainder, min/max,
    ternaries, masks, the C math functions on safe domains; a fifth of the
    programs rank 3, the rest rank 2 with `iterate` 1, 2 or 4.  Integer
    programs draw a high-magnitude (2^48 inputs, no casts through double)
    or a low-magnitude (2^28, casts allowed) profile."""
    base = rng.choice(["int64", "uint64", "double", "half"])
    is_f = base in ("double", "half")
    low_mag = (not is_f) and rng.random() < 0.5
    rank3 = rng.random() < 0.2
    decl = "a(24, 32, *)" if rank3 else "a(64, *)"
    lines = [f"kernel: fw", f"input {base}: {decl}"]
    prev = ["a"]

    def off():
        if rank3:
            return (f"{rng.randint(-1, 1)}, {rng.randint(-1, 1)}, "
                    f"{rng.randint(-2, 2)}")
        return f"{rng.randint(-2, 2)}, {rng.randint(-2, 2)}"

    def lit(v):
        if is_f:
            return f"{float(v)}"
        return f"{base}({v})"

    def term(src):
        r = f"{src}({off()})"
        k = rng.random()
        if is_f:
            if k < 0.2:
                return f"{r} * {round(rng.uniform(-2, 2), 4)}"
            if k < 0.3:
                return f"abs({r})"
            if k < 0.4:
                return f"min({r}, {src}({off()}))"
            if k < 0.5:
                return f"({r} > 0.0 ? {r} : {src}({off()}))"
            if k < 0.58:
                # a denominator of at least 1 (a square plus one)
                d = f"{src}({off()})"
                return f"{r} / ({d} * {d} + 1.0)"
            if k < 0.64:
                return f"sqrt(abs({r}))"
            if k < 0.72:
                # domains kept well-conditioned (tanh, squares plus one,
                # asin at most 0.9)
                d = f"{src}({off()})"
                return rng.choice([
                    f"atan({r})", f"asin(tanh({r}) * 0.9)",
                    f"log1p({r} * {r})", f"expm1(tanh({r}))",
                    f"hypot({r}, {d})",
                    f"atan2({r}, {d} * {d} + 1.0)",
                    f"copysign({r}, {d})", f"sinh(tanh({r}))",
                    f"log10({r} * {r} + 1.0)",
                ])
            if k < 0.78 and base == "double":
                return f"double(int64({r}))"  # f64 -> i64 -> f64
            return r
        if k < 0.15:
            return f"{r} * {lit(rng.randint(1, 9))}"
        if k < 0.25:
            return f"max({r}, {src}({off()}))"
        if k < 0.35:
            return f"({r} >> {rng.randint(0, 50)})"
        if k < 0.42:
            # a tap-valued shift amount, masked to [0, 16)
            return f"({r} >> ({src}({off()}) & {lit(15)}))"
        if k < 0.5:
            return f"({r} > {lit(10)} ? {r} : {src}({off()}))"
        if k < 0.58:
            return f"{r} / {lit(2 ** rng.randint(1, 12))}"
        if k < 0.64:
            return f"{r} % {lit(rng.randint(3, 10**6))}"
        if k < 0.7:
            return f"({r} & {lit(2 ** rng.randint(4, 40) - 1)})"
        if k < 0.76 and low_mag:
            return f"{base}(double({r}) * 0.5)"  # i64 -> f64 -> i64
        return r

    n_stages = rng.randint(1, 3)
    anchor = "(0, 0, 0)" if rank3 else "(0, 0)"
    for s in range(n_stages):
        src = rng.choice(prev)
        nterms = rng.randint(2, 4)
        expr = " + ".join(term(src) for _ in range(nterms))
        name = f"s{s}" if s + 1 < n_stages else "out"
        kind = "local" if s + 1 < n_stages else "output"
        lines.append(f"{kind} {base}: {name}{anchor} = {expr}")
        prev.append(name)
    it = 1 if rank3 else rng.choice([1, 1, 1, 2, 4])
    if it > 1:
        lines.insert(1, f"iterate: {it}")
    return "\n".join(lines) + "\n", base, low_mag


def gen128(rng: random.Random) -> tuple[str, str]:
    """Random 65..128-bit integer program over int96, uint128, int128 or
    uint100 (integer operations only); returns (source, base type)."""
    base = rng.choice(["int96", "uint128", "int128", "uint100"])
    lines = [f"kernel: fq", f"input {base}: a(64, *)"]
    prev = ["a"]

    def off():
        return f"{rng.randint(-2, 2)}, {rng.randint(-2, 2)}"

    def term(src):
        r = f"{src}({off()})"
        k = rng.random()
        if k < 0.12:
            return f"{r} * {base}({rng.randint(1, 10**12)})"
        if k < 0.22:
            return f"max({r}, {src}({off()}))"
        if k < 0.32:
            return f"({r} >> {rng.randint(0, 100)})"
        if k < 0.4:
            return f"({r} >> ({src}({off()}) & {base}(31)))"
        if k < 0.48:
            return f"({r} > {base}(10) ? {r} : {src}({off()}))"
        if k < 0.56:
            return f"{r} / {base}({2 ** rng.randint(1, 40)})"
        if k < 0.64:
            return f"{r} % {base}({rng.randint(3, 10**9)})"
        if k < 0.72:
            return f"({r} & {base}({2 ** rng.randint(8, 100) - 1}))"
        if k < 0.8:
            return f"{base}(int64({r}))"  # narrow-and-widen cast chain
        return r

    n_stages = rng.randint(1, 2)
    for s in range(n_stages):
        src = rng.choice(prev)
        expr = " + ".join(term(src) for _ in range(rng.randint(2, 3)))
        name = f"s{s}" if s + 1 < n_stages else "out"
        kind = "local" if s + 1 < n_stages else "output"
        lines.append(f"{kind} {base}: {name}(0, 0) = {expr}")
        prev.append(name)
    if rng.random() < 0.3:
        lines.insert(1, "iterate: 2")
    return "\n".join(lines) + "\n", base


WIDE_SEED0 = 910_000
W128_SEED0 = 7_128_000
WIDE_SHAPES = {3: [(16, 24, 128), (24, 32, 128), (17, 25, 130)],
               2: [(32, 128), (40, 128), (33, 130), (64, 256)]}
W128_SHAPES = [(16, 48), (13, 33), (24, 64)]
# the share of cells allowed beyond a float gate where a compare of a value
# rounded to about zero may flip (half's rounding; an ulp of libm): one
# sweep, and with `iterate` feedback, which spreads a flipped cell
FLIP_SHARE = {False: 0.005, True: 0.012}
DOUBLE_REL = 1e-10


@dataclasses.dataclass
class Case:
    """One fuzz program with its grid and inputs (`inputs` names them)."""
    seed: int
    source: str
    program: StencilProgram
    base: str
    shape: tuple[int, ...]
    inputs: dict


def wide_input(base: str, low_mag: bool, shape, nprng: np.random.Generator) -> np.ndarray:
    """`scripts/fuzz_wide.py::main`'s draw: half 0.5 x normal (no f16
    overflow mid-chain), double 10 x normal, int64 in +-2^48 (2^28 for the
    low-magnitude profile), uint64 in [0, 2^49) ([0, 2^29))."""
    hi_bits = 28 if low_mag else 48
    if base == "half":
        return (nprng.standard_normal(shape) * 0.5).astype(np.float16)
    if base == "double":
        return nprng.standard_normal(shape) * 10.0
    if base == "int64":
        return nprng.integers(-2**hi_bits, 2**hi_bits, shape, dtype=np.int64)
    return nprng.integers(0, 2**(hi_bits + 1), shape, dtype=np.uint64)


def wide_case(seed: int, shape: tuple[int, ...] | None = None) -> Case:
    """Seed `seed` of `scripts/fuzz_wide.py::main`: its program, grid and
    input (drawn at `shape` instead of its grid where given)."""
    rng = random.Random(WIDE_SEED0 + seed)
    src, base, low_mag = gen_wide(rng)
    p = parse(src)
    shape = shape or tuple(rng.choice(WIDE_SHAPES[p.rank]))
    x = wide_input(base, low_mag, shape, np.random.default_rng(seed))
    return Case(seed, src, p, base, shape, {"a": x})


def wide_gate(p: StencilProgram, base: str, gold: np.ndarray, got: np.ndarray) -> bool | None:
    """`scripts/fuzz_wide.py`'s gate outside `valid_rim()`: integers bit
    for bit, double at `DOUBLE_REL` relative (to max(|gold|, 1)), half as
    the share of cells beyond 3e-2 relative under `FLIP_SHARE`.  None when
    the rim covers the whole grid (the original skips the seed)."""
    rim = p.valid_rim()
    g, o = interior(gold, rim), interior(got, rim)
    if g.size == 0:
        return None
    if base in ("double", "half"):
        g, o = g.astype(np.float64), o.astype(np.float64)
        rel = np.abs(g - o) / np.maximum(np.abs(g), 1.0)
        if base == "half":
            return bool(np.mean(rel >= 3e-2) < FLIP_SHARE[p.iterate > 1])
        return bool(rel.max() < DOUBLE_REL)
    return bool(np.array_equal(g, o))


def w128_case(seed: int) -> Case:
    """Seed `seed` of `scripts/fuzz_wide.py::fuzz_128`: its program, grid
    and input (an object array of Python ints over the type's range)."""
    rng = random.Random(W128_SEED0 + seed)
    src, base = gen128(rng)
    shape = tuple(rng.choice(W128_SHAPES))
    bits = int("".join(c for c in base if c.isdigit()))
    nprng = np.random.default_rng(seed)
    vals = [int.from_bytes(nprng.bytes(16), "little") & ((1 << bits) - 1)
            for _ in range(shape[0] * shape[1])]
    if not base.startswith("u"):
        vals = [v - (1 << bits) if v >= (1 << (bits - 1)) else v for v in vals]
    x = np.array(vals, dtype=object).reshape(shape)
    return Case(seed, src, parse(src), base, shape, {"a": x})


# ---- scripts/fuzz_mesh.py ------------------------------------------------------------


def gen_mesh(rng: random.Random) -> tuple[str, str, int]:
    """Random rank-2 program over float, uint16 or int64 with `iterate` 1,
    2 or 4 (two stages only at one sweep); returns (source, base type,
    iterate)."""
    base = rng.choice(["float", "float", "uint16", "int64"])
    it = rng.choice([1, 1, 2, 4])
    lines = [f"kernel: fm", f"input {base}: a(64, *)"]
    if it > 1:
        lines.insert(1, f"iterate: {it}")

    def off():
        return f"{rng.randint(-2, 2)}, {rng.randint(-2, 2)}"

    def term(src):
        r = f"{src}({off()})"
        k = rng.random()
        if base == "float":
            if k < 0.3:
                return f"{r} * {round(rng.uniform(-1, 1), 3)}f"
            if k < 0.45:
                return f"min({r}, {src}({off()}))"
            return r
        if k < 0.25:
            return f"{r} * {base}({rng.randint(1, 7)})"
        if k < 0.4:
            return f"max({r}, {src}({off()}))"
        if k < 0.55:
            return f"({r} >> {rng.randint(0, 8)})"
        return r

    n_stages = 1 if it > 1 else rng.randint(1, 2)
    prev = ["a"]
    for s in range(n_stages):
        src = rng.choice(prev)
        expr = " + ".join(term(src) for _ in range(rng.randint(2, 4)))
        name = f"s{s}" if s + 1 < n_stages else "out"
        kind = "local" if s + 1 < n_stages else "output"
        lines.append(f"{kind} {base}: {name}(0, 0) = {expr}")
        prev.append(name)
    return "\n".join(lines) + "\n", base, it


MESH_SEED0 = 5_777_000
MESH_SHAPES = [(64, 96), (100, 131), (61, 96), (96, 250), (40, 128)]
MESH_CONFIGS = [dict(axis_sizes=[8], dims=[0]), dict(axis_sizes=[4], dims=[0]),
                dict(axis_sizes=[2, 4], dims=[0, 1]), dict(axis_sizes=[4, 2], dims=[0, 1])]


@dataclasses.dataclass
class MeshCase(Case):
    """A `Case` with `scripts/fuzz_mesh.py::main`'s mesh draws: the mesh
    (`axis_sizes`, `dims`), the cadence (`sweeps_per_exchange`, None for
    the automatic one), `overlap`, and whether the seed is one where the
    original runs its kernels (`seed % 7 == 3`)."""
    iterate: int = 1
    axis_sizes: list = dataclasses.field(default_factory=list)
    dims: list = dataclasses.field(default_factory=list)
    sweeps_per_exchange: int | None = None
    overlap: bool = False
    kernel_seed: bool = False


def mesh_case(seed: int, shape: tuple[int, ...] | None = None) -> MeshCase:
    """Seed `seed` of `scripts/fuzz_mesh.py::main`: its program, uneven
    grid, input, mesh, cadence and overlap (the input drawn at `shape`
    instead of its grid where given)."""
    rng = random.Random(MESH_SEED0 + seed)
    src, base, it = gen_mesh(rng)
    nprng = np.random.default_rng(seed)
    drawn = tuple(rng.choice(MESH_SHAPES))
    shape = shape or drawn
    if base == "float":
        x = nprng.standard_normal(shape).astype(np.float32)
    elif base == "uint16":
        x = nprng.integers(0, 60000, shape).astype(np.uint16)
    else:
        x = nprng.integers(-2**45, 2**45, shape).astype(np.int64)
    cfg = rng.choice(MESH_CONFIGS)
    spe = rng.choice([1, 1, None, it if it > 1 else None])
    overlap = rng.random() < 0.3
    return MeshCase(seed, src, parse(src), base, shape, {"a": x}, it,
                    list(cfg["axis_sizes"]), list(cfg["dims"]), spe, overlap,
                    seed % 7 == 3)


def mesh_gate(c: MeshCase, gold: np.ndarray, got: np.ndarray) -> bool | None:
    """`scripts/fuzz_mesh.py`'s gate: a single-stage program exchanging
    every sweep (or running one sweep) on the whole grid, else outside
    `valid_rim()`; integers bit for bit, floats at 1e-4 (relative and
    absolute).  None when the rim leaves no interior (skipped)."""
    p = c.program
    exact_everywhere = (len(p.stage_order()) == 1
                        and (c.sweeps_per_exchange == 1 or c.iterate == 1))
    r = 0 if exact_everywhere else p.valid_rim()
    g, o = interior(gold, r), interior(got, r)
    if g.size == 0:
        return None
    if c.base == "float":
        return bool(np.allclose(g.astype(np.float64), o.astype(np.float64),
                                rtol=1e-4, atol=1e-4))
    return bool(np.array_equal(g, o))
