"""What the port's checks share: the oracle, the input distributions, the
comparison gates and the programs the checks run.

`rand_inputs` and `compare_outputs` are the port's copies of
`soda_tpu/utils/testing.py`'s (the tests hold them equal to the
originals, so a tolerance cannot drift between the packages); the oracle
is the port's NumPy reference (`interp/numpy_ref.py`).  Gates
(docs/SEMANTICS.md): integer outputs bit-exact; `half` programs at 2e-2;
f32 programs with libm transcendentals at 2e-3; other floats at 1e-4.
`pinned_plan` pins the row-march's order of a step's stages, which only
the checks choose; `build_emulated` compiles many kernels' host emulation
at once, and `emulate` runs a plan through it.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from ..interp.numpy_ref import run as oracle  # noqa: F401

CORPUS = pathlib.Path(__file__).resolve().parents[2] / "tests" / "soda"

# the rank-3 corpus: every program kernel 1 runs
RANK3_CORPUS = ("jacobi3d", "denoise3d", "gradmag3d", "orient3d", "heat3d",
                "poisson3d_f64")

# the rank-2 corpus of at most 64 bits (all but accum128): every program
# kernel 2 runs, the `iterate` ones as chained one-sweep calls
RANK2_CORPUS = ("accum64", "bigphase2d", "blur", "conv5x5", "denoise2d",
                "denoise2p", "dilate2d", "erode2d", "gauss5x5", "gaussian2d",
                "gradient2d", "jacobi2d", "jacobi2d_i64", "laplace2d",
                "mathfn2d", "mathfn_f64", "poisson_f64", "reaction_f64",
                "residual2d", "seidel2d", "smooth_half", "sobel2d")

# integer programs that pin C division, remainder, shifts and narrow-width
# masking through the kernel (a uint16 box blur, and an int16 chain whose
# intermediate stage divides negative values)
INT3D_SOURCES = {
    "box7_u16": """
kernel: box7_u16
input uint16: a(16, 16, *)
output uint16: b(0, 0, 0) = (a(0, 0, 0) + a(0, 0, 1) + a(0, 0, -1) + a(0, 1, 0) + a(0, -1, 0) + a(1, 0, 0) + a(-1, 0, 0)) / 7
""",
    "divneg_i16": """
kernel: divneg_i16
input int16: a(16, 16, *)
local int16: d(0, 0, 0) = (a(0, 0, 1) - a(0, 0, -1) - a(1, 0, 0) * 3) / 5
output int16: o(0, 0, 0) = (d(0, 1, 0) - d(-1, 0, 0)) % 7 + (d(0, 0, 0) >> 2) - int16(d(0, 0, -1) * 9)
""",
}

# the rank-1 corpus: every program that only the windows kernel runs
RANK1_CORPUS = ("smooth1d",)

# full-width uint64 through each kernel: rank 3 (kernel 1), rank 2 (kernel
# 2; U64_PARAM is soda_tpu's tests/test_backends.py::
# test_pallas_wide_params_run_in_kernel, a uint64 param), fused iterate
# sweeps (kernel 3) and rank 1 (kernel 4), with compares, shifts, division
# and remainder on values above 2^63
U64_SOURCES = {
    "u64_3d": """
kernel: u64_3d
input uint64: a(32, 32, *)
output uint64: o(0, 0, 0) = (a(0, 0, -1) + a(0, 0, 1) + a(0, -1, 0) + a(0, 1, 0) + a(-1, 0, 0) + a(1, 0, 0)) / uint64(6) ^ (a(0, 0, 0) >> 61)
""",
    "u64_2d": """
kernel: u64_2d
input uint64: a(128, *)
output uint64: o(0, 0) = (a(0, 0) > a(0, 1)) ? (a(0, 0) / uint64(3) + (a(-1, 0) & a(1, 0))) : (a(0, 1) >> 2) % uint64(1000000007)
""",
    "u64_param": """
kernel: wp
param uint64: k
input uint16: a(64, *)
output uint64: out(0, 0) = uint64(a(0, 0)) * k + uint64(a(0, 1))
""",
    "u64_iter": """
kernel: u64_iter
iterate: 4
input uint64: a(128, *)
output uint64: o(0, 0) = ((a(0, -1) >> 2) + (a(0, 1) >> 2) + (a(-1, 0) >> 2) + (a(1, 0) >> 2)) ^ a(0, 0)
""",
    "u64_1d": """
kernel: u64_1d
input uint64: a(4096)
output uint64: o(0) = (a(0) > a(1)) ? a(-1) / uint64(3) : a(1) % uint64(1000000007)
""",
}


def _star3d(radius: int) -> str:
    taps = ["u(0, 0, 0)"] + [
        f"u({o[0]}, {o[1]}, {o[2]})" for r in range(1, radius + 1) for s in (r, -r)
        for o in ((s, 0, 0), (0, s, 0), (0, 0, s))]
    return (f"kernel: star3d_r{radius}\ninput double: u(64, 64, *)\n"
            f"output double: v(0, 0, 0) = ({' + '.join(taps)}) * 0.02\n")


# a 49-point radius-8 star in f64 (a space-order-16 finite-difference
# stencil): its line-buffer ring (17 planes of an f64 tile and its halo)
# fits no tile of the default shared-memory budget, so the planner falls
# back to the windows kernel
STAR3D_R8 = _star3d(8)


def pinned_plan(p, shape, pin: dict):
    """`plan(p, shape, **pin)`, where a pin's "sync" ("skew" or "barrier")
    re-plans the plan's one group with a step's stages in that order at
    the same tile and chunk: `plan()` leaves the order to the planner, and
    the checks reach the other one through the planner's `_plan_group`."""
    from ..plan import planner

    kw = {k: v for k, v in pin.items() if k != "sync"}
    pl = planner.plan(p, shape, **kw)
    if "sync" not in pin:
        return pl
    (g,) = pl.groups
    prog = planner.cascade(p, g.sweeps)
    return dataclasses.replace(pl, groups=[planner._plan_group(
        prog, prog.stage_order(), tuple(shape),
        kw.get("smem_budget", planner.SMEM_BUDGET), g.tile, g.bz,
        sweeps=g.sweeps, sync=pin["sync"])])


def build_emulated(kernels, *, hazard: bool = False, workers: int = 4) -> None:
    """Compile the host emulation of each distinct source among `kernels`
    (`GroupKernel`s) in `workers` threads, each running its own compiler;
    a later `k.build(emulate=True, hazard=hazard)` loads the library."""
    import concurrent.futures

    distinct = {k.source: k for k in kernels}
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        list(pool.map(lambda k: k.build(emulate=True, hazard=hazard),
                      distinct.values()))


def kernel_names(the_plan) -> list[str]:
    """The kernel each group of a plan runs: "linebuffer3d",
    "linebuffer2d", "windows", or "sweeps" (a fused cascade)."""
    return ["sweeps" if g.sweeps > 1 else g.kernel for g in the_plan.groups]


def emulate(p, the_plan, ins, ps=None, *, iterate=None, hazard: bool = False) -> dict:
    """Run `p` over numpy inputs through the host emulation of each planned
    group's kernel (`GroupKernel.build(emulate=True, hazard=hazard)`),
    chained as `cuda.build_fn` chains the kernels on the card: `iterate /
    nf` calls, the first output feeding the first input.  Returns numpy
    outputs.  This is the kernels' march on the CPU, the role that
    interpret mode plays for `soda_tpu`'s Pallas kernels."""
    import torch

    from ..backend import cuda
    from ..backend.io import to_numpy, to_torch
    from ..ir.dtypes import torch_dtype

    tins, tps = to_torch(p, ins, ps or {}, "cpu")
    it = max(p.iterate if iterate is None else iterate, 1)
    nf = the_plan.groups[0].sweeps
    if it % nf:
        raise ValueError(f"plan fuses {nf} sweeps, which does not divide iterate {it}")
    kernels = [cuda.group_kernel(p, g) for g in the_plan.groups]
    entries = [k.build(emulate=True, hazard=hazard).lib.soda_launch for k in kernels]
    in0, out0 = p.input_names[0], p.output_names[0]
    values = dict(tins)
    for c in range(it // nf):
        produced = {}
        for k, entry in zip(kernels, entries):
            outs = {o: torch.empty(the_plan.grid_shape, dtype=torch_dtype(p.tensors[o].type))
                    for o in k.group.outputs}
            k.launch(entry, values, tps, outs, 0)
            values.update(outs)
            produced.update(outs)
        if c + 1 < it // nf:
            values = {n: tins[n] for n in p.input_names}
            values[in0] = produced[out0]
    return to_numpy(p, {o: values[o] for o in p.output_names})


def rand_inputs(p, shape, rng):
    """Random inputs + params for `p`: signed ints draw negatives
    (sign-dependent C semantics), >32-bit draws exercise the pair/limb
    carriers past int32, >64-bit builds object arrays of Python ints."""
    ins = {}
    for n in p.input_names:
        t = p.tensors[n].type
        if t.is_float:
            ins[n] = rng.standard_normal(shape).astype(t.np_dtype())
        elif t.kind == "int" and t.width > 64:
            hi = rng.integers(0, 1 << (min(t.width, 127) - 65),
                              shape).astype(object)
            lo = rng.integers(0, 1 << 62, shape).astype(object)
            ins[n] = (hi << 64) | lo
        elif t.kind == "int" and t.width > 32:
            ins[n] = rng.integers(-(1 << 40), 1 << 40, shape).astype(
                t.np_dtype())
        elif t.kind == "int":
            hi = 1 << min(t.width - 1, 12)
            ins[n] = rng.integers(-hi, hi, shape).astype(t.np_dtype())
        elif t.width > 32:
            ins[n] = rng.integers(0, 1 << 40, shape).astype(t.np_dtype())
        else:
            ins[n] = rng.integers(0, min(250, (1 << t.width) - 1),
                                  shape).astype(t.np_dtype())
    ps = {pp.name: rng.standard_normal(pp.shape).astype(pp.type.np_dtype())
          for pp in p.params.values()}
    return ins, ps


def u64_inputs(p, shape, rng):
    """`rand_inputs`, with every uint64 input and param drawn again over
    the whole range [0, 2^64), so that values above 2^63 reach every
    compare, shift and division (the same draws as `rand_inputs` for a
    program without uint64)."""
    def u64(t):
        return t.is_int and t.kind == "uint" and t.width == 64

    ins, ps = rand_inputs(p, shape, rng)
    full = dict(dtype=np.uint64, endpoint=True)
    for n in p.input_names:
        if u64(p.tensors[n].type):
            ins[n] = rng.integers(0, 2**64 - 1, shape, **full)
    for pp in p.params.values():
        if u64(pp.type):
            ps[pp.name] = rng.integers(0, 2**64 - 1, pp.shape, **full)
    return ins, ps


def tolerance(p) -> float:
    """The float gate of `compare_outputs` for program `p`: 2e-2 for half
    programs, 2e-3 for f32 programs with libm transcendentals, else 1e-4
    (relative and absolute)."""
    half = any(t.type.is_float and t.type.width == 16
               for t in p.tensors.values())
    f32_libm = (p.uses_libm_transcendentals()
                and p.max_float_width() == 32)
    return 2e-2 if half else (2e-3 if f32_libm else 1e-4)


def compare_outputs(p, got, gold, rim) -> bool:
    """Rim-excluded comparison: ints BIT-exact, floats at the
    program-derived tolerance.  Returns False (never raises) so the
    hardware gate can count failures; refuses a vacuous pass on an
    all-rim grid."""
    def interior(a):
        if rim == 0:
            return a
        return a[tuple(slice(rim, -rim) for _ in range(a.ndim))]

    tol = tolerance(p)
    for k in gold:
        a, b = interior(np.asarray(got[k])), interior(np.asarray(gold[k]))
        if a.size == 0:
            return False
        if not p.tensors[k].type.is_float:
            if not np.array_equal(a, b):
                return False
        elif not np.allclose(a.astype(np.float64), b.astype(np.float64),
                             rtol=tol, atol=tol):
            return False
    return True
