"""Time the port's at-size rows of one copy of `soda_tpu_torch` on the card.

    python3 scripts/torch_ab_rows.py <root> <label> [program,program,...]

`<root>` holds the `soda_tpu_torch` package to time (the checkout itself,
or a parent commit unpacked with `git archive` into a directory that
`.gitignore` lists).  Two copies are compared in one call to the chip, in
turns (parent, change, change, parent), each turn its own process:

    for r in build/parent . . build/parent; do python3 scripts/torch_ab_rows.py $r X; done

The rows are this checkout's `chip_smoke.py` rows: kernels 1, 2 and 4 one
sweep per call (`AT_SIZE`, `BIG`, `AT_SIZE_2D`, `MAIN_WINDOWS`), the fused rows at the
planner's depth (`AT_SIZE_SWEEPS`) and the depth sweep (`DEPTH_SWEEP`, at
every depth the timed copy's planner fits), and kernel 1's `EXTRA` rows
(u64_3d 512^3 over the whole uint64 range, the radius-8 f64 star
512^3 pinned to the line buffer by a 227 KiB budget, jacobi3d on the
benchmark's 1026 x 1026 x 2048 mesh shard and on 511^3); the optional third
argument keeps the rows of the programs it names.  The corpus is always
this checkout's `tests/soda`; u64_3d and star3d_r8 are the timed copy's
`utils/testing.py` programs.  Per row it prints the CUDA-event time per sweep
over back-to-back calls (two turns averaged, `chip_smoke.events_ms`), the
device time of the kernels alone (`chip_smoke.device_ms`), the host's time
to enqueue one call (`fn` without a wait, the mean of the turn's calls:
where it exceeds the kernels' time, the back-to-back time is the
host's), and, for grids
of at most 2^24 cells, whether the result equals the plain PyTorch version
at 1e-4; then the registers and spills `ptxas` reported for every kernel.
Inputs are made on the card from a fixed seed (`chip_smoke.device_inputs`).
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import json
import math
import pathlib
import re
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
CORPUS = HERE / "tests" / "soda"
# (program, grid, sweeps, plan keywords) beyond chip_smoke's tables: kernel
# 1 on the benchmark's mesh shard (2048^3 on [2, 2] with its halo) and on
# 511^3 (the scalar load path)
EXTRA = (("u64_3d", (512, 512, 512), 1, {}),
         ("star3d_r8", (512, 512, 512), 1, {"smem_budget": 227 * 1024}),
         ("jacobi3d", (1026, 1026, 2048), 1, {}),
         ("jacobi3d", (511, 511, 511), 1, {}))


def _smoke():
    """This checkout's `chip_smoke.py`, whichever package copy is timed."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rows(smoke, fused_depths, program, only) -> list:
    """(program, grid, sweeps, plan keywords) per row; sweeps None is the
    planner's depth."""
    out = [(n, s, 1, {}) for n, s in smoke.AT_SIZE + (smoke.BIG,) + smoke.AT_SIZE_2D
           + (smoke.MAIN_WINDOWS,)]
    out += [(n, s, None, {}) for n, s in smoke.AT_SIZE_SWEEPS]
    for n, s in smoke.DEPTH_SWEEP:
        out += [(n, s, d, {}) for d in [1] + fused_depths(program(n), s)]
    out += list(EXTRA)
    return [r for r in out if only is None or r[0] in only]


def programs():
    """name -> the timed copy's program: the corpus, then u64_3d and the
    radius-8 star from its `utils/testing.py`."""
    from soda_tpu_torch.frontend.parser import parse, parse_file
    from soda_tpu_torch.utils.testing import STAR3D_R8, U64_SOURCES

    extra = {"star3d_r8": STAR3D_R8, **U64_SOURCES}

    def program(n: str):
        path = CORPUS / f"{n}.soda"
        return parse_file(path) if path.exists() else parse(extra[n])

    return program


def main(root: str, label: str, only: str = "") -> int:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import soda_tpu_torch
    from soda_tpu_torch.backend import cuda, eager
    from soda_tpu_torch.plan.planner import fused_depths

    if not torch.cuda.is_available():
        print("torch_ab_rows: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    print(label, "package", soda_tpu_torch.__file__, flush=True)
    program = programs()
    fns = {}
    for n, s, d, kw in rows(smoke, fused_depths, program,
                            set(only.split(",")) if only else None):
        p = program(n)
        fns[(n, s, d)] = (p, cuda.build_fn(p, grid_shape=s, sweeps=d, **kw))
    kernels = {}
    for p, fn in fns.values():
        for g in fn.plan.groups:
            k = cuda.group_kernel(p, g)
            kernels[k.source] = k
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        built = list(pool.map(lambda k: (k, k.build()), kernels.values()))
    print(f"{label} built {len(built)} kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for k, b in built:
        ptx = [ln.strip() for ln in b.log.splitlines() if re.search(r"registers|spill", ln)]
        print(f"{label} {b.path.name}: {'; '.join(ptx[:2])}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for (n, s, d), (p, fn) in fns.items():
        ins = smoke.device_inputs(p, s, gen, dev)
        pars = {pp.name: torch.from_numpy(np.random.default_rng(1).standard_normal(
            pp.shape).astype(pp.type.np_dtype())).to(dev) for pp in p.params.values()}
        got = fn(ins, pars)
        torch.cuda.synchronize()
        it = max(p.iterate, 1)
        ok = None
        if math.prod(s) <= 2**24:
            ref = eager.run(p, ins, pars)
            ok = all(torch.allclose(got[k].double(), ref[k].double(), rtol=1e-4, atol=1e-4)
                     for k in got)
        reps = 3 if math.prod(s) > 2**26 else 20
        ms = (smoke.events_ms(lambda: fn(ins, pars), reps)
              + smoke.events_ms(lambda: fn(ins, pars), reps)) / 2 / it
        alone = smoke.device_ms(lambda: fn(ins, pars), reps)
        alone = float("nan") if alone is None else alone / it
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(ins, pars)
        host = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        g = fn.plan.groups[0]
        out[f"{n} {s} nf{d or 'auto'}"] = (ms, alone, g.sweeps,
                                           g.modeled_seconds / g.sweeps * 1e3, host)
        print(f"{label} {n} {s} nf {d or 'auto'} (planned {g.sweeps}): {ms:.4f} ms/sweep "
              f"events, {alone:.4f} alone, {g.modeled_seconds / g.sweeps * 1e3:.4f} "
              f"modeled, host {host:.4f} ms per call ({it // g.sweeps} launch(es) a "
              f"group); plain {ok}; {g.kernel} tile {g.tile} chunk {g.bz} smem "
              f"{g.smem_bytes} B, load {g.load or '-'}, sync {g.sync or '-'}, planned "
              f"{g.hbm_bytes_per_call / g.useful_cells_per_call:.3f} B/cell-update",
              flush=True)
        del ins, pars, got
        torch.cuda.empty_cache()
    print("JSON", label, json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
