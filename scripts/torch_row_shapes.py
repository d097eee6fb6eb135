"""Time kernel 2's row-march and its rank-2 cascades at pinned plans on the card.

    python3 scripts/torch_row_shapes.py [program,program,...]

For each row (a program, a grid and a fused depth) it times the planner's
own plan and the pinned variants below: the tile (RB, TX), the order of a
step's stages (`sync`: "skew", one wait a step, or "barrier", a barrier
after each stage; pinned with `utils/testing.py::pinned_plan`) and the
shared-memory budget (the chunk BY is the planner's for the pinned tile).
Each variant's output
must equal the planner's plan bit for bit.  Per variant it prints the
device time of one call's kernel alone (`chip_smoke.device_ms`, CUDA events
behind a sleep kernel) per sweep, the plan (threads, CTAs an SM, waves,
shared memory), and the registers and spills `ptxas` reported.  Inputs are
made on the card from a fixed seed (`chip_smoke.device_inputs`).  About a
minute on one H100.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
BIG = 232_448   # the whole 227 KB a CTA may hold: one or two CTAs an SM

# (program, grid, fused depth): [(tile, sync, smem budget), ...]
VARIANTS = {
    ("jacobi2d", (2048, 2048), 4): [
        ((8, 128), "skew", None), ((8, 128), "barrier", None),
        ((16, 128), "barrier", None), ((8, 256), "barrier", None)],
    ("jacobi2d", (2048, 2048), 8): [
        ((4, 128), "skew", None), ((8, 128), "barrier", None),
        ((4, 256), "barrier", None)],
    ("jacobi2d", (16384, 16384), 4): [
        ((8, 128), "skew", None), ((8, 128), "barrier", None),
        ((16, 128), "barrier", None), ((8, 256), "barrier", None)],
    ("jacobi2d", (16384, 16384), 8): [
        ((4, 128), "skew", None), ((8, 128), "barrier", None),
        ((4, 256), "barrier", None), ((4, 256), "skew", BIG)],
    ("residual2d", (8192, 8192), 4): [
        ((4, 128), "skew", None), ((8, 128), "barrier", None),
        ((4, 256), "barrier", None)],
    ("denoise2p", (8192, 8192), 4): [
        ((4, 128), "skew", None), ((8, 128), "barrier", None),
        ((4, 256), "barrier", None)],
    ("denoise2p", (8192, 8192), 2): [
        ((8, 128), "skew", None), ((16, 128), "barrier", None),
        ((8, 256), "barrier", None)],
    ("jacobi2d_i64", (2048, 2048), 4): [
        ((4, 128), "skew", None), ((8, 128), "barrier", None)],
    ("blur", (16384, 16384), 1): [
        ((16, 256), "skew", None), ((16, 256), "barrier", None),
        ((8, 256), "skew", None)],
    ("blur", (2048, 4096), 1): [
        ((16, 256), "skew", None), ((16, 256), "barrier", None),
        ((8, 256), "skew", None)],
}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(only: str = "") -> int:
    sys.path.insert(0, str(HERE))
    import torch

    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.frontend.parser import parse_file
    from soda_tpu_torch.plan import planner
    from soda_tpu_torch.utils import report
    from soda_tpu_torch.utils.testing import pinned_plan

    if not torch.cuda.is_available():
        print("torch_row_shapes: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    keep = set(only.split(",")) if only else None
    rows = {}
    for (n, shape, nf), variants in VARIANTS.items():
        if keep and n not in keep:
            continue
        p = parse_file(HERE / "tests" / "soda" / f"{n}.soda")
        plans = [("planner", planner.plan(p, shape, sweeps=nf))]
        for tile, sync, budget in variants:
            pl = pinned_plan(p, shape, {
                "sweeps": nf, "tile": tile, "sync": sync,
                "smem_budget": budget or planner.SMEM_BUDGET})
            g = pl.groups[0]
            label = f"tile {tile} {sync} budget {budget or 'default'}"
            if len(pl.groups) == 1 and g.sweeps == nf and g.kernel == "linebuffer2d":
                plans.append((label, pl))
            else:
                print(f"{n} {shape} nf {nf} {label}: no such plan", flush=True)
        rows[(n, shape, nf)] = (p, plans)
    kernels = {}
    for p, plans in rows.values():
        for _, pl in plans:
            for g in pl.groups:
                k = cuda.group_kernel(p, g)
                kernels[k.source] = k
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        built = dict(pool.map(lambda k: (k.source, k.build()), kernels.values()))
    print("card:", report.card(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for (n, shape, nf), (p, plans) in rows.items():
        ins = smoke.device_inputs(p, shape, gen, dev)
        ref = None
        for label, pl in plans:
            fn = cuda.build_fn(p, the_plan=pl, iterate=nf)
            got = fn(ins, {})
            same = True if ref is None else smoke.bitwise_equal(got, ref)
            ref = got if ref is None else ref
            del got
            fn(ins, {})
            torch.cuda.synchronize()
            alone = smoke.device_ms(lambda: fn(ins, {}), 5)
            g = pl.groups[0]
            log = built[cuda.group_kernel(p, g).source].log
            ptx = "; ".join(ln.strip() for ln in log.splitlines()
                            if re.search(r"registers|spill", ln))[:160]
            per = "not measured" if alone is None else f"{alone / nf:.4f}"
            print(f"shapes {n} {shape} nf {nf} {label}: {per} ms/sweep alone; "
                  f"{'bit for bit' if same else 'MISMATCH'}; {g.describe()}; {ptx}",
                  flush=True)
            if not same:
                return 1
        del ins, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
