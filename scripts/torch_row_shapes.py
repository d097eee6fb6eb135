"""Time the marches (kernel 2's row-march, kernel 1's z-march) and their cascades at pinned plans on the card.

    python3 scripts/torch_row_shapes.py [program,program,...]

For each row (a program, `+tcse` where it is rewritten by
`optimize/tcse.py` first, a grid and a fused depth) it times the planner's
own plan and the pinned variants below: the tile ((RB, TX) for rank 2,
(TY, TX) for rank 3), the order of a step's stages (`sync`: "skew", one
wait a step, or "barrier", a barrier after each stage, in the rings) or
the march (rank 2's cascades "columns", the column march, or "rings";
rank 3's multi-level groups "columns3d", the column z-march, or "rings3d";
pinned with `utils/testing.py::pinned_plan`), the shared-memory budget and,
where a variant names one, the chunk (BY or BZ; else the planner's for
the pinned tile).  Programs outside the corpus (u64_3d) are `utils/testing.py`'s.
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
MARCHES = ("columns", "rings", "columns3d", "rings3d")

# (program, grid, fused depth): [(tile, sync or march, smem budget[, chunk]),
# ...]; a tile None is the planner's for that march
VARIANTS = {
    ("jacobi2d", (2048, 2048), 4): [
        (None, "columns", None), (None, "rings", None),
        ((8, 128), "skew", None), ((8, 128), "barrier", None),
        ((16, 128), "barrier", None), ((8, 256), "barrier", None)],
    ("jacobi2d", (2048, 2048), 8): [
        (None, "columns", None), (None, "rings", None),
        ((4, 128), "skew", None), ((8, 128), "barrier", None),
        ((4, 256), "barrier", None)],
    ("jacobi2d", (16384, 16384), 4): [
        (None, "columns", None), (None, "rings", None),
        ((8, 128), "skew", None), ((8, 128), "barrier", None),
        ((16, 128), "barrier", None), ((8, 256), "barrier", None)],
    ("jacobi2d", (16384, 16384), 8): [
        (None, "columns", None), (None, "rings", None),
        ((4, 128), "skew", None), ((8, 128), "barrier", None),
        ((4, 256), "barrier", None), ((4, 256), "skew", BIG),
        ((4, 240), "columns", None), ((2, 240), "columns", None),
        ((4, 112), "columns", None), ((2, 112), "columns", None),
        ((4, 176), "columns", None), ((4, 256), "columns", None),
        ((4, 240), "columns", None, 256), ((4, 240), "columns", None, 1024)],
    ("residual2d", (8192, 8192), 4): [
        (None, "columns", None), (None, "rings", None),
        ((4, 128), "skew", None), ((8, 128), "barrier", None),
        ((4, 256), "barrier", None)],
    ("denoise2p", (8192, 8192), 4): [
        (None, "columns", None), (None, "rings", None),
        ((4, 128), "skew", None), ((8, 128), "barrier", None),
        ((4, 256), "barrier", None)],
    ("denoise2p", (8192, 8192), 2): [
        (None, "columns", None), (None, "rings", None),
        ((8, 128), "skew", None), ((16, 128), "barrier", None),
        ((8, 256), "barrier", None)],
    ("jacobi2d_i64", (2048, 2048), 4): [
        (None, "columns", None), (None, "rings", None),
        ((4, 128), "skew", None), ((8, 128), "barrier", None)],
    ("blur", (16384, 16384), 1): [
        ((16, 256), "skew", None), ((16, 256), "barrier", None),
        ((8, 256), "skew", None)],
    ("blur", (2048, 4096), 1): [
        ((16, 256), "skew", None), ((16, 256), "barrier", None),
        ((8, 256), "skew", None)],
    ("gauss5x5", (16384, 16384), 1): [
        ((16, 256), "barrier", None), ((8, 256), "skew", None)],
    # rewritten by `optimize/tcse.py`: seven hoisted stages in a chain
    ("gauss5x5+tcse", (16384, 16384), 1): [
        ((4, 256), "barrier", None), ((8, 128), "barrier", None),
        ((4, 128), "skew", None), ((8, 256), "barrier", BIG),
        ((16, 256), "barrier", BIG)],
    # kernel 1 (rank 3): tiles (TY, TX); four CTAs an SM at most (the
    # registers), fewer where the rings take more than a quarter of an
    # SM's shared memory
    ("jacobi3d", (512, 512, 512), 1): [
        ((32, 64), "skew", None), ((16, 64), "skew", None),
        ((32, 32), "skew", None), ((16, 32), "skew", None),
        ((32, 128), "skew", None), ((16, 128), "skew", None), ((8, 128), "skew", None),
        ((16, 192), "skew", None), ((64, 64), "skew", None),
        ((32, 128), "skew", None, 32), ((32, 128), "skew", None, 128)],
    # the mesh cell's shard (2048^3 on [2, 2] with its halo)
    ("jacobi3d", (1026, 1026, 2048), 1): [
        ((32, 64), "skew", None), ((32, 128), "skew", None), ((16, 128), "skew", None),
        ((8, 128), "skew", None), ((16, 192), "skew", None)],
    ("denoise3d", (256, 256, 256), 1): [
        ((16, 64), "barrier", None), ((16, 32), "skew", None),
        ((32, 64), "skew", BIG), ((8, 64), "skew", None)],
    # kernel 1's multi-level groups: the column z-march and the rings (each
    # at its planner's tile), and the column z-march at pinned tiles
    ("denoise3d", (512, 512, 512), 1): [
        (None, "columns3d", None), (None, "rings3d", None),
        ((16, 64), "columns3d", None), ((32, 32), "columns3d", None),
        ((8, 32), "columns3d", None)],
    ("orient3d", (512, 512, 512), 1): [
        (None, "columns3d", None), (None, "rings3d", None)],
    ("heat3d", (256, 256, 256), 2): [
        (None, "columns3d", None), (None, "rings3d", None),
        ((32, 64), "barrier", None), ((16, 64), "skew", None),
        ((32, 32), "skew", None)],
    ("heat3d", (512, 512, 512), 2): [
        (None, "columns3d", None), (None, "rings3d", None),
        ((16, 32), "columns3d", None), ((32, 32), "columns3d", None),
        ((32, 64), "barrier", None), ((16, 64), "skew", None),
        ((32, 32), "skew", None)],
    # jacobi3d x 2: two sweeps (iterate 2) fused a call
    ("jacobi3d", (512, 512, 512), 2): [
        (None, "columns3d", None), (None, "rings3d", None),
        ((16, 32), "columns3d", None)],
    ("heat3d", (512, 512, 512), 4): [
        (None, "columns3d", None), (None, "rings3d", None), ((16, 32), "columns3d", None),
        ((32, 32), "barrier", None), ((16, 64), "skew", None),
        ((16, 32), "skew", None), ((32, 64), "skew", BIG)],
    # 64-bit rings: three CTAs an SM at (32, 64), four at (16, 64)
    ("poisson3d_f64", (256, 256, 256), 1): [
        ((16, 64), "skew", None, 32), ((32, 32), "skew", None, 32),
        ((32, 64), "skew", None, 32)],
    ("u64_3d", (512, 512, 512), 1): [
        ((16, 64), "skew", None, 64), ((32, 32), "skew", None, 64),
        ((32, 64), "skew", None, 32)],
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
    from soda_tpu_torch.optimize import tcse
    from soda_tpu_torch.plan import planner
    from soda_tpu_torch.utils import report
    from soda_tpu_torch.frontend.parser import parse
    from soda_tpu_torch.utils.testing import U64_SOURCES, pinned_plan

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
        name, _, rewrite = n.partition("+")
        p = (parse(U64_SOURCES[name]) if name in U64_SOURCES
             else parse_file(HERE / "tests" / "soda" / f"{name}.soda"))
        if rewrite:
            p = tcse.apply(p)
        # a program of fewer sweeps than the depth runs the depth's sweeps
        it = {"iterate": nf} if nf > max(p.iterate, 1) else {}
        plans = [("planner", planner.plan(p, shape, sweeps=nf, **it))]
        for tile, sync, budget, *chunk in variants:
            pin = {"sweeps": nf, "tile": tile, **it,
                   "smem_budget": budget or planner.SMEM_BUDGET,
                   **({"march": sync} if sync in MARCHES else {"sync": sync})}
            if chunk:
                pin["bz"] = chunk[0]
            pl = pinned_plan(p, shape, pin)
            g = pl.groups[0]
            label = (f"tile {tile}{f' chunk {chunk[0]}' if chunk else ''} {sync} "
                     f"budget {budget or 'default'}")
            if (len(pl.groups) == 1 and g.sweeps == nf
                    and g.kernel in ("linebuffer2d", "linebuffer3d")):
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
