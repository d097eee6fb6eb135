"""Time the windows kernel's direct reads at several blocks on the card.

    python3 scripts/torch_windows_blocks.py

The radius-8 f64 star (`soda_tpu_torch/utils/testing.py::STAR3D_R8`) on a
512^3 grid: at the default shared-memory budget no window of its input
fits, so the windows kernel reads it tap by tap (49 loads a cell).  For
each (block, CTAs an SM that `__launch_bounds__` asks the registers to
allow) in `VARIANTS`, the kernel is generated and built (nvcc, all at
once), its output is held bit for bit against the line-buffer kernel
planned at 227 KiB, and its time per call is printed: the mean of two
turns of 5 calls by CUDA events (`chip_smoke.events_ms`), beside the
registers and spills ptxas reported and the card's name and power limit.
The line-buffer kernel is timed last the same way.  It sets the rank-3
blocks of `planner.WINDOW_BLOCKS` and `windows.ctas_per_sm` (PERF.md).
"""

from __future__ import annotations

import concurrent.futures
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (512, 512, 512)
VARIANTS = (((8, 8, 64), 4), ((8, 8, 64), 2), ((32, 8, 32), 4), ((32, 8, 32), 2),
            ((32, 8, 32), 1), ((16, 8, 32), 2), ((64, 8, 32), 2), ((16, 16, 32), 2),
            ((32, 4, 64), 2))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from soda_tpu_torch.backend import cuda, windows
    from soda_tpu_torch.frontend.parser import parse
    from soda_tpu_torch.utils import report
    from soda_tpu_torch.utils.testing import STAR3D_R8

    if not torch.cuda.is_available():
        print("torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = report.card()
    p = parse(STAR3D_R8)
    kernels = {}
    for block, ctas in VARIANTS:
        g = cuda.build_fn(p, grid_shape=SHAPE, block=block).plan.groups[0]
        k = windows.GroupKernel(p, g)
        bound = windows.ctas_per_sm
        windows.ctas_per_sm = lambda _g, c=ctas: c
        try:
            k.source  # generated now, under this bound
        finally:
            windows.ctas_per_sm = bound
        kernels[(block, ctas)] = k
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        logs = dict(zip(kernels, pool.map(lambda k: k.build().log, kernels.values())))
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn(SHAPE, generator=gen, device=dev, dtype=torch.float64)
    lb = cuda.build_fn(p, grid_shape=SHAPE, smem_budget=227 * 1024)
    want = lb({"u": u}, {})["v"]
    failed = False
    for key, k in kernels.items():
        out = torch.empty_like(u)

        def run(k=k, out=out):
            k({"u": u}, {}, out={"v": out})

        run()
        torch.cuda.synchronize()
        ok = torch.equal(out, want)
        failed |= not ok
        ms = (chip_smoke.events_ms(run, 5) + chip_smoke.events_ms(run, 5)) / 2
        ptxas = "; ".join(ln.strip() for ln in logs[key].splitlines()
                          if re.search(r"registers|spill", ln))
        print(f"star3d_r8 {SHAPE} windows block {key[0]}, {key[1]} CTA(s)/SM: "
              f"{ms:.4f} ms, {'bit for bit' if ok else 'MISMATCH'} vs line buffer; "
              f"{ptxas}; card {card}", flush=True)

    def run_lb():
        lb({"u": u}, {})

    ms = (chip_smoke.events_ms(run_lb, 5) + chip_smoke.events_ms(run_lb, 5)) / 2
    print(f"star3d_r8 {SHAPE} line buffer at 227 KiB: {ms:.4f} ms; "
          f"{lb.plan.groups[0].describe()}; card {card}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
