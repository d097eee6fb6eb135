#!/usr/bin/env python
"""Random int64 / uint64 / double / half programs through the port's
kernels, held against its NumPy oracle: the port's counterpart of
`scripts/fuzz_wide.py`, seed for seed (`soda_tpu_torch/utils/fuzz.py`
keeps the generators, grids, input draws and gates).

    python scripts/torch_fuzz_wide.py [n_seeds] [--cpu [--hazard]] [--w128]

By default each program runs through `backend/cuda.py::run` on the card
(the planner's plan: kernels 1 to 4 and the fused sweeps) and is held
against the oracle (`interp/numpy_ref.py`) outside `valid_rim()` with the
original's gates (`fuzz.wide_gate`: integers bit for bit, double at 1e-10
relative, half as a share of cells beyond 3e-2); integer programs are
also held bit for bit on the whole grid against the plain path
(`eager.run`) on the card.  `--cpu` runs each planned group's host
emulation instead (g++, `-DSODA_HOST_EMULATION`; `--hazard` adds the
marches' hazard emulation) and the plain path on the CPU.  `--w128`
runs 65-128-bit programs (`fuzz.gen128`) through the oracle, the C++
golden runner (`__int128`) and, every 4th seed, the plain path's limbs
(`eager.run`, on the card unless `--cpu`): bit for bit.

Every kernel is built first, in parallel (nvcc for sm_90a on the card,
g++ with `--cpu`), and each seed's build seconds are printed.  A build or
launch failure counts as a failure; any failure exits 1.  A seed whose
rim covers its whole grid is skipped, as the original skips it, and
counted.
"""

import concurrent.futures
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def _seeds(argv: list[str]) -> int:
    return int(argv[1]) if len(argv) > 1 and argv[1].isdigit() else 40


def fuzz_128(n: int, device) -> int:
    """Oracle against the golden runner and, every 4th seed, the plain
    path's limbs: three implementations, bit for bit."""
    from soda_tpu_torch.backend import cpp, eager
    from soda_tpu_torch.backend.io import to_numpy
    from soda_tpu_torch.interp.numpy_ref import run as oracle
    from soda_tpu_torch.utils.fuzz import w128_case

    failures = 0
    for seed in range(n):
        c = w128_case(seed)
        p = c.program
        try:
            gold = oracle(p, c.inputs)["out"]
            ok = bool((cpp.compile_and_run(p, c.inputs)["out"] == gold).all())
            tag = "cpp"
            if seed % 4 == 0:
                got = to_numpy(p, eager.run(p, c.inputs, device=device))["out"]
                ok = ok and bool((got == gold).all())
                tag = f"cpp+eager on {device}"
        except Exception as e:  # noqa: BLE001 -- a failed run is a failure of the seed
            print(f"seed {seed}: RUN FAILED {type(e).__name__}: {e}\n{c.source}")
            failures += 1
            continue
        print(f"seed {seed} [{c.base} {c.shape}, {tag}]: {'OK' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            print(c.source)
            failures += 1
    print(f"{failures} failures / {n} seeds (128-bit)")
    return 1 if failures else 0


def main() -> int:
    argv = sys.argv
    n = _seeds(argv)
    cpu, hazard = "--cpu" in argv, "--hazard" in argv
    if hazard and not cpu:
        print("--hazard is the host emulation's: give --cpu too", file=sys.stderr)
        return 2
    from soda_tpu_torch.utils.device import resolve

    device = resolve("cpu" if cpu else "cuda")
    if "--w128" in argv:
        return fuzz_128(n, device)

    from soda_tpu_torch.backend import cuda, eager
    from soda_tpu_torch.backend.io import to_numpy
    from soda_tpu_torch.interp.numpy_ref import run as oracle
    from soda_tpu_torch.plan.planner import plan
    from soda_tpu_torch.utils.fuzz import interior, wide_case, wide_gate
    from soda_tpu_torch.utils.report import card
    from soda_tpu_torch.utils.testing import emulate, kernel_names

    where = ("host emulation" + (" (hazard)" if hazard else "")) if cpu else "card"
    print(f"fuzz_wide on the {where}: {card() if not cpu else 'no card'}", flush=True)
    cases = [wide_case(seed) for seed in range(n)]
    plans = {c.seed: plan(c.program, c.shape) for c in cases}
    kernels = {c.seed: [cuda.group_kernel(c.program, g) for g in plans[c.seed].groups]
               for c in cases}

    def build(seed):
        try:
            return seed, sum(k.build(emulate=cpu, hazard=hazard).seconds
                             for k in kernels[seed]), None
        except Exception as e:  # noqa: BLE001 -- reported as the seed's failure
            return seed, 0.0, e

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8 if cpu else 16) as pool:
        builds = {s: (sec, err) for s, sec, err in pool.map(build, plans)}
    print(f"build: {sum(len(k) for k in kernels.values())} kernels for {n} seeds "
          f"in {time.perf_counter() - t0:.1f} s wall", flush=True)

    failures = skipped = 0
    for c in cases:
        p, ins = c.program, c.inputs
        pl = plans[c.seed]
        head = (f"seed {c.seed} [{c.base}, rank {p.rank}, iterate {max(p.iterate, 1)}, "
                f"{c.shape}, {'+'.join(kernel_names(pl))}, "
                f"build {builds[c.seed][0]:.1f} s]")
        gold = oracle(p, ins)["out"]
        if interior(gold, p.valid_rim()).size == 0:
            print(f"{head}: rim covers the grid, skipped")
            skipped += 1
            continue
        try:
            if builds[c.seed][1] is not None:
                raise builds[c.seed][1]
            if cpu:
                got = emulate(p, pl, ins, hazard=hazard)["out"]
            else:
                got = to_numpy(p, cuda.run(p, ins, device=device, the_plan=pl))["out"]
            ok = wide_gate(p, c.base, gold, got)
            if c.base in ("int64", "uint64"):
                plain = to_numpy(p, eager.run(p, ins, device=device))["out"]
                ok = ok and np.array_equal(got, plain)
        except Exception as e:  # noqa: BLE001 -- a failed build or launch is a failure
            print(f"{head}: RUN FAILED {type(e).__name__}: {e}\n{c.source}")
            failures += 1
            continue
        print(f"{head}: {'OK' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            print(c.source)
            failures += 1
    print(f"{failures} failures / {n} seeds ({skipped} skipped: rim covers the grid)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
