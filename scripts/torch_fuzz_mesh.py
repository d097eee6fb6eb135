#!/usr/bin/env python
"""Random stencil programs sharded over random meshes, held against the
port's NumPy oracle: the port's counterpart of `scripts/fuzz_mesh.py`,
seed for seed (`soda_tpu_torch/utils/fuzz.py::mesh_case` keeps its
generator, uneven grids, meshes [8], [4], [2, 4] and [4, 2], cadences and
overlap draws, and `mesh_gate` its gates).

    python scripts/torch_fuzz_mesh.py [n_seeds] [--cpu]

Shards sit on the visible cards round robin: shard i on cuda:(i mod n),
so one card holds every shard and four cards hold two each; between two
cards a halo exchange is a peer copy, and the overlap's copy streams run
on every card that holds a shard.  `--cpu` puts every shard on the CPU.
The local evaluation is `cuda` (kernels 1 to 4 and the fused sweeps, as
the planner chooses for the shard; each group's plain version on CPU
shards), and the plain path (`eager`) on the seeds where the original
runs its kernels (seed % 7 == 3).

Gates (the original's): a single-stage program exchanging every sweep,
or running one sweep, on the whole grid; otherwise outside `valid_rim()`;
integers bit for bit, floats at 1e-4.  A run failure counts as a
failure; any failure exits 1.
"""

import concurrent.futures
import math
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    argv = sys.argv
    n = int(argv[1]) if len(argv) > 1 and argv[1].isdigit() else 40
    cpu = "--cpu" in argv

    import torch

    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.backend.io import finalize_outputs, to_numpy, to_torch
    from soda_tpu_torch.interp.numpy_ref import run as oracle
    from soda_tpu_torch.parallel import mesh
    from soda_tpu_torch.utils.device import resolve
    from soda_tpu_torch.utils.fuzz import mesh_case, mesh_gate
    from soda_tpu_torch.utils.report import card

    if cpu:
        devices = ["cpu"]
    else:
        resolve("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    print(f"fuzz_mesh over {len(devices)} device(s) {devices}"
          + ("" if cpu else f": {card()}"), flush=True)

    runs = []
    for seed in range(n):
        c = mesh_case(seed)
        local = "eager" if c.kernel_seed else "cuda"
        shards = [devices[i % len(devices)] for i in range(math.prod(c.axis_sizes))]
        fn = mesh.build_sharded_fn(
            c.program, mesh.make_mesh(c.axis_sizes, None, shards), grid_shape=c.shape,
            dims=c.dims, sweeps_per_exchange=c.sweeps_per_exchange, local_backend=local,
            overlap=c.overlap)
        runs.append((c, local, shards, fn))
    if not cpu:
        # every shard shape's kernels, built in parallel before the first run
        kernels = {k.source: k for c, local, _, fn in runs if local == "cuda"
                   for pl in fn.local_plans().values()
                   for k in (cuda.group_kernel(c.program, g) for g in pl.groups)}
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            list(pool.map(lambda k: k.build(), kernels.values()))
        print(f"build: {len(kernels)} kernels in {time.perf_counter() - t0:.1f} s wall",
              flush=True)

    failures = skipped = 0
    for c, local, shards, fn in runs:
        p = c.program
        cfg = (f"{'x'.join(map(str, c.axis_sizes))}mesh spe={c.sweeps_per_exchange} "
               f"ov={int(c.overlap)} {local} on {len(set(shards))} device(s)")
        try:
            gold = oracle(p, c.inputs)["out"]
            ins, pars = to_torch(p, c.inputs, {}, shards[0])
            cuda.reset_launches()
            got = to_numpy(p, finalize_outputs(p, fn(ins, pars)))["out"]
            launched = sum(cuda.launch_counts().values())
        except Exception as e:  # noqa: BLE001 -- a failed run is a failure of the seed
            print(f"seed {c.seed}: RUN FAILED {type(e).__name__}: {e}\n{c.source}")
            failures += 1
            continue
        head = (f"seed {c.seed} [{c.base} it={c.iterate} {c.shape} {cfg}, "
                f"shards {'x'.join(map(str, fn.shard_shape))}, cadence "
                f"{fn.sweeps_per_exchange}, {fn.stats['group_calls']} group calls, "
                f"{launched} kernel launches, {fn.stats['exchange_bytes']} B exchanged]")
        ok = mesh_gate(c, gold, got)
        if ok is None:
            print(f"{head}: rim leaves no interior, skipped")
            skipped += 1
            continue
        # on the cards every group call of the kernels' backend is a launch
        if local == "cuda" and not cpu and launched != fn.stats["group_calls"]:
            ok = False
        print(f"{head}: {'OK' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            print(c.source)
            failures += 1
    print(f"{failures} failures / {n} seeds (mesh; {skipped} skipped)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
