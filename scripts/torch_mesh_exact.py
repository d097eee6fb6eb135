"""A multi-stage program on the mesh against the whole grid: a benchmark
configuration's program (by default denoise3d: u the state, rhs fixed; or
HPGMG-FV's smoother, x the state and five fixed fields, three read with a
halo that crosses the shards) kept on the mesh's cards for a few calls
through `parallel/mesh.py::build_sharded_fn`, each call's output gathered
and held bit for bit against the benchmark's plain reference
(`portbench/reference/<program>.py`, computed on the first card in blocks
of 64 planes from the call's own input) and against the whole-grid
`cuda.build_fn` on the first card, on the whole grid, its faces included.
The inputs are drawn as the configuration's file says (dtype, ranges).

    python3 scripts/torch_mesh_exact.py            # 1024 x 1024 x 512 on [2, 2] and [4]
    python3 scripts/torch_mesh_exact.py --cpu      # a small grid on CPU shards
    python3 scripts/torch_mesh_exact.py --config hpgmg-jacobi-512

Shard i lies on `cuda:(i mod count)`; with one card every shard is on
cuda:0.  Prints one line a call (cells off each way, ms a call by the host
clock around every card's synchronise, bytes exchanged) and exits 1 if
any cell is off.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import check, harness, inputs  # noqa: E402
from soda_tpu_torch.backend import cuda  # noqa: E402
from soda_tpu_torch.frontend.parser import parse_file  # noqa: E402
from soda_tpu_torch.parallel import mesh  # noqa: E402
from soda_tpu_torch.parallel.sharded import gather_grid, shard_grid  # noqa: E402

LAYOUTS = (([2, 2], [0, 1]), ([4], [0]))
CHUNK = 64


def reference_off(ref, x, fields, got) -> int:
    """Cells of `got` whose bits differ from one sweep of the reference
    from `x` and the fixed `fields`, computed in blocks of CHUNK planes."""
    return check.compare_sweep(
        ref, lambda a, b: x[a:b], lambda a, b: got[a:b], x.shape[0], x.shape[1:], CHUNK,
        x.dtype, x.device, {n: lambda a, b, t=t: t[a:b] for n, t in fields.items()}
    )["cells_off"]


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="CPU shards at a small grid")
    ap.add_argument("--config", default="denoise3d-512",
                    help="a configuration under portbench/configs/: program, dtype, inputs")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--seed", type=int, default=18)
    args = ap.parse_args(argv)
    if args.cpu:
        grid, first, devices = (16, 32, 48), torch.device("cpu"), ["cpu"] * 4
    else:
        if not torch.cuda.is_available():
            print("no CUDA card (--cpu runs on CPU shards)", file=sys.stderr)
            return 2
        grid, first = (1024, 1024, 512), torch.device("cuda", 0)
        devices = [torch.device("cuda", i % torch.cuda.device_count()) for i in range(4)]
        print(f"cards: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}")
    cfg = harness.load_json("configs", args.config)
    ref = harness.load_module("reference", cfg["reference"])
    p = parse_file(harness.program_path(cfg["program"]))
    src, dst = p.input_names[0], p.output_names[0]
    x0 = inputs.grid(grid, args.seed, inputs.Spec.of(cfg), first)
    fields = {n: inputs.grid(grid, inputs.field_seed(args.seed, n), spec, first)
              for n, spec in inputs.fields_of(cfg).items()}
    whole = cuda.build_fn(p, grid_shape=grid)
    bad = 0
    for sizes, dims in LAYOUTS:
        m = mesh.make_mesh(sizes, devices=devices)
        cards = list(dict.fromkeys(m.devices.flat))
        fn = mesh.build_sharded_fn(p, m, grid_shape=grid, dims=dims)
        state = {n: shard_grid(t, m, fn.dims) for n, t in fields.items()}
        state[src] = shard_grid(x0, m, fn.dims)
        x = x0
        for c in range(args.calls):
            sync(cards)
            t0 = time.perf_counter()
            state[src] = fn(state, {})[dst]
            sync(cards)
            ms = (time.perf_counter() - t0) * 1e3
            got = gather_grid(state[src], first)
            off_ref = reference_off(ref, x, fields, got)
            x = whole({src: x, **fields}, {})[dst]
            off_whole = int((check.bits(got) != check.bits(x)).sum())
            bad += off_ref + off_whole
            print(f"{p.name} {grid} on {sizes} dims {dims} call {c}: {off_ref} cells off "
                  f"the reference, {off_whole} off the whole grid, {ms:.3f} ms, "
                  f"{fn.stats['exchange_bytes']} B exchanged, shard {fn.shard_shape}",
                  flush=True)
            del got
        del fn, state
    print(f"{'FAIL' if bad else 'OK'}: {bad} cells off in all")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
