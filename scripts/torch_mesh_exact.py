"""A multi-stage program on the mesh against the whole grid: denoise3d (u
the state, rhs fixed) kept on the mesh's cards for a few calls through
`parallel/mesh.py::build_sharded_fn`, each call's output gathered and held
bit for bit against the benchmark's plain reference
(`portbench/reference/denoise3d.py`, computed on the first card in blocks
of 64 planes from the call's own input) and against the whole-grid
`cuda.build_fn` on the first card, on the whole grid, its faces included.

    python3 scripts/torch_mesh_exact.py            # 1024 x 1024 x 512 on [2, 2] and [4]
    python3 scripts/torch_mesh_exact.py --cpu      # a small grid on CPU shards

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

from portbench import harness  # noqa: E402
from soda_tpu_torch.backend import cuda  # noqa: E402
from soda_tpu_torch.frontend.parser import parse_file  # noqa: E402
from soda_tpu_torch.parallel import mesh  # noqa: E402
from soda_tpu_torch.parallel.sharded import gather_grid, shard_grid  # noqa: E402

LAYOUTS = (([2, 2], [0, 1]), ([4], [0]))
CHUNK = 64


def reference_off(ref, u, rhs, got) -> int:
    """Cells of `got` whose bits differ from one sweep of the reference
    from `u` and `rhs`, computed in blocks of CHUNK planes."""
    n0, h = u.shape[0], ref.HALO

    def block(t, a, b):
        out = torch.zeros((b - a, *t.shape[1:]), dtype=t.dtype, device=t.device)
        out[max(a, 0) - a:min(b, n0) - a] = t[max(a, 0):min(b, n0)]
        return out

    off = 0
    for z in range(0, n0, CHUNK):
        z1 = min(z + CHUNK, n0)
        want = ref.sweep_at(block(u, z - h, z1 + h), z - h, n0, block(rhs, z - h, z1 + h))
        off += int((got[z:z1].view(torch.int32) != want.view(torch.int32)).sum())
    return off


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="CPU shards at a small grid")
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
    ref = harness.load_module("reference", "denoise3d")
    p = parse_file(harness.program_path("denoise3d"))
    g = torch.Generator(device=first).manual_seed(args.seed)
    u0 = torch.rand(grid, generator=g, device=first)
    rhs = torch.rand(grid, generator=g, device=first)
    whole = cuda.build_fn(p, grid_shape=grid)
    bad = 0
    for sizes, dims in LAYOUTS:
        m = mesh.make_mesh(sizes, devices=devices)
        cards = list(dict.fromkeys(m.devices.flat))
        fn = mesh.build_sharded_fn(p, m, grid_shape=grid, dims=dims)
        state = {"u": shard_grid(u0, m, fn.dims), "rhs": shard_grid(rhs, m, fn.dims)}
        u = u0
        for c in range(args.calls):
            sync(cards)
            t0 = time.perf_counter()
            state["u"] = fn(state, {})["unew"]
            sync(cards)
            ms = (time.perf_counter() - t0) * 1e3
            got = gather_grid(state["u"], first)
            off_ref = reference_off(ref, u, rhs, got)
            u = whole({"u": u, "rhs": rhs}, {})["unew"]
            off_whole = int((got.view(torch.int32) != u.view(torch.int32)).sum())
            bad += off_ref + off_whole
            print(f"denoise3d {grid} on {sizes} dims {dims} call {c}: {off_ref} cells off "
                  f"the reference, {off_whole} off the whole grid, {ms:.3f} ms, "
                  f"{fn.stats['exchange_bytes']} B exchanged, shard {fn.shard_shape}",
                  flush=True)
            del got
        del fn, state
    print(f"{'FAIL' if bad else 'OK'}: {bad} cells off in all")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
