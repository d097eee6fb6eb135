"""Readings of the check on many seeds in one process: the program's, the
control's and the faults'.  The benchmark's own runs never run this.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 2 \
        [--mode program|control|unchanged|altered|half|no_exchange]

`program` runs the cell as run.py does (its readings set the lower end of a
limit).  The others put something in the place of the program's local
sweep, `soda_tpu_torch.backend.cuda.build_fn`'s fn, which both entries
call (the mesh on every shard), and leave the rest of the run as it is:

    control      the reference in the program's place, computed in the
                 precision below the configuration's dtype (LOWER)
    unchanged    a sweep that returns its input: the state never moves
    altered      the program's sweep with one cell changed where it is made
    half         the program's sweep with the upper half of dim 0 left zero
    no_exchange  the mesh's halo exchange between shards left out

The last line is a JSON object: the readings by seed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

MODES = ("program", "control", "unchanged", "altered", "half", "no_exchange")
# the control's precision, the one below the configuration's: the step that
# would tempt a later change
LOWER = {"float64": "float32", "float32": "bfloat16"}


def lower_dtype(dtype: str):
    import torch

    if dtype not in LOWER:
        raise ValueError(f"no control precision below {dtype!r} (have {sorted(LOWER)})")
    return getattr(torch, LOWER[dtype])


def _local(mode: str, real, reference, chunk: int, low):
    """The local sweep `mode` puts in the program's place, with build_fn's
    signature; `real` is the program's own fn or None, `low` the control's
    dtype."""
    from portbench import check

    def fn(inputs, params, bufs=None):
        (src, x), = inputs.items()
        if mode == "control":
            return {fn.dst: check.sweep_in_chunks(reference, x, chunk, low)}
        if mode == "unchanged":
            return {fn.dst: x}
        y = real(inputs, params, bufs=bufs)[fn.dst]
        if mode == "altered":
            mid = tuple(n // 2 for n in y.shape)
            y[mid] = y[mid] + 1.0
        elif mode == "half":
            y[y.shape[0] // 2:] = 0
        return {fn.dst: y}

    fn.plan = None if real is None else real.plan
    fn.alloc = (lambda device: None) if real is None else real.alloc
    return fn


@contextlib.contextmanager
def patched(mode: str, reference, chunk: int, dtype: str = "float32"):
    """The program with `mode`'s change in place, for the duration; `dtype`
    is the configuration's."""
    from unittest import mock

    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.parallel import mesh

    if mode == "program":
        yield
        return
    if mode == "no_exchange":
        with mock.patch.object(mesh, "_exchange", lambda ext, dim, lo, hi: 0):
            yield
        return
    real_build = cuda.build_fn
    low = lower_dtype(dtype) if mode == "control" else None

    def build_fn(program, the_plan=None, grid_shape=None, **kw):
        real = None if mode in ("control", "unchanged") else real_build(
            program, the_plan, grid_shape, **kw)
        f = _local(mode, real, reference, chunk, low)
        f.dst = program.output_names[0]
        return f

    with mock.patch.object(cuda, "build_fn", build_fn):
        yield


def readings(workload: str, seeds, seconds: float, mode: str, *, grid=None, devices=None,
             log=None) -> dict:
    """seed -> {"correct", "checks": {name: cells off}, "widest": gap}."""
    import torch

    from portbench import harness, loop

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench = harness.load_benchmark()
    out = {}
    for seed in seeds:
        cell = loop.Cell(bench, workload, grid=grid, devices=devices)
        with patched(mode, cell.reference, cell.traffic["check"]["chunk_planes"],
                     cell.config["dtype"]):
            got = loop.run(cell, seed, seconds, False, time.perf_counter(), log)
        loop.release([torch.device(d) for d in cell.devices])   # the last seed's grids
        limit = cell.config["limits"]["cells_off"]
        offs = {k: c["cells_off"] for k, c in got["checks"].items()}
        out[seed] = {"correct": all(v <= limit for v in offs.values()), "checks": offs,
                     "widest": max(c["max_gap"] for c in got["checks"].values()),
                     "blocks": len(got["window"].blocks_ms), "setup_s": got["setup_s"]}
        log(f"{mode} seed {seed}: {out[seed]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--mode", choices=MODES, default="control")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the readings are taken on the card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    got = readings(args.workload, seeds, args.seconds, args.mode)
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "card": torch.cuda.get_device_name(0), "readings": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
