"""sodac for the torch port (minimal).

Counterpart of `soda_tpu/cli/sodac.py`.  Parses a `.soda` file, plans it
for the CUDA path (ranks 1 to 3), prints the plan, and with `--run` runs
it on random inputs made from `--seed` on the card (or on the CPU with
`--device cpu`), checks the result against the port's NumPy reference and
prints the max difference.  Exit code 1 when the check fails.

    python -m soda_tpu_torch.cli.sodac tests/soda/blur.soda \\
        --grid-shape 2048,4096 --run

`--sweeps N` asks for N fused sweeps per kernel call of an `iterate`
program (as the JAX CLI's flag); the printed plan shows the depth
(`sweeps=`).  `--block 8,32` pins the windows kernel with that block (the
JAX CLI's `--block`, which pins its windows blocks).  The JAX CLI's other
flags are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _shape(s: str) -> tuple[int, ...]:
    try:
        shape = tuple(int(v) for v in s.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"want comma-separated integers, got {s!r}") from None
    if not shape or min(shape) <= 0:
        raise argparse.ArgumentTypeError(f"want positive sizes, got {s!r}")
    return shape


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sodac-torch",
        description="Compile and run a .soda stencil program on PyTorch/CUDA")
    ap.add_argument("soda_src", help="input .soda file")
    ap.add_argument("--grid-shape", type=_shape, default=None,
                    help="full grid shape, e.g. 64,64,128 (default: from the "
                         "input's tile sizes, '*' dims as 128)")
    ap.add_argument("--iterate", type=int, default=None)
    ap.add_argument("--sweeps", type=int, default=None,
                    help="fused sweeps per kernel call for iterate programs "
                         "(default: the planner's choice; 1 = one sweep per "
                         "call; a non-divisor of iterate is snapped to one)")
    ap.add_argument("--block", type=_shape, default=None,
                    help="pin the windows kernel with this block, one size "
                         "per axis, e.g. 8,32 (one sweep per call)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the card, never a fallback) or 'cpu'")
    ap.add_argument("--run", action="store_true",
                    help="run on random inputs and check against the oracle")
    return ap


def _grid_shape(program, args) -> tuple[int, ...]:
    if args.grid_shape is not None:
        if len(args.grid_shape) != program.rank:
            raise SystemExit(f"--grid-shape has rank {len(args.grid_shape)}, "
                             f"program rank is {program.rank}")
        return args.grid_shape
    tile = program.tensors[program.input_names[0]].tile_size or ()
    return tuple(128 if d is None else d for d in tile)


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    from ..backend import cuda
    from ..backend.io import to_numpy
    from ..frontend.parser import parse_file
    from ..plan.planner import plan
    from ..utils.testing import compare_outputs, oracle, rand_inputs

    overrides = {} if args.iterate is None else {"iterate": args.iterate}
    program = parse_file(args.soda_src, overrides)
    shape = _grid_shape(program, args)
    print(program.describe())
    if args.sweeps is not None and args.sweeps < 1:
        raise SystemExit(f"--sweeps wants a positive count, got {args.sweeps}")
    plan_kw = {k: v for k, v in (("sweeps", args.sweeps), ("block", args.block))
               if v is not None}
    try:
        print(plan(program, shape, **plan_kw).describe())
    except ValueError as e:
        raise SystemExit(f"no CUDA plan: {e}") from None
    if not args.run:
        return 0
    ins, ps = rand_inputs(program, shape, np.random.default_rng(args.seed))
    got = to_numpy(program, cuda.run(program, ins, ps, device=args.device, **plan_kw))
    gold = oracle(program, ins, ps)
    for n in program.output_names:
        diff = np.abs(got[n].astype(np.float64) - gold[n].astype(np.float64))
        print(f"{n}: max |diff| vs oracle = {float(diff.max()) if diff.size else 0.0}")
    ok = compare_outputs(program, got, gold, 0)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
