"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It measures `soda_tpu_torch` on the
cards the cell asks for, and exits 2 without printing a result where torch
sees no CUDA card or fewer than the cell needs: it never falls back to
the CPU.  The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (with `--trace 0` the cell's end-to-end
metrics, with `--trace 1` its per-layer ones), `device` and, traced,
`breakdown`; last the numbers the check compared, each beside its limit,
which also end standard error.  Everything else goes to standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(CHECKOUT)        # the checkout, not portbench/, first
    # caches at fixed paths inside the checkout (the port keeps its own
    # libraries in build/cuda/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CHECKOUT / "build" / "portbench" / sub)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The cards' names and power limits, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def result(bench: dict, cell, got: dict, trace: bool) -> dict:
    """The last line's object from one run's numbers."""
    from portbench import harness

    import torch

    window, checks, cards = got["window"], got["checks"], got["cards"]
    limits = cell.config["limits"]
    compared = {f"cells_off.{name}": {"value": c["cells_off"], "limit": limits["cells_off"]}
                for name, c in checks.items()}
    failed = sum(1 for c in compared.values() if c["value"] > c["limit"])
    on_cuda = cards[0].type == "cuda"
    kind = torch.cuda.get_device_name(cards[0]) if on_cuda else "cpu"
    device = {"platform": "gpu" if on_cuda else "cpu", "kind": kind, "count": len(cards),
              "memory_peak_bytes": got["peak"]}
    out = {"correct": failed == 0 and len(window.blocks_ms) > 0,
           "attempted": len(window.blocks_ms), "failed": failed}
    metrics = {}
    if not trace:
        values = {"gcells_per_s": window.gcells_per_s(cell.cells, cell.config["iterate"]),
                  "block_p95_ms": window.block_p95_ms(), "setup_s": got["setup_s"]}
        for m in harness.metrics_of(bench, cell.name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        log(f"window {window.seconds!r} s, {len(window.blocks_ms)} blocks of "
            f"{cell.traffic['block_sweeps']} calls of {cell.config['iterate']} sweeps, "
            f"{window.calls} calls; block ms median "
            f"{harness.percentile(window.blocks_ms, 50)!r}, p95 {values['block_p95_ms']!r}, "
            f"max {max(window.blocks_ms)!r}")
    else:
        t = got["trace"]
        t.peak = harness.peak_of(kind) if on_cuda else None
        for m in harness.metrics_of(bench, cell.name, "per_layer"):
            v = harness.load_module("layers", m["name"]).read(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            else:
                log(f"per-layer {m['name']}: nothing to read, left out")
        idle = t.idle_pct()
        log(f"traced: window {t.window_s!r} s, busy s by card "
            f"{t.busy_s}, idle % by card {idle}; kernel ms alone {t.kernel_ms!r}, "
            f"enqueue ms a call {t.enqueue_ms!r}; bound ms a call "
            f"{harness.bound_ms(t.roofline, t.cells, t.sweeps_per_call, t.peak)!r}")
        if t.busy_s:
            device["busy_s"] = sum(t.busy_s.values()) / len(t.busy_s)
            device["window_s"] = t.window_s
        if t.device_ops is not None:
            out["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    out["metrics"] = metrics
    out["device"] = device
    out["checks"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, loop

    bench = harness.load_benchmark()
    cell = loop.Cell(bench, args.workload)
    import torch

    log(f"set-up: torch and the harness imported at {time.perf_counter() - T_START:.3f} s")
    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"the cell {cell.name} needs {need} CUDA card(s); torch {torch.__version__} sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    log(f"cell {cell.name}, seed {args.seed}, {args.seconds} s, trace {args.trace}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    got = loop.run(cell, args.seed, args.seconds, bool(args.trace), T_START, log)
    out = result(bench, cell, got, bool(args.trace))
    log(f"cards: {card_line()}")
    log(f"counters: {got['counters']}; memory peak {got['peak']} B")
    found = harness.banned_modules()
    if found:
        log(f"modules loaded that the benchmark may not hold: {found}; no result")
        return 3
    for name, c in out["checks"].items():
        log(f"compared {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
