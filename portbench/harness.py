"""What every cell of the benchmark shares: finding its parts by name, the
timer, the statistics and the window's arithmetic.

The parts of a cell are files found by the names in BENCHMARK.json, so a
later change adds a cell or a metric by adding files:

    configs/<config>.json      the program, grid, dtype, fixed fields, iterate,
                               chips, mesh, entry, reference, roofline and limits
    programs/<program>.soda    a frozen copy of the program
    traffic/<mix>.json         the loop's parameters, read by loop.py
    entries/<entry>.py         how the system under test is built and called
    reference/<program>.py     the plain PyTorch reference
    roofline/<program>.json    the benchmark's own count of bytes and ops
    layers/<metric>.py         the reader of one per-layer metric

This module imports no torch at import time and nothing of the program.
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# top-level module names that no run may hold once its window has closed,
# compared whole: soda_tpu_torch, the program, begins with soda_tpu
BANNED = ("jax", "jaxlib", "flax", "soda_tpu")


class MissingPart(LookupError):
    """A name in BENCHMARK.json or a config has no file of its own."""


def _path(kind: str, name: str, suffix: str) -> pathlib.Path:
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        have = sorted(p.name[:-len(suffix)] for p in (HERE / kind).glob(f"*{suffix}"))
        raise MissingPart(f"no {kind} named {name!r}: {path} is missing (have {have})")
    return path


def load_json(kind: str, name: str) -> dict:
    return json.loads(_path(kind, name, ".json").read_text())


def load_module(kind: str, name: str):
    """The module `<kind>/<name>.py`, loaded from its file (names may hold
    dots and dashes, so it is not imported by name)."""
    path = _path(kind, name, ".py")
    key = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def program_path(name: str) -> pathlib.Path:
    return _path("programs", name, ".soda")


def load_benchmark() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise MissingPart(f"no workload {name!r} in BENCHMARK.json "
                      f"(have {[w['name'] for w in bench['workloads']]})")


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    without a `workloads` key, and those that list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def peak_of(kind: str) -> dict | None:
    """The table of peaks' entry for a card named `kind`, None if it has none."""
    for entry in json.loads((HERE / "peaks.json").read_text()).values():
        if entry["match"] in kind:
            return entry
    return None


def bound_ms(count: dict, cells: int, sweeps: int, peak: dict | None) -> float | None:
    """The least time of one call of `sweeps` sweeps over `cells` cells on
    a card of `peak`: the larger of the bytes over the memory's rate and
    the ops over the float32 rate (None without a peak).  The ops count
    every sweep, the bytes once a call: a call that fuses its sweeps need
    read and write each cell only once."""
    if peak is None:
        return None
    bytes_s = count["bytes_per_cell"] * cells / peak["hbm_bytes_per_s"]
    ops_s = count["float32_ops_per_cell"] * cells / peak["float32_ops_per_s"]
    return max(bytes_s, ops_s * sweeps) * 1e3


# -- statistics --------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between the two
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """All the work over all the time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


# -- the window --------------------------------------------------------------

class Window:
    """Blocks timed by the host clock.  Each block is the work between two
    synchronisations of every card; the window starts at the first block's
    start and ends at the last block's synchronisation."""

    def __init__(self):
        self.start: float | None = None
        self.end: float | None = None
        self.blocks_ms: list[float] = []
        self.calls = 0

    def add(self, t0: float, t1: float, calls: int) -> None:
        if self.start is None:
            self.start = t0
        self.end = t1
        self.blocks_ms.append((t1 - t0) * 1e3)
        self.calls += calls

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def gcells_per_s(self, cells: int, sweeps_per_call: int = 1) -> float:
        return rate(cells * self.calls * sweeps_per_call, self.seconds) / 1e9

    def block_p95_ms(self) -> float:
        return percentile(self.blocks_ms, 95)


# -- kernel alone ------------------------------------------------------------
# Frozen copy of chip_smoke.py::device_ms and its constants, so a
# later change to the smoke test does not move the yardstick.
SLEEP_CYCLES = 3_000_000   # at most 1.98 GHz: at least 1.5 ms
SLEEP_COVERS_S = 1e-3


def device_ms(fn, reps: int, sleeps: int = 1, log=None) -> float | None:
    """Device time of the kernels one `fn()` enqueues, in ms (the mean of
    `reps`), by CUDA events: a sleep kernel (`sleeps` x SLEEP_CYCLES) holds
    the stream while the host enqueues the start event, `fn`'s kernels and
    the end event, so no host gap is timed.  None ("not measured") where
    the host took longer to enqueue than the sleep lasts."""
    import torch

    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES * sleeps)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if host_s > SLEEP_COVERS_S * sleeps:
            if log:
                log(f"device time: the host enqueued for {host_s * 1e3:.3f} ms, longer "
                    f"than the sleep; not measured")
            return None
        total += start.elapsed_time(end)
    return total / reps


def banned_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of BANNED."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in BANNED)
