"""Reduce one `torch.profiler` session to the device's busy time, its idle
gaps and the operations that took the most time.

The session is exported as a Chrome trace into the run's temporary
directory, read and deleted.  Device operations are the events of the
categories in DEVICE_CATS, each on its card (`args.device`); host events
(CPU ops, the benchmark's `record_function` spans, CUDA runtime calls) say
what the host was doing during an idle gap.  The traced window is the
benchmark's span WINDOW.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10
NAME_CHARS = 96


def export_events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list[dict], cards: list[int]) -> dict | None:
    """busy and window seconds per card, the top device operations and the
    top idle gaps by the innermost host event at the gap's middle, each
    averaged over `cards`.  None where the trace holds no window or no
    device operation on these cards."""
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev_ops = collections.defaultdict(list)
    op_time = collections.Counter()
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        card = (e.get("args") or {}).get("device", e.get("pid"))
        try:
            card = int(card)
        except (TypeError, ValueError):
            continue
        if card not in cards:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, w0), min(b, w1)
        if b > a:
            dev_ops[card].append((a, b))
            op_time[str(e.get("name", "?"))[:NAME_CHARS]] += (b - a) * 1e-6
    if not dev_ops:
        return None
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), str(e.get("name")))
                  for e in spans if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    gaps = collections.Counter()
    busy = {}
    for card in cards:
        merged = _merge(dev_ops.get(card, []))
        busy[card] = sum(b - a for a, b in merged) * 1e-6
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps[_doing(host, starts, (a + b) / 2)] += (b - a) * 1e-6
    n = len(cards)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy,
        "device_ops": [[k, v / n] for k, v in op_time.most_common(TOP)],
        "idle_gaps": [[k, v / n] for k, v in gaps.most_common(TOP)],
    }


def _doing(host, starts, t: float, look: int = 4096) -> str:
    """The innermost host event running at `t`: of those that contain it,
    the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        a, b, name = host[j]
        if a <= t <= b:
            return name[:NAME_CHARS]
    return "(no host event)"
