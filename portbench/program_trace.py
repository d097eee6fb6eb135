"""The program's own spans and device intervals over the profiled slice,
as `soda_tpu_torch.utils.trace` holds them: the per-layer readers of the
program's steps read them through here.

The program records them only while a profiler records, and the entries'
`reset_counters` (`cuda.reset_launches`) clears them just before the
profiled slice opens, so they cover that slice alone.  Each function
returns None, never 0, where the program has no such module (one older
than its tracing) or the slice recorded nothing of the kind (the plain
path on the CPU records no `soda.kernel` and no interval)."""

from __future__ import annotations


def _trace():
    try:
        from soda_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def span_mean_s(name: str) -> float | None:
    """Mean host seconds of the span `name`."""
    trace = _trace()
    t = trace.totals().get(name) if trace else None
    if t is None or t.count == 0:
        return None
    return t.total_s / t.count


def interval_ms_a_call(kind: str, call_span: str) -> dict[str, float] | None:
    """ms of the interval `kind` by card, each card's total over the count
    of the span `call_span` (one a call)."""
    trace = _trace()
    if trace is None:
        return None
    calls = trace.totals().get(call_span)
    by_card = trace.device_ms().get(kind)
    if not by_card or calls is None or calls.count == 0:
        return None
    return {card: ms / calls.count for card, (_, ms) in by_card.items()}
