"""idle_pct.loop: % of the profiled slice in which no kernel, copy or set
ran on the card, from one torch.profiler session.  None where the profiler
holds no device records."""


def read(t):
    idle = t.idle_pct()
    return None if not idle else sum(idle.values()) / len(idle)
