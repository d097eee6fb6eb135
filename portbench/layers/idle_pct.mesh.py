"""idle_pct.mesh: % of the profiled slice in which no kernel, copy or set
ran on a card, the mean of the mesh's cards (each card's value is on an
earlier line of standard error), from one torch.profiler session.  None
where the profiler holds no device records."""


def read(t):
    idle = t.idle_pct()
    return None if not idle else sum(idle.values()) / len(idle)
