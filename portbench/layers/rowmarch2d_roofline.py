"""rowmarch2d_roofline: the rank-2 row-march's share of its roofline, in %:
the least time of one call by the benchmark's own count
(roofline/<program>.json, its bytes once a call, against peaks.json's
card) over the call's kernels alone (kernel_ms.frame).  None without a
peak for the card or a kernel time."""

from portbench import harness


def read(t):
    bound = harness.bound_ms(t.roofline, t.cells, t.sweeps_per_call, t.peak)
    if bound is None or not t.kernel_ms:
        return None
    return 100.0 * bound / t.kernel_ms
