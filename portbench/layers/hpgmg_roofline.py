"""hpgmg_roofline: kernel 1's share of its roofline on HPGMG's smoother, in
%: the least time of one call by the benchmark's own count
(roofline/hpgmg_jacobi.json, 56 B a cell, bound by the bytes on the H100
17 times over the float64 ops, against peaks.json's card) over the call's
kernels alone (kernel_ms.hpgmg).  None without a peak for the card or a
kernel time."""

from portbench import harness


def read(t):
    bound = harness.bound_ms(t.roofline, t.cells, t.sweeps_per_call, t.peak)
    if bound is None or not t.kernel_ms:
        return None
    return 100.0 * bound / t.kernel_ms
