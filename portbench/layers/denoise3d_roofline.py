"""denoise3d_roofline: kernel 1's share of its roofline on denoise3d's
three-stage group, in %: the least time of one call by the benchmark's own
count (roofline/denoise3d.json, 12 B a cell, bound by the bytes on the
H100, against peaks.json's card) over the call's kernels alone
(kernel_ms.denoise).  None without a peak for the card or a kernel time."""

from portbench import harness


def read(t):
    bound = harness.bound_ms(t.roofline, t.cells, t.sweeps_per_call, t.peak)
    if bound is None or not t.kernel_ms:
        return None
    return 100.0 * bound / t.kernel_ms
