"""kernel_ms.cascade: ms of one call's kernels on the card, alone (CUDA
events behind a sleep kernel, harness.device_ms), the mean of the traffic's
`kernel_sample` calls of the window's own chain: one call runs the
configuration's `iterate` sweeps fused in one launch of the rank-2 cascade
(`backend/sweeps.py` over the row-march, kernel 3's counterpart).  None
when not measured."""


def read(t):
    return t.kernel_ms
