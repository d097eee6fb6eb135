"""kernel_ms.denoise: ms of one call's kernels on the card, alone (CUDA
events behind a sleep kernel, harness.device_ms), the mean of the traffic's
`kernel_sample` calls of the window's own chain: one call is one launch of
kernel 1 (the z-march) fusing denoise3d's three stages.  None when not
measured."""


def read(t):
    return t.kernel_ms
