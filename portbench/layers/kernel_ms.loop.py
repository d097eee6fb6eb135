"""kernel_ms.loop: ms of one call's kernels on the card, alone (CUDA
events behind a sleep kernel, harness.device_ms), the mean of the traffic's
`kernel_sample` calls of the window's own chain.  None when not measured."""


def read(t):
    return t.kernel_ms
