"""kernel_ms.hpgmg: ms of one call's kernels on the card, alone (CUDA
events behind a sleep kernel, harness.device_ms), the mean of the traffic's
`kernel_sample` calls of the window's own chain: one call is one launch of
kernel 1 (the column z-march) fusing HPGMG's dinv and xn, fed six float64
planes a step.  None when not measured."""


def read(t):
    return t.kernel_ms
