"""kernel_ms.frame: ms of one call's kernels on the card, alone (CUDA events
behind a sleep kernel, harness.device_ms), the mean of the traffic's
`kernel_sample` calls of the window's own feed: each call reads a frame of
the ring that 15 others have passed through the L2 since, and runs one
launch of the rank-2 row-march (`backend/linebuffer2d.py`, kernel 2) over
a two-stage group.  None when not measured."""


def read(t):
    return t.kernel_ms
