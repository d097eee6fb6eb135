"""enqueue_ms.loop: ms of the host clock around one call of build_fn's fn
(the wrapper's checks, the output's allocation and the launch), no
synchronise, the mean over every call of the window outside the profiled
slice and the kernel sample."""


def read(t):
    return t.enqueue_ms
