"""enqueue_ms.mesh: ms of the host clock around one resident call of the
sharded fn (every card's exchange and kernels enqueued by the single
controller), no synchronise, the mean over every call of the window outside
the profiled slice."""


def read(t):
    return t.enqueue_ms
