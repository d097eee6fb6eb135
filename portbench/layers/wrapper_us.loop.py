"""wrapper_us.loop: us of host time in the kernel wrapper a call, the
program's span `soda.kernel` (`linebuffer.GroupKernel.__call__` on the
card: the checks, the output's allocation and the C launch), the mean over
every call of the profiled slice, the profiler's own recording included.
None where the program records no such span."""

from portbench import program_trace


def read(t):
    s = program_trace.span_mean_s("soda.kernel")
    return None if s is None else s * 1e6
