"""shard_kernel_ms.mesh: ms a call of one shard's local evaluation on its
card (kernel 1 on the extended shard), the program's interval "local"
(CUDA events on the card's stream around the shard's `build_fn` call) over
the profiled slice, the mean of the mesh's cards (each card's value on
standard error).  None where the program records no such interval."""

import sys

from portbench import program_trace


def read(t):
    by_card = program_trace.interval_ms_a_call("local", "soda.mesh.call")
    if not by_card:
        return None
    print(f"shard_kernel_ms.mesh by card: {by_card}", file=sys.stderr, flush=True)
    return sum(by_card.values()) / len(by_card)
