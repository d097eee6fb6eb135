"""exchange_ms.mesh: ms a call of the halo exchange on a card, the
program's interval "exchange" (CUDA events on each card's stream from
before the first copy into it to after the last, waits for its neighbours
included) over the profiled slice, the mean of the mesh's cards (each
card's value on standard error).  None where the program records no such
interval."""

import sys

from portbench import program_trace


def read(t):
    by_card = program_trace.interval_ms_a_call("exchange", "soda.mesh.call")
    if not by_card:
        return None
    print(f"exchange_ms.mesh by card: {by_card}", file=sys.stderr, flush=True)
    return sum(by_card.values()) / len(by_card)
