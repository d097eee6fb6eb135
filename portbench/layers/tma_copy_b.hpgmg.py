"""tma_copy_b.hpgmg: the mean bytes one TMA plane copy moves, over the
profiled slice: the program's counter of plane copies (`cuda.tma_copies()`,
each launch the copies its plan makes, every fed ring's planes in every
CTA, and their boxes' bytes) as bytes over copies.  For the same bytes,
larger boxes mean fewer copies to start and wait on, and a smaller share
of halo.  None where the program has no such counter, or the slice
recorded no copy."""

import sys


def read(t):
    try:
        from soda_tpu_torch.backend import cuda
    except ImportError:
        return None
    if not hasattr(cuda, "tma_copies"):
        return None
    got = cuda.tma_copies()
    print(f"program TMA copies since the profiled slice opened: {got}", file=sys.stderr,
          flush=True)
    if not got["copies"]:
        return None
    return got["bytes"] / got["copies"]
