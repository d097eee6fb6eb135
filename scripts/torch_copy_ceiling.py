"""The card's practical rate for one read and one write a cell.

    python3 scripts/torch_copy_ceiling.py

Times `y.copy_(x)` on float32 grids the size of kernel 1's benchmark cells
(512^3, and the mesh cell's 1026 x 1026 x 2048 shard) by CUDA events over
back-to-back copies, after a warm-up, and prints per grid the ms a copy,
the bytes it moves (one read and one write of every cell) over that time,
and that rate's share of the published 3.35 TB/s.  A stencil sweep that
reads every input cell once and writes every output cell once moves the
same bytes, so the copy's time is the least a sweep can take on this card
in practice, beside the published peak's bound.  No benchmark cell runs
this script.  Exits 2 without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys

PEAK_GBPS = 3350.0   # H100 SXM HBM3, published
GRIDS = ((512, 512, 512), (1026, 1026, 2048))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_copy_ceiling: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip() or torch.cuda.get_device_name(dev), flush=True)
    out = {}
    for shape in GRIDS:
        x = torch.randn(shape, device=dev)
        y = torch.empty_like(x)
        cells = x.numel()
        reps = max(5, int(2e10 // (8 * cells)))   # about 20 GB of traffic a turn
        for _ in range(3):
            y.copy_(x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        turns = []
        for _ in range(3):
            start.record()
            for _ in range(reps):
                y.copy_(x)
            end.record()
            end.synchronize()
            turns.append(start.elapsed_time(end) / reps)
        ms = min(turns)
        gbps = 8 * cells / (ms * 1e-3) / 1e9
        out["x".join(map(str, shape))] = {"ms": ms, "turns_ms": turns, "gb_per_s": gbps,
                                         "peak_share": gbps / PEAK_GBPS}
        print(f"copy {shape} f32: {ms:.4f} ms a copy (turns {', '.join(f'{t:.4f}' for t in turns)}), "
              f"{gbps:.1f} GB/s = {100 * gbps / PEAK_GBPS:.1f}% of {PEAK_GBPS:.0f}", flush=True)
        del x, y
        torch.cuda.empty_cache()
    print("JSON", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
