"""The one general traffic generator: a closed loop with one caller.

The caller enqueues `block_sweeps` calls of the system under test back to
back, then synchronises every card the cell uses, and only then starts
the next block.  A call runs the configuration's `iterate` sweeps, so
`block_sweeps` counts calls.  The traffic's `feed` says what each call
takes as the program's first input:

    "state"   (the default) each call's output is the next call's input:
              the grid is made on the first card from the seed and stays
              on the cards throughout;
    "frames"  a ring of `frames` grids made on the first card in set-up,
              frame k from `inputs.frame_seed(seed, k)`; call k (counted
              from the first call of set-up) takes frame k mod `frames`,
              and no output is ever fed back, as a stream of new frames
              would be read.

The configuration's `fields`, made on the first card from the seed too,
are the program's other inputs, held fixed and passed on every call.

This is the only loop there is: a traffic file whose `loop` is not
"closed" or whose `callers` is not 1 is refused, not run as this one.

Set-up builds the system, makes the grid, runs the first call (the start
of the check) and `warm_blocks` blocks: the first holding nothing more,
the others as many grids as the check will hold.  The window then runs
blocks until `seconds` have passed; the rate is all the sweeps over all
the window's time, the tail is over every block.

Memory is read by card three times: the peak of set-up (the grid made and
laid out, the first call), the peak of the first warm block less the
start grid the check holds (what the traffic and the program hold by
themselves) and the peak to the window's close, beside the bytes the
check then holds.  `memory_peak_bytes` is the largest peak of all.

The check holds, by reference and without a copy, the output of the first
call (its input is made again from the seed alone), the input and output
of one call in each of `sampled_blocks` blocks drawn from the seed (a
reservoir over the window's blocks, so the draw covers the whole window
however long it is) and, with `last`, the window's last call: under the
frame feed each input is that call's frame.  Once the window has closed
and the peak memory has been read, the system's own buffers are freed and
check.py judges each.

With `trace`, the window also holds one profiled slice of `profile_blocks`
blocks (after `skip_blocks`), `kernel_sample` calls timed alone on the
device (harness.device_ms, behind `kernel_sleeps` sleeps), and the host
clock around every other call (the enqueue).
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import math
import random
import time

import torch

from . import check, devtrace, harness, inputs

FEEDS = ("state", "frames")


@dataclasses.dataclass
class Trace:
    """What a `--trace 1` run measured; the layer readers read it."""
    cell: str
    cells: int
    sweeps_per_call: int
    roofline: dict
    peak: dict | None
    kernel_ms: float | None = None
    enqueue_ms: float | None = None
    busy_s: dict | None = None            # card -> s busy in the traced window
    window_s: float | None = None
    device_ops: list | None = None
    idle_gaps: list | None = None

    def idle_pct(self) -> dict | None:
        if not self.busy_s or not self.window_s:
            return None
        return {c: 100.0 * (1.0 - b / self.window_s) for c, b in self.busy_s.items()}


class Cell:
    """One cell's parts, found by name."""

    def __init__(self, bench: dict, name: str, *, grid=None, devices=None):
        self.workload = harness.find_cell(bench, name)
        self.name = name
        self.config = harness.load_json("configs", self.workload["config"])
        self.traffic = harness.load_json("traffic", self.workload["traffic"])
        self.reference = harness.load_module("reference", self.config["reference"])
        self.roofline = harness.load_json("roofline", self.config["roofline"])
        self.system_cls = harness.load_module("entries", self.config["entry"]).System
        for key, want in (("loop", "closed"), ("callers", 1)):
            if self.traffic.get(key) != want:
                raise ValueError(f"traffic {self.traffic['name']!r}: {key} "
                                 f"{self.traffic.get(key)!r}; loop.py runs only {key} {want!r}")
        if self.traffic["warm_blocks"] < 2:
            raise ValueError("warm_blocks: one block holding nothing, then at least one "
                             "holding the check's grids")
        self.feed = self.traffic.get("feed", "state")
        if self.feed not in FEEDS:
            raise ValueError(f"traffic {self.traffic['name']!r}: feed {self.feed!r}; "
                             f"loop.py feeds only {FEEDS}")
        self.frames = self.traffic.get("frames") if self.feed == "frames" else None
        if self.feed == "frames" and not (isinstance(self.frames, int) and self.frames >= 2):
            raise ValueError(f"traffic {self.traffic['name']!r}: frames {self.frames!r}; "
                             f"a ring of frames holds at least 2")
        self.inputs = inputs.Spec.of(self.config)
        self.fields = inputs.fields_of(self.config)
        self.grid = tuple(grid or self.config["grid"])
        self.devices = list(devices or [f"cuda:{i}" for i in range(self.config["chips"])])
        self.cells = math.prod(self.grid)


class Feed:
    """What each call takes as the program's first input: the last call's
    output (`ring` None, the state feed), or the next frame of `ring`."""

    def __init__(self, ring: list | None = None):
        self.ring = ring
        self.calls = 0

    def after(self, y):
        """The next call's input, once a call has returned `y`."""
        self.calls += 1
        return y if self.ring is None else self.ring[self.calls % len(self.ring)]


def _step(sut, feed: Feed, box: list, keep_last: bool) -> None:
    """One call of the profiled slice or the kernel sample: `box` holds the
    next input and the last (input, output) pair, and is updated in place."""
    y = sut.call(box[0])
    box[1] = (box[0], y) if keep_last else None
    box[0] = feed.after(y)


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def peaks(devices) -> dict:
    """The allocator's peak by card since its last reset."""
    return {str(d): torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"}


def held_bytes(states) -> dict:
    """Bytes by card of the distinct storages that `states` (tensors or
    sharded grids) keep alive."""
    seen, out = set(), collections.Counter()
    for state in states:
        if state is None:
            continue
        for t in (state.shards.values() if hasattr(state, "shards") else [state]):
            st = t.untyped_storage()
            if (str(t.device), st.data_ptr()) not in seen:
                seen.add((str(t.device), st.data_ptr()))
                out[str(t.device)] += st.nbytes()
    return dict(out)


def release(devices) -> None:
    """Free what nothing refers to any more (the collector, for any cycle
    that holds a buffer: the sharded fn holds none since it stopped calling
    itself, but a program may) and return the allocator's free cached blocks
    to the cards, so a large freed block is not split for the next,
    differently sized buffers."""
    gc.collect()
    if any(d.type == "cuda" for d in devices):
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, log) -> dict:
    """Set-up, the window and the check of one run; returns the numbers
    run.py prints."""
    from soda_tpu_torch.frontend.parser import parse_file

    def stamp(what: str) -> None:
        log(f"set-up: {what} at {time.perf_counter() - t_start:.3f} s")

    tr, cfg = cell.traffic, cell.config
    per_block = tr["block_sweeps"]
    stamp("imports done")
    program = parse_file(harness.program_path(cfg["program"]))
    if set(program.input_names[1:]) != set(cell.fields):
        raise ValueError(f"program {cfg['program']!r} reads {program.input_names}: the state "
                         f"{program.input_names[0]!r} and fields {program.input_names[1:]}, "
                         f"the config names fields {sorted(cell.fields)}")
    sut = cell.system_cls(program, cfg, cell.grid, cell.devices)
    stamp("system built")
    first = torch.device(cell.devices[0])
    cards = sut.devices
    if first.type == "cuda":
        torch.cuda.init()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)

    fields = {name: inputs.grid(cell.grid, inputs.field_seed(seed, name), spec, first)
              for name, spec in cell.fields.items()}
    if cell.frames:
        start_seed = inputs.frame_seed(seed, 0)
        feed = Feed([sut.load(inputs.grid(cell.grid, inputs.frame_seed(seed, k), cell.inputs,
                                          first), fields) for k in range(cell.frames)])
        x = feed.ring[0]
    else:
        start_seed = seed
        feed = Feed()
        x = sut.load(inputs.grid(cell.grid, seed, cell.inputs, first), fields)
    del fields
    sync(cards)
    release(cards)        # the grids as made, once laid out
    stamp("grid made and laid out" if feed.ring is None else f"{cell.frames} frames made")
    y = sut.call(x)                       # the first call, from the start seed's grid
    held = {"start": (None, y)}
    x = feed.after(y)
    del y
    sync(cards)
    release(cards)        # the first layout's buffers, which no later call uses
    stamp("first call")
    memory = {"set-up": peaks(cards)}
    on_cards = [d for d in cards if d.type == "cuda"]
    for d in on_cards:
        torch.cuda.reset_peak_memory_stats(d)
    # the first warm block holds nothing more: the traffic's own peak; the
    # others hold as many grids as the check will hold in the window, so
    # the allocator has cached every buffer the window needs
    for _ in range(per_block):
        x = feed.after(sut.call(x))
    sync(cards)
    start_bytes = held_bytes([held["start"][1]])
    memory["loop"] = {k: v - start_bytes.get(k, 0) for k, v in peaks(cards).items()}
    spare = collections.deque(maxlen=2 * tr["check"]["sampled_blocks"]
                              + int(tr["check"]["last"]))
    for _ in range((tr["warm_blocks"] - 1) * per_block):
        y = sut.call(x)
        if spare.maxlen:
            spare.append(y)
        x = feed.after(y)
    y = None
    sync(cards)
    spare.clear()
    stamp("warm blocks")

    rng = random.Random(f"portbench:{seed}")
    want = tr["check"]["sampled_blocks"]
    samples: list = []
    keep_last = tr["check"]["last"]
    last = None                           # the last call's (input, output)
    window = harness.Window()
    t_set = trace and tr["trace"]
    prof_at = tr["trace"]["skip_blocks"] if t_set else -1
    enq_s, enq_n = 0.0, 0
    tcell = Trace(cell.name, cell.cells, cfg["iterate"], cell.roofline, None)
    stages = {"profiled": not t_set or tr["trace"]["profile_blocks"] == 0,
              "sampled": not t_set or tr["trace"]["kernel_sample"] == 0 or first.type != "cuda"}
    setup_s = None
    b = 0
    while True:
        # which sweep of this block the check holds, drawn before it runs
        pick = None
        if want:
            j = b if b < want else rng.randrange(b + 1)
            if j < want:
                pick = (j, rng.randrange(per_block))
                if j < len(samples):
                    samples[j] = None      # freed before the new pair exists
        if b == prof_at:
            box = [x, last]
            x = last = None       # the slice holds the only references
            got = _profiled(sut, feed, box, tr["trace"]["profile_blocks"], per_block, cards,
                            keep_last, log)
            x, last = box
            del box
            for k in ("busy_s", "window_s", "device_ops", "idle_gaps"):
                setattr(tcell, k, got.get(k))
            stages["profiled"] = True
        t0 = time.perf_counter()
        if setup_s is None:
            setup_s = t0 - t_start
        for s in range(per_block):
            if t_set:
                e0 = time.perf_counter()
                y = sut.call(x)
                enq_s += time.perf_counter() - e0
                enq_n += 1
            else:
                y = sut.call(x)
            if pick and s == pick[1]:
                pair = (x, y)
            if keep_last:
                last = (x, y)
            x = feed.after(y)
        y = None
        sync(cards)
        t1 = time.perf_counter()
        window.add(t0, t1, per_block)
        if pick:
            if pick[0] < len(samples):
                samples[pick[0]] = (b, pick[1]) + pair
            else:
                samples.append((b, pick[1]) + pair)
            del pair
        b += 1
        if stages["profiled"] and not stages["sampled"]:
            box = [x, last]
            x = last = None

            def one():
                box[1] = None     # only the input and the output live during a timed call
                _step(sut, feed, box, keep_last)

            gc.disable()          # no collection inside a timed call
            try:
                tcell.kernel_ms = harness.device_ms(one, tr["trace"]["kernel_sample"],
                                                    tr["trace"]["kernel_sleeps"], log=log)
            finally:
                gc.enable()
            x, last = box
            del box, one
            stages["sampled"] = True
        if t1 - window.start >= seconds and all(stages.values()):
            break
    if enq_n:
        tcell.enqueue_ms = enq_s * 1e3 / enq_n

    memory["window"] = peaks(cards)
    peak = max((max(memory["set-up"][k], v) for k, v in memory["window"].items()), default=0)
    counters = sut.counters()
    if keep_last:
        held["last"] = last
    for entry in samples:
        if entry is not None:
            held[f"block_{entry[0]}.{entry[1]}"] = entry[2:]
    memory["check holds"] = held_bytes(s for pair in held.values() for s in pair)
    log(f"memory by card, B: {memory}; memory_peak_bytes {peak}")
    del samples, last, x, feed            # the ring, but for the frames the check holds
    sut_planes = sut.planes
    sut.close()
    release(cards)        # the program's own buffers, before the reference runs
    checks = _judge(cell, seed, start_seed, held, sut_planes, first, log)
    return {"window": window, "setup_s": setup_s, "peak": peak, "checks": checks,
            "trace": tcell if trace else None, "cards": cards, "counters": counters,
            "memory": memory}


def _profiled(sut, feed: Feed, box: list, blocks: int, per_block: int, cards,
              keep_last: bool, log):
    """`blocks` blocks under one torch.profiler session (one a process:
    torch.profiler has been seen to drop kernel records over several), with
    spans around the window, each block and each synchronise only, so the
    host runs as it does untraced but for the profiler's own cost.  `box`
    holds the next input and the last (input, output) pair, and is updated
    in place."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_cuda = [d for d in cards if d.type == "cuda"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    sut.reset_counters()
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            for _ in range(blocks):
                with record_function("portbench.block"):
                    for _ in range(per_block):
                        _step(sut, feed, box, keep_last)
                    with record_function("portbench.sync"):
                        sync(cards)
    log(f"profiled {blocks} blocks, {blocks * per_block} calls; counters {sut.counters()}")
    red = devtrace.reduce(devtrace.export_events(prof), [d.index for d in on_cuda])
    if red is None:
        log("the profiler holds no device records: busy and idle not measured")
        return {}
    return red


def _judge(cell: Cell, seed: int, start_seed: int, held: dict, planes, device, log) -> dict:
    n0, shape = cell.grid[0], cell.grid[1:]
    chunk = cell.traffic["check"]["chunk_planes"]
    fields = {name: lambda a, b, name=name, spec=spec: inputs.planes(
                  cell.grid, inputs.field_seed(seed, name), a, b, spec, device)
              for name, spec in cell.fields.items()}
    out = {}
    for name, (src, dst) in held.items():
        if src is None:
            def get_src(a, b):
                return inputs.planes(cell.grid, start_seed, a, b, cell.inputs, device)
        else:
            def get_src(a, b, src=src):
                return planes(src, a, b, device)
        out[name] = check.compare_sweep(cell.reference, get_src,
                                        lambda a, b, dst=dst: planes(dst, a, b, device),
                                        n0, shape, chunk, cell.inputs.dtype, device, fields)
        log(f"check {name}: {out[name]['cells_off']} cells off of {cell.cells}, "
            f"widest gap {out[name]['max_gap']!r}")
    return out
