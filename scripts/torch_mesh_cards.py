#!/usr/bin/env python
"""The device mesh (`soda_tpu_torch/parallel/mesh.py`) across the visible
cards, timed, with the link between them measured.

    python3 scripts/torch_mesh_cards.py

It needs at least two visible cards and exits 2 with fewer: it never falls
back to one.  Run it on four H100s of one host (about 40 s once the
processes are up).

Timing across cards: a CUDA event times one card's stream only, so every
time here is the host clock around work that ends in
`torch.cuda.synchronize(d)` for every card d that holds a shard ("ms a
call"); "enqueue" is the host clock over the same calls before that
synchronisation (the single controller issues every shard's work from one
thread).  Shard i of a mesh sits on card i mod n (n the cards), as in
`scripts/torch_fuzz_mesh.py` and `entry.dryrun_multichip`.

1. The link: for every ordered pair of cards (and each card with itself,
   the floor of the method), `torch.cuda.can_device_access_peer`, the rate
   of a 1 GiB `copy_` (median of LINK_REPS) and the time of a 4 KiB copy
   (median of LATENCY_REPS; also by CUDA events on the source card's
   stream, where torch runs a copy between cards).  Without peer access torch stages a copy
   through the host, which would read near the pinned host link's rate.
2. `chip_smoke.py`'s mesh rows a-e (`MESH_ROWS`), each run with its shards
   across the cards beside the same mesh with every shard on the first
   card and the whole grid on the first card, in turns (whole, across,
   one card, whole); the gates of `chip_smoke.py` phase 17: launches equal
   the shards' group calls, bit for bit against the whole grid (outside
   `valid_rim()` where the row says so).
3. At size: jacobi3d 1024^3 on [2, 2] across the cards beside the whole
   grid on one card (bit for bit); the same grid laid out on the cards
   (`parallel/sharded.py`): `shard_grid` from pinned host memory and from
   the first card and `gather_grid` to the host and to the first card,
   s and GB/s, bytes by source, each round trip bit for bit; then
   resident, `ShardedGrid`s in and out, ten chained calls (ms a call,
   enqueue) beside the gathered call and the whole grid on one card, bit
   for bit against ten whole-grid sweeps.  jacobi2d 16384^2 x 8 on [4] at
   every cadence (1 bit for bit on the whole grid, the rest outside the
   rim), the measured fastest beside the mesh's default cadence and
   `choose_exchange_cadence`'s pick under the data sheet's NVLink and
   under this run's measured link; then resident at the default cadence,
   ten chained calls, the first bit for bit against the gathered call.
   `run_sharded` on numpy inputs (jacobi3d 512^3 on [2, 2]): the bytes by
   source show every shard copied from the host.
4. Host tiling over the mesh: jacobi3d 1024^3 under 2 GiB a card on [2, 2]
   across the cards (every tile's shards from the host to their own
   cards, the bytes by source printed), beside the same grid host-tiled on
   the first card alone under 2 GiB; each bit for bit against the whole
   grid computed on one card.
5. `entry.dryrun_multichip(n)` for n the cards, on its default devices,
   and `sodac jacobi3d.soda --grid-shape 512,512,512 --mesh 2,2 --run`
   with no `--device`.

Every line names the card and its power limit; the last lines give the
measured link as a `--link-model` spec.  Any failed gate exits 1.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LINK_BYTES = 2**30
LATENCY_BYTES = 4096
LINK_REPS = 5
LATENCY_REPS = 100
REPS = 10
RESIDENT_CALLS = 10   # chained calls with the grid on the cards
# NVIDIA's H100 SXM data sheet: 900 GB/s of NVLink 4 in all, 450 each way;
# the latency is the port's assumption before this script measured one
NVLINK_DATASHEET = (450.0, 5e-6)
BIG_3D = ("jacobi3d", (1024, 1024, 1024), (2, 2))
CADENCE_ROW = ("jacobi2d", (16384, 16384), (4,), (1, 2, 4, 8))
TILED = ("jacobi3d", (1024, 1024, 1024), (2, 2), 2 * 2**30)
FROM_HOST = ("jacobi3d", (512, 512, 512), (2, 2))     # run_sharded on numpy inputs
CLI = ["jacobi3d.soda", "--grid-shape", "512,512,512", "--mesh", "2,2", "--run"]


def log(*a) -> None:
    print(*a, flush=True)


def sync(cards) -> None:
    import torch

    for c in sorted(set(cards)):
        torch.cuda.synchronize(c)


def wall_ms(fn, reps: int, cards) -> float:
    """ms a call of `fn`, the host clock over `reps` calls that ends once
    every card in `cards` has finished."""
    sync(cards)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(cards)
    return (time.perf_counter() - t0) * 1e3 / reps


def enqueue_ms(fn, reps: int, cards) -> float:
    """ms a call the host takes to issue `fn`'s work, before it waits."""
    sync(cards)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    sync(cards)
    return host * 1e3 / reps


def link_phase(cards, card) -> dict:
    """The peer-copy matrix; returns the median rate (GB/s) and 4 KiB time
    (s) over the pairs of distinct positions."""
    import torch

    bufs = [torch.empty(LINK_BYTES // 4, dtype=torch.float32, device=c) for c in cards]
    for b in bufs:
        b.normal_()
    rates, lats = {}, {}
    for a, i in enumerate(cards):
        for b, j in enumerate(cards):
            src, dst = bufs[a], bufs[b] if a != b else torch.empty_like(bufs[a])
            peer = i == j or torch.cuda.can_device_access_peer(i, j)
            dst.copy_(src)
            times = []
            for _ in range(LINK_REPS):
                sync((i, j))
                t0 = time.perf_counter()
                dst.copy_(src)
                sync((i, j))
                times.append(time.perf_counter() - t0)
            small_src, small_dst = src[:LATENCY_BYTES // 4], dst[:LATENCY_BYTES // 4]
            small = []
            for _ in range(LATENCY_REPS):
                sync((i, j))
                t0 = time.perf_counter()
                small_dst.copy_(small_src)
                sync((i, j))
                small.append(time.perf_counter() - t0)
            # the same copy by CUDA events on the source card's stream, which
            # runs it after waiting for the destination's stream
            stream = torch.cuda.current_stream(i)
            on_card = []
            for _ in range(LATENCY_REPS):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record(stream)
                small_dst.copy_(small_src)
                end.record(stream)
                end.synchronize()
                on_card.append(start.elapsed_time(end) * 1e-3)
            if not torch.equal(dst[::4097].cpu(), src[::4097].cpu()):
                raise SystemExit(f"link cuda:{i} -> cuda:{j}: the copy differs")
            rate = LINK_BYTES / statistics.median(times) / 1e9
            lat = statistics.median(small)
            log(f"link cuda:{i} -> cuda:{j}: peer access {peer}; {LINK_BYTES} B in "
                f"{statistics.median(times) * 1e3:.4f} ms (median of {LINK_REPS}, "
                f"{[round(t * 1e3, 4) for t in times]}) = {rate:.1f} GB/s; "
                f"{LATENCY_BYTES} B in {lat * 1e6:.2f} us (median of {LATENCY_REPS}, "
                f"min {min(small) * 1e6:.2f}, max {max(small) * 1e6:.2f}), by events on "
                f"cuda:{i}'s stream {statistics.median(on_card) * 1e6:.2f} us; card {card}")
            if a != b:
                rates[(a, b)], lats[(a, b)] = rate, lat
    del bufs
    torch.cuda.empty_cache()
    if not rates:
        raise SystemExit("the link needs two positions")
    gbps, lat = statistics.median(rates.values()), statistics.median(lats.values())
    log(f"link between positions: median {gbps:.1f} GB/s (min {min(rates.values()):.1f}, "
        f"max {max(rates.values()):.1f}), median 4 KiB copy {lat * 1e6:.2f} us (min "
        f"{min(lats.values()) * 1e6:.2f}, max {max(lats.values()) * 1e6:.2f}); card {card}")
    return {"gbps": gbps, "latency_s": lat}


def run(cards: list[int]) -> int:
    """Every section over the cards `cards` (card indices; shard i on
    cards[i mod len(cards)]).  Returns the exit code."""
    import numpy as np
    import torch

    from chip_smoke import MESH_ROWS, bitwise_equal, device_inputs
    from soda_tpu_torch import entry as entry_points
    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.cli import sodac
    from soda_tpu_torch.frontend.parser import parse_file
    from soda_tpu_torch.parallel import host_tile, mesh
    from soda_tpu_torch.parallel.sharded import gather_grid, shard_grid
    from soda_tpu_torch.plan.planner import plan
    from soda_tpu_torch.utils.report import card as card_info
    from soda_tpu_torch.utils.testing import CORPUS

    t_start = time.perf_counter()
    card = card_info()
    dev0 = torch.device("cuda", cards[0])
    smi = shutil.which("nvidia-smi")
    every = (subprocess.run([smi, "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
             if smi else "not measured")
    log(f"cards {cards}: {[torch.cuda.get_device_name(c) for c in sorted(set(cards))]}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi index, name, "
        f"power.limit: {' | '.join(every.splitlines())}")

    def across(n: int) -> list:
        return [torch.device("cuda", cards[i % len(cards)]) for i in range(n)]

    programs = {n: parse_file(CORPUS / f"{n}.soda")
                for n in {r[1] for r in MESH_ROWS} | {"jacobi3d", "jacobi2d", "jacobi2d_i64"}}

    # every mesh and whole grid below, planned now and built in parallel
    rows = []          # (row, program, shape, sizes, names, dims, run, layout, fn)
    kernels = {}

    def add(p, the_plan):
        for g in the_plan.groups:
            k = cuda.group_kernel(p, g)
            kernels[k.source] = k

    def sharded(p, shape, sizes, names=None, dims=None, devices=None, **kw):
        fn = mesh.build_sharded_fn(p, mesh.make_mesh(sizes, names, devices or across(
            math.prod(sizes))), grid_shape=shape, dims=dims, **kw)
        for pl in fn.local_plans().values():
            add(p, pl)
        return fn

    for row, n, shape, sizes, names, dims, runs in MESH_ROWS:
        p = programs[n]
        add(p, plan(p, shape))
        for cadence, overlap, exact in runs:
            for layout, devices in (("across", None), ("one card", [dev0] * math.prod(sizes))):
                rows.append((row, p, shape, sizes, names, dims, (cadence, overlap, exact),
                             layout, sharded(p, shape, sizes, names, dims, devices,
                                             sweeps_per_exchange=cadence, overlap=overlap)))
    n, big_shape, big_sizes = BIG_3D
    big_fn = sharded(programs[n], big_shape, big_sizes)
    add(programs[n], plan(programs[n], big_shape))
    n, cad_shape, cad_sizes, cadences = CADENCE_ROW
    cad_fns = {c: sharded(programs[n], cad_shape, cad_sizes, sweeps_per_exchange=c)
               for c in (*cadences, None)}
    add(programs[n], plan(programs[n], cad_shape))
    n, tiled_shape, tiled_sizes, budget = TILED
    p = programs[n]
    tiled_mesh = mesh.make_mesh(tiled_sizes, None, across(math.prod(tiled_sizes)))
    tiles_mesh = host_tile.choose_host_tiles(p, tiled_shape, budget, 1, mesh_shape=tiled_sizes)
    tiles_one = host_tile.choose_host_tiles(p, tiled_shape, budget, 1)
    for tiles in (tiles_mesh, tiles_one):
        ext = host_tile.plan_host_tiling(p, tiled_shape, tiles, 1)[2]
        win = tuple(min(e, g) for e, g in zip(ext, tiled_shape))
        if tiles is tiles_mesh:
            sharded(p, win, tiled_sizes, iterate=1)
        else:
            add(p, plan(p, win))
    for cfg in entry_points.dryrun_configs(len(cards)):
        sharded(cfg["program"], cfg["grid"], cfg["sizes"], cfg["names"], cfg["dims"],
                iterate=entry_points.DRYRUN_ITERATE, sweeps_per_exchange=1)
        add(cfg["program"], plan(cfg["program"], cfg["grid"], iterate=entry_points.DRYRUN_ITERATE))
    sharded(programs["jacobi3d"], (512, 512, 512), (2, 2))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(len(kernels), 32)) as pool:
        list(pool.map(lambda k: k.build(), kernels.values()))
    log(f"build: {len(kernels)} kernels in {time.perf_counter() - t0:.1f} s wall")

    # ---- 1. the link ----------------------------------------------------------
    link = link_phase(cards, card)

    # ---- 2. rows a-e across the cards, on one card, and whole ------------------
    gen = torch.Generator(device=dev0).manual_seed(0)
    current = None     # the row whose inputs and whole grid are on cuda:0
    for row, p, shape, sizes, names, dims, (cadence, overlap, exact), layout, fn in rows:
        if row != current:
            current, ins, whole_fn, whole = row, None, None, None
            torch.cuda.empty_cache()
            ins = device_inputs(p, shape, gen, dev0)
            whole_fn = cuda.build_fn(p, grid_shape=shape)
            whole = whole_fn(ins, {})
        cuda.reset_launches()
        got = fn(ins, {})
        sync(cards)
        launched = sum(cuda.launch_counts().values())
        calls = fn.stats["group_calls"]
        rim = 0 if exact else p.valid_rim()
        inner = tuple(slice(rim, d - rim) for d in shape)
        ok = launched == calls > 0 and bitwise_equal(
            {k: v[inner].contiguous() for k, v in got.items()},
            {k: whole[k][inner].contiguous() for k in got})
        del got
        w0 = wall_ms(lambda: whole_fn(ins, {}), REPS, cards)
        ms = wall_ms(lambda: fn(ins, {}), REPS, cards)
        enq = enqueue_ms(lambda: fn(ins, {}), REPS, cards)
        w1 = wall_ms(lambda: whole_fn(ins, {}), REPS, cards)
        log(f"mesh {row} {p.name} {shape} over {'x'.join(map(str, sizes))}"
            f"{' ' + ','.join(names) if names else ''} {layout}, cadence "
            f"{fn.sweeps_per_exchange}, {'overlap' if overlap else 'sync'}: shards of "
            f"{'x'.join(map(str, fn.shard_shape))}; launches {launched}/{calls}; "
            f"{'bit for bit' if ok else 'MISMATCH'} against the whole grid"
            f"{'' if exact else f' outside the rim {rim}'}; {fn.stats['exchange_bytes']} B "
            f"exchanged a call, into the shards by source {fn.stats['scatter_from']}, "
            f"{fn.stats['gather_bytes']} B gathered; {ms:.4f} ms a call, enqueue {enq:.4f}; whole grid on "
            f"cuda:{cards[0]} {w0:.4f} / {w1:.4f}; card {card}")
        if not ok:
            log(f"FAILED mesh row {row} {layout}")
            return 1
    del ins, whole_fn, whole
    rows.clear()
    torch.cuda.empty_cache()

    # ---- 3. at size -------------------------------------------------------------
    n, shape, sizes = BIG_3D
    p = programs[n]
    x = {"t0": torch.randn(shape, generator=gen, device=dev0)}
    whole_fn = cuda.build_fn(p, grid_shape=shape)
    whole = whole_fn(x, {})
    cuda.reset_launches()
    got = big_fn(x, {})
    sync(cards)
    launched = sum(cuda.launch_counts().values())
    ok = launched == big_fn.stats["group_calls"] > 0 and bitwise_equal(got, whole)
    del got
    w0 = wall_ms(lambda: whole_fn(x, {}), 5, cards)
    ms = wall_ms(lambda: big_fn(x, {}), 5, cards)
    enq = enqueue_ms(lambda: big_fn(x, {}), 5, cards)
    w1 = wall_ms(lambda: whole_fn(x, {}), 5, cards)
    log(f"at size {n} {shape} over {'x'.join(map(str, sizes))} across {cards}: shards of "
        f"{'x'.join(map(str, big_fn.shard_shape))}; launches {launched}/"
        f"{big_fn.stats['group_calls']}; {'bit for bit' if ok else 'MISMATCH'} against the "
        f"whole grid; {big_fn.stats['exchange_bytes']} B exchanged; {ms:.4f} ms a call "
        f"(scatter, exchange, kernels, gather), enqueue {enq:.4f}; whole grid on cuda:"
        f"{cards[0]} {w0:.4f} / {w1:.4f}; card {card}")
    if not ok:
        log(f"FAILED at size {n}")
        return 1

    # the grid laid out on the cards, from the host and from the first card,
    # and back; each twice (the first call pays for pinned host memory)
    m, dims = big_fn.mesh, big_fn.dims
    nbytes = x["t0"].numel() * x["t0"].element_size()
    x_pin = torch.empty(shape, dtype=x["t0"].dtype, pin_memory=True)
    x_pin.copy_(x["t0"])

    def timed_copy(copy):
        moved = {}
        sync(cards)
        t0 = time.perf_counter()
        out = copy(moved)
        sync(cards)
        return out, time.perf_counter() - t0, moved

    for label, src in (("pinned host memory", x_pin), (f"cuda:{cards[0]}", x["t0"])):
        for rep in (1, 2):
            g, sec, moved = timed_copy(lambda st: shard_grid(src, m, dims, stats=st))
            same = torch.equal(gather_grid(g, dev0).view(torch.int32), x["t0"].view(torch.int32))
            log(f"layout: shard_grid of {n} {shape} from {label} onto "
                f"{'x'.join(map(str, sizes))} across {cards}, call {rep}: {sec:.4f} s, "
                f"{nbytes / sec / 1e9:.1f} GB/s; into the shards by source "
                f"{moved['scatter_from']}; {'bit for bit' if same else 'MISMATCH'} gathered "
                f"back; card {card}")
            if not same:
                log("FAILED shard_grid")
                return 1
    for label, to, want in (("the host", "cpu", x_pin), (f"cuda:{cards[0]}", dev0, x["t0"])):
        for rep in (1, 2):
            back, sec, moved = timed_copy(lambda st: gather_grid(g, to, stats=st))
            same = torch.equal(back.view(torch.int32), want.view(torch.int32))
            log(f"layout: gather_grid of {n} {shape} from {'x'.join(map(str, sizes))} across "
                f"{cards} to {label}, call {rep}: {sec:.4f} s, {nbytes / sec / 1e9:.1f} GB/s; "
                f"{moved['gather_bytes']} B; {'bit for bit' if same else 'MISMATCH'}; "
                f"card {card}")
            del back
            if not same:
                log("FAILED gather_grid")
                return 1
    del g, x_pin

    # resident: ShardedGrids in and out, the grid on the cards between calls
    g = {"t0": shard_grid(x["t0"], m, dims)}
    cuda.reset_launches()
    first = big_fn(g, {})
    sync(cards)
    launched = sum(cuda.launch_counts().values())
    ok = (launched == big_fn.stats["group_calls"] > 0
          and big_fn.stats["scatter_bytes"] == big_fn.stats["gather_bytes"] == 0
          and bitwise_equal({"t1": gather_grid(first["t1"], dev0)}, whole))
    del first
    want = x["t0"]
    for _ in range(RESIDENT_CALLS):
        want = whole_fn({"t0": want}, {})["t1"]
    sync(cards)
    t0 = time.perf_counter()
    for _ in range(RESIDENT_CALLS):
        g = {"t0": big_fn(g, {})["t1"]}
    sync(cards)
    res_ms = (time.perf_counter() - t0) * 1e3 / RESIDENT_CALLS
    chain_ok = torch.equal(gather_grid(g["t0"], dev0).view(torch.int32), want.view(torch.int32))
    del want
    t0 = time.perf_counter()
    for _ in range(RESIDENT_CALLS):
        g = {"t0": big_fn(g, {})["t1"]}
    res_enq = (time.perf_counter() - t0) * 1e3 / RESIDENT_CALLS
    sync(cards)
    w2 = wall_ms(lambda: whole_fn(x, {}), 5, cards)
    log(f"resident {n} {shape} over {'x'.join(map(str, sizes))} across {cards}: ShardedGrids "
        f"in and out; launches {launched}/{big_fn.stats['group_calls']}; "
        f"{big_fn.stats['scatter_bytes'] + big_fn.stats['gather_bytes']} B scattered and "
        f"gathered; the first call {'bit for bit' if ok else 'MISMATCH'} against the whole "
        f"grid; {RESIDENT_CALLS} chained calls {res_ms:.4f} ms a call, enqueue {res_enq:.4f}, "
        f"{'bit for bit' if chain_ok else 'MISMATCH'} against {RESIDENT_CALLS} whole-grid "
        f"sweeps; {big_fn.stats['exchange_bytes']} B exchanged a call; the gathered call "
        f"{ms:.4f}; whole grid on cuda:{cards[0]} {w0:.4f} / {w1:.4f} / {w2:.4f}; card {card}")
    if not (ok and chain_ok):
        log(f"FAILED resident {n}")
        return 1
    del g, x, whole, whole_fn
    torch.cuda.empty_cache()

    n, shape, sizes, cadences = CADENCE_ROW
    p = programs[n]
    it = max(p.iterate, 1)
    x = {"t0": torch.randn(shape, generator=gen, device=dev0)}
    whole_fn = cuda.build_fn(p, grid_shape=shape)
    whole = whole_fn(x, {})
    timed = {}
    for c, fn in cad_fns.items():
        cuda.reset_launches()
        got = fn(x, {})
        sync(cards)
        launched = sum(cuda.launch_counts().values())
        rim = 0 if c == 1 else p.valid_rim()
        inner = tuple(slice(rim, d - rim) for d in shape)
        ok = launched == fn.stats["group_calls"] > 0 and bitwise_equal(
            {"t1": got["t1"][inner].contiguous()}, {"t1": whole["t1"][inner].contiguous()})
        del got
        ms = wall_ms(lambda: fn(x, {}), REPS, cards)
        enq = enqueue_ms(lambda: fn(x, {}), REPS, cards)
        if c is not None:
            timed[c] = ms
        else:
            default_ms = ms
        log(f"cadence {n} {shape} x {it} over {'x'.join(map(str, sizes))} across {cards}: "
            f"asked {c or 'default'}, ran {fn.sweeps_per_exchange}; launches {launched}/"
            f"{fn.stats['group_calls']}; {'bit for bit' if ok else 'MISMATCH'} against the "
            f"whole grid{f' outside the rim {rim}' if rim else ''}; "
            f"{fn.stats['exchange_bytes']} B exchanged; {ms:.4f} ms a call, enqueue "
            f"{enq:.4f}; card {card}")
        if not ok:
            log(f"FAILED cadence {c}")
            return 1
    w = wall_ms(lambda: whole_fn(x, {}), REPS, cards)
    m4 = mesh.make_mesh(sizes, None, across(math.prod(sizes)))
    saved = mesh.LINK_MODEL[mesh.FAST_LINK]
    picks = {}
    try:
        for name, const in (("data sheet", NVLINK_DATASHEET),
                            ("measured", (link["gbps"], link["latency_s"]))):
            mesh.LINK_MODEL[mesh.FAST_LINK] = const
            picks[name] = mesh.choose_exchange_cadence(
                p, shape, m4, (0,), it, {m4.axis_names[0]: mesh.FAST_LINK})[m4.axis_names[0]]
    finally:
        mesh.LINK_MODEL[mesh.FAST_LINK] = saved
    fastest = min(timed, key=timed.get)
    log(f"cadence {n} {shape} x {it}: measured fastest {fastest} ({timed[fastest]:.4f} ms); "
        f"the mesh's default {cad_fns[None].sweeps_per_exchange}; choose_exchange_cadence "
        f"under the data sheet {NVLINK_DATASHEET} picks {picks['data sheet']}, under the "
        f"measured ({link['gbps']:.1f}, {link['latency_s']:.3g}) picks {picks['measured']}; "
        f"whole grid on cuda:{cards[0]} {w:.4f} ms; card {card}")
    # resident at the default cadence
    fn = cad_fns[None]
    gathered = fn(x, {})
    g = {"t0": shard_grid(x["t0"], fn.mesh, fn.dims)}
    cuda.reset_launches()
    first = fn(g, {})
    sync(cards)
    launched = sum(cuda.launch_counts().values())
    ok = (launched == fn.stats["group_calls"] > 0
          and fn.stats["scatter_bytes"] == fn.stats["gather_bytes"] == 0
          and bitwise_equal({"t1": gather_grid(first["t1"], dev0)}, gathered))
    del first, gathered
    sync(cards)
    t0 = time.perf_counter()
    for _ in range(RESIDENT_CALLS):
        g = {"t0": fn(g, {})["t1"]}
    sync(cards)
    res_ms = (time.perf_counter() - t0) * 1e3 / RESIDENT_CALLS
    t0 = time.perf_counter()
    for _ in range(RESIDENT_CALLS):
        g = {"t0": fn(g, {})["t1"]}
    res_enq = (time.perf_counter() - t0) * 1e3 / RESIDENT_CALLS
    sync(cards)
    log(f"resident {n} {shape} x {it} over {'x'.join(map(str, sizes))} across {cards}, "
        f"cadence {fn.sweeps_per_exchange}: ShardedGrids in and out; launches {launched}/"
        f"{fn.stats['group_calls']}; the first call {'bit for bit' if ok else 'MISMATCH'} "
        f"against the gathered call; {RESIDENT_CALLS} chained calls {res_ms:.4f} ms a call, "
        f"enqueue {res_enq:.4f}; the gathered call {default_ms:.4f}; whole grid on cuda:"
        f"{cards[0]} {w:.4f}; card {card}")
    if not ok:
        log(f"FAILED resident {n}")
        return 1
    del g, x, whole, whole_fn, cad_fns
    torch.cuda.empty_cache()

    # run_sharded on numpy inputs: every shard from the host to its own card
    n, shape, sizes = FROM_HOST
    p = programs[n]
    x_host = {"t0": torch.randn(shape, generator=gen, device=dev0).cpu().numpy()}
    whole = cuda.run(p, x_host, {}, device=dev0)
    st = {}
    sync(cards)
    t0 = time.perf_counter()
    got = mesh.run_sharded(p, x_host, {}, mesh=mesh.make_mesh(sizes, None, across(
        math.prod(sizes))), stats=st)
    sync(cards)
    sec = time.perf_counter() - t0
    ok = bitwise_equal(got, whole) and set(st["scatter_from"]) == {"cpu"}
    log(f"run_sharded {n} {shape} from numpy over {'x'.join(map(str, sizes))} across {cards}: "
        f"into the shards by source {st['scatter_from']}; {st['gather_bytes']} B gathered "
        f"onto cuda:{cards[0]}; {st['exchange_bytes']} B exchanged; "
        f"{'bit for bit' if ok else 'MISMATCH'} against the whole grid; {sec:.3f} s with the "
        f"host's copies; card {card}")
    if not ok:
        log(f"FAILED run_sharded from numpy {n}")
        return 1
    del got, whole, x_host

    # ---- 4. host tiling over the mesh ----------------------------------------------
    n, shape, sizes, budget = TILED
    p = programs[n]
    x = torch.randn(shape, generator=gen, device=dev0)
    whole = cuda.run(p, {"t0": x}, {}, device=dev0)["t1"].cpu().numpy()
    x_host = {"t0": x.cpu().numpy()}
    del x
    torch.cuda.empty_cache()
    for label, tiles, m in (("over the mesh", tiles_mesh, tiled_mesh),
                            (f"on cuda:{cards[0]} alone", tiles_one, None)):
        st = {}
        cuda.reset_launches()
        got = host_tile.run_host_tiled(p, x_host, tiles=tiles, sweeps_per_pass=1, mesh=m,
                                       device=dev0, stats=st)["t1"]
        launched = sum(cuda.launch_counts().values())
        same = np.array_equal(got.view(np.uint32), whole.view(np.uint32))
        calls = st["mesh_group_calls"] if m else launched
        ok = same and launched == calls > 0
        where = f" on {sorted({str(d) for d in m.devices.flat})}" if m else ""
        log(f"host tiled {n} {shape} {label}: {'x'.join(map(str, st['n_tiles']))} tiles of "
            f"{'x'.join(map(str, tiles))} under {budget} B a device{where}; launches "
            f"{launched}/{calls}; "
            f"{st['mesh_exchange_bytes']} B exchanged; {st['h2d_bytes']} B to the cards "
            f"(by source {st.get('scatter_from', {'cpu': st['h2d_bytes']})}) "
            f"and {st['d2h_bytes']} back; {'bit for bit' if same else 'MISMATCH'} against "
            f"the whole grid; {sum(st['pass_seconds']):.3f} s a pass (the host: staging "
            f"{st['stage_seconds']:.3f}, waiting {st['wait_seconds']:.3f}, stitching "
            f"{st['stitch_seconds']:.3f}); card {card}")
        if not ok:
            log(f"FAILED host tiling {label}")
            return 1
        del got
    del whole, x_host

    # ---- 5. the entry point and the CLI -------------------------------------------------
    t0 = time.perf_counter()
    ran = entry_points.dryrun_multichip(len(cards))
    log(f"entry: dryrun_multichip({len(cards)}) passed in {time.perf_counter() - t0:.2f} s: "
        f"{json.dumps(ran)}")
    buf = io.StringIO()
    cuda.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = sodac.main([str(CORPUS / CLI[0]), *CLI[1:]])
    sync(cards)
    launched = sum(cuda.launch_counts().values())
    last = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("mesh:", "executed", "OK", "MISMATCH"))]
    log(f"cli: sodac {' '.join(CLI)}: rc {rc}, kernel launches {launched}; " + " | ".join(last))
    if rc != 0 or launched < 1 or "OK" not in last:
        log("FAILED the CLI")
        return 1

    log(f"link model measured: --link-model '{mesh.FAST_LINK}={link['gbps']:.1f}:"
        f"{link['latency_s']:.3g}' (data sheet {NVLINK_DATASHEET}); card {card}")
    log(f"torch_mesh_cards: every section passed in {time.perf_counter() - t_start:.1f} s")
    return 0


def main() -> int:
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        print(f"torch_mesh_cards: needs at least two visible cards, torch sees {count}",
              file=sys.stderr)
        return 2
    return run(list(range(count)))


if __name__ == "__main__":
    raise SystemExit(main())
