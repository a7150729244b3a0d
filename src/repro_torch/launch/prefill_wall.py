"""Wall time of a full-width prefill, and an alternating A/B of it between
two source trees of the port.

    python src/repro_torch/launch/prefill_wall.py --arch recurrentgemma-9b \
        --batch 4 --seq 48 --reps 10
    python src/repro_torch/launch/prefill_wall.py --ab OLD/src NEW/src --pairs 10

The first form builds one engine with random weights (seed 0) at the
config's full width, runs two prefills to warm it up, then times `reps`
prefills one at a time, each synchronized, and prints one JSON line: per
prefill the wall ms and the ms of CPU time this thread spent in it, the
host microseconds of one call of B4's wrapper at the prefill's shape
(none for a model without B4) and the `repro_torch` package it imported.
`--src` names the tree whose `repro_torch` is imported (default: the one
holding this file).

The second form runs the first once per sample set in a fresh process,
alternately from the two trees: pair i runs A then B for even i and B
then A for odd i, so a drift in the host over the run falls on both.  It
prints every run's line tagged with its tree, then per tree the median
of the runs' medians.  Two trees' `build/kernels/` are their own, so each
builds its kernels once.

A prefill of a served model is host-bound (PERF.md): where the wall
moves and the CPU time moves with it, the host ran the same Python
slower; where the wall moves alone, the thread waited on the device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE_SRC = Path(__file__).resolve().parents[2]


def time_prefills(arch: str, batch: int, seq: int, reps: int, device: str) -> dict:
    """One engine of `arch`, `reps` timed prefills of [batch, seq] tokens."""
    import torch

    import repro_torch
    from repro_torch.launch import serve

    eng = serve.build_engine(arch, kv_cache=True, device=device)
    cfg, api = eng.cfg, eng.api
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tokens = torch.randint(1, cfg.vocab_size, (batch, seq), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))

    def prefill():
        api.prefill(cfg, eng.params, {"tokens": tokens}, cache_len=seq)

    walls, cpus = [], []
    with torch.no_grad():
        for _ in range(2):
            prefill()
        sync()
        for _ in range(reps):
            w0, c0 = time.perf_counter(), time.thread_time()
            prefill()
            sync()
            walls.append((time.perf_counter() - w0) * 1e3)
            cpus.append((time.thread_time() - c0) * 1e3)
        wrapper_us = _b4_wrapper_us(torch, cfg, batch, seq, dev, sync)
    return {"arch": arch, "batch": batch, "seq": seq, "device": str(dev),
            "wall_ms": walls, "cpu_ms": cpus,
            "median_wall_ms": statistics.median(walls),
            "median_cpu_ms": statistics.median(cpus),
            "b4_wrapper_host_us": wrapper_us,
            "package": str(Path(repro_torch.__file__).parent)}


def _b4_wrapper_us(torch, cfg, batch, seq, dev, sync, calls=200):
    """Host microseconds of one call of B4's wrapper at the hybrid family's
    prefill shape, the device's work not waited for; None for the other
    families."""
    if cfg.family != "hybrid":
        return None
    from repro_torch.kernels import rglru_scan as k
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.rand(batch, seq, cfg.lru_width, device=dev, generator=g)
    b = torch.rand(batch, seq, cfg.lru_width, device=dev, generator=g)
    call = lambda: k.rglru_scan(a, b)                      # noqa: E731
    call()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    us = (time.perf_counter() - t0) * 1e6 / calls
    sync()
    return us


def run_ab(src_a: str, src_b: str, pairs: int, child_args: list[str]) -> dict:
    """Alternate fresh processes of the first form between two trees."""
    from repro_torch.launch.ab import alternate
    runs = alternate(Path(__file__).resolve(), src_a, src_b, pairs, child_args)
    summary = {tag: {"src": src, "median_of_medians_wall_ms":
                     statistics.median(r["median_wall_ms"] for r in runs[tag]),
                     "median_of_medians_cpu_ms":
                     statistics.median(r["median_cpu_ms"] for r in runs[tag])}
               for tag, src in (("A", src_a), ("B", src_b))}
    print(json.dumps({"summary": summary}))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="recurrentgemma-9b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=48)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--src", default=str(HERE_SRC),
                   help="source tree whose repro_torch is imported")
    p.add_argument("--ab", nargs=2, metavar=("SRC_A", "SRC_B"),
                   help="alternate fresh processes between two source trees")
    p.add_argument("--pairs", type=int, default=10)
    args = p.parse_args(argv)
    if args.ab:
        sys.path.insert(0, str(HERE_SRC))
        run_ab(*args.ab, args.pairs,
               ["--arch", args.arch, "--batch", str(args.batch), "--seq", str(args.seq),
                "--reps", str(args.reps), "--device", args.device])
        return 0
    sys.path.insert(0, os.path.abspath(args.src))
    print(json.dumps(time_prefills(args.arch, args.batch, args.seq, args.reps, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
