"""Kernel B2's times at chip_smoke.py's rows, and an alternating A/B of
them between two source trees of the port.

    python src/repro_torch/launch/cost_batch_ab.py [--src SRC]
    python src/repro_torch/launch/cost_batch_ab.py --ab OLD/src NEW/src --pairs 10

The first form imports `repro_torch` from `--src` (default: the tree
holding this file) and runs `chip_smoke.time_cost_batch` and
`chip_smoke.time_simulate_batch` with it (the chip_smoke.py beside this
file): B2 at m = 10⁶ with per-query inputs (f32, f64) and at
simulate_batch's own operands (f64: the prefill's and the KV-on decode
probe's), L2 flushed before each launch, beside the plain version, the
profiler's kernel duration and the bound; the wrapper's host time a call
at simulate_batch's operands; simulate_batch over 10⁶ queries, its
per-call wall over 30 calls (with the garbage collector on and off)
beside its costliest host operations; then its mean wall over 10 calls
and B2's share of the device's busy time.  A tree whose wrapper
launches more than B2 a call is timed all the same.  It prints one JSON
line.

The second form runs the first in a fresh process per sample set,
alternately from the two trees (`launch/ab.py`): pair i runs A then B for
even i and B then A for odd i.  It prints every run's line tagged with its
tree, then per tree the median of each row's times, and per pair B's
simulate_batch wall, busy time and per-call median walls less A's.  Each tree builds its
own kernels into its own `build/kernels/`.  Compare only runs of one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

HERE_SRC = Path(__file__).resolve().parents[2]
ROOT = HERE_SRC.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card(cs) -> dict:
    import torch
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi()}


def wrapper_host_us(torch, kcb, cs, calls=200) -> dict:
    """Host microseconds a pass_surface call at simulate_batch's operands
    (llama2-7b, m = 10⁶, f64; the prefill's and the KV-on probe's), over
    `calls` calls enqueued back to back: the wrapper's own work, since the
    device runs behind."""
    import time

    from repro_torch.configs import get_config
    cfg = get_config("llama2-7b")
    tin = torch.as_tensor(cs.synthetic_queries(10**6)[0], dtype=torch.float64, device="cuda")
    batch = torch.full((), cs.ANALYTIC_BATCH, dtype=torch.float64, device="cuda")
    out = {}
    for key, ops, decode in (("prefill", (tin, tin, batch), False),
                             ("decode probe", (tin.new_ones(()), tin + 0.5, batch), True)):
        kcb.pass_surface(cfg, *ops, decode=decode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            kcb.pass_surface(cfg, *ops, decode=decode)
        out[key] = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
    return out


def _cpu() -> int:
    """The CPU this process last ran on (field 39 of /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


def simulate_walls(torch, kcb, cs, calls=30, top=12) -> dict:
    """simulate_batch (llama2-7b, batch 32, 10⁶ synthetic queries, KV on
    and off) called `calls` times one at a time: the quartiles and mean of
    the per-call wall in ms, with Python's garbage collector on and off,
    and for each call its wall, the process's minor page faults and the
    device allocator's new segments (cudaMalloc calls) in it, and the CPU
    it ended on; and
    the host ms a call of the profiler's `top` costliest CPU-side
    operations (self time, over 5 calls)."""
    import gc
    import resource
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import PAPER_ZOO
    from repro_torch.energy import AnalyticLLMSimulator
    tin, tout = cs.synthetic_queries(cs.SYNTHETIC_QUERIES)
    out = {}
    for kv in (True, False):
        sim = AnalyticLLMSimulator(PAPER_ZOO["llama2-7b"], batch=cs.ANALYTIC_BATCH,
                                   kv_cache=kv, noise_sigma=0.0)
        rec = {}
        for mode in ("gc on", "gc off"):
            kcb.simulate_batch(sim, tin, tout)
            if mode == "gc off":
                gc.collect()
                gc.disable()
            walls, faults, mallocs, cpus = [], [], [], []
            for _ in range(calls):
                f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
                m0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
                t0 = time.perf_counter()
                kcb.simulate_batch(sim, tin, tout)
                walls.append((time.perf_counter() - t0) * 1e3)
                faults.append(resource.getrusage(resource.RUSAGE_SELF).ru_minflt - f0)
                mallocs.append(torch.cuda.memory_stats().get("segment.all.allocated", 0) - m0)
                cpus.append(_cpu())
            gc.enable()
            q = statistics.quantiles(walls, n=4)
            rec[mode] = {"q1": q[0], "median": q[1], "q3": q[2],
                         "mean": statistics.fmean(walls), "calls_ms": walls,
                         "minor_faults": faults, "device_mallocs": mallocs, "cpu": cpus}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kcb.simulate_batch(sim, tin, tout)
        ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)[:top]
        rec["host_ops_ms"] = {e.key: e.self_cpu_time_total / 1e3 / 5 for e in ops}
        out[f"KV-{'on' if kv else 'off'}"] = rec
    return out


def time_b2() -> dict:
    """The imported tree's B2 at time_cost_batch's rows, the wrapper's host
    time, and simulate_batch."""
    import torch

    import repro_torch
    from repro_torch.kernels import cost_batch as kcb

    cs = _chip_smoke()
    rows = cs.time_cost_batch(torch, kcb, one_kernel=False)
    host = wrapper_host_us(torch, kcb, cs)
    walls = simulate_walls(torch, kcb, cs)
    sim = cs.time_simulate_batch(torch, kcb)
    return {**_card(cs), "rows": rows, "host_us": host, "simulate_batch": sim,
            "walls": walls, "package": str(Path(repro_torch.__file__).parent)}


def run_ab(src_a: str, src_b: str, pairs: int) -> dict:
    from repro_torch.launch.ab import alternate
    runs = alternate(Path(__file__).resolve(), src_a, src_b, pairs)
    summary = {}
    for tag, src in (("A", src_a), ("B", src_b)):
        recs = runs[tag]
        rows = {key: {f: statistics.median(r["rows"][key][f] for r in recs)
                      for f in ("ms", "plain_ms", "bound_ms")}
                for key in recs[0]["rows"]}
        sims = {label: {f: statistics.median(r["simulate_batch"][label][f] for r in recs)
                        for f in ("wall_ms", "busy_ms", "kernel_ms", "kernel_share")}
                for label, v in recs[0]["simulate_batch"].items() if v}
        host = {key: statistics.median(r["host_us"][key] for r in recs)
                for key in recs[0]["host_us"]}
        walls = {kv: {mode: {f: statistics.median(r["walls"][kv][mode][f] for r in recs)
                            for f in ("median", "mean")}
                      for mode in ("gc on", "gc off")}
                 for kv in recs[0]["walls"]}
        summary[tag] = {"src": src, "rows": rows, "host_us": host, "simulate_batch": sims,
                        "walls": walls}
    # pair by pair: B's simulate_batch less A's, and the pairs where B was slower
    paired = {}
    for label, v in runs["A"][0]["simulate_batch"].items():
        if not v:
            continue
        paired[label] = {}
        for f in ("wall_ms", "busy_ms"):
            d = [b["simulate_batch"][label][f] - a["simulate_batch"][label][f]
                 for a, b in zip(runs["A"], runs["B"])]
            paired[label][f] = {"b_minus_a": d, "median": statistics.median(d),
                                "b_slower": sum(x > 0 for x in d), "pairs": len(d)}
    for kv in runs["A"][0]["walls"]:
        for mode in ("gc on", "gc off"):
            for f in ("median", "mean"):
                d = [b["walls"][kv][mode][f] - a["walls"][kv][mode][f]
                     for a, b in zip(runs["A"], runs["B"])]
                paired[f"per-call {f} {kv} {mode}"] = {
                    "b_minus_a": d, "median": statistics.median(d),
                    "b_slower": sum(x > 0 for x in d), "pairs": len(d)}
    summary["paired"] = paired
    print(json.dumps({"summary": summary}))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", default=str(HERE_SRC),
                   help="source tree whose repro_torch is imported")
    p.add_argument("--ab", nargs=2, metavar=("SRC_A", "SRC_B"),
                   help="alternate fresh processes between two source trees")
    p.add_argument("--pairs", type=int, default=10)
    args = p.parse_args(argv)
    if args.ab:
        sys.path.insert(0, str(HERE_SRC))
        run_ab(*args.ab, args.pairs)
        return 0
    sys.path.insert(0, os.path.abspath(args.src))
    print(json.dumps(time_b2()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
