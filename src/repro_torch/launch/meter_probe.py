"""The card's NVML energy counter, as `energy.meter.NvmlMeter` reads it:
how often it steps, what a read costs, how far it lags a change of load,
and how windows opened and closed on its steps compare with windows read
at arbitrary times.  With `--warm-up`, also whether a KV-off trial at a new
(τin, τout) runs slower than the next one after `launch.serve.warm_up`.
With `--rules TREE`, also each model's characterization metered in turn by
another checkout's NvmlMeter (TREE, say the parent commit unpacked with
`git archive`) and by this one's, one call a window, then by this one with
every window at least `launch.serve.TRIAL_WINDOW_S` long.

    PYTHONPATH=src python -m repro_torch.launch.meter_probe [--seconds 2]
    PYTHONPATH=src python -m repro_torch.launch.meter_probe --warm-up llama2-7b,mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.meter_probe --rules build/parent

Needs a CUDA device.  Prints a summary per part and writes every step the
counter took to `--out` (JSON).
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.energy.meter import NvmlMeter


def read_cost_us(meter: NvmlMeter, n: int = 2000) -> float:
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        meter.millijoules()
        samples.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(samples)


def counter_steps(meter: NvmlMeter, n: int) -> list[tuple[float, float]]:
    """The counter's next `n` steps: (ms since the step before, joules)."""
    e, t = meter.next_step()
    out = []
    for _ in range(n):
        e1, t1 = meter.next_step(e)
        out.append((round((t1 - t) * 1e3, 1), (e1 - e) / 1e3))
        e, t = e1, t1
    return out


def record_steps(meter: NvmlMeter, seconds: float, done=None) -> tuple[list, float | None]:
    """Every step the counter takes over `seconds`: (time, mJ) pairs, the
    first being the reading at the start.  With `done` (a CUDA event) also
    the time it was first seen complete."""
    t_end = time.perf_counter() + seconds
    last = meter.millijoules()
    steps = [(time.perf_counter(), last)]
    t_done = None
    while (now := time.perf_counter()) < t_end:
        mj = meter.millijoules()
        if mj != last:
            steps.append((now, mj))
            last = mj
        if done is not None and t_done is None and done.query():
            t_done = now
    return steps, t_done


def summarize(label: str, steps: list) -> dict:
    gaps = [(b[0] - a[0]) * 1e3 for a, b in zip(steps[1:], steps[2:])]
    incs = [b[1] - a[1] for a, b in zip(steps[1:], steps[2:])]
    if not gaps:
        print(f"[probe] {label}: the counter stepped {len(steps) - 1} times")
        return {"label": label, "steps": len(steps) - 1}
    hist = collections.Counter(round(g, 1) for g in gaps)
    watts = [i / g for i, g in zip(incs, gaps)]      # mJ / ms
    out = {"label": label, "steps": len(gaps), "gap_ms_median": statistics.median(gaps),
           "gap_ms_min": min(gaps), "gap_ms_max": max(gaps),
           "step_mJ_median": statistics.median(incs), "step_mJ_min": min(incs),
           "step_mJ_max": max(incs), "watts_median": statistics.median(watts),
           "gap_ms_histogram": sorted(hist.items(), key=lambda kv: -kv[1])[:12]}
    print(f"[probe] {label}: {json.dumps(out)}")
    return out


def matmul_load(n: int = 8192):
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    c = torch.empty_like(a)
    for _ in range(5):
        torch.matmul(a, b, out=c)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        torch.matmul(a, b, out=c)
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / 20

    def run(seconds: float):
        for _ in range(max(1, int(seconds * 1e3 / ms))):
            torch.matmul(a, b, out=c)
    return run, ms


def step_response(meter: NvmlMeter, run) -> dict:
    """Idle 0.5 s, a 1 s load, idle 0.5 s: the counter's power per step
    against the load's start (enqueued) and end (its event seen done)."""
    torch.cuda.synchronize()
    pre, _ = record_steps(meter, 0.5)
    t_on = time.perf_counter()
    run(1.0)
    done = torch.cuda.Event()
    done.record()
    steps, t_off = record_steps(meter, 1.6, done)
    steps = pre + steps[1:]
    rows = [{"t_ms_from_on": round((b[0] - t_on) * 1e3, 3),
             "gap_ms": round((b[0] - a[0]) * 1e3, 3),
             "watts": round((b[1] - a[1]) / ((b[0] - a[0]) * 1e3), 1)}
            for a, b in zip(steps[1:], steps[2:])]
    idle = statistics.median(r["watts"] for r in rows if r["t_ms_from_on"] < 0)
    busy = statistics.median(r["watts"] for r in rows
                             if 300 < r["t_ms_from_on"] < (t_off - t_on) * 1e3 - 100)
    mid = (idle + busy) / 2
    rise = next((r["t_ms_from_on"] for r in rows if r["t_ms_from_on"] > 0
                 and r["watts"] > mid), None)
    off_ms = (t_off - t_on) * 1e3
    fall = next((r["t_ms_from_on"] - off_ms for r in rows
                 if r["t_ms_from_on"] > off_ms and r["watts"] < mid), None)
    out = {"idle_w": idle, "busy_w": busy, "load_ms": off_ms,
           "first_step_above_mid_after_on_ms": rise,
           "first_step_below_mid_after_off_ms": fall}
    print(f"[probe] step response: {json.dumps(out)}")
    near = [r for r in rows if -60 < r["t_ms_from_on"] < 120
            or -60 < r["t_ms_from_on"] - off_ms < 200]
    print(f"[probe] steps near the edges: {json.dumps(near)}")
    return {"summary": out, "rows": rows}


def windows(meter: NvmlMeter, run, ms: float) -> dict:
    """Joules per matmul from back-to-back windows of several lengths (the
    meter's, idle head and tail charged) and from raw reads at arbitrary
    times, against one 3 s window of the meter."""
    out = {}
    _, s, j = meter.measure(lambda: run(3.0))
    ref = j / (3.0 * 1e3 / ms)
    out["long"] = {"seconds": s, "joules": j, "mJ_per_matmul": ref * 1e3,
                   "idle_w": meter.idle_w}
    for length in (0.02, 0.05, 0.2, 0.5):
        n = max(1, int(length * 1e3 / ms))
        metered, window, idle = [], [], []
        for _ in range(8):
            _, s, j = meter.measure(lambda: run(length))
            metered.append(j / n / ref)
            window.append(meter.last["window_j"] / n / ref)
            idle.append(meter.last["idle_s"] * 1e3)
        raw = []
        for _ in range(8):
            torch.cuda.synchronize()
            e0 = meter.millijoules()
            run(length)
            torch.cuda.synchronize()
            raw.append((meter.millijoules() - e0) / 1e3 / n / ref)
        out[f"{length}s"] = {"metered": metered, "window": window, "idle_ms": idle,
                             "raw": raw, "idle_w": meter.idle_w}
        print(f"[probe] {length} s windows ({n} matmuls), joules per matmul over the 3 s "
              f"window's: metered {[round(x, 3) for x in metered]}, whole windows "
              f"{[round(x, 3) for x in window]} (idle head + tail ms "
              f"{[round(x, 1) for x in idle]}, idle {meter.idle_w:.1f} W), raw reads "
              f"{[round(x, 3) for x in raw]}")
    return out


def warm_up_check(archs: list[str], passes: int = 2) -> dict:
    """Per arch: launch.serve.warm_up, then `passes` passes over the
    campaign's (τin, τout) pairs up to 32, each pair's three KV-off trials
    back to back (batch 2, tokens from one rng seeded 0), the pairs in a
    new shuffled order each pass.  In pass 1 a pair's first trial is its
    first run after the engine-wide warm-up; in pass 2 the pair has run
    before, as the reference's per-pair warm-up would have run it.
    Prints each pair's first trial over the median of its other two."""
    from repro_torch.launch import serve as serve_mod
    pairs = [(a, b) for a in (8, 16, 32) for b in (8, 16, 32)]
    order = np.random.default_rng(7)
    out = {}
    for arch in archs:
        eng = serve_mod.build_engine(arch, kv_cache=False, device="cuda")
        t0 = time.perf_counter()
        serve_mod.warm_up(eng, 2, 32)
        warm = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        res = []
        for k in range(passes):
            ratios = []
            for i in order.permutation(len(pairs)):
                tin, tout = pairs[i]
                runs = []
                for _ in range(3):
                    toks = rng.integers(1, eng.cfg.vocab_size, (2, tin)).astype(np.int32)
                    _, st = eng.generate({"tokens": toks}, tout)
                    runs.append((st.runtime_s, st.energy_j))
                r = [x[0] for x in runs]
                ratios.append(r[0] / statistics.median(r[1:]))
                res.append({"pass": k + 1, "pair": [tin, tout], "runs": runs})
            later = [abs(x["runs"][1][0] / x["runs"][2][0] - 1) for x in res
                     if x["pass"] == k + 1]
            print(f"[probe] warm-up {arch} pass {k + 1}: first trial / median of the next "
                  f"two, per pair {[round(x, 3) for x in ratios]}; median "
                  f"{statistics.median(ratios):.4f}; |second / third - 1| median "
                  f"{statistics.median(later):.4f}")
        print(f"[probe] warm-up {arch}: warm_up took {warm:.2f} s")
        out[arch] = res
        del eng
        torch.cuda.empty_cache()
    return out


def load_meter(tree: str):
    """The `energy.meter` module of the checkout at `tree`."""
    spec = importlib.util.spec_from_file_location(
        "meter_of_" + Path(tree).name, Path(tree) / "src/repro_torch/energy/meter.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rules_ab(archs: list[str], tree: str, limit_w: float, passes: int = 2) -> dict:
    """Per arch: one KV-off engine, `launch.serve.warm_up`, then its
    campaign (batch 2, τ up to 64 for a dense model and 32 otherwise, an
    rng seeded 0 each run) metered `passes` times by `tree`'s NvmlMeter and
    this one's in turn, one call a window, and once more by this one with
    each window at least `TRIAL_WINDOW_S`.  Before each run, the idle power
    over a window of 0.5 s of sleep.  Prints each run's trial power (min,
    median, max), the trials outside [idle / 2, 1.05 x limit_w], the idle
    powers the meter measured and the smallest window's joules."""
    from repro_torch.core.characterize import run_campaign
    from repro_torch.energy import meter as this
    from repro_torch.launch import serve as serve_mod
    other = load_meter(tree)
    runs = [(tree, other, 0.0), ("this tree", this, 0.0)] * passes
    runs.append(("this tree, windows >= TRIAL_WINDOW_S", this, serve_mod.TRIAL_WINDOW_S))
    out = {}
    for arch in archs:
        eng = serve_mod.build_engine(arch, kv_cache=False, device="cuda")
        top = 64 if eng.cfg.family == "dense" else 32
        serve_mod.warm_up(eng, 2, top)
        out[arch] = []
        for label, mod, min_s in runs:
            _, s, j = NvmlMeter("cuda").measure(lambda: time.sleep(0.5))
            idle = j / s
            eng.meter, eng.min_window_s = mod.NvmlMeter("cuda"), min_s
            rng = np.random.default_rng(0)
            seen = []

            def measure(tin, tout):
                toks = rng.integers(1, eng.cfg.vocab_size, (2, tin)).astype(np.int32)
                _, st = eng.generate({"tokens": toks}, tout)
                seen.append((eng.meter.idle_w, st.energy_j * st.repeats))
                return st.energy_j, st.runtime_s

            t0 = time.perf_counter()
            trials = run_campaign(arch, measure, serve_mod.campaign_settings(top))
            wall = time.perf_counter() - t0
            w = [t.energy_j / t.runtime_s for t in trials]
            bad = [round(x, 1) for x in w if not idle / 2 <= x <= 1.05 * limit_w]
            idles = sorted({round(i, 1) for i, _ in seen})
            print(f"[probe] rules {arch} ({label}): {len(trials)} trials in {wall:.1f} s, "
                  f"idle {idle:.1f} W; trial W min {min(w):.1f} median "
                  f"{statistics.median(w):.1f} max {max(w):.1f}; outside the gate {bad}; "
                  f"the meter's idle W {idles}; smallest window "
                  f"{min(x for _, x in seen):.2f} J", flush=True)
            out[arch].append({"meter": label, "min_window_s": min_s, "idle_w": idle,
                              "watts": w, "meter_idle_w": idles})
        del eng
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--warm-up", default="")
    p.add_argument("--rules", default="", help="another checkout to A/B the meter against")
    p.add_argument("--rules-archs", default="llama2-13b,mamba2-130m")
    p.add_argument("--out", default="build/meter_probe.json")
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[probe] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}")
    meter = NvmlMeter("cuda")
    print(f"[probe] NVML device UUID {meter.uuid}; torch's "
          f"{torch.cuda.get_device_properties(0).uuid}")
    res = {"read_us": read_cost_us(meter)}
    print(f"[probe] one counter read: {res['read_us']:.2f} us (median of 2,000)")
    steps, _ = record_steps(meter, args.seconds)
    res["idle"] = summarize("idle", steps)
    res["idle_steps"] = steps
    run, ms = matmul_load()
    print(f"[probe] load: bf16 8192^3 matmul, {ms:.4f} ms each")
    run(args.seconds + 0.5)
    steps, _ = record_steps(meter, args.seconds)
    torch.cuda.synchronize()
    res["load"] = summarize("under load", steps)
    res["load_steps"] = steps
    res["step_response"] = step_response(meter, run)
    res["windows"] = windows(meter, run, ms)
    if args.warm_up:
        res["warm_up"] = warm_up_check(args.warm_up.split(","))
    if args.rules:
        limit_w = float(smi.stdout.split(",")[1].split()[0])
        res["rules"] = rules_ab(args.rules_archs.split(","), args.rules, limit_w)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
