"""One run of one cell: weights, engine, warm-up, the measured window, the
traced span and the correctness check.

The system under test is `repro_torch.serving.engine.InferenceEngine`
with its KV cache on: each batch is one `generate` (a prefill graph, then
one graphed decode step a token through the cache and kernel B1).  The
harness gives the engine its own step meter, the hook through which the
engine times each prefill and decode step; the engine synchronises the
host with each step's token anyway.  The window is a closed loop over
whole jobs: the batches of job 0, 1, ... back to back, until a job ends
at or after `seconds` (every job serves the same sizes, so the window's
work does not depend on the seed or on where it closes; closing at a
batch's end instead made the work flip with the host's speed, PERF.md).
"""

from __future__ import annotations

import gc
import sys
import time
from contextlib import nullcontext

import numpy as np
import torch

from bench import check, devtrace, traffic, weights
from bench.measure import Run, Served
from bench.reference import Reference
from bench.spec import Cell, spec_of

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_JOB = 1 << 20        # the traced span's job index: apart from the window's
WARM_JOB = 1 << 21         # the warm-up's
# Serving before the window opens: a process's first seconds of serving
# run up to ~10 % slower on the card's host, for a length that varies from
# run to run (PERF.md).
WARM_SECONDS = 20.0
TRACE_SECONDS = 2.0        # the traced span: whole batches, at least this long


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class StepTimer:
    """The engine's step meter (`meter=`): the host clock's (start, end) of
    each step, its end taken after the device has finished it."""

    per_call = False

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.records: list[tuple[float, float]] = []
        self.annotate = False

    def measure(self, fn):
        span = torch.profiler.record_function("bench.step") if self.annotate else nullcontext()
        with span:
            t0 = time.perf_counter()
            out = fn()
            if self.cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        self.records.append((t0, t1))
        return out, t1 - t0, 0.0


def model_config(conf: dict):
    """The port's ModelConfig of a configuration file."""
    from repro_torch.models.common import ModelConfig

    s = spec_of(conf)
    kw = dict(name=s.name, family=s.family, n_layers=s.n_layers, d_model=s.d_model,
              n_heads=s.n_heads, n_kv_heads=s.n_kv_heads, head_dim=s.head_dim, d_ff=s.d_ff,
              vocab_size=s.vocab_size, window=s.window, rope_theta=s.rope_theta,
              rmsnorm_eps=s.rms_eps, param_dtype=s.dtype,
              tie_embeddings=bool(conf.get("tie_word_embeddings", False)))
    if s.moe:
        kw.update(n_experts=s.n_experts, top_k=s.top_k)
    return ModelConfig(**kw)


def check_layout(cfg, tree: dict) -> None:
    """Raise unless `tree` has the port's paths, shapes and dtype."""
    from repro_torch.models import get_api

    want = dict(weights.leaves(get_api(cfg).param_shapes(cfg)))
    have = dict(weights.leaves(tree))
    bad = sorted(p for p in want.keys() | have.keys()
                 if p not in want or p not in have or want[p].shape != have[p].shape
                 or want[p].dtype != have[p].dtype)
    if bad:
        raise ValueError(f"the weights differ from the port's layout at {bad}")


def build_engine(cfg, tree: dict, device: torch.device):
    from repro_torch.serving.engine import InferenceEngine

    timer = StepTimer(device)
    return InferenceEngine(cfg, tree, kv_cache=True, meter=timer, device=device), timer


def warm(engine, timer, cell: Cell, seed: int) -> None:
    """Capture the graphs of every shape the cell's jobs run (through the
    engine's `_prepare`, which `generate` runs first; a whole `generate`
    a shape where the engine has none), then serve whole batches of a
    warm-up job until `WARM_SECONDS` have passed."""
    B, n = cell.cell["batch"], cell.cell["job_requests"]
    prepare = getattr(engine, "_prepare", None)
    for prompt, steps in traffic.shapes(cell.traffic, n):
        batch = {"tokens": np.zeros((B, prompt), np.int32)}
        if prepare is not None:
            prepare(batch, steps)
        else:
            engine.generate(batch, steps)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_SECONDS:
        for b in next(jobs(cell, seed, WARM_JOB)):
            serve(engine, timer, b)
            if time.perf_counter() - t0 >= WARM_SECONDS:
                break


def serve(engine, timer: StepTimer, batch: traffic.Batch) -> Served:
    n = len(timer.records)
    out, _ = engine.generate({"tokens": batch.tokens}, batch.steps)
    walls = timer.records[n:]
    if len(walls) != 1 + batch.steps:
        raise RuntimeError(f"the engine metered {len(walls)} steps for a prefill and "
                           f"{batch.steps} decode steps")
    return Served(batch, np.asarray(out), walls)


def jobs(cell: Cell, seed: int, first: int = 0):
    s = cell.spec
    k = first
    while True:
        yield traffic.job(cell.traffic, cell.cell["job_requests"], cell.cell["batch"],
                          s.vocab_size, seed, k)
        k += 1


def serve_window(engine, timer, cell: Cell, seed: int, seconds: float):
    """Whole jobs back to back until one ends at or after `seconds`:
    (served batches, window seconds)."""
    served = []
    t0 = time.perf_counter()
    for job in jobs(cell, seed):
        served += [serve(engine, timer, b) for b in job]
        if time.perf_counter() - t0 >= seconds:
            break
    return served, time.perf_counter() - t0


def serve_traced(engine, timer, cell: Cell, seed: int) -> tuple[dict, list[Served]]:
    """Batches of a further job under the profiler until `TRACE_SECONDS`
    have passed (whole batches): the trace's reduction and the batches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    served = []
    timer.annotate = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(devtrace.SPAN):
                t0 = time.perf_counter()
                for b in next(jobs(cell, seed, TRACE_JOB)):
                    served.append(serve(engine, timer, b))
                    if time.perf_counter() - t0 >= TRACE_SECONDS:
                        break
    finally:
        timer.annotate = False
    return devtrace.reduce(prof), served


def judge(cell: Cell, tree: dict, picked, *, fp8_control: bool = False) -> dict:
    """`check.numbers` of the sampled requests against the reference, and
    with `fp8_control` the control's under "control"."""
    dev = next(weights.leaves(tree))[1].device
    seqs, first, served = check.sequences(picked)
    seqs = [torch.as_tensor(x, dtype=torch.long, device=dev) for x in seqs]
    ref = Reference(cell.spec, tree).logits(seqs, first)
    out = check.numbers(ref, served)
    if fp8_control:
        ctl = Reference(cell.spec, tree, fp8=True).logits(seqs, first)
        out["control"] = check.control_numbers(ref, ctl)
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             started: float | None = None, energy: bool = True) -> tuple[Run, dict, dict]:
    """One run: (what it recorded, the device's record, the check's numbers).
    `started` is the process's start on the host clock (default: now)."""
    started = time.perf_counter() if started is None else started
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    s = cell.spec
    cfg = model_config(cell.config)
    tree = weights.make(s, seed, dev)
    check_layout(cfg, tree)
    engine, timer = build_engine(cfg, tree, dev)
    warm(engine, timer, cell, seed)
    counter = None
    if energy:
        from bench.nvml import EnergyCounter
        counter = EnergyCounter(dev)
    e0, t0 = counter.open() if counter else (0, time.perf_counter())
    setup_s = t0 - started
    served, window_s = serve_window(engine, timer, cell, seed, seconds)
    run = Run(cell=cell, served=served, window_s=window_s, setup_s=setup_s,
              capture_s=engine.capture_s)
    if counter:
        e1, t1 = counter.close()
        run.joules, run.energy_s = (e1 - e0) / 1e3, t1 - t0
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  "count": 1,
                  "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                        if dev.type == "cuda" else 0)}
    if counter:
        device_rec["power_limit_w"] = counter.power_limit_w()
    if trace:
        run.trace, run.traced = serve_traced(engine, timer, cell, seed)
        device_rec["busy_s"] = run.trace["busy_s"]
        device_rec["window_s"] = run.trace["window_s"]
    picked = check.sample(run, cell.cell["check"]["sample_requests"], seed)
    del engine, timer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    found = judge(cell, tree, picked)
    return run, device_rec, found
