#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Every engine call on the card replays a CUDA graph captured for its shapes
(`serving.engine`: the reference's jit keys); the graphs' replays add the
launches their captures recorded to the kernels' counts, and each serve
phase prints every engine's graphs (count, capture seconds, pool GiB).

Phases, each of which must pass:
  1. device   the card's name and count, and `nvidia-smi`'s name and power limit;
  2. build    every CUDA kernel from src/repro_torch/kernels/csrc (B1, B2,
              B3 and B4 with their backward kernels), with the compiler's
              register/shared-memory report;
  3. check    each kernel against its plain PyTorch version on the card, at
              the main paths' shapes: B1 (q f32 within 1e-4, q bf16 within
              2e-2, elementwise and of the output's largest magnitude) at
              the llama2 shapes, the MoE path's (granite-moe-3b-a800m,
              mixtral-8x7b), falcon-7b's MQA (71 query heads on one KV
              head) and recurrentgemma-9b's head dim 256 ring, with bf16
              and float8_e4m3fn caches, keys past pos overwritten
              (the output bit-identical); B2 for every family branch and
              both decode modes at m = 1,000,037 (f32 rtol 1e-5, f64 rtol
              1e-12), and in each operand mode (uniform batch or new tokens,
              context aliasing new tokens, a stride-0 batch, misaligned
              bases) at m = 1, 3, 5 and 1,000,037, one launch a call; B3
              at mamba2-130m's (f32 atol 2e-4 / rtol 1e-3, bf16 within 2e-2
              of the output's largest magnitude); B4 at recurrentgemma-9b's
              (1e-4); B3 and B4 also at the edges of their designs (chunk
              and tile boundaries, state sizes 16..256, W % 4 != 0); the
              backward kernels of B3 and B4, through their autograd
              Functions, against autograd of the plain versions (f32
              within 2e-4 of each gradient's own largest magnitude, B3's
              bf16 within 2e-2 of the same f32 reference beside the plain
              bf16 version's own error) at phase 11's training shapes and the designs'
              edges, with and without h0 and the final state's gradient,
              bit for bit on repeat, and at S <= 64 against autograd of
              the sequential oracles (kernels/ref.py);
  4. timing   each kernel, its plain version and, for B1, a library call
              (CUDA events, L2 flushed between launches), beside the bound
              for its bytes or operations; B1 also back to back with the
              L2 warm and its wrapper's host time a call; the timing's floor, a streaming
              yardstick for B4 and B3's time per chunk, and B3, B4, the
              floor and the yardstick back to back with the L2 warm; the
              B3 and B4 backward kernels at the training shapes beside
              their bounds and autograd's backward through the plain
              versions; B2 also at simulate_batch's own operands, with the
              profiler's kernel duration and one kernel a call checked;
              `simulate_batch` queries/s and B2's share of its busy time;
  5. analytic the paper's §6.3 case study through the port's host modules
              (analytic campaign, Eq. 6/7 fits, ζ-sweep, baselines), then
              `cost_matrices` on the card over the llama2-7b/13b/70b fleet
              in both KV modes at batch 32, on the 500 Alpaca-like queries
              and on 1,000,000 synthetic ones, held within 1e-9 of the
              numpy closed form; kernel B2's launches must equal the
              pass-cost evaluations made (1 + 3 per decode segment per
              simulator and call);
  6. serve    the paper's serve path through `repro_torch.launch.serve.serve`
              twice, each at full width with random bf16 weights drawn on
              the card: characterize with the KV cache off (one warm-up
              generate over every length, then the campaign), fit, route 24
              queries, serve with the KV cache on.  First llama2-7b and
              llama2-13b (characterized up to 64 tokens, the reference's
              `characterize_fleet` default), where kernel B1's
              launch count must equal the decode work done; then
              mamba2-130m and recurrentgemma-9b (characterized up to 32
              tokens: SCAN_CHAR_MAX_TOKENS), where every prefill must launch
              B3 once per SSM layer or B4 once per recurrent layer, and
              every decode step B1 once per attention layer;
              one KV-on generate of each outside the router makes every
              kernel launch whatever the routing.  Every engine call is
              metered by the card's NVML energy counter
              (`energy.meter.NvmlMeter`, one window a call, opened and
              closed on the counter's steps); this and the serve phases
              of 8 and 9 print Eq. 6's R² on those joules beside the R²
              of the host model's (`WallClockMeter`'s) for the same trials,
              each trial's power (held within [idle / 2, 1.05 x the power
              limit]), its shortest trial and the meter's per-window error
              bound as a share of its smallest trial window (held at 5 %:
              a trial shorter than `launch.serve.TRIAL_WINDOW_S` is
              repeated inside its window), the repeats'
              spread and each (τin, τout)'s first
              trial over its later ones, and the windows' joules against
              NVML's reading over the whole run (held within one counter
              step a window); phase 1 prints the counter's steps at idle
              and under load and what one read costs;
  7. outputs  reduced models on the card (through the kernels) against the
              same models on the CPU (plain versions), llama2-7b and
              recurrentgemma-9b also with float8_e4m3fn KV caches, and
              finite full-width decode logits that agree with a full
              re-forward; the reference's fp8-cache gate (qwen3-1.7b-reduced,
              mean |delta logit| < 0.2) on the card, and a full-width
              llama2-7b fp8-cache decode through B1 against the same
              through the plain version (relative L2 0.1, with a control
              the limit must fail), B1's launches counted over its fp8
              decode steps alone; then the device's busy share of
              full-width decode steps and prefills and the kernels' shares
              of it (profiler); then the engine's CUDA graphs against the
              same steps run eagerly on the card at full width (llama2-7b,
              mamba2-130m, recurrentgemma-9b; KV on, prefill + 8 decode
              steps, and KV off, a trial's 8 re-forwards): greedy tokens
              identical, logits bit-identical, each mode's step wall,
              busy time and idle share, and the profiler's records of B1
              (one per attention layer) in a decode replay and of B3 / B4
              (one per SSM / recurrent layer) in a KV-off replay;
  8. moe      the MoE family through the same `serve`: granite-moe-3b-a800m
              at full width and depth (32 layers) and mixtral-8x7b at full
              width cut to 4 of 32 layers (DEPTH_CUTS: 47 B parameters fit
              no 80 GB card), random bf16 weights, characterized up to 16 tokens,
              24 queries routed and served, and one KV-on generate of each
              outside the router; B1's launches must equal the attention
              layers x decode steps.  Then the reduced mixtral, granite and
              deepseek-v3 (both MLA decode modes) on the card against the
              CPU, full-width decode against a re-forward with the device's
              busy share of a decode step (granite, mixtral, and
              deepseek-v3-671b cut to 4 layers, 3 dense + 1 MoE, in both
              MLA decode modes, where B1 must launch 0 times);
  9. encdec + vlm  seamless-m4t-large-v2 (over 4,096 frames, cut to 6 of
              its 24 encoder and 24 decoder layers: DEPTH_CUTS) and
              internvl2-2b (24 layers, 256 patches) at full width, random
              bf16 weights, with seeded
              frames and patches: `serve()` passes tokens only, so the same
              characterize (KV off, up to 16 tokens, through `measure_fn`'s
              zero frames/patches) -> fit -> route (24 queries, zeta 0.5) ->
              serve (KV on, batch 4) pipeline is built from the package's
              parts; every engine call's B1 launches must be 2 x dec_layers
              (self + cross-attention) a seamless decode step, n_layers an
              internvl2 one, and 0 a prefill.  Then both reduced models on
              the card against the CPU, full-width decode against a
              re-forward, and the device's busy share of a decode step of
              each and of a seamless KV-off forward;
 10. cluster  the cluster simulator, its observability layer and the online
              router (`repro_torch.cluster`, `repro_torch.obs`,
              `serving.OnlineRouter`; host code, numpy): (a) fig4's main
              table at the reference's sizes (200 Alpaca-like requests at
              0.5, 2 and 8 qps, zeta 0.5 and 1, six policies over the
              llama2-7b/13b/70b fleet), each run audited live at 1 shard
              and identical to its bare 4-shard twin, the offline oracle
              never beaten on the Eq. 2 objective, per-phase DVFS never
              above the fixed frequency's energy, the telemetry cell (bare ==
              fused == sharded observability) and the availability cell
              (120 requests, MTTF 5x, 10x, 50x: partitions closed to 1e-9,
              the failure-aware oracle bound, >= 90 % goodput at 10x);
              (b) perf_suite's bench_cluster at 20,000 requests (host
              requests/s beside the host CPU's model); (c) the six policies
              at 2 qps over a llama2-7b/13b fleet routed by the profiles
              phase 6 fitted on the card (every request served, the oracle
              bound, the auditor silent); (d) `OnlineRouter` live: phase 6's
              24 queries routed one at a time by zeta_online over those
              profiles and served at once, batch 1, by KV-cached llama2-7b
              and -13b engines on the card, B1's launches equal to layers x
              max_new over the served requests;
 11. train    the training path (`launch.steps.build_train_step`, AdamW,
              bf16 weights drawn on the card, `lm_train_batches(kind=
              "markov")`), run through `launch.steps.compile_train_step`,
              the port of the reference's `jax.jit(train_step,
              donate_argnums=(0, 1))`: one CUDA graph per input
              signature, captured after a warm-up step and replayed:
              (a) qwen3-1.7b at full width and depth, remat on, batch 64 x
              128 tokens in two microbatches of 32 accumulated in f32; (b)
              granite-moe-3b-a800m at full width and depth, batch 32 x 128
              (one microbatch), every gradient finite, the pairs dropped
              past capacity per step, and no scatter or index_add in the
              dispatch/combine backward; each cell runs EAGER_STEPS eager
              steps (the same step bodies, `graphed=False`), then 4
              graphed ones from the eager steps' params; in each mode
              each step's loss, wall and NVML J, step 2 under the profiler
              (device busy; idle share against the later steps' wall),
              tokens/s and the model-FLOP share (6 N T, N active less the
              input embedding) against the H100 SXM's dense bf16 peak, the
              peak memory; the graph's warm-up and capture seconds and
              pool GiB; losses finite and the last below the first, the
              graphed idle share below the eager one; (c) qwen3-1.7b at
              full width cut to 2 layers, deterministic algorithms on: 4
              graphed steps bit-identical to 4 eager ones, and the same
              compiled step over 2 steps from fresh trees + save + load +
              2, equal to the 4 straight bit for bit (the checkpoint in a
              `launch.train` step directory, for (e)); (d) two compiled
              steps (a warm-up step and a replay) of the reduced dense,
              moe (granite, deepseek-v3), encdec, vlm, ssm and hybrid
              models on the card against the eager CPU step, mamba2's and
              recurrentgemma's through B3's and B4's backward kernels; (e)
              the training CLI, `launch.train.main`, at qwen3-1.7b's full
              size on its default device (4 steps, no checkpoint), the
              trainer's resume (`launch.train.train` of (c)'s 2 layers,
              resuming from (c)'s step-2 checkpoint for 2 steps), and 4
              steps of mamba2-130m (batch 16 x 512); (f) mamba2-130m at
              full size, remat on, batch 16 x 512, and (g)
              recurrentgemma-9b at full width cut to 6 of its 38 layers
              (TRAIN_DEPTH_CUTS: AdamW at 38 layers needs ~167 GB), batch
              16 x 256, each run as (a) is, with B3's or B4's forward and
              backward shares of each profiled step's busy time, and each
              step's launches (a replay adds what its capture recorded)
              held to layers x (2 forward, the pass and remat's
              recompute; 1 backward).  B1 and B2 launch 0 times in the
              phase; B3's and B4's forward and backward launches equal
              what the layers run need;
 12. sharding and the dry run, on a one-rank NCCL group and a (1, 1)
              ("data", "model") mesh: (a) qwen3-1.7b trained as phase 11
              (a) trains it, 2 steps on FSDP DTensors under the train
              rules, against the unsharded step from the same weights
              (losses within 1e-5, params after the 2 steps within
              1e-4 x max(1, max|p|): the training gates; step walls
              printed), and llama2-7b prefill + 7 greedy decode steps on
              DTensors under the decode rules, B1 on the cache's S shard
              with its LSE output and the merge by LSE (greedy tokens
              identical, logits within relative L2 0.1, B1's launches
              = layers x steps); (b) the dry run's trace of one more
              train step and decode step on fake CUDA tensors (a child
              process) against FlopCounterMode around the real
              step on the card (B1's
              plain version's count added for its launches) within 1e-6,
              and its predicted peak within 15 % of max_memory_allocated;
              (c) B1's LSE against the plain version's at the llama2 and
              D=256 ring shapes, and B1 on 2 and 4 sequence slices merged
              by LSE within 1 % of max|plain| of the whole; (d) the
              dry-run CLI for qwen3-1.7b and deepseek-v3-671b x the four
              input shapes on a fake 16 x 16 mesh, in a child process
              started once the kernels are timed (as (b)'s) and joined
              last: the child exits 0, every record ok and written in
              this run, its table, its wall and the serve phases' walls
              printed.

Exits nonzero, printing no result, without a CUDA device, without the
port's sources beside it, or when any phase fails (an NVML counter that
cannot be opened or read fails its phase).  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import platform
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
if (ROOT / "src" / "repro_torch").is_dir():     # else main() stops: no port beside it
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.energy.hardware import H100_SXM
    HBM_BYTES_PER_S = H100_SXM.hbm_bw
    # CUDA-core f32, bf16 tensor; f64 outside the tensor cores (H100 SXM data sheet)
    PEAK_OPS = {"float32": 67e12, "bfloat16": H100_SXM.peak_flops, "float64": 34e12}
SERVE_ARCHS = ["llama2-7b", "llama2-13b"]
SERVE_CHAR_MAX_TOKENS = 64      # the llama2 path's grid top: the reference's default
SCAN_ARCHS = ["mamba2-130m", "recurrentgemma-9b"]
SCAN_CHAR_MAX_TOKENS = 32       # the scan path's characterization grid top
MOE_ARCHS = ["granite-moe-3b-a800m", "mixtral-8x7b"]
MOE_CHAR_MAX_TOKENS = 16        # the MoE path's characterization grid top
# Depth cuts at full width: mixtral-8x7b's 32 layers (47 B parameters, ~94 GB
# in bf16) and deepseek-v3-671b's 61 fit no 80 GB card.  To keep the script
# inside its time limit on slow hosts, mixtral-8x7b is served with 4 layers
# and seamless-m4t-large-v2 with 6 of its 24 encoder and 24 decoder layers
# (an encdec cut is per stack; its KV-off characterization re-encodes 4,096
# frames every call, device-bound, which the engine's CUDA graphs do not
# shorten).  granite-moe-3b-a800m is served at all its 32 layers.
DEPTH_CUTS = {"mixtral-8x7b": 4, "deepseek-v3-671b": 4, "seamless-m4t-large-v2": 6}
ENCDEC_VLM_ARCHS = ["seamless-m4t-large-v2", "internvl2-2b"]
ENCDEC_VLM_CHAR_MAX_TOKENS = 16
SERVE_QUERIES = 24
# phase 11 (training): (arch, batch, seq, graphed steps) at full width and
# depth, after EAGER_STEPS eager ones
TRAIN_DENSE = ("qwen3-1.7b", 64, 128, 4)        # two microbatches of 32
TRAIN_MOE = ("granite-moe-3b-a800m", 32, 128, 4)  # one microbatch
TRAIN_RESUME_LAYERS = 2         # qwen3-1.7b's 28 layers cut for the resume check
TRAIN_LR = 3e-4                 # repro.launch.train's default
TRAIN_SSM = ("mamba2-130m", 16, 512, 4)        # 8 of B3's 64-step chunks a row
TRAIN_HYBRID = ("recurrentgemma-9b", 16, 256, 4)  # one microbatch
# recurrentgemma-9b's 38 layers with AdamW need ~167 GB, which fits no 80 GB
# card: phase 11 (g) trains it at full width cut to two (rec, rec, attn) units
TRAIN_DEPTH_CUTS = {"recurrentgemma-9b": 6}
TRAIN_SSM_CLI = ("mamba2-130m", 16, 512, 4)     # (e)'s run of the CLI on B3
TRAIN_REDUCED = ["qwen3-1.7b-reduced", "granite-moe-3b-a800m-reduced",
                 "deepseek-v3-671b-reduced", "seamless-m4t-large-v2-reduced",
                 "internvl2-2b-reduced", "mamba2-130m-reduced", "recurrentgemma-9b-reduced"]
# the forward and backward kernels of the scans, by substring of their names
SCAN_KERNEL_KEYS = {"B3 forward": ("ssd_chunk_scan",), "B3 backward": ("ssd_bwd_",),
                    "B4 forward": ("rglru_scan_kernel",), "B4 backward": ("rglru_scan_bwd",)}
BF16_DENSE_PEAK = 989.4e12      # H100 SXM data sheet, dense bf16 FLOP/s
# one config per family branch of the pass-cost surface
COST_ARCHS = ["llama2-7b", "mixtral-8x7b", "mistral-7b", "mamba2-130m", "recurrentgemma-9b",
              "deepseek-v3-671b", "seamless-m4t-large-v2", "internvl2-2b"]
ANALYTIC_BATCH = 32                 # the paper's batch
SYNTHETIC_QUERIES = 1_000_000


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def power_draw() -> str:
    """nvidia-smi's power.draw, or what kept it from being read."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip() if res.returncode == 0 else f"not read ({res.stderr.strip()})"


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def power_limit_w(smi: str) -> float:
    """The power limit in `nvidia-smi`'s "name, 700.00 W" line."""
    return float(smi.rsplit(",", 1)[1].strip().split()[0])


def counter_report(torch) -> dict:
    """The NVML energy counter the port's meter reads (`NvmlMeter`): the
    steps it takes at idle and under a bf16 matmul load (gap in ms and
    joules), and what one read costs.  Returns the median gap, the largest
    step's joules and the read's microseconds."""
    from repro_torch.energy.meter import NvmlMeter
    from repro_torch.launch.meter_probe import counter_steps, read_cost_us
    meter = NvmlMeter("cuda")
    read_us = read_cost_us(meter, 100)
    torch.cuda.synchronize()
    idle = counter_steps(meter, 5)
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    c = torch.empty_like(a)
    for _ in range(500):            # ~0.7 s of work queued ahead of the reads
        torch.matmul(a, a, out=c)
    load = counter_steps(meter, 4)
    torch.cuda.synchronize()
    del a, c
    gaps = [g for g, _ in idle + load]
    print(f"[meter] NVML energy counter (nvmlDeviceGetTotalEnergyConsumption, mJ): step "
          f"(ms, J) at idle {idle}, under a bf16 matmul load {load}; update interval "
          f"median {statistics.median(gaps)} ms; one read {read_us:.1f} us (median of 100)")
    return {"step_ms": statistics.median(gaps), "step_j": max(j for _, j in idle + load),
            "read_us": read_us}


def idle_watts() -> float:
    """The card's idle power now: one metered window over 0.5 s of sleep."""
    from repro_torch.energy.meter import NvmlMeter
    meter = NvmlMeter("cuda")
    _, s, j = meter.measure(lambda: time.sleep(0.5))
    return j / s


# the idle power's error over a window's idle head and tail: the spread of
# the power of mamba2-130m's eager trials, which drew the idle power
IDLE_W_ERR = 5.0


def window_error_j(counter, idle_w) -> float:
    """The bound on one window's error: a counter read's latency at the
    card's idle power, plus the idle power's error over the idle head and
    tail (at most a counter step before the call and two after it)."""
    return counter["read_us"] * 1e-6 * idle_w + IDLE_W_ERR * 3 * counter["step_ms"] * 1e-3


def quartiles(xs) -> list:
    qs = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else xs
    return [round(q, 4) for q in qs]


def energy_report(tag, serve_mod, out, whole, idle_w, limit_w, counter, calls) -> None:
    """The serve cell's energy: per characterized model Eq. 6's R² on NVML
    joules beside the host model's and the runtime R², each trial's power
    (within [idle / 2, 1.05 x limit]), the meter's per-window error bound
    against the smallest of its trials' windows (at most 5 %: the engine
    repeats a short trial inside its window, `calls.windows`), the
    repeats' spread and the first trial at each (τin, τout) over the later
    ones; then the windows' joules (trials and served batches) against the
    NVML reading over the whole run `whole` (a NvmlMeter's `last`), within
    one counter step a window."""
    from repro_torch.core.characterize import fit_profile_from_trials
    from repro_torch.energy.meter import WallClockMeter
    n_windows, windows_j = 0, 0.0
    for prof in out["profiles"]:
        trials = out["trials"][prof.name]
        modeled = fit_profile_from_trials(prof.name, prof.accuracy.a_k,
                                          serve_mod.host_model(trials))
        print(f"[{tag}] {prof.name}: Eq. 6 energy R2 on NVML_J={prof.energy.r_squared} "
              f"host-model_J={modeled.energy.r_squared}; runtime R2="
              f"{prof.runtime.r_squared} ({len(trials)} trials)")
        check(math.isfinite(prof.energy.r_squared) and math.isfinite(prof.runtime.r_squared)
              and math.isfinite(modeled.energy.r_squared), f"{prof.name}: fit is not finite")
        watts = [t.energy_j / t.runtime_s for t in trials]
        print(f"[{tag}] {prof.name}: trial power W min {min(watts):.1f} median "
              f"{statistics.median(watts):.1f} max {max(watts):.1f} (idle {idle_w:.1f}, "
              f"limit {limit_w})")
        check(all(idle_w / 2 <= w <= 1.05 * limit_w for w in watts),
              f"{prof.name}: a trial's power lies outside [{idle_w / 2}, {1.05 * limit_w}] W: "
              f"{[round(w, 1) for w in watts]}")
        short = min(trials, key=lambda t: t.runtime_s)
        err_j = window_error_j(counter, idle_w)
        # the campaign's windows: the warm-up's, then one a trial
        wins = calls.windows[(prof.name, False)][-len(trials):]
        share = err_j / min(wins)
        print(f"[{tag}] {prof.name}: shortest trial ({short.tau_in}, {short.tau_out}): "
              f"{short.runtime_s} s, {short.energy_j} J, {short.energy_j / short.runtime_s:.1f} "
              f"W (gate [{idle_w / 2:.1f}, {1.05 * limit_w:.1f}]); trials' windows "
              f"{min(wins)}-{max(wins)} J (a window at least {serve_mod.TRIAL_WINDOW_S} s); the "
              f"meter's per-window error bound {err_j:.3f} J is {share:.4f} of the smallest")
        check(len(wins) == len(trials) and share <= 0.05,
              f"{prof.name}: the meter's error bound {err_j} J is {share} of its smallest "
              f"trial window ({len(wins)} windows for {len(trials)} trials)")
        visits = collections.defaultdict(list)
        for t in trials:
            visits[(t.tau_in, t.tau_out)].append(t)
        spread_j = [(max(v.energy_j for v in vs) - min(v.energy_j for v in vs))
                    / statistics.median(v.energy_j for v in vs) for vs in visits.values()]
        spread_s = [(max(v.runtime_s for v in vs) - min(v.runtime_s for v in vs))
                    / statistics.median(v.runtime_s for v in vs) for vs in visits.values()]
        first = [vs[0].runtime_s / statistics.median(v.runtime_s for v in vs[1:])
                 for vs in visits.values()]
        later = [vs[1].runtime_s / statistics.median(v.runtime_s for v in vs[2:])
                 for vs in visits.values() if len(vs) > 2]
        print(f"[{tag}] {prof.name}: repeats at a (tin, tout), (max - min) / median: "
              f"joules median {statistics.median(spread_j):.4f}, seconds median "
              f"{statistics.median(spread_s):.4f}; seconds of the first trial at a pair / "
              f"median of its later ones, quartiles {quartiles(first)} over {len(first)} "
              f"pairs; of the second / median of the later ones {quartiles(later)} over "
              f"{len(later)} pairs")
        n_windows += len(trials)
        windows_j += sum(wins)
    for arch, t in out["totals"].items():
        print(f"[{tag}] {arch}: queries={t['queries']} tokens={t['tokens']} "
              f"measured_s={t['runtime_s']} NVML_J={t['energy_j']} "
              f"host-model_J={WallClockMeter().power_w * t['runtime_s']}")
        n_windows += t["batches"]
        windows_j += t["energy_j"]
    bound = whole["window_j"] + n_windows * counter["step_j"]
    print(f"[{tag}] NVML J over the whole run={whole['window_j']}; its {n_windows} trial and "
          f"served-batch windows sum to {windows_j} J, {windows_j / whole['window_j']:.4f} "
          f"of it (limit: + {n_windows} counter steps of {counter['step_j']} J)")
    check(windows_j <= bound, f"{tag}: the windows' joules {windows_j} exceed {bound}")


# ---------------------------------------------------------------------------
# Kernel B1: checks and timing
# ---------------------------------------------------------------------------


def served_cache_len(serve_mod, extra=0) -> int:
    """The KV-on engine's cache length for the served workload's longest
    query, `extra` positions (vlm patches) ahead of its tokens."""
    span = serve_mod.SERVE_WORKLOAD["max_in"] + serve_mod.SERVE_WORKLOAD["max_out"] + extra
    return max(serve_mod.SERVE_BUCKET,
               math.ceil(span / serve_mod.SERVE_BUCKET) * serve_mod.SERVE_BUCKET)


def decode_shapes(torch, serve_mod):
    from repro_torch.configs import get_config
    s_serve = served_cache_len(serve_mod)
    s_vlm = served_cache_len(serve_mod, get_config("internvl2-2b").n_patches)
    n_frames = get_config("seamless-m4t-large-v2").n_frames
    bf, f8 = torch.bfloat16, torch.float8_e4m3fn
    return {   # name -> (B, Hq, Hkv, D, S, q dtype, cache dtype)
        "llama2-7b serve": (4, 32, 32, 128, s_serve, bf, bf),
        "llama2-7b serve fp8": (4, 32, 32, 128, s_serve, bf, f8),
        "llama2-13b serve": (4, 40, 40, 128, s_serve, bf, bf),
        "llama2-70b GQA": (4, 64, 8, 128, 4096, bf, bf),
        "llama2-70b GQA fp8": (4, 64, 8, 128, 4096, bf, f8),
        "granite-moe serve": (4, 24, 8, 64, s_serve, bf, bf),
        "granite-moe serve fp8": (4, 24, 8, 64, s_serve, bf, f8),
        "mixtral serve": (4, 32, 8, 128, s_serve, bf, bf),
        "mixtral serve fp8": (4, 32, 8, 128, s_serve, bf, f8),
        "falcon-7b MQA": (4, 71, 1, 64, s_serve, bf, bf),
        "falcon-7b MQA fp8": (4, 71, 1, 64, s_serve, bf, f8),
        "recurrentgemma-9b ring": (4, 16, 1, 256, 2048, bf, bf),
        "recurrentgemma-9b ring fp8": (4, 16, 1, 256, 2048, bf, f8),
        "seamless cross": (4, 16, 16, 64, n_frames, bf, bf),
        "seamless cross fp8": (4, 16, 16, 64, n_frames, bf, f8),
        "internvl2 serve": (4, 16, 8, 128, s_vlm, bf, bf),
        "internvl2 serve fp8": (4, 16, 8, 128, s_vlm, bf, f8),
        "reduced": (2, 4, 2, 32, s_serve, torch.float32, torch.float32),
        "reduced fp8": (2, 4, 2, 32, s_serve, torch.float32, f8),
    }


def decode_inputs(torch, shape, seed):
    B, Hq, Hkv, D, S, dtype, cache_dtype = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(cache_dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(cache_dtype)
    return q, k, v


def _garbage(torch, k, v, pos, fp8_nan=False):
    """Copies of k and v with the keys past pos overwritten: +-1e4 (+-448,
    the largest finite value, in an fp8 cache), or fp8 NaN bit patterns."""
    k2, v2 = k.clone(), v.clone()
    if fp8_nan:
        k2.view(torch.uint8)[:, pos + 1:] = 0x7F
        v2.view(torch.uint8)[:, pos + 1:] = 0xFF
    else:
        big = 448.0 if k.dtype == torch.float8_e4m3fn else 1e4
        k2[:, pos + 1:] = big
        v2[:, pos + 1:] = -big
    return k2, v2


def decode_within(a, b, tol) -> bool:
    """Elementwise within tol + tol*|plain|, and the largest error within
    tol times the plain output's largest magnitude: with randn inputs a
    long cache averages the values down to a few hundredths, where the
    elementwise bound alone is as large as the output."""
    diff = (a - b).abs()
    return bool((diff <= tol + tol * b.abs()).all()) and diff.max().item() <= tol * b.abs().max().item()


def check_decode(torch, kda, shapes) -> dict:
    """B1 against its plain version: pos 0/mid/S-1, ring full and not,
    softcap, and keys beyond pos overwritten (bit-identical output, and
    NaN bit patterns in fp8 caches too).  Tolerance by q's dtype: f32
    1e-4, bf16 2e-2, elementwise and against the output's scale
    (`decode_within`).  Returns name -> max error."""
    errs = {}
    misses = []
    for i, (name, shape) in enumerate(shapes.items()):
        S, dtype = shape[4], shape[5]
        fp8 = shape[6] == torch.float8_e4m3fn
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        q, k, v = decode_inputs(torch, shape, seed=i)
        cases = [("pos=0", 0, False, 0.0), ("pos=mid", S // 2, False, 0.0),
                 ("pos=S-1", S - 1, False, 0.0), ("ring not full", S // 3, True, 0.0),
                 ("ring full", S + 7, True, 0.0), ("softcap=2", S - 1, False, 2.0)]
        worst = 0.0
        for label, pos, ring, cap in cases:
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            a = kda.decode_attention(q, k, v, p, ring=ring, softcap=cap).float()
            b = kda.decode_attention_plain(q, k, v, p, ring=ring, softcap=cap).float()
            err = (a - b).abs().max().item()
            ok = decode_within(a, b, tol)
            worst = max(worst, err)
            print(f"[check] B1 {name} {label}: max_abs_err={err:.3e} "
                  f"max|plain|={b.abs().max().item():.3e} tol={tol:g} {'ok' if ok else 'MISS'}")
            if not ok:
                misses.append(f"{name} {label}")
        pos = S // 2
        k2, v2 = _garbage(torch, k, v, pos)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        clean = kda.decode_attention(q, k, v, p)
        dirty = kda.decode_attention(q, k2, v2, p)
        plain = kda.decode_attention_plain(q, k2, v2, p)
        err = (dirty.float() - plain.float()).abs().max().item()
        same = torch.equal(clean, dirty)
        if fp8:
            same = same and torch.equal(clean, kda.decode_attention(
                q, *_garbage(torch, k, v, pos, fp8_nan=True), p))
        ok = same and decode_within(dirty.float(), plain.float(), tol)
        worst = max(worst, err)
        print(f"[check] B1 {name} garbage tail{' (and fp8 NaN)' if fp8 else ''}: "
              f"bit-identical={same} max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(f"{name} garbage tail")
        errs[name] = worst
    torch.cuda.synchronize()
    check(not misses, f"B1 disagrees with its plain version: {misses}")
    return errs


def time_ms(torch, fn, flush, reps=30) -> float:
    """Mean device time of fn() over reps calls, with the 50 MB L2
    overwritten before each (the serving loop finds the cache cold).  A
    spin on the device after the flush keeps it busy while the host
    enqueues fn's kernels, so the events bracket device work only."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)     # ~0.5 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def time_warm_ms(torch, fn, reps=64) -> float:
    """Mean device time of fn() over reps calls back to back with the L2
    warm: the host enqueues all of them behind a spin on the device, so
    the events bracket the kernels alone, one after another, without
    time_ms's cold L2 and its event pair around each lone launch."""
    for _ in range(3):
        fn()
    torch.cuda._sleep(20_000_000)        # ~10 ms, longer than enqueueing reps calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def decode_bound(shape, pos) -> tuple[float, str]:
    """Least time for one call: K/V rows up to pos read once at the cache's
    itemsize, q read, out written, against the card's memory rate; or its
    multiply-adds against the peak rate for q's type (fp8 caches compute
    in q's type), whichever is larger."""
    B, Hq, Hkv, D, S, dtype, cache_dtype = shape
    n_valid = min(pos + 1, S)
    bytes_ = (2 * B * n_valid * Hkv * D * cache_dtype.itemsize
              + 2 * B * Hq * D * dtype.itemsize + 4)
    ops = 4 * B * Hq * n_valid * D
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[str(dtype).removeprefix("torch.")]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(torch, q, k, v, pos):
    """One library call computing B1's function over the same cache and
    mask (scaled_dot_product_attention, K/V repeated over the group); None
    for an fp8 cache, which it does not take."""
    import torch.nn.functional as F
    if k.dtype == torch.float8_e4m3fn:
        return None
    B, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    q4, k4, v4 = q[:, :, None], k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(S, device="cuda") <= pos)[None, None, None]
    if Hq != Hkv:
        k4, v4 = k4.repeat_interleave(Hq // Hkv, 1), v4.repeat_interleave(Hq // Hkv, 1)
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)


def host_us(torch, fn, calls=200) -> float:
    """Host microseconds of one call of fn, the device's work not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def time_decode(torch, kda, shapes) -> dict:
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for i, (name, shape) in enumerate(shapes.items()):
        B, Hq, Hkv, D, S, dtype, cache_dtype = shape
        q, k, v = decode_inputs(torch, shape, seed=100 + i)
        pos = S - 1
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        call = lambda: kda.decode_attention(q, k, v, p)                     # noqa: E731
        library = sdpa_call(torch, q, k, v, pos)
        t = {
            "ms": time_ms(torch, call, flush),
            "warm_ms": time_warm_ms(torch, call),
            "plain_ms": time_ms(torch, lambda: kda.decode_attention_plain(q, k, v, p), flush),
            "library_ms": time_ms(torch, library, flush) if library else None,
            "host_us": host_us(torch, call),
        }
        t["bound_ms"], t["bound_by"] = decode_bound(shape, pos)
        t["shape"] = (f"B={B} Hq={Hq} Hkv={Hkv} D={D} S={S} pos={pos} q "
                      f"{str(dtype).removeprefix('torch.')} cache "
                      f"{str(cache_dtype).removeprefix('torch.')}")
        lib = f"{t['library_ms']:.4f} ms" if library else "none (takes no fp8 cache)"
        print(f"[time] B1 {name} ({t['shape']}): kernel {t['ms']:.4f} ms (warm, back to "
              f"back: {t['warm_ms']:.4f} ms; host {t['host_us']:.1f} us a call), plain "
              f"{t['plain_ms']:.4f} ms, sdpa {lib}, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of bound")
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# Main path and output checks
# ---------------------------------------------------------------------------


def expected_decode_launches(serve_mod, out, get_config=None) -> int:
    """Layers x max_new summed over the served batches, batched as `serve`
    batches them; the KV-off characterization never decodes.  Layers are
    those of the configs `serve` ran (`get_config`: the registry's, or the
    MoE phase's depth cut)."""
    from repro_torch.data import token_batches
    if get_config is None:
        from repro_torch.configs import get_config
    n = 0
    for arch, reqs in out["plan"].per_model.items():
        if not reqs:
            continue
        cfg = get_config(arch)
        qs = [(r.tau_in, r.max_new_tokens) for r in reqs]
        for b in token_batches(qs, 4, cfg.vocab_size):
            n += cfg.n_layers * int(b["tau_out"].max())
    return n


def run_serve(torch, kda, serve_mod, limit_w, counter) -> tuple[int, list]:
    """Phase 6's llama2 serve.  Returns B1's launches over it and the
    llama2-7b/13b profiles fitted from the card's runs."""
    from repro_torch.energy.meter import NvmlMeter
    from repro_torch.serving import InferenceEngine
    idle_w = idle_watts()
    torch.cuda.reset_peak_memory_stats()
    with EngineCalls(InferenceEngine, {"B1": kda}) as calls:
        kda.launches = 0
        whole = NvmlMeter("cuda")
        out, wall, _ = whole.measure(lambda: serve_mod.serve(
            SERVE_ARCHS, n_queries=SERVE_QUERIES, zeta=0.5,
            char_max_tokens=SERVE_CHAR_MAX_TOKENS, device="cuda"))
        launches = kda.launches

    calls.report("serve")
    energy_report("serve", serve_mod, out, whole.last, idle_w, limit_w, counter, calls)
    print(f"[serve] serve() wall s={wall} (characterized up to {SERVE_CHAR_MAX_TOKENS} tokens)")
    print(f"[serve] max_memory_allocated GiB={torch.cuda.max_memory_allocated() / 2**30}")
    expected = expected_decode_launches(serve_mod, out)
    print(f"[serve] B1 launches={launches} expected={expected} (layers x max_new over batches)")
    n_routed = sum(len(rs) for rs in out["plan"].per_model.values())
    check(n_routed == SERVE_QUERIES, f"plan routed {n_routed} of {SERVE_QUERIES} queries")
    check(sum(t["queries"] for t in out["totals"].values()) == SERVE_QUERIES,
          "served query count differs from the plan")
    check(all(t["tokens"] > 0 and t["runtime_s"] > 0 for t in out["totals"].values()),
          "a served model reports no tokens or no time")
    check(expected > 0 and launches == expected,
          f"B1 launched {launches} times over serve(), expected {expected}")
    return launches, out["profiles"]


def frontend_batch(torch, cfg, B, seed, device="cuda") -> dict:
    """Random f32 frames (encdec) or patches (vlm) for a batch of B, drawn
    on `device` from a seeded generator, in the shapes `measure_fn`'s zero
    inputs have; {} for the token-only families."""
    from repro_torch.serving.engine import frontend_inputs
    g = torch.Generator(device=device).manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g, device=device)
            for k, v in frontend_inputs(cfg, B).items()}


def compare_reduced(torch, arch, prompt_len, cache_dtype="", **fields) -> None:
    """A reduced f32 model on the card (through the kernels) against the
    same weights on the CPU (plain versions): greedy tokens identical,
    prefill and decode logits within 1e-4.  With an fp8 cache
    (`cache_dtype`) the CPU runs KV-on too: the cache's rounding is the
    model's, and both sides must make it alike.  `fields` replace config
    fields (deepseek-v3's `mla_absorb`).  encdec and vlm models get the
    same random frames or patches on both sides."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving.engine import prefix_positions

    cfg = get_config(arch).replace(**fields)
    if cache_dtype:
        cfg = cfg.replace(cache_dtype=cache_dtype)
    api = get_api(cfg)
    label = (f"{arch}{' ' + cache_dtype + ' cache' if cache_dtype else ''}"
             + "".join(f" {k}={v}" for k, v in fields.items()))
    cpu = api.init_params(cfg, torch.Generator().manual_seed(1), torch.device("cpu"))
    gpu = _map(cpu, lambda t: t.to("cuda"))
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, prompt_len)).astype(np.int32)
    extra = frontend_batch(torch, cfg, 2, seed=1, device="cpu")
    a, _ = InferenceEngine(cfg, gpu, kv_cache=True, device="cuda").generate(
        {"tokens": toks, **extra}, 8)
    b, _ = InferenceEngine(cfg, cpu, kv_cache=bool(cache_dtype), device="cpu").generate(
        {"tokens": toks, **extra}, 8)
    print(f"[outputs] {label} greedy tokens, card KV-on vs CPU "
          f"KV-{'on' if cache_dtype else 'off'}: identical={np.array_equal(a, b)}")
    check(np.array_equal(a, b), f"{label}: greedy tokens differ between card and CPU")
    worst = 0.0
    with torch.no_grad():
        batch = {"tokens": torch.as_tensor(toks), **extra}
        cache_len = prefix_positions(cfg) + prompt_len + 20
        lg, cg = api.prefill(cfg, gpu, {k: v.to("cuda") for k, v in batch.items()},
                             cache_len=cache_len)
        lc, cc = api.prefill(cfg, cpu, batch, cache_len=cache_len)
        if cache_dtype:
            check(cg.k.dtype == cfg.kv_dtype, f"{label}: cache is {cg.k.dtype}")
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        for t in range(4):
            tok = torch.as_tensor(a[:, t])
            lg, cg = api.decode_step(cfg, gpu, cg, {"token": tok.to("cuda")})
            lc, cc = api.decode_step(cfg, cpu, cc, {"token": tok})
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
    print(f"[outputs] {label} logits, card vs CPU: max_abs_err={worst:.3e} tol=1e-4")
    check(worst <= 1e-4, f"{label}: logits differ between card and CPU")


def check_full_width(torch, serve_mod, arch, tol=0.1):
    """Full width: decode logits finite and close to a full re-forward of
    the same tokens.  Returns (engine, cache, last token) for profiling."""
    eng = serve_mod.build_engine(arch, kv_cache=True, device="cuda")
    cache, token = check_decode_vs_reforward(torch, eng.api, eng.cfg, eng.params, tol=tol)
    return eng, cache, token


# In f32 a MoE token's experts may differ between a decode step and a
# re-forward only where the re-forward's router logits tie to within this
# (their drift is ~1e-6).  In bf16 router logits are a bf16 product, so
# exact ties are common, and rounding through the layers moves them by
# hundredths to a few tenths: there the flips are reported.
F32_TIE_GAP = 1e-3


class RouteLog:
    """While active, records each MoE dispatch's router output (experts
    chosen, probabilities) as `repro_torch.models.moe.route` returns it."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.orig, self.calls = moe, moe.route, []

        def route(cfg, router, xt):
            probs, gates, eidx = self.orig(cfg, router, xt)
            self.calls.append((eidx, probs))
            return probs, gates, eidx

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig


def route_flips(torch, dec_calls, ref_calls, seq_len):
    """Per token of a decode step: whether its experts differ from those
    the re-forward chose at the same (last) position in some MoE layer;
    the re-forward's logit gap between the K-th and (K+1)-th expert in the
    first layer where a token's differ (past it the token's hidden state
    has diverged, and later layers route it apart at any margin); and the
    count of (token, layer) pairs that differ."""
    check(len(dec_calls) == len(ref_calls), "decode and re-forward ran different MoE layers")
    first_gap, n_diff = {}, 0
    for (e_d, _), (e_r, p_r) in zip(dec_calls, ref_calls):
        B, K = e_d.shape
        last = torch.arange(B, device=e_d.device) * seq_len + seq_len - 1
        e_r, p_r = e_r[last], p_r[last]
        diff = (e_d.sort(-1).values != e_r.sort(-1).values).any(-1)
        top = p_r.sort(-1, descending=True).values
        gap = top[:, K - 1].log() - top[:, K].log()
        for b in diff.nonzero().flatten().tolist():
            n_diff += 1
            first_gap.setdefault(b, gap[b].item())
    flipped = torch.tensor([b in first_gap for b in range(B)], device=e_d.device)
    return flipped, [first_gap[b] for b in sorted(first_gap)], n_diff


def check_decode_vs_reforward(torch, api, cfg, params, tol=0.1, tie_gap=None):
    """Prefill 12 tokens, decode 4: the last decode logits finite and
    within relative L2 `tol` of a prefill of all 16 (0.1 in bf16, which
    rounds at other points in the two paths, through every layer; None:
    printed, not held).  Under
    MoE the two passes' expert choices are compared in every MoE layer; a
    token whose experts differ somewhere is left out of the logits'
    comparison, and with `tie_gap` must first differ where the re-forward's
    K-th and (K+1)-th router logits lie closer than that.  Returns (cache,
    last token)."""
    import numpy as np
    from repro_torch.models.common import padded_vocab
    from repro_torch.serving.engine import prefix_positions
    B, S = 4, 16
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32), device="cuda")
    extra = frontend_batch(torch, cfg, B, seed=2)
    P = prefix_positions(cfg)
    with torch.no_grad():
        _, cache = api.prefill(cfg, params, {"tokens": toks[:, :12], **extra},
                               cache_len=P + 48)
        for t in range(12, S - 1):
            _, cache = api.decode_step(cfg, params, cache, {"token": toks[:, t]})
        with RouteLog() as dec:
            logits, cache = api.decode_step(cfg, params, cache, {"token": toks[:, S - 1]})
        with RouteLog() as ref:
            full, _ = api.prefill(cfg, params, {"tokens": toks, **extra}, cache_len=P + S)
    torch.cuda.synchronize()
    shape = tuple(logits.shape)
    # columns past the vocabulary pad it to a multiple of 128, masked to -1e30
    logits, full = logits[:, :cfg.vocab_size].float(), full[:, :cfg.vocab_size].float()
    finite = bool(torch.isfinite(logits).all())
    per_token = ((logits - full).norm(dim=-1) / full.norm(dim=-1)).tolist()
    rel = ((logits - full).norm() / full.norm()).item()
    kept = torch.ones(B, dtype=torch.bool, device="cuda")
    gaps, n_diff = [], 0
    if dec.calls:
        flipped, gaps, n_diff = route_flips(torch, dec.calls, ref.calls, S)
        kept = ~flipped
    n_kept = int(kept.sum())
    rel_kept = ((logits[kept] - full[kept]).norm() / full[kept].norm()).item() if n_kept else 0.0
    print(f"[outputs] {cfg.name} decode logits {shape} finite={finite}; relative L2 "
          f"difference from a full re-forward={rel:.4g}, per token "
          f"{', '.join(f'{r:.4g}' for r in per_token)}"
          + (f"; {len(dec.calls)} MoE layers x {B} tokens, expert sets differing at "
             f"{n_diff}, in {len(gaps)} tokens (re-forward logit gap where each first "
             f"differs: {', '.join(f'{g:.4g}' for g in gaps)}"
             f"{f'; tol {tie_gap:g}' if tie_gap else ''}), over the {n_kept} tokens "
             f"without: {rel_kept:.4g}" if dec.calls else "")
          + (f" (tol {tol:g})" if tol else " (not held: see check_moe_outputs)"))
    check(finite and shape == (4, padded_vocab(cfg.vocab_size)), f"{cfg.name}: logits bad")
    check(tie_gap is None or all(g < tie_gap for g in gaps),
          f"{cfg.name}: decode and re-forward chose other experts at a clear router margin")
    check(tol is None or rel_kept <= tol,
          f"{cfg.name}: full-width decode disagrees with the re-forward")
    return cache, toks[:, S - 1]


# B1's kernels (bf16 and f32 paths) in the profiler's names.
B1_KEYS = ("flash_decode_",)


class PlainAttention:
    """While active, the model path's attention runs B1's plain version on
    the card (the reference's arithmetic), for comparison only."""

    def __init__(self, kda):
        self.kda = kda

    def __enter__(self):
        self.orig = self.kda.decode_attention
        self.kda.decode_attention = self.kda.decode_attention_plain
        return self

    def __exit__(self, *exc):
        self.kda.decode_attention = self.orig


def _fp8_vs_bf16(torch, kda, api, cfg, params, toks, prefix, steps):
    """Decode logits per step with the config's cache and with an fp8 one,
    after the same prefill, and B1's launches over the fp8-cache decode
    steps alone (its count set to 0 just before them, read just after)."""
    cfg8 = cfg.replace(cache_dtype="float8_e4m3fn")
    out = {}
    with torch.no_grad():
        for name, c in (("base", cfg), ("fp8", cfg8)):
            _, cache = api.prefill(c, params, {"tokens": toks[:, :prefix]}, cache_len=48)
            check(cache.k.dtype == c.kv_dtype, f"{c.name}: cache is {cache.k.dtype}")
            out[name] = []
            kda.launches = 0
            for t in range(prefix, prefix + steps):
                logits, cache = api.decode_step(c, params, cache, {"token": toks[:, t]})
                out[name].append(logits[:, :cfg.vocab_size].float())
    return out, kda.launches


def check_fp8_decode(torch, kda, eng) -> int:
    """fp8 KV caches (float8_e4m3fn) through B1.  (1) The reference's own
    gate (tests/test_models.py: qwen3-1.7b-reduced, one decode step after a
    12-token prefill, mean |delta logit| against the full-precision cache
    < 0.2) on the card.  (2) Full-width llama2-7b, 4 decode steps: the fp8
    decode through the kernel against the same through the plain version
    (the reference's arithmetic), relative L2 <= 0.1 as check_full_width
    holds bf16 paths, beside the same gap with the bf16 cache and a
    control the limit must fail (plain fp8 against plain bf16 cache); and
    the fp8-vs-bf16 gap of both, against the same 0.2.  Returns B1's
    launches over the kernel's fp8 decode steps, which must be 4 x layers
    (and 0 over the plain version's)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_api

    rcfg = get_config("qwen3-1.7b-reduced")
    rapi = get_api(rcfg)
    rparams = rapi.init_params(rcfg, torch.Generator(device="cuda").manual_seed(0),
                               torch.device("cuda"))
    rtoks = torch.as_tensor(np.random.default_rng(0).integers(
        1, rcfg.vocab_size, (2, 13)).astype(np.int32), device="cuda")
    small, _ = _fp8_vs_bf16(torch, kda, rapi, rcfg, rparams, rtoks, 12, 1)
    gap = (small["fp8"][0] - small["base"][0]).abs().mean().item()
    print(f"[outputs] {rcfg.name} fp8 vs f32 cache, the reference's gate: mean |delta logit| "
          f"{gap:.4f} (< 0.2)")
    check(gap < 0.2, f"{rcfg.name}: fp8-cache decode off the reference's gate")

    cfg, api = eng.cfg, eng.api
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (4, 16)).astype(np.int32), device="cuda")
    kern, n8 = _fp8_vs_bf16(torch, kda, api, cfg, eng.params, toks, 12, 4)
    with PlainAttention(kda):
        plain, n_plain = _fp8_vs_bf16(torch, kda, api, cfg, eng.params, toks, 12, 4)
    torch.cuda.synchronize()
    gaps = {k: [(a - b).abs().mean().item() for a, b in zip(r["fp8"], r["base"])]
            for k, r in (("kernel", kern), ("plain", plain))}

    def rel_l2(xs, ys):
        return max(((a - b).norm() / b.norm()).item() for a, b in zip(xs, ys))

    rel = rel_l2(kern["fp8"], plain["fp8"])
    # what the 0.1 limit is held against: the same kernel-vs-plain gap with
    # the bf16 cache (bf16's rounding through 32 layers), and the fp8
    # cache's own effect (plain fp8 vs plain bf16), which the limit must fail
    rel_bf16 = rel_l2(kern["base"], plain["base"])
    control = rel_l2(plain["fp8"], plain["base"])
    mag = float(np.mean([x.abs().mean().item() for x in kern["base"]]))
    finite = all(bool(torch.isfinite(x).all()) for x in kern["fp8"])
    print(f"[outputs] {cfg.name} fp8 cache, 4 decode steps: kernel vs plain relative L2 "
          f"{rel:.4f} (tol 0.1; with the bf16 cache {rel_bf16:.4f}; control, plain fp8 vs plain "
          f"bf16 cache, {control:.4f}, must exceed the tol), finite={finite}; "
          f"mean |delta logit| fp8 vs bf16 cache per step: "
          f"kernel {', '.join(f'{g:.4f}' for g in gaps['kernel'])}, plain "
          f"{', '.join(f'{g:.4f}' for g in gaps['plain'])} (the reference's 0.2, at this "
          f"width: {'met' if max(gaps['kernel']) < 0.2 else 'missed'} by the kernel, "
          f"{'met' if max(gaps['plain']) < 0.2 else 'missed'} by the plain version); "
          f"mean |logit| {mag:.4f}; B1 launches over the fp8 steps {n8}")
    check(finite and rel <= 0.1, f"{cfg.name}: fp8-cache decode through B1 off the plain version")
    check(control > 0.1, f"{cfg.name}: the 0.1 limit cannot tell an fp8 cache from a bf16 one "
          f"(control {control:.4f})")
    check(n8 == 4 * cfg.n_layers and n_plain == 0,
          f"B1 launched {n8} times over 4 fp8 decode steps of {cfg.n_layers} layers, "
          f"{n_plain} times through the plain version")
    return n8


def check_outputs(torch, kda, serve_mod) -> int:
    """Returns B1's launches over the full-width fp8-cache decode."""
    compare_reduced(torch, "llama2-7b-reduced", 12)
    compare_reduced(torch, "llama2-7b-reduced", 12, cache_dtype="float8_e4m3fn")
    eng, cache, token = check_full_width(torch, serve_mod, "llama2-7b")
    fp8_launches = check_fp8_decode(torch, kda, eng)
    decode_breakdown(torch, eng.api, eng.cfg, eng.params, cache, token, B1_KEYS,
                     "B1 (one kernel a call)")
    return fp8_launches


# Phase 7's graphed-against-eager block: full width, a prompt of 40 tokens
# and 8 new ones, batch 4 KV-on (as served) and 2 KV-off (as characterized)
GRAPH_ARCHS = ["llama2-7b", "mamba2-130m", "recurrentgemma-9b"]
GRAPH_PROMPT, GRAPH_NEW = 40, 8


def graph_drive(torch, eng, batch, steps) -> tuple:
    """Prefill and `steps` greedy decode steps through the engine's own
    steps (captured first when it is graphed), as `generate` runs them:
    each step's logits and tokens, and the cache and token to step on."""
    eng._prepare(batch, steps)
    inputs = {"tokens": torch.as_tensor(batch["tokens"], device=eng.device),
              **eng._extra_inputs(batch)}
    logits, cache = eng._prefill(inputs, eng._cache_len(inputs["tokens"].shape[1], steps))
    out = [logits.clone()]
    token = eng.sampler(logits, eng.generator)
    toks = [token.clone()]
    for _ in range(steps):
        key = eng._decode_key(cache, token)
        token, cache = eng._decode(cache, token)
        out.append(eng.steps[key].outputs[2].clone())
        toks.append(token.clone())
    torch.cuda.synchronize()
    return out, toks, cache, token


def prefill_logits(eng) -> list:
    """The logits of each of `eng`'s prefill calls from now on, cloned at
    the call: a graph's static logits hold only until the engine's next
    replay (its graphs share one memory pool)."""
    seen = []

    def prefill(inputs, cache_len):
        logits, cache = type(eng)._prefill(eng, inputs, cache_len)
        seen.append(logits.clone())
        return logits, cache

    eng._prefill = prefill
    return seen


def step_profile(torch, label, fn, keys, steps=6) -> tuple:
    """Wall ms, device busy ms and idle share of one engine step, and the
    profiler's records a call of the kernels named by `keys` (None where
    it saw no device time)."""
    wall_ms, events, why = _profile(torch, fn, steps)
    if not events:
        print(f"[graphs] {label}: wall {wall_ms:.3f} ms; busy not measured ({why})")
        return wall_ms, None, None
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    records = sum(e.count for e in events if any(k in e.key for k in keys)) // steps
    print(f"[graphs] {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; {keys} kernel records a call: {records}")
    return wall_ms, busy_ms, records


def check_graphs(torch, serve_mod) -> None:
    """The engine's CUDA graphs against the same steps run eagerly on the
    card (`graphed = False`), at full width: GRAPH_ARCHS KV on (prefill and
    GRAPH_NEW decode steps) and KV off (the GRAPH_NEW re-forwards of a
    characterization trial).  Greedy tokens identical and every step's
    logits bit-identical; each engine's graphs; one decode step's and one
    KV-off prefill's wall, device busy time and idle share in both modes;
    and in one replay the profiler's kernel records: B1 once per
    attention layer in a decode step, B3 once per SSM layer and B4 once
    per recurrent layer in a KV-off prefill."""
    import numpy as np
    from repro_torch.models import hybrid
    from repro_torch.serving import InferenceEngine
    t0 = time.perf_counter()
    for arch in GRAPH_ARCHS:
        base = serve_mod.build_engine(arch, kv_cache=True, device="cuda")
        cfg, params = base.cfg, base.params
        del base
        scans = SCAN_KERNEL_KEYS["B3 forward"] + SCAN_KERNEL_KEYS["B4 forward"]
        if cfg.family == "hybrid":
            want = {"decode": hybrid.pattern_counts(cfg)[2], "prefill": hybrid.n_rec_layers(cfg)}
        else:
            want = {"decode": cfg.n_layers * (cfg.family == "dense"),
                    "prefill": cfg.n_layers * (cfg.family == "ssm")}
        for kv, B in ((True, 4), (False, 2)):
            engs = {}
            for graphed in (True, False):
                engs[graphed] = InferenceEngine(cfg, params, kv_cache=kv,
                                                bucket=serve_mod.SERVE_BUCKET, device="cuda")
                engs[graphed].graphed = graphed
            toks = np.random.default_rng(7).integers(
                1, cfg.vocab_size, (B, GRAPH_PROMPT)).astype(np.int32)
            batch = {"tokens": toks}
            if kv:
                runs = {g: graph_drive(torch, e, batch, GRAPH_NEW) for g, e in engs.items()}
                same_tokens = all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))
                same = [torch.equal(a, b) for a, b in zip(runs[True][0], runs[False][0])]
                kind, keys, n_want = "decode", B1_KEYS, want["decode"]
                fns = {g: (lambda e=e, c=runs[g][2], t=runs[g][3]: e._decode(c, t))
                       for g, e in engs.items()}
            else:
                seen = {g: prefill_logits(e) for g, e in engs.items()}
                gens = {g: e.generate(batch, GRAPH_NEW)[0] for g, e in engs.items()}
                same_tokens = np.array_equal(gens[True], gens[False])
                same = [torch.equal(a, b) for a, b in zip(seen[True], seen[False])]
                same.append(len(seen[True]) == len(seen[False]) == len(engs[True].steps)
                            == GRAPH_NEW)
                kind, keys, n_want = "KV-off prefill", scans, want["prefill"]
                L = GRAPH_PROMPT + GRAPH_NEW - 1          # the trial's longest, captured
                inputs = {"tokens": torch.as_tensor(np.random.default_rng(8).integers(
                    1, cfg.vocab_size, (B, L)).astype(np.int32), device="cuda")}
                fns = {g: (lambda e=e: e._prefill(inputs, L)) for g, e in engs.items()}
            g = engine_graphs(engs[True])
            print(f"[graphs] {arch} KV-{'on' if kv else 'off'} (B={B}, {GRAPH_PROMPT} + "
                  f"{GRAPH_NEW} tokens): greedy tokens graphed == eager {same_tokens}; logits "
                  f"bit-identical in {sum(same)} of {len(same)} steps; {g['graphs']} graphs, "
                  f"capture s={g['capture_s']}, pool GiB={g['pool_gib']}, warm-up launches "
                  f"{g['warm_launches']}")
            check(same_tokens and all(same), f"{arch} kv={kv}: graphed steps differ from eager")
            stats = {}
            for graphed, fn in fns.items():
                label = f"{arch} {kind} step {'graphed (replay)' if graphed else 'eager'}"
                stats[graphed] = step_profile(torch, label, fn, keys)
            records = stats[True][2]
            print(f"[graphs] {arch} {kind}: graphed wall / eager wall "
                  f"{stats[True][0] / stats[False][0]:.3f}; kernel records a replay {records}, "
                  f"want {n_want}")
            check(records == n_want, f"{arch} {kind}: the replay's trace shows {records} "
                  f"records of {keys}, want {n_want}")
            del engs, fns
            gc.collect()
            torch.cuda.empty_cache()
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[phase] graphs against eager s={time.perf_counter() - t0}")


def _profile(torch, fn, steps):
    """Wall ms per call of fn (unprofiled, synchronized), and the kernels
    torch.profiler saw over `steps` more calls (None and why if it saw no
    device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    fn()
                torch.cuda.synchronize()
            # kernels only: an operator's row repeats its kernels' device time
            events = [e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA
                      and e.self_device_time_total > 0]
        except (RuntimeError, AssertionError) as e:   # reporting only: no tracer
            return wall_ms, None, str(e)
    return wall_ms, events or None, "the profiler saw no device time"


def kernel_split(torch, fn, pattern, steps=10) -> dict | None:
    """Device ms per call of each kernel fn launches whose name matches the
    regular expression `pattern` (its first group names it), from
    torch.profiler over `steps` calls with the L2 warm; None if the
    profiler saw no device time."""
    _, events, _ = _profile(torch, fn, steps)
    if not events:
        return None
    split = collections.defaultdict(float)
    for e in events:
        m = re.search(pattern, e.key)
        if m:
            split[m.group(1)] += e.self_device_time_total / 1e3 / steps
    return dict(split)


def _breakdown(label, wall_ms, events, why, steps, kernel_keys, kernel_label) -> dict | None:
    """Prints wall, device busy and idle share, the named kernels' share of
    the busy time and the top kernels; returns those numbers (None if the
    profiler saw no device time)."""
    if not events:
        print(f"[profile] {label}: wall {wall_ms:.3f} ms; device busy share not measured ({why})")
        return None
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    mine = [e for e in events if any(k in e.key for k in kernel_keys)]
    k_ms = sum(e.self_device_time_total for e in mine) / 1e3 / steps
    launches = sum(e.count for e in mine) // steps
    print(f"[profile]   {kernel_label}: {k_ms:.4f} ms per call, "
          f"{k_ms / busy_ms:.3f} of device busy time, over "
          f"{launches} launches a call of "
          f"{sorted({e.key[:80] for e in mine})}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / steps:.4f} ms per call "
              f"x{e.count // steps} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": 1 - busy_ms / wall_ms,
            "kernel_ms": k_ms, "kernel_share": k_ms / busy_ms, "launches": launches}


def decode_breakdown(torch, api, cfg, params, cache, token, kernel_keys, kernel_label,
                     steps=8) -> None:
    """Wall time of a full-width decode step (unprofiled) against the
    device's busy time in it (torch.profiler: the sum of the kernels'
    device time), and the named kernels' share of that time."""
    state = {"cache": cache}

    def step():
        _, state["cache"] = api.decode_step(cfg, params, state["cache"], {"token": token})

    wall_ms, events, why = _profile(torch, step, steps)
    _breakdown(f"{cfg.name} decode step, B={token.shape[0]}", wall_ms, events, why, steps,
               kernel_keys, kernel_label)


def prefill_breakdown(torch, api, cfg, params, tokens, kernel_keys, kernel_label,
                      steps=4) -> None:
    """The same for a full-width prefill of `tokens` (with random frames
    or patches for encdec and vlm)."""
    from repro_torch.serving.engine import prefix_positions
    batch = {"tokens": tokens, **frontend_batch(torch, cfg, tokens.shape[0], seed=3)}
    wall_ms, events, why = _profile(
        torch, lambda: api.prefill(cfg, params, batch,
                                   cache_len=prefix_positions(cfg) + tokens.shape[1]),
        steps)
    _breakdown(f"{cfg.name} prefill, B={tokens.shape[0]} S={tokens.shape[1]}", wall_ms,
               events, why, steps, kernel_keys, kernel_label)


# ---------------------------------------------------------------------------
# Kernels B3 and B4: checks and timing
# ---------------------------------------------------------------------------


def ssd_inputs(torch, b, s, h, p, g, n, dtype, seed):
    """tests/test_kernels.py::TestSSDScan's scales."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return ((rand(b, s, h, p) * 0.5).to(dtype), -(rand(b, s, h) * 0.3).abs(),
            (rand(b, s, g, n) * 0.5).to(dtype), (rand(b, s, g, n) * 0.5).to(dtype),
            rand(b, h, p, n) * 0.5)


def rglru_inputs(torch, B, S, W, seed):
    """tests/test_kernels.py::TestRGLRU's scales."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (0.7 + 0.299 * torch.rand((B, S, W), generator=gen, device="cuda"),
            0.1 * torch.randn((B, S, W), generator=gen, device="cuda"),
            torch.randn((B, W), generator=gen, device="cuda"))


def ssd_within(torch, ours, plain, dtype) -> tuple[float, bool]:
    """f32: atol 2e-4, rtol 1e-3 (TestSSDScan).  bf16: within 2e-2 of the
    output's largest magnitude (kernel and plain version round the scores,
    the chunk states and the decay-weighted inputs to bf16 as the reference
    does, but the plain version's bf16 einsums also round their outputs,
    and the two chunk at 64 and 256 steps)."""
    diff = (ours.float() - plain.float()).abs()
    if dtype == torch.float32:
        return diff.max().item(), bool((diff <= 2e-4 + 1e-3 * plain.float().abs()).all())
    return diff.max().item(), diff.max().item() <= 2e-2 * plain.float().abs().max().item()


# Edges of the kernels' designs: B3's 64-step bf16 chunks (S = 1, 63, 64,
# 65, 129), state sizes 16..256 and two groups; B4's tiles (S = 4100),
# float4 edge (W = 4097) and the serve prefill shape.
SSD_EDGES = [(2, 1, 24, 64, 1, 128), (2, 63, 24, 64, 1, 128), (2, 64, 24, 64, 1, 128),
             (2, 65, 24, 64, 1, 128), (2, 129, 24, 64, 1, 128), (1, 65, 4, 16, 2, 16),
             (1, 129, 4, 32, 2, 64), (2, 129, 8, 64, 2, 256)]
RGLRU_EDGES = [(4, 48, 4096), (2, 4100, 4096), (2, 128, 4097)]


def check_scans(torch, kss, krg) -> dict:
    """B3 at mamba2-130m's shape (h=24, p=64, n=128, one group) and B4 at
    recurrentgemma-9b's width (W=4096), S spanning short, ragged, whole and
    multi-chunk sequences, with and without an initial state; then the
    designs' edges (SSD_EDGES, RGLRU_EDGES).  Returns kernel -> worst
    max_abs_err per dtype."""
    worst = collections.defaultdict(float)
    misses = []
    ssd_cases = [(b, s, 24, 64, 1, 128) for b in (2, 4) for s in (8, 37, 128, 256, 300)]
    for case in ssd_cases + SSD_EDGES:
        b, s, h, p, g, n = case
        for dtype in (torch.bfloat16, torch.float32):
            xdt, dA, B, C, h0 = ssd_inputs(torch, *case, dtype, seed=s + b)
            for init in (None, h0):
                y, fin = kss.ssd_scan(xdt, dA, B, C, chunk=256, h0=init)
                y_p, fin_p = kss.ssd_scan_plain(xdt, dA, B, C, chunk=256, h0=init)
                (ey, oy), (ef, of) = (ssd_within(torch, y, y_p, dtype),
                                      ssd_within(torch, fin, fin_p, dtype))
                name = str(dtype).removeprefix("torch.")
                worst[f"B3 {name}"] = max(worst[f"B3 {name}"], ey, ef)
                label = (f"b={b} S={s} h={h} p={p} g={g} n={n} {name} "
                         f"h0={'yes' if init is not None else 'no'}")
                print(f"[check] B3 {label}: y max_abs_err={ey:.3e}, final state "
                      f"max_abs_err={ef:.3e} {'ok' if oy and of else 'MISS'}")
                if not (oy and of):
                    misses.append(f"B3 {label}")
    rglru_cases = [(2, s, 4096) for s in (1, 8, 37, 128, 300)]
    for Bsz, s, W in rglru_cases + RGLRU_EDGES:
        a, bb, h0 = rglru_inputs(torch, Bsz, s, W, seed=s)
        for init in (None, h0):
            h, last = krg.rglru_scan(a, bb, init)
            h_p, last_p = krg.rglru_scan_plain(a, bb, init)
            err = max((h - h_p).abs().max().item(), (last - last_p).abs().max().item())
            ok = bool(((h - h_p).abs() <= 1e-4 + 1e-4 * h_p.abs()).all()
                      and ((last - last_p).abs() <= 1e-4 + 1e-4 * last_p.abs()).all())
            worst["B4 float32"] = max(worst["B4 float32"], err)
            label = (f"B={Bsz} S={s} W={W} {krg.plan(s, W)} "
                     f"h0={'yes' if init is not None else 'no'}")
            print(f"[check] B4 {label}: max_abs_err={err:.3e} tol=1e-4 {'ok' if ok else 'MISS'}")
            if not ok:
                misses.append(f"B4 {label}")
    torch.cuda.synchronize()
    check(not misses, f"B3/B4 disagree with their plain versions: {misses}")
    return dict(worst)


def ssd_bound(b, s, h, p, g, n, dtype_name) -> tuple[float, str]:
    """x and B, C read, dA read, y and the f32 final state written, against
    the memory rate; or the recurrence's 4*P*N flops a step a head against
    the peak rate for the input type, whichever is larger."""
    size = 4 if dtype_name == "float32" else 2
    bytes_ = (2 * b * s * h * p * size + 2 * b * s * g * n * size + 4 * b * s * h
              + 4 * b * h * p * n)
    ops = 4 * b * s * h * p * n
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rglru_bound(B, S, W) -> tuple[float, str]:
    """a and b read, h and h_last written (f32), against the memory rate;
    or one multiply-add a step a channel against the f32 rate."""
    bytes_ = 3 * B * S * W * 4 + B * W * 4
    ops = 2 * B * S * W
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_scans(torch, kss, krg) -> dict:
    """B3 and B4 at the shapes the serve path gives them: the KV-off
    characterization's longest forward (batch 2, S=128) and a KV-on serve
    prefill (batch 4, S=48); B3 in bf16 as the models run it and in f32
    (its other kernel), B4 in f32.  No single PyTorch call computes either
    function: no library time."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, b, s in (("characterize", 2, 128), ("serve", 4, 48)):
        for dtype, key in ((torch.bfloat16, f"B3 {label}"), (torch.float32, f"B3 f32 {label}")):
            xdt, dA, B, C, _ = ssd_inputs(torch, b, s, 24, 64, 1, 128, dtype, seed=7)
            t = {"ms": time_ms(torch, lambda: kss.ssd_scan(xdt, dA, B, C, chunk=256), flush),
                 "plain_ms": time_ms(torch, lambda: kss.ssd_scan_plain(xdt, dA, B, C,
                                                                       chunk=256), flush),
                 "library_ms": None}
            dtype_name = str(dtype).removeprefix("torch.")
            t["bound_ms"], t["bound_by"] = ssd_bound(b, s, 24, 64, 1, 128, dtype_name)
            t["shape"] = f"b={b} S={s} h=24 p=64 g=1 n=128 {dtype_name}"
            out[key] = t
        a, bb, _ = rglru_inputs(torch, b, s, 4096, seed=7)
        t = {"ms": time_ms(torch, lambda: krg.rglru_scan(a, bb), flush),
             "plain_ms": time_ms(torch, lambda: krg.rglru_scan_plain(a, bb), flush),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = rglru_bound(b, s, 4096)
        t["shape"] = f"B={b} S={s} W=4096 float32"
        out[f"B4 {label}"] = t
    for name, t in out.items():
        print(f"[time] {name} ({t['shape']}): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.1%} of bound")
    # What the times above stand on: the floor of this timing (a one-element
    # add), a streaming PyTorch kernel over B4's bytes (reads two [B,S,W]
    # f32 arrays, writes one: not B4's function), and B3's time per 64-step
    # chunk (bf16, b=2, S = 64..512).
    # The same again back to back with the L2 warm (time_warm_ms), as B4
    # meets a and b in a prefill right after the kernels that made them.
    one = torch.zeros(1, device="cuda")
    print(f"[time] timing floor (one-element add): {time_ms(torch, lambda: one.add_(1), flush):.4f}"
          f" ms; warm, back to back: {time_warm_ms(torch, lambda: one.add_(1)):.4f} ms")
    for b, s in ((2, 128), (4, 48)):
        a, bb, _ = rglru_inputs(torch, b, s, 4096, seed=7)
        h = torch.empty_like(a)
        print(f"[time] B4 yardstick, torch.mul(a, b, out=h) at B={b} S={s} W=4096: "
              f"{time_ms(torch, lambda: torch.mul(a, bb, out=h), flush):.4f} ms; warm, back to "
              f"back: {time_warm_ms(torch, lambda: torch.mul(a, bb, out=h)):.4f} ms, B4 "
              f"{time_warm_ms(torch, lambda: krg.rglru_scan(a, bb)):.4f} ms")
        xdt, dA, B, C, _ = ssd_inputs(torch, b, s, 24, 64, 1, 128, torch.bfloat16, seed=7)
        print(f"[time] B3 bf16 at b={b} S={s}, warm, back to back: "
              f"{time_warm_ms(torch, lambda: kss.ssd_scan(xdt, dA, B, C, chunk=256)):.4f} ms")
    sweep = {}
    for s in (64, 128, 256, 512):
        xdt, dA, B, C, _ = ssd_inputs(torch, 2, s, 24, 64, 1, 128, torch.bfloat16, seed=7)
        sweep[s] = time_ms(torch, lambda: kss.ssd_scan(xdt, dA, B, C, chunk=256), flush)
    print(f"[time] B3 bf16 at b=2 by S: " + ", ".join(f"S={s} {t:.4f} ms" for s, t in sweep.items())
          + f"; {(sweep[512] - sweep[64]) / 7:.4f} ms a further 64-step chunk")
    return out


# B3's backward at mamba2-130m's training shape (phase 11 (f)), the
# forward's chunk edges (S = 1, 63, 64, 65, 129), state sizes 16..256 and
# two groups; B4's at recurrentgemma-9b's training shape (phase 11 (g)),
# a sequence of many tiles (S = 4100) and a width off the float4 grid.
SSD_BWD_CASES = ([(16, 512, 24, 64, 1, 128)]
                 + [(2, s, 24, 64, 1, 128) for s in (1, 63, 64, 65, 129)]
                 + [(1, 65, 4, 16, 2, 16), (1, 129, 4, 32, 2, 64), (2, 129, 8, 64, 2, 256)])
RGLRU_BWD_CASES = [(16, 256, 4096), (2, 4100, 4096), (2, 128, 4097)]
SCAN_BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def scan_grads(torch, fn, inputs, cotangents) -> list:
    """Gradients of sum(out . cotangent) (a None cotangent: the output is
    unused, as the final state is in training) through fn, one per
    non-None input; an input out of reach gets zeros."""
    inputs = [None if t is None else t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*inputs)
    loss = sum((o.float() * c).sum() for o, c in zip(outs, cotangents) if c is not None)
    live = [t for t in inputs if t is not None]
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(grads, live)]


def grad_errs(ours, ref) -> list[float]:
    """Per gradient, |ours - ref| over that gradient's own largest |ref|.
    A gradient whose reference is under a thousandth of the largest one's
    (ddA at S = 1 without h0 is zero analytically) is held at that
    thousandth instead."""
    tops = [float(r.float().abs().max()) for r in ref]
    floor = 1e-3 * max(max(tops), 1e-30)
    return [float((o.float() - r.float()).abs().max()) / max(t, floor)
            for o, r, t in zip(ours, ref, tops)]


def grad_err(ours, ref) -> tuple[float, float]:
    """(largest of `grad_errs`, largest |ours - ref|)."""
    return (max(grad_errs(ours, ref)),
            max(float((o.float() - r.float()).abs().max()) for o, r in zip(ours, ref)))


def check_scan_backwards(torch, kss, krg, kref) -> dict:
    """Each backward kernel, through its autograd Function, against autograd
    of its plain version on the card (f32, TF32 off): each gradient of f32
    inputs within 2e-4 of its own largest magnitude, of bf16 inputs (B3)
    within 2e-2 of the same f32 reference, the plain bf16 version's own
    error printed beside; with and without h0 and the final state's
    gradient; two calls equal bit for bit.  At S <= 64 also against
    autograd of the sequential oracles (kernels/ref.py).  Returns kernel
    -> worst error per dtype over every case, relative and ("... abs")
    absolute, and ("... train abs") the absolute error at the training
    shape, the first case of each list."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = collections.defaultdict(float)
    misses = []
    ssd = lambda *t: kss.ssd_scan(*t[:4], chunk=256, h0=t[4])
    ssd_plain = lambda *t: kss.ssd_scan_plain(*t[:4], chunk=256, h0=t[4])

    def ssd_seq(*t):
        h = t[0].shape[2]
        return kref.ssd_scan_ref(t[0], t[1], t[2].repeat_interleave(h // t[2].shape[2], 2),
                                 t[3].repeat_interleave(h // t[3].shape[2], 2), t[4])

    for case in SSD_BWD_CASES:
        b, s, h, p, g, n = case
        xdt, dA, B, C, h0 = ssd_inputs(torch, *case, torch.float32, seed=s + b)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dfin = torch.randn((b, h, p, n), generator=gen, device="cuda")
        for init in (None, h0):
            for d_final in (None, dfin):
                args = [xdt, dA, B, C, init]
                cots = [dy, d_final]
                ref = scan_grads(torch, ssd_plain, args, cots)
                ours = scan_grads(torch, ssd, args, cots)
                again = scan_grads(torch, ssd, args, cots)
                same = all(torch.equal(x, y) for x, y in zip(ours, again))
                e32, a32 = grad_err(ours, ref)
                bf = [t.bfloat16() for t in (xdt, B, C)]
                args_bf = [bf[0], dA, bf[1], bf[2], init]
                ours16 = scan_grads(torch, ssd, args_bf, cots)
                e16, a16 = grad_err(ours16, ref)
                each16 = grad_errs(ours16, ref)
                each16_plain = grad_errs(scan_grads(torch, ssd_plain, args_bf, cots), ref)
                ok = e32 <= SCAN_BWD_TOL["float32"] and e16 <= SCAN_BWD_TOL["bfloat16"] and same
                label = (f"b={b} S={s} h={h} p={p} g={g} n={n} h0={'yes' if init is not None else 'no'}"
                         f" d_final={'yes' if d_final is not None else 'no'}")
                names = ("dxdt", "ddA", "dB", "dC", "dh0")
                per = ", ".join(f"{nm} {e:.1e} ({ep:.1e})"
                                for nm, e, ep in zip(names, each16, each16_plain))
                line = (f"[check] B3 backward {label}, error over each gradient's own largest: "
                        f"f32 {e32:.3e} (tol 2e-4), bf16 {e16:.3e} (tol 2e-2; the plain bf16 "
                        f"version's {max(each16_plain):.3e}; the scalar f32 design before this one "
                        f"reached 5.6e-03 at worst); "
                        f"bf16 per gradient, the plain bf16 version's in brackets: {per}; "
                        f"repeat bit-equal {same}")
                if s <= 64:
                    e_seq, _ = grad_err(ours, scan_grads(torch, ssd_seq, args, cots))
                    ok = ok and e_seq <= SCAN_BWD_TOL["float32"]
                    line += f", against the sequential oracle {e_seq:.3e}"
                print(f"{line} {'ok' if ok else 'MISS'}")
                for key, val in (("float32", e32), ("bfloat16", e16), ("float32 abs", a32),
                                 ("bfloat16 abs", a16)):
                    worst[f"B3 bwd {key}"] = max(worst[f"B3 bwd {key}"], val)
                if case == SSD_BWD_CASES[0]:
                    worst["B3 bwd train bfloat16 abs"] = max(worst["B3 bwd train bfloat16 abs"],
                                                             a16)
                if not ok:
                    misses.append(f"B3 backward {label}")
        torch.cuda.synchronize()

    def rglru_seq(a, b_, h0):
        hs = kref.rglru_scan_ref(a, b_, h0)
        return hs, hs[:, -1]

    for Bsz, s, W in RGLRU_BWD_CASES + [(2, 48, 4096)]:
        a, bb, h0 = rglru_inputs(torch, Bsz, s, W, seed=s)
        dh = torch.randn((Bsz, s, W), generator=gen, device="cuda")
        dlast = torch.randn((Bsz, W), generator=gen, device="cuda")
        for init in (None, h0):
            for d_last in (None, dlast):
                args, cots = [a, bb, init], [dh, d_last]
                ours = scan_grads(torch, krg.rglru_scan, args, cots)
                again = scan_grads(torch, krg.rglru_scan, args, cots)
                same = all(torch.equal(x, y) for x, y in zip(ours, again))
                err, abs_err = grad_err(ours, scan_grads(torch, krg.rglru_scan_plain, args, cots))
                ok = err <= SCAN_BWD_TOL["float32"] and same
                label = (f"B={Bsz} S={s} W={W} {krg.plan(s, W)} h0={'yes' if init is not None else 'no'}"
                         f" dh_last={'yes' if d_last is not None else 'no'}")
                line = (f"[check] B4 backward {label}, error over each gradient's own largest: "
                        f"{err:.3e} (tol 2e-4), repeat bit-equal {same}")
                if s <= 64:
                    e_seq, _ = grad_err(ours, scan_grads(torch, rglru_seq, args, cots))
                    ok = ok and e_seq <= SCAN_BWD_TOL["float32"]
                    line += f", against the sequential oracle {e_seq:.3e}"
                print(f"{line} {'ok' if ok else 'MISS'}")
                worst["B4 bwd float32"] = max(worst["B4 bwd float32"], err)
                worst["B4 bwd float32 abs"] = max(worst["B4 bwd float32 abs"], abs_err)
                if (Bsz, s, W) == RGLRU_BWD_CASES[0]:
                    worst["B4 bwd train float32 abs"] = max(worst["B4 bwd train float32 abs"],
                                                            abs_err)
                if not ok:
                    misses.append(f"B4 backward {label}")
    torch.cuda.synchronize()
    check(not misses, f"the B3/B4 backwards disagree with autograd of their plain versions: "
                      f"{misses}")
    return dict(worst)


def ssd_bwd_cost(b, s, h, p, g, n, dtype_name) -> tuple[float, float, float]:
    """(bytes the function moves, its operations, bytes the design moves)
    for one B3 backward: xdt, dA, B, C and dy read, dxdt, ddA, dB and dC
    written; the function's multiply-adds in the chunked form at the
    design's 32-step chunks, two operations each, per chunk and head: the
    adjoint walk (dS_in), C B^T and dy x^T on the causal triangle, dx, dB
    and dC inside the chunk (triangle) and from the carried state and
    dS_out, and dcs.  The entering states S_in are the forward's; the
    design's forward walk that recomputes them is not counted.  Beside them
    the design's bytes: the function's, its scratch (each chunk's entering
    state and outgoing adjoint as bf16 hi and lo planes, 4 bytes an
    element, written by the states kernel and read by the chunk kernel),
    and the states kernel's own reads of xdt, dy, B, C and dA."""
    size = 4 if dtype_name == "float32" else 2
    Q = 32
    nc = -(-s // Q)
    bytes_ = 3 * b * s * h * p * size + 4 * b * s * g * n * size + 8 * b * s * h
    tri = Q * (Q + 1) // 2
    fma_chunk = (Q * p * n                     # adjoint walk
                 + tri * n + tri * p            # C B^T, dy x^T
                 + 3 * Q * p * n                # dx, dB, dC from S_in and dS_out
                 + tri * p + 2 * tri * n        # dx, dB, dC inside the chunk
                 + Q * (p + n) + tri + p * n)   # dcs
    ops = 2 * fma_chunk * b * nc * h
    n_pad = -(-n // 16) * 16
    scratch = 2 * (2 * 4 * b * h * nc * p * n_pad)
    rereads = 2 * b * s * h * p * size + 2 * b * s * g * n * size + 2 * 4 * b * s * h
    return bytes_, ops, bytes_ + scratch + rereads


def time_scan_backwards(torch, kss, krg) -> dict:
    """Each backward kernel at phase 11's training shapes (B3 bf16 b=16
    S=512, mamba2-130m; B4 B=16 S=256 W=4096, recurrentgemma-9b), CUDA
    events with the L2 flushed, beside its bound and the time of autograd's
    backward through the plain version (its forward run once, outside the
    timing).  No single PyTorch call computes either: no library time."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    shape = (16, 512, 24, 64, 1, 128)
    xdt, dA, B, C, _ = ssd_inputs(torch, *shape, torch.bfloat16, seed=7)
    dy = torch.randn(xdt.shape, generator=gen, device="cuda").bfloat16()
    ins = [t.detach().requires_grad_() for t in (xdt, dA, B, C)]
    y, _ = kss.ssd_scan_plain(*ins, chunk=256)
    bytes_, ops, design = ssd_bwd_cost(*shape, "bfloat16")
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]
    call = lambda: kss._launch_bwd(xdt, dA, B, C, None, dy, None, False)    # noqa: E731
    split = kernel_split(torch, call, r"(ssd_bwd_\w+)")
    out["B3 bwd train"] = {
        "ms": time_ms(torch, call, flush, reps=10),
        "plain_ms": time_ms(torch, lambda: torch.autograd.grad(y, ins, dy, retain_graph=True),
                            flush, reps=10),
        "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": "b=16 S=512 h=24 p=64 g=1 n=128 bfloat16 (f32 sums)",
        "note": (f"{bytes_ / 1e6:.1f} MB in and out, {ops / 1e9:.2f} GFLOP "
                 f"({t_ops * 1e3:.4f} ms at the bf16 rate; the design takes them on the "
                 f"tensor cores, its f32 operands as bf16 hi and lo, two or three products "
                 f"each, and recomputes the entering states besides); the design moves "
                 f"{design / 1e6:.1f} MB with its scratch and rereads "
                 f"({design / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate); per launch, "
                 f"device ms a call with the L2 warm (torch.profiler): "
                 + (", ".join(f"{k} {v:.4f}" for k, v in split.items()) if split
                    else "not measured (the profiler saw no device time)"))}
    del y, ins
    a, bb, _ = rglru_inputs(torch, 16, 256, 4096, seed=7)
    h, _ = krg.rglru_scan(a, bb)
    dh = torch.randn(a.shape, generator=gen, device="cuda")
    ins = [t.detach().requires_grad_() for t in (a, bb)]
    h_p, _ = krg.rglru_scan_plain(*ins)
    bytes_ = 5 * 4 * 16 * 256 * 4096
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, 3 * 16 * 256 * 4096 / PEAK_OPS["float32"]
    out["B4 bwd train"] = {
        "ms": time_ms(torch, lambda: krg._launch_bwd(a, h, None, dh, None, False), flush),
        "plain_ms": time_ms(torch, lambda: torch.autograd.grad(h_p, ins, dh, retain_graph=True),
                            flush),
        "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": "B=16 S=256 W=4096 float32",
        "note": f"a, h, dh read and da, db written: {bytes_ / 1e6:.1f} MB"}
    for name, t in out.items():
        print(f"[time] {name} ({t['shape']}): kernel {t['ms']:.4f} ms, autograd of the plain "
              f"version {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.1%} of bound; {t['note']}; card {nvidia_smi()}")
    return out


# ---------------------------------------------------------------------------
# The ssm + hybrid fleet's serve path
# ---------------------------------------------------------------------------


class EngineCalls:
    """Counts the engines' prefill and decode calls per (model, KV mode,
    kind), and the kernel launches each made, by wrapping
    InferenceEngine._prefill/_decode while the block runs (a call replays
    a CUDA graph, which adds the launches its capture recorded); keeps
    each engine's graphs after each generate (`report` prints them); and
    each per-call meter's window per (model, KV mode): its joules net of
    the idle head and tail, over all the repeats it held."""

    def __init__(self, engine_cls, counters: dict):
        self.cls, self.counters = engine_cls, counters
        self.calls = collections.Counter()
        self.launches = collections.Counter()
        self.engines = {}       # serial -> the engine's graphs after its last generate
        self.windows = collections.defaultdict(list)    # (model, kv) -> window joules

    def _wrap(self, orig, kind):
        def call(eng, *args, **kw):
            before = {k: m.launches for k, m in self.counters.items()}
            out = orig(eng, *args, **kw)
            key = (eng.cfg.name, eng.kv_cache, kind)
            self.calls[key] += 1
            for k, m in self.counters.items():
                self.launches[key + (k,)] += m.launches - before[k]
            return out
        return call

    def _wrap_generate(self, orig):
        def generate(eng, *args, **kw):
            n = len(eng.steps)
            out = orig(eng, *args, **kw)
            stats = out[1]
            if stats.call_energy_j is not None:
                self.windows[(eng.cfg.name, eng.kv_cache)].append(
                    stats.call_energy_j * stats.repeats)
            if not hasattr(eng, "_smoke_serial"):
                eng._smoke_serial = len(self.engines)
            if len(eng.steps) != n or eng._smoke_serial not in self.engines:
                self.engines[eng._smoke_serial] = engine_graphs(eng)
            return out
        return generate

    def __enter__(self):
        self.orig = self.cls._prefill, self.cls._decode, self.cls.generate
        self.cls._prefill = self._wrap(self.orig[0], "prefill")
        self.cls._decode = self._wrap(self.orig[1], "decode")
        self.cls.generate = self._wrap_generate(self.orig[2])
        return self

    def __exit__(self, *exc):
        self.cls._prefill, self.cls._decode, self.cls.generate = self.orig

    def report(self, tag) -> None:
        for g in self.engines.values():
            print(f"[{tag}] graphs: {g['arch']} KV-{'on' if g['kv'] else 'off'} engine: "
                  f"{g['graphs']} graphs, capture s={g['capture_s']}, pool GiB="
                  f"{g['pool_gib']}, warm-up launches {g['warm_launches']}")
        print(f"[{tag}] graphs over the phase: {sum(g['graphs'] for g in self.engines.values())}"
              f" in {len(self.engines)} engines, capture s="
              f"{sum(g['capture_s'] for g in self.engines.values())}")


def engine_graphs(eng) -> dict:
    """An engine's CUDA graphs: how many, the seconds their warm-ups and
    captures took, the pool's reserved GiB and the warm-ups' launches."""
    short = {"repro_torch.kernels.decode_attention": "B1",
             "repro_torch.kernels.ssd_scan": "B3", "repro_torch.kernels.rglru_scan": "B4"}
    return {"arch": eng.cfg.name, "kv": eng.kv_cache, "graphs": len(eng.steps),
            "capture_s": eng.capture_s, "pool_gib": eng.pool_bytes() / 2**30,
            "warm_launches": {short[k]: n for k, n in eng.capture_launches.items() if n}}


def per_call_launches(cfg, kind) -> dict:
    """Kernel launches one engine call of a scan-fleet model must make."""
    from repro_torch.models import hybrid
    is_hybrid = cfg.family == "hybrid"
    if kind == "prefill":
        return {"B3": cfg.n_layers if cfg.family == "ssm" else 0,
                "B4": hybrid.n_rec_layers(cfg) if is_hybrid else 0, "B1": 0}
    return {"B3": 0, "B4": 0, "B1": hybrid.pattern_counts(cfg)[2] if is_hybrid else 0}


def run_scan_serve(torch, counters, serve_mod, limit_w, counter) -> dict:
    """serve() of the ssm + hybrid fleet, then one KV-on generate of each
    model outside the router.  Every engine call's kernel launches must be
    its layers' count.  Returns kernel -> launches over the whole run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.energy.meter import NvmlMeter
    from repro_torch.serving import InferenceEngine
    gc.collect()
    torch.cuda.empty_cache()
    idle_w = idle_watts()
    torch.cuda.reset_peak_memory_stats()
    for m in counters.values():
        m.launches = 0
    with EngineCalls(InferenceEngine, counters) as calls:
        whole = NvmlMeter("cuda")
        out, wall, _ = whole.measure(lambda: serve_mod.serve(
            SCAN_ARCHS, n_queries=SERVE_QUERIES, zeta=0.5,
            char_max_tokens=SCAN_CHAR_MAX_TOKENS, device="cuda"))
        for arch in SCAN_ARCHS:      # every kernel, whatever the routing
            eng = serve_mod.build_engine(arch, kv_cache=True, device="cuda")
            toks = np.random.default_rng(3).integers(1, eng.cfg.vocab_size, (4, 40))
            gen, _ = eng.generate({"tokens": toks.astype(np.int32)}, 8)
            check(gen.shape == (4, 8), f"{arch}: generate returned {gen.shape}")
            del eng
        torch.cuda.synchronize()
    launches = {k: m.launches for k, m in counters.items()}

    calls.report("scan-serve")
    energy_report("scan-serve", serve_mod, out, whole.last, idle_w, limit_w, counter, calls)
    print(f"[scan-serve] serve() wall s={wall} "
          f"(characterized up to {SCAN_CHAR_MAX_TOKENS} tokens)")
    print(f"[scan-serve] max_memory_allocated GiB={torch.cuda.max_memory_allocated() / 2**30}")
    n_routed = sum(len(rs) for rs in out["plan"].per_model.values())
    check(n_routed == SERVE_QUERIES, f"plan routed {n_routed} of {SERVE_QUERIES} queries")
    check(sum(t["queries"] for t in out["totals"].values()) == SERVE_QUERIES,
          "served query count differs from the plan")

    bad = []
    for (arch, kv, kind), n in sorted(calls.calls.items()):
        want = per_call_launches(get_config(arch), kind)
        got = {k: calls.launches[(arch, kv, kind, k)] for k in counters}
        print(f"[scan-serve] {arch} KV-{'on' if kv else 'off'} {kind}: {n} calls, "
              f"launches {got}, expected {({k: n * w for k, w in want.items()})}")
        if got != {k: n * w for k, w in want.items()}:
            bad.append(f"{arch} kv={kv} {kind}")
    check(not bad, f"kernel launches differ from the layer counts: {bad}")
    check(launches == {k: sum(v for key, v in calls.launches.items() if key[3] == k)
                       for k in counters}, "kernel launches outside the engines' calls")
    for k, key in (("B3", ("mamba2-130m", True, "prefill")),
                   ("B4", ("recurrentgemma-9b", True, "prefill")),
                   ("B1", ("recurrentgemma-9b", True, "decode"))):
        check(calls.launches[key + (k,)] > 0, f"{k} never launched on the KV-on path")
    print(f"[scan-serve] launches over the run: {launches}")
    return launches


def check_scan_outputs(torch, serve_mod) -> None:
    compare_reduced(torch, "mamba2-130m-reduced", 37)
    compare_reduced(torch, "recurrentgemma-9b-reduced", 37)
    compare_reduced(torch, "recurrentgemma-9b-reduced", 37, cache_dtype="float8_e4m3fn")
    for arch, keys, label in (
            ("mamba2-130m", ("ssd_chunk_scan_bf16_kernel", "ssd_chunk_scan_f32_kernel"), "B3"),
            ("recurrentgemma-9b", ("rglru_scan_kernel",), "B4")):
        eng, cache, token = check_full_width(torch, serve_mod, arch)
        tokens = torch.randint(1, eng.cfg.vocab_size, (4, 48), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(4))
        prefill_breakdown(torch, eng.api, eng.cfg, eng.params, tokens, keys, label)
        if arch == "recurrentgemma-9b":
            decode_breakdown(torch, eng.api, eng.cfg, eng.params, cache, token, B1_KEYS,
                             "B1 (one kernel a call, head dim 256)")
        del eng, cache
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The MoE fleet's serve path
# ---------------------------------------------------------------------------


class DepthCut:
    """While active, the serve module's config lookup gives the archs of
    DEPTH_CUTS at full width with that many layers (an encdec model that
    many in each stack); others unchanged."""

    def __init__(self, serve_mod):
        self.mod = serve_mod
        self.orig = serve_mod.get_config

    def lookup(self, arch):
        cfg = self.orig(arch)
        if arch not in DEPTH_CUTS:
            return cfg
        n = DEPTH_CUTS[arch]
        if cfg.family == "encdec":
            return cfg.replace(n_layers=2 * n, enc_layers=n, dec_layers=n)
        return cfg.replace(n_layers=n)

    def describe(self, arch) -> str:
        from repro_torch.models import get_api
        cfg, full = self.lookup(arch), self.orig(arch)
        cut = (f"{cfg.n_layers} of {full.n_layers} layers (depth cut)"
               if cfg.n_layers != full.n_layers else f"all {cfg.n_layers} layers")
        return (f"{arch}: d_model {cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, "
                f"{cut}, {get_api(cfg).count_params(cfg) / 1e9:.2f} B parameters "
                f"({get_api(full).count_params(full) / 1e9:.2f} B at full depth)")

    def __enter__(self):
        self.mod.get_config = self.lookup
        return self

    def __exit__(self, *exc):
        self.mod.get_config = self.orig


def run_moe_serve(torch, kda, serve_mod, limit_w, counter) -> int:
    """serve() of granite-moe-3b-a800m and mixtral-8x7b (DEPTH_CUTS), then
    one KV-on generate of each outside the router.  Every engine decode
    call must launch B1 once per layer and every prefill never; over the
    run B1's launches must equal the served batches' layers x max_new plus
    the generates'.  Returns B1's launches over the run."""
    import numpy as np
    from repro_torch.energy.meter import NvmlMeter
    from repro_torch.serving import InferenceEngine
    gc.collect()
    torch.cuda.empty_cache()
    idle_w = idle_watts()
    torch.cuda.reset_peak_memory_stats()
    cut = DepthCut(serve_mod)
    for arch in MOE_ARCHS:
        print(f"[moe-serve] {cut.describe(arch)}")
    with cut, EngineCalls(InferenceEngine, {"B1": kda}) as calls:
        kda.launches = 0
        whole = NvmlMeter("cuda")
        out, wall, _ = whole.measure(lambda: serve_mod.serve(
            MOE_ARCHS, n_queries=SERVE_QUERIES, zeta=0.5,
            char_max_tokens=MOE_CHAR_MAX_TOKENS, device="cuda"))
        peak = torch.cuda.max_memory_allocated()
        expected = expected_decode_launches(serve_mod, out, cut.lookup)
        for arch in MOE_ARCHS:      # B1 launches whatever the routing
            eng = serve_mod.build_engine(arch, kv_cache=True, device="cuda")
            toks = np.random.default_rng(3).integers(1, eng.cfg.vocab_size, (4, 40))
            gen, _ = eng.generate({"tokens": toks.astype(np.int32)}, 8)
            check(gen.shape == (4, 8), f"{arch}: generate returned {gen.shape}")
            expected += 8 * eng.cfg.n_layers
            del eng
        torch.cuda.synchronize()
        launches = kda.launches

    calls.report("moe-serve")
    energy_report("moe-serve", serve_mod, out, whole.last, idle_w, limit_w, counter, calls)
    print(f"[moe-serve] serve() wall s={wall} (characterized up to {MOE_CHAR_MAX_TOKENS} tokens)")
    print(f"[moe-serve] max_memory_allocated GiB over serve()={peak / 2**30}")
    n_routed = sum(len(rs) for rs in out["plan"].per_model.values())
    check(n_routed == SERVE_QUERIES, f"plan routed {n_routed} of {SERVE_QUERIES} queries")
    check(sum(t["queries"] for t in out["totals"].values()) == SERVE_QUERIES,
          "served query count differs from the plan")
    check(all(t["tokens"] > 0 and t["runtime_s"] > 0 for t in out["totals"].values()),
          "a served model reports no tokens or no time")

    bad = []
    for (arch, kv, kind), n in sorted(calls.calls.items()):
        want = cut.lookup(arch).n_layers if kind == "decode" else 0
        got = calls.launches[(arch, kv, kind, "B1")]
        print(f"[moe-serve] {arch} KV-{'on' if kv else 'off'} {kind}: {n} calls, "
              f"B1 launches {got}, expected {n * want}")
        if got != n * want:
            bad.append(f"{arch} kv={kv} {kind}")
    check(not bad, f"B1 launches differ from layers x decode steps: {bad}")
    check(launches == sum(calls.launches.values()), "B1 launched outside the engines' calls")
    for arch in MOE_ARCHS:
        check(calls.launches[(arch, True, "decode", "B1")] > 0,
              f"B1 never launched in {arch}'s decode")
    print(f"[moe-serve] B1 launches={launches} expected={expected} "
          f"(attention layers x decode steps: served batches and the generates)")
    check(launches == expected, f"B1 launched {launches} times, expected {expected}")
    return launches


def check_cut_depth(torch, cfg, tol, tie_gap=None, **fields_per_run) -> None:
    """`cfg` (full width, few layers) with weights drawn on the card in its
    dtype: decode against a re-forward (`check_decode_vs_reforward`), once
    per config fields in `fields_per_run` (label -> dict), else once."""
    from repro_torch.models import get_api
    api = get_api(cfg)
    params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             torch.device("cuda"))
    for label, fields in (fields_per_run or {"": {}}).items():
        print(f"[outputs] {cfg.name} in {cfg.param_dtype} at full width, {cfg.n_layers} "
              f"layers ({cfg.n_dense_layers} dense){' ' + label if label else ''}:")
        check_decode_vs_reforward(torch, api, cfg.replace(**fields), params, tol=tol,
                                  tie_gap=tie_gap)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def check_moe_outputs(torch, kda, serve_mod) -> None:
    """Reduced MoE models on the card against the CPU; then at full width
    (DEPTH_CUTS) decode against a re-forward and the device's share of a
    decode step, for granite-moe-3b-a800m and mixtral-8x7b (B1 in every
    layer) and deepseek-v3-671b in both MLA decode modes (no B1: its
    launches over those decodes must be 0).  mixtral's 4-layer bf16
    comparison is printed, not held: with random weights its stack
    amplifies bf16 rounding (tokens whose experts agree in every layer
    drift 0.05-0.09 apart, a flipped top-2 expert moves a token by ~1), so
    it is held at 2 layers, in bf16 (0.1) and in f32 (1e-3), as deepseek-v3
    is in f32 at 1 dense + 1 MoE layer."""
    compare_reduced(torch, "mixtral-8x7b-reduced", 21)
    compare_reduced(torch, "granite-moe-3b-a800m-reduced", 21)
    compare_reduced(torch, "deepseek-v3-671b-reduced", 21, mla_absorb=True)
    compare_reduced(torch, "deepseek-v3-671b-reduced", 21, mla_absorb=False)
    cut = DepthCut(serve_mod)
    print(f"[outputs] {cut.describe('deepseek-v3-671b')}")
    with cut:
        for arch in MOE_ARCHS:
            eng, cache, token = check_full_width(
                torch, serve_mod, arch, tol=None if arch == "mixtral-8x7b" else 0.1)
            decode_breakdown(torch, eng.api, eng.cfg, eng.params, cache, token, B1_KEYS,
                             "B1 (one kernel a call)")
            del eng, cache
            gc.collect()
            torch.cuda.empty_cache()
        mixtral2 = cut.lookup("mixtral-8x7b").replace(n_layers=2)
        check_cut_depth(torch, mixtral2, tol=0.1)
        check_cut_depth(torch, mixtral2.replace(param_dtype="float32"), tol=1e-3,
                        tie_gap=F32_TIE_GAP)
        eng = serve_mod.build_engine("deepseek-v3-671b", kv_cache=True, device="cuda")
        deepseek2 = cut.lookup("deepseek-v3-671b").replace(n_layers=2, n_dense_layers=1,
                                                            param_dtype="float32")
    kda.launches = 0
    for absorb in (True, False):
        cfg = eng.cfg.replace(mla_absorb=absorb)
        print(f"[outputs] deepseek-v3-671b mla_absorb={absorb}:")
        cache, token = check_decode_vs_reforward(torch, eng.api, cfg, eng.params)
        decode_breakdown(torch, eng.api, cfg, eng.params, cache, token, B1_KEYS,
                         "B1 (none expected: MLA attends in plain PyTorch)")
    launches = kda.launches
    print(f"[outputs] deepseek-v3-671b B1 launches over both MLA decodes={launches} (expected 0)")
    check(launches == 0, f"B1 launched {launches} times on the MLA path")
    del eng, cache
    gc.collect()
    torch.cuda.empty_cache()
    # f32 at full width, 1 dense + 1 MoE layer (~49 GB)
    check_cut_depth(torch, deepseek2, tol=1e-3, tie_gap=F32_TIE_GAP,
                    **{f"mla_absorb={a}": {"mla_absorb": a} for a in (True, False)})


# ---------------------------------------------------------------------------
# The encdec + vlm fleet, served through the engine
# ---------------------------------------------------------------------------


def b1_per_call(cfg, kind) -> int:
    """B1's launches in one engine call: an encdec decode step attends
    twice a decoder layer (its own cache, then the encoder memory), a vlm
    decode step once a layer; a prefill (KV on or off) never."""
    if kind != "decode":
        return 0
    return 2 * cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers


def characterize_with_frontends(serve_mod, arch) -> list:
    """`serve_mod.characterize`'s campaign for one encdec or vlm model: KV
    off, batch 2, up to ENCDEC_VLM_CHAR_MAX_TOKENS, after one warm-up over
    every length (`serve_mod.warm_up`), through `measure_fn` (zero frames
    or patches).  Returns the trials."""
    from repro_torch.core.characterize import run_campaign
    from repro_torch.serving.engine import measure_fn
    engine = serve_mod.build_engine(arch, kv_cache=False, device="cuda",
                                    min_window_s=serve_mod.TRIAL_WINDOW_S)
    serve_mod.warm_up(engine, 2, ENCDEC_VLM_CHAR_MAX_TOKENS)
    measure = measure_fn(lambda: engine, 2, engine.cfg.vocab_size)
    return run_campaign(arch, measure, serve_mod.campaign_settings(ENCDEC_VLM_CHAR_MAX_TOKENS))


def serve_with_frontends(torch, serve_mod, archs, *, seed=0) -> dict:
    """`serve_mod.serve` for models whose prefill also takes frames or
    patches: characterize, fit, route SERVE_QUERIES Alpaca-like queries at
    zeta 0.5, and serve each model's batches (batch 4, KV on) with seeded
    random frames/patches.  Returns {"plan", "totals", "profiles", "trials"}."""
    import numpy as np
    from repro_torch.data import alpaca_like_workload, token_batches
    from repro_torch.data.workloads import WorkloadSpec
    from repro_torch.serving import EnergyAwareRouter
    from repro_torch.serving.requests import Request

    trials = {}
    for arch in archs:
        trials[arch] = characterize_with_frontends(serve_mod, arch)
        gc.collect()
        torch.cuda.empty_cache()
    profiles = [serve_mod.fit_and_report(arch, trials[arch]) for arch in archs]
    router = EnergyAwareRouter(profiles, zeta=0.5)
    queries = alpaca_like_workload(WorkloadSpec(n_queries=SERVE_QUERIES,
                                                **serve_mod.SERVE_WORKLOAD))
    plan = router.route([Request(i, np.zeros(q[0], np.int32), q[1])
                         for i, q in enumerate(queries)])
    engines = {a: serve_mod.build_engine(a, kv_cache=True, device="cuda") for a in archs}
    totals = {}
    for n, (arch, rs) in enumerate(plan.per_model.items()):
        if not rs:
            continue
        eng = engines[arch]
        e_j = t_s = 0.0
        n_tok = 0
        batches = list(token_batches([(r.tau_in, r.max_new_tokens) for r in rs], 4,
                                     eng.cfg.vocab_size))
        for i, b in enumerate(batches):
            max_new = int(b["tau_out"].max())
            batch = {"tokens": b["tokens"],
                     **frontend_batch(torch, eng.cfg, 4, seed=seed + 100 * n + i)}
            _, stats = eng.generate(batch, max_new)
            e_j += stats.energy_j
            t_s += stats.runtime_s
            n_tok += int(b["lengths"].sum()) + max_new * 4
        totals[arch] = {"queries": len(rs), "energy_j": e_j, "runtime_s": t_s,
                        "tokens": n_tok, "batches": len(batches)}
    return {"plan": plan, "totals": totals, "profiles": profiles, "trials": trials}


def run_encdec_vlm_serve(torch, kda, serve_mod, limit_w, counter) -> dict:
    """serve_with_frontends over ENCDEC_VLM_ARCHS (DEPTH_CUTS in force),
    then one KV-on generate of each outside the router.  Every engine
    call's B1 launches must be `b1_per_call`'s.  Returns arch -> B1's
    launches in its engines' calls."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.energy.meter import NvmlMeter
    from repro_torch.models import get_api
    from repro_torch.serving import InferenceEngine
    cut = DepthCut(serve_mod)
    for arch in ENCDEC_VLM_ARCHS:
        cfg, full = cut.lookup(arch), get_config(arch)
        layers = (f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers (of "
                  f"{full.enc_layers} + {full.dec_layers}) over {cfg.n_frames} frames"
                  if cfg.family == "encdec"
                  else f"{cfg.n_layers} layers, {cfg.n_patches} patches")
        print(f"[encdec-vlm] {arch}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads} x {cfg.head_dim_}, {layers}, "
              f"{get_api(cfg).count_params(cfg) / 1e9:.3f} B parameters ({cfg.param_dtype})")
    gc.collect()
    torch.cuda.empty_cache()
    idle_w = idle_watts()
    torch.cuda.reset_peak_memory_stats()
    with cut, EngineCalls(InferenceEngine, {"B1": kda}) as calls:
        kda.launches = 0
        whole = NvmlMeter("cuda")
        out, wall, _ = whole.measure(
            lambda: serve_with_frontends(torch, serve_mod, ENCDEC_VLM_ARCHS))
        peak = torch.cuda.max_memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        for arch in ENCDEC_VLM_ARCHS:      # B1 launches whatever the routing
            eng = serve_mod.build_engine(arch, kv_cache=True, device="cuda")
            toks = np.random.default_rng(3).integers(1, eng.cfg.vocab_size, (4, 40))
            gen, _ = eng.generate({"tokens": toks.astype(np.int32),
                                   **frontend_batch(torch, eng.cfg, 4, seed=3)}, 8)
            check(gen.shape == (4, 8), f"{arch}: generate returned {gen.shape}")
            del eng
        torch.cuda.synchronize()
        launches = kda.launches

    calls.report("encdec-vlm")
    energy_report("encdec-vlm", serve_mod, out, whole.last, idle_w, limit_w, counter, calls)
    print(f"[encdec-vlm] serve wall s={wall} (characterize + fit + route + serve; "
          f"characterized up to {ENCDEC_VLM_CHAR_MAX_TOKENS} tokens)")
    print(f"[encdec-vlm] max_memory_allocated GiB over the serve wall={peak / 2**30}")
    n_routed = sum(len(rs) for rs in out["plan"].per_model.values())
    check(n_routed == SERVE_QUERIES, f"plan routed {n_routed} of {SERVE_QUERIES} queries")
    check(sum(t["queries"] for t in out["totals"].values()) == SERVE_QUERIES,
          "served query count differs from the plan")
    check(all(t["tokens"] > 0 and t["runtime_s"] > 0 for t in out["totals"].values()),
          "a served model reports no tokens or no time")

    bad = []
    per_arch = collections.Counter()
    for (arch, kv, kind), n in sorted(calls.calls.items()):
        want = b1_per_call(cut.lookup(arch), kind)
        got = calls.launches[(arch, kv, kind, "B1")]
        per_arch[arch] += got
        print(f"[encdec-vlm] {arch} KV-{'on' if kv else 'off'} {kind}: {n} calls, "
              f"B1 launches {got}, expected {n * want} ({want} a call)")
        if got != n * want:
            bad.append(f"{arch} kv={kv} {kind}")
    check(not bad, f"B1 launches differ from b1_per_call: {bad}")
    check(launches == sum(per_arch.values()), "B1 launched outside the engines' calls")
    for arch in ENCDEC_VLM_ARCHS:
        check(calls.launches[(arch, True, "decode", "B1")] > 0,
              f"B1 never launched in {arch}'s decode")
    print(f"[encdec-vlm] B1 launches={launches}: {dict(per_arch)}")
    return dict(per_arch)


def check_encdec_vlm_outputs(torch, kda, serve_mod) -> None:
    """The reduced models on the card against the CPU; at full width,
    decode against a re-forward (relative L2 0.1, the dense cell's limit),
    B1's launches over one decode step, and the device's busy share of a
    decode step (B=4) of each model and of a seamless KV-off forward (B=2,
    16 tokens, 4,096 frames encoded again)."""
    compare_reduced(torch, "seamless-m4t-large-v2-reduced", 21)
    compare_reduced(torch, "internvl2-2b-reduced", 21)
    for arch in ENCDEC_VLM_ARCHS:
        eng, cache, token = check_full_width(torch, serve_mod, arch)
        cfg = eng.cfg
        with torch.no_grad():
            kda.launches = 0
            _, cache = eng.api.decode_step(cfg, eng.params, cache, {"token": token})
            torch.cuda.synchronize()
            n = kda.launches
        print(f"[outputs] {arch} B1 launches over one decode step={n} "
              f"(expected {b1_per_call(cfg, 'decode')})")
        check(n == b1_per_call(cfg, "decode"), f"{arch}: B1 launched {n} times in a step")
        label = ("B1 (self + cross-attention, two a decoder layer)" if cfg.family == "encdec"
                 else "B1 (one a layer, G = 2)")
        decode_breakdown(torch, eng.api, cfg, eng.params, cache, token, B1_KEYS, label)
        if cfg.family == "encdec":
            tokens = torch.randint(1, cfg.vocab_size, (2, 16), device="cuda",
                                   generator=torch.Generator(device="cuda").manual_seed(4))
            prefill_breakdown(torch, eng.api, cfg, eng.params, tokens, B1_KEYS,
                              "B1 (none expected in a forward)")
        del eng, cache
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Kernel B2 and the analytic path
# ---------------------------------------------------------------------------


def cost_inputs(torch, m, dtype, seed):
    """new tokens and context in [1, 4096] (context >= new tokens) and a
    per-query batch in [1, 64]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nt = torch.randint(1, 4097, (m,), generator=g, device="cuda").to(dtype)
    ctx = nt + torch.randint(0, 4097, (m,), generator=g, device="cuda").to(dtype)
    return nt, ctx, torch.randint(1, 65, (m,), generator=g, device="cuda").to(dtype)


# B2's operand modes beside the per-query case, each at these sizes: one
# query up to 5 (a tail alone, or a vector and a tail), and 1,000,037 (not
# a multiple of a vector)
B2_MODE_CASES = ("uniform batch", "uniform new tokens", "aliased", "stride-0 batch",
                 "misaligned", "misaligned context")
B2_MODE_SIZES = (1, 3, 5, 1_000_037)


def b2_operands(torch, case, m, dtype, seed):
    """(new_tokens, context, batch) of m queries on the card for one of B2's
    operand modes: a 0-d batch; the KV-on decode probe's
    0-d 1 as new tokens with a 0-d batch; the prefill's one tensor as new
    tokens and context with a 0-d batch; a batch expanded with stride 0;
    every array sliced one element past a 16-byte boundary (t[1:]); only
    the context so sliced.  The kernel reads a sliced array element by
    element."""
    nt, ctx, bt = cost_inputs(torch, m + 1, dtype, seed)
    batch = torch.full((), 32, dtype=dtype, device="cuda")
    if case == "uniform batch":
        return nt[:m], ctx[:m], batch
    if case == "uniform new tokens":
        return torch.ones((), dtype=dtype, device="cuda"), ctx[:m], batch
    if case == "aliased":
        return ctx[:m], ctx[:m], batch
    if case == "stride-0 batch":
        return nt[:m], ctx[:m], batch.expand(m)
    if case == "misaligned":
        return nt[1:], ctx[1:], bt[1:]
    if case == "misaligned context":
        return nt[:m], ctx[1:], bt[:m]
    raise ValueError(case)


def b2_input_bytes(torch, nt, ctx, bt) -> int:
    """Bytes B2's inputs need, each read once: every distinct array's m
    elements (a context that is the new tokens' tensor counts once) and one
    element of each uniform value (one element, or a view repeating one
    with stride 0)."""
    shape = torch.broadcast_shapes(nt.shape, ctx.shape, bt.shape)
    n = 0
    for i, t in enumerate((nt, ctx, bt)):
        if i == 1 and (ctx.data_ptr(), ctx.shape, ctx.stride()) == (
                nt.data_ptr(), nt.shape, nt.stride()):
            continue
        e = t.expand(shape)
        uniform = all(st == 0 for st, k in zip(e.stride(), e.shape) if k > 1)
        n += (1 if uniform else shape.numel()) * t.element_size()
    return n


def check_cost_batch(torch, kcb) -> dict:
    """B2 against its plain version for every family branch and both decode
    modes at m = 1,000,037 with per-query inputs, then in each operand mode
    (B2_MODE_CASES) at B2_MODE_SIZES, one launch a call: f32 within rtol
    1e-5 (the reference's gate for the TPU kernel), f64 within 1e-12.
    Returns dtype -> worst max_abs_err."""
    from repro_torch.configs import get_config
    worst = collections.defaultdict(float)
    misses = []
    modes = collections.defaultdict(lambda: [0.0, 0.0, 0, 0])   # err, rel, same, calls

    def compare(cfg, ops, decode, rtol):
        before = kcb.launches
        ours = kcb.pass_surface(cfg, *ops, decode=decode)
        one = kcb.launches == before + 1
        plain = kcb.pass_surface_plain(cfg, *ops, decode=decode)
        err = max((a - b).abs().max().item() for a, b in zip(ours, plain))
        rel = max(((a - b).abs() / b.abs()).max().item() for a, b in zip(ours, plain))
        same = all(torch.equal(a, b) for a, b in zip(ours, plain))
        return err, rel, same, one and rel <= rtol

    for i, arch in enumerate(COST_ARCHS):
        cfg = get_config(arch)
        for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            nt, ctx, bt = cost_inputs(torch, 1_000_037, dtype, seed=i)
            name = str(dtype).removeprefix("torch.")
            for decode in (False, True):
                err, rel, same, ok = compare(cfg, (nt, ctx, bt), decode, rtol)
                worst[name] = max(worst[name], err)
                label = f"{arch} {name} decode={decode}"
                print(f"[check] B2 {label}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
                      f"bit-identical={same} rtol={rtol:g} {'ok' if ok else 'MISS'}")
                if not ok:
                    misses.append(label)
            for case in B2_MODE_CASES:
                for m in B2_MODE_SIZES:
                    ops = b2_operands(torch, case, m, dtype, seed=100 + i)
                    for decode in (False, True):
                        err, rel, same, ok = compare(cfg, ops, decode, rtol)
                        worst[name] = max(worst[name], err)
                        row = modes[(case, m, name)]
                        row[0], row[1] = max(row[0], err), max(row[1], rel)
                        row[2] += same
                        row[3] += 1
                        if not ok:
                            misses.append(f"{arch} {name} {case} m={m} decode={decode}")
    for (case, m, name), (err, rel, same, calls) in modes.items():
        print(f"[check] B2 {case} m={m} {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
              f"bit-identical in {same} of {calls} calls ({len(COST_ARCHS)} archs x 2 decode "
              f"modes, one launch each)")
    torch.cuda.synchronize()
    check(not misses, f"B2 disagrees with its plain version or launched other than once: "
                      f"{misses}")
    return dict(worst)


def cost_ops_per_query(cfg, decode) -> int:
    """Products, sums and minima B2 does for one query of this config,
    counted from the kernel's branches."""
    clamp = cfg.local_window if cfg.family == "hybrid" else cfg.window
    ops = 2 + bool(clamp)                       # tokens, 2 N tokens, clamp
    ops += 4 if cfg.family == "ssm" else 7 + 7 * (cfg.family == "encdec")
    ops += 4 * (cfg.family == "moe") + (6 if cfg.family == "moe" else 1) + 4
    return ops + (3 + 2 * (cfg.family == "ssm") if decode else 0)


def profiled_kernel_ms(torch, fn, flush, key, steps=10):
    """(device ms a call of the kernels whose name holds `key`, their
    launches a call, every other kernel's launches a call besides the
    flush's) from torch.profiler over `steps` calls of fn, the L2 flushed
    before each as time_ms flushes it; None and why if the profiler saw no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA
                  and e.self_device_time_total > 0 and not e.key.startswith("Memcpy")]
    except (RuntimeError, AssertionError) as e:     # reporting only: no tracer
        return None, str(e)
    mine = [e for e in events if key in e.key]
    if not mine:
        return None, "the profiler saw no device time"
    others = sum(e.count for e in events if key not in e.key) - steps    # less the flushes
    return (sum(e.self_device_time_total for e in mine) / 1e3 / steps,
            sum(e.count for e in mine) / steps, others / steps), ""


def time_cost_batch(torch, kcb, one_kernel=True) -> dict:
    """B2 at m = 1,000,000: per-query inputs (llama2-70b, decode probe), f32
    and f64; and simulate_batch's own calls at llama2-7b in f64, the
    prefill's (τin as new tokens and context, a 0-d batch) and the KV-on
    decode probe's (a 0-d 1, L, a 0-d batch).  Each beside its plain
    version, the profiler's kernel duration (L2 flushed, as time_ms) and
    the bound for the bytes its inputs need (b2_input_bytes) and its two
    outputs.  No single PyTorch call computes the surface: no library
    time.  one_kernel: fail unless the profiler saw one B2 launch and no
    other kernel a call."""
    from repro_torch.configs import get_config
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    m = 1_000_000
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        rows.append((f"B2 {name}", "llama2-70b", True, cost_inputs(torch, m, dtype, seed=11),
                     f"m={m} {name} llama2-70b decode=True, per-query inputs"))
    tin = torch.as_tensor(synthetic_queries(m)[0], dtype=torch.float64, device="cuda")
    batch = torch.full((), ANALYTIC_BATCH, dtype=torch.float64, device="cuda")
    rows.append(("B2 simulate_batch prefill", "llama2-7b", False, (tin, tin, batch),
                 f"m={m} float64 llama2-7b decode=False, simulate_batch's prefill call "
                 f"(tin, tin, 0-d batch)"))
    L = tin + 0.5
    rows.append(("B2 simulate_batch decode probe", "llama2-7b", True,
                 (L.new_ones(()), L, batch),
                 f"m={m} float64 llama2-7b decode=True, simulate_batch's KV-on decode probe "
                 f"(0-d 1, L, 0-d batch)"))
    out = {}
    for key, arch, decode, ops, shape in rows:
        cfg = get_config(arch)
        name = str(ops[0].dtype).removeprefix("torch.")
        call = lambda: kcb.pass_surface(cfg, *ops, decode=decode)           # noqa: E731
        t = {"ms": time_ms(torch, call, flush),
             "plain_ms": time_ms(torch, lambda: kcb.pass_surface_plain(cfg, *ops, decode=decode),
                                 flush),
             "library_ms": None}
        size = ops[0].element_size()
        bytes_ = b2_input_bytes(torch, *ops) + 2 * m * size
        t_bytes = bytes_ / HBM_BYTES_PER_S
        t_ops = cost_ops_per_query(cfg, decode) * m / PEAK_OPS[name]
        t["bound_ms"] = max(t_bytes, t_ops) * 1e3
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        t["shape"] = shape
        prof, why = profiled_kernel_ms(torch, call, flush, "cost_batch_kernel")
        if prof:
            t["profiled_ms"], per_call, others = prof
            seen = (f"profiler: kernel {t['profiled_ms']:.4f} ms, {per_call:g} B2 launches "
                    f"and {others:g} other kernels a call")
        else:
            t["profiled_ms"], per_call, others = None, None, None
            seen = f"profiler: not measured ({why})"
        print(f"[time] {key} ({shape}): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {bytes_} bytes), "
              f"{t['bound_ms'] / t['ms']:.1%} of bound; {seen}")
        if prof and one_kernel:
            check(per_call == 1 and others == 0,
                  f"{key}: {per_call} B2 launches and {others} other kernels a call")
        out[key] = t
    return out


def synthetic_queries(m):
    """benchmarks/perf_suite.py's synthetic (τin, τout) draws."""
    import numpy as np
    rng = np.random.default_rng(m)
    return rng.integers(1, 4096, m), rng.integers(1, 4096, m)


SIMULATE_STEPS = 10     # simulate_batch calls timed, then profiled


def time_simulate_batch(torch, kcb) -> dict:
    """simulate_batch over 10^6 synthetic queries: wall time and queries/s
    (host clock, numpy in and out), the device's busy share of it and B2's
    share of that (profiler).  Returns label -> `_breakdown`'s numbers."""
    from repro_torch.configs import PAPER_ZOO
    from repro_torch.energy import AnalyticLLMSimulator
    tin, tout = synthetic_queries(SYNTHETIC_QUERIES)
    out = {}
    for kv in (True, False):
        sim = AnalyticLLMSimulator(PAPER_ZOO["llama2-7b"], batch=ANALYTIC_BATCH, kv_cache=kv,
                                   noise_sigma=0.0)
        wall_ms, events, why = _profile(torch, lambda: kcb.simulate_batch(sim, tin, tout),
                                        SIMULATE_STEPS)
        label = f"simulate_batch llama2-7b KV-{'on' if kv else 'off'} m={len(tin)}"
        print(f"[time] {label}: {wall_ms:.2f} ms per call, {len(tin) / wall_ms * 1e3:.4g} "
              f"queries/s (host clock, numpy in and out)")
        out[label] = _breakdown(label, wall_ms, events, why, SIMULATE_STEPS,
                                ("cost_batch_kernel",), "B2")
    return out


def run_analytic(torch, kcb) -> int:
    """The §6.3 case study on the host, then cost_matrices on the card over
    the same fleet.  Returns B2's launches over the card part."""
    import numpy as np
    from repro_torch.configs import CASE_STUDY_GAMMA, CASE_STUDY_MODELS, PAPER_ZOO, TABLE1
    from repro_torch.core import characterize, scheduler
    from repro_torch.data import alpaca_like_workload
    from repro_torch.energy import AnalyticLLMSimulator

    t0 = time.perf_counter()
    settings = characterize.CampaignSettings(grid_range=(8, 2048), max_trials=2, min_trials=2,
                                             vary_input_range=(8, 8),
                                             vary_output_range=(8, 8), seed=9)
    profiles = []
    for name in CASE_STUDY_MODELS:
        sim = AnalyticLLMSimulator(PAPER_ZOO[name], kv_cache=False, seed=13)
        trials = characterize.run_campaign(name, sim.measure_per_query, settings)
        profiles.append(characterize.fit_profile_from_trials(name, TABLE1[name]["a_k"], trials))
    queries = alpaca_like_workload()
    zetas = np.round(np.linspace(0.0, 1.0, 11), 2)
    sweep = scheduler.zeta_sweep(profiles, queries, zetas)
    capped = scheduler.zeta_sweep(profiles, queries, [0.0, 0.5, 1.0], gamma=CASE_STUDY_GAMMA)
    baselines = {"round_robin": scheduler.schedule_round_robin(profiles, queries),
                 "random": scheduler.schedule_random(profiles, queries, seed=4)}
    for p in profiles:
        print(f"[analytic] {p.name}: energy R2={p.energy.r_squared} "
              f"runtime R2={p.runtime.r_squared}")
        check(0.9 < p.energy.r_squared <= 1.0 and 0.9 < p.runtime.r_squared <= 1.0,
              f"{p.name}: the Eq. 6/7 fit is poor")
    for z, asg in zip(zetas, sweep):
        print(f"[analytic] zeta={z:.1f}: E={asg.total_energy_j} J "
              f"runtime={asg.total_runtime_s} s mean_A_K={asg.mean_accuracy_ak} "
              f"counts={asg.counts().tolist()}")
    for z, asg in zip([0.0, 0.5, 1.0], capped):
        print(f"[analytic] gamma-capped zeta={z:.1f}: E={asg.total_energy_j} J "
              f"counts={asg.counts().tolist()}")
    for name, asg in baselines.items():
        print(f"[analytic] baseline {name}: E={asg.total_energy_j} J")
    energies = [a.total_energy_j for a in sweep]
    check(all(b <= a + 1e-6 for a, b in zip(energies, energies[1:])),
          "energy does not fall monotonically as zeta -> 1")
    print(f"[analytic] case study on the host s={time.perf_counter() - t0}")

    alpaca = (np.array([q[0] for q in queries]), np.array([q[1] for q in queries]))
    synth = synthetic_queries(SYNTHETIC_QUERIES)
    sample = np.random.default_rng(0).choice(SYNTHETIC_QUERIES, 2000, replace=False)
    kcb.launches = 0
    expected = 0
    worst = 0.0
    for kv in (True, False):
        sims = [AnalyticLLMSimulator(PAPER_ZOO[n], batch=ANALYTIC_BATCH, kv_cache=kv,
                                     noise_sigma=0.0) for n in CASE_STUDY_MODELS]
        for label, (tin, tout), idx in (("alpaca 500", alpaca, np.arange(len(alpaca[0]))),
                                        ("synthetic 1M", synth, sample)):
            t0 = time.perf_counter()
            E, R = kcb.cost_matrices(sims, tin, tout)
            dt = time.perf_counter() - t0
            expected += sum(kcb.surface_calls(s.cfg, kv) for s in sims)
            check(E.shape == R.shape == (len(tin), len(sims)) and np.isfinite(E).all()
                  and np.isfinite(R).all() and (E > 0).all() and (R > 0).all(),
                  f"cost_matrices {label}: bad shape or values")
            rel = 0.0
            for j, sim in enumerate(sims):
                pbs = [sim.simulate(int(tin[i]), int(tout[i])) for i in idx]
                for got, want in ((E[idx, j], [pb.energy_j for pb in pbs]),
                                  (R[idx, j], [pb.runtime_s for pb in pbs])):
                    rel = max(rel, float(np.max(np.abs(got - want) / np.abs(want))))
            worst = max(worst, rel)
            print(f"[analytic] cost_matrices KV-{'on' if kv else 'off'} {label} "
                  f"{E.shape}: {dt * 1e3:.1f} ms; max rel err vs numpy simulate over "
                  f"{len(idx)} queries x {len(sims)} models = {rel:.3e} (tol 1e-9) "
                  f"{'ok' if rel <= 1e-9 else 'MISS'}")
    launches = kcb.launches
    print(f"[analytic] B2 launches={launches} expected={expected} "
          f"(1 + 3 x decode segments, per simulator and call)")
    check(worst <= 1e-9, f"cost_matrices off the numpy closed form by {worst:.3e}")
    check(launches == expected, f"B2 launched {launches} times, expected {expected}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the cluster simulator and the online router
# ---------------------------------------------------------------------------

# benchmarks/fig4_online_gap.py's sizes
FIG4_N = 200
FIG4_RATES_QPS = (0.5, 2.0, 8.0)
FIG4_POWER_RATES_QPS = (0.5, 2.0)
FIG4_ZETAS = (0.5, 1.0)
FIG4_MAX_BATCH = 8
FIG4_IDLE_TIMEOUT_S = 30.0
FIG4_FIT_POINTS = ((8, 8), (64, 64), (256, 128), (1024, 256), (32, 512),
                   (512, 512), (128, 32), (2048, 64), (2048, 1024))
AVAIL_FLEET = ("llama2-7b", "llama2-7b", "llama2-13b")
AVAIL_N = 120
AVAIL_MTTF_MULTS = (5.0, 10.0, 50.0)
# benchmarks/perf_suite.py's bench_cluster at its largest size
CLUSTER_BENCH_N = 20_000
CLUSTER_BENCH_QPS = 8.0
CLUSTER_BENCH_POINTS = FIG4_FIT_POINTS[:-1]


def host_cpu() -> str:
    """The host CPU as lscpu names it (model, architecture, vendor) and its
    logical CPU count: the event loop runs on the host."""
    fields = {}
    try:
        res = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30)
        for line in res.stdout.splitlines():
            key, _, value = line.strip().partition(":")
            fields.setdefault(key, value.strip())
    except OSError:
        pass
    return (f"{fields.get('Model name', 'model not reported')}, "
            f"{fields.get('Architecture', platform.machine())}, "
            f"vendor {fields.get('Vendor ID', 'not reported')}, {os.cpu_count()} logical CPUs")


def analytic_profile(name, points=FIG4_FIT_POINTS):
    """fig4's Eq. 6/7 fit of one case-study model against the analytic
    simulator on the paper's SWING node."""
    from repro_torch.configs import PAPER_ZOO, TABLE1
    from repro_torch.core.energy_model import fit_profile
    from repro_torch.energy import SWING_NODE, AnalyticLLMSimulator
    sim = AnalyticLLMSimulator(PAPER_ZOO[name], SWING_NODE, batch=1, kv_cache=True,
                               noise_sigma=0.0)
    pbs = [sim.simulate(a, b) for a, b in points]
    return fit_profile(name, TABLE1[name]["a_k"], [p[0] for p in points],
                       [p[1] for p in points], [pb.energy_j for pb in pbs],
                       [pb.runtime_s for pb in pbs])


def fleet_builders(profiles, names=None, *, max_batch=FIG4_MAX_BATCH, **kw):
    """Zero-arg ClusterNode factories: node i hosts names[i] (one node per
    profile by default) on the simulator's SWING node model and is routed
    by that model's profile."""
    from repro_torch.cluster import ClusterNode
    from repro_torch.configs import PAPER_ZOO
    from repro_torch.energy import SWING_NODE
    by_name = {p.name: p for p in profiles}
    names = names or [p.name for p in profiles]
    return [(lambda i=i, n=n: ClusterNode(i, PAPER_ZOO[n], by_name[n], SWING_NODE,
                                          max_batch=max_batch, **kw))
            for i, n in enumerate(names)]


def fig4_trace(rate, n=FIG4_N):
    """fig4's trace: the Alpaca-like workload (seed 7) replayed at `rate`."""
    from repro_torch.cluster import replay_trace
    from repro_torch.data import WorkloadSpec, alpaca_like_workload
    queries = alpaca_like_workload(WorkloadSpec(n_queries=n, seed=7))
    return replay_trace(queries, rate, seed=11, name=f"alpaca@{rate:g}qps")


def fig4_policies():
    from repro_torch.cluster import (GreedyEnergyPolicy, LeastLoadedPolicy,
                                     OfflineOraclePolicy, RandomPolicy, RoundRobinPolicy,
                                     ZetaOnlinePolicy)
    return [RoundRobinPolicy(), RandomPolicy(seed=0), LeastLoadedPolicy(),
            GreedyEnergyPolicy(), ZetaOnlinePolicy(), OfflineOraclePolicy()]


def partition_residual(rep) -> float:
    """The energy buckets' relative gap to the report's total."""
    buckets = rep.energy_breakdown()
    return abs(sum(buckets.values()) - rep.total_energy_j) / max(1.0, rep.total_energy_j)


def policy_table(profiles, names, rate, tag) -> dict:
    """fig4's six policies at one rate and both ζ.  Each run is made twice:
    at 1 shard under a live auditor (which raises at the first settlement
    off its closed form by more than 1e-9) and bare at 4 shards; the two
    reports must be identical.  The offline oracle must be no worse than
    any online policy on the Eq. 2 objective (and, at ζ = 1, on predicted
    energy).  Returns {zeta: {policy: report}}."""
    from repro_torch.cluster import fresh_nodes, simulate_cluster
    from repro_torch.obs import InvariantAuditor, Telemetry
    builders = fleet_builders(profiles, names)
    trace = fig4_trace(rate)
    out = {}
    for zeta in FIG4_ZETAS:
        reports = {}
        for pol, pol4 in zip(fig4_policies(), fig4_policies()):
            tel = Telemetry(auditor=InvariantAuditor())
            rep = simulate_cluster(trace, fresh_nodes(builders), pol, zeta=zeta,
                                   telemetry=tel, shards=1)
            rep4 = simulate_cluster(trace, fresh_nodes(builders), pol4, zeta=zeta, shards=4)
            check(rep.to_json(include_records=True) == rep4.to_json(include_records=True),
                  f"{tag} rate={rate:g} zeta={zeta:g} {pol.name}: audited 1-shard and "
                  f"bare 4-shard reports differ")
            check(len(rep.records) == len(trace),
                  f"{tag} {pol.name}: served {len(rep.records)} of {len(trace)}")
            check(partition_residual(rep) <= 1e-9, f"{tag} {pol.name}: energy partition open")
            check(tel.auditor.n_checks > 0, f"{tag} {pol.name}: the auditor checked nothing")
            reports[pol.name] = rep
        oracle = reports["offline_oracle"]
        for name, rep in reports.items():
            check(oracle.objective <= rep.objective + 1e-9,
                  f"{tag} rate={rate:g} zeta={zeta:g}: oracle beaten on objective by {name}")
            if zeta == 1.0:
                check(oracle.predicted_energy_j <= rep.predicted_energy_j + 1e-6,
                      f"{tag} rate={rate:g}: oracle beaten on energy by {name} at zeta=1")
        online = [r.objective for n, r in reports.items() if n != "offline_oracle"]
        print(f"[cluster] {tag} rate={rate:g} qps zeta={zeta:g}: oracle_obj={oracle.objective} "
              f"best_online_obj={min(online)} worst_online_obj={max(online)} "
              f"oracle_E={oracle.total_energy_j} J oracle_p95={oracle.latency_p95} s "
              f"zeta_online_slo={reports['zeta_online'].slo_attainment()}")
        out[zeta] = reports
    return out


def power_cells(profiles) -> None:
    """Per-phase DVFS against the fixed frequency under zeta_online in
    every (rate, ζ) cell of fig4's table: the governed busy and total
    energy must be no more than the fixed run's.  Then fig4's gating cells
    (reactive idle gating, with and without DVFS, at the power rates and
    ζ 0.5) must serve every request."""
    from repro_torch.cluster import (ReactiveIdlePolicy, ZetaOnlinePolicy, fresh_nodes,
                                     simulate_cluster)
    fixed = fleet_builders(profiles)
    governed = fleet_builders(profiles, dvfs="per_phase")

    def run(trace, builders, zeta, gated=False):
        scaler = ReactiveIdlePolicy(idle_timeout_s=FIG4_IDLE_TIMEOUT_S) if gated else None
        return simulate_cluster(trace, fresh_nodes(builders), ZetaOnlinePolicy(), zeta=zeta,
                                autoscaler=scaler, shards=1)

    for rate in FIG4_RATES_QPS:
        trace = fig4_trace(rate)
        for zeta in FIG4_ZETAS:
            base, dvfs = run(trace, fixed, zeta), run(trace, governed, zeta)
            check(dvfs.total_busy_energy_j <= base.total_busy_energy_j + 1e-6,
                  f"DVFS busy energy above fixed at rate={rate:g} zeta={zeta:g}")
            check(dvfs.total_energy_j <= base.total_energy_j + 1e-6,
                  f"DVFS total energy above fixed at rate={rate:g} zeta={zeta:g}")
            line = (f"[cluster] power rate={rate:g} qps zeta={zeta:g}: E fixed="
                    f"{base.total_energy_j} dvfs={dvfs.total_energy_j}")
            if rate in FIG4_POWER_RATES_QPS and zeta == 0.5:
                gated, both = run(trace, fixed, zeta, True), run(trace, governed, zeta, True)
                check(len(gated.records) == len(both.records) == FIG4_N,
                      f"gated runs served fewer requests at rate={rate:g}")
                line += f" gated={gated.total_energy_j} gated+dvfs={both.total_energy_j}"
            print(line + " J (the simulator's SWING node model)")


def telemetry_cell(profiles) -> None:
    """fig4's telemetry cell (governed fleet, predictor router, reactive
    gating, SLO preempter, 2 qps) bare, with full Telemetry fused, and with
    full Telemetry sharded over 4 shards: the three reports identical, the
    fused and sharded Prometheus text and Chrome trace identical, and the
    report rebuilt from the registry within 1e-6 J."""
    from repro_torch.cluster import (ClusterReport, ReactiveIdlePolicy, SLOPreemptionPolicy,
                                     TauOutPredictor, ZetaOnlinePolicy, fresh_nodes)
    from repro_torch.cluster.engine import Runner
    from repro_torch.obs import EventTracer, InvariantAuditor, Telemetry
    builders = fleet_builders(profiles, dvfs="per_phase")
    trace = fig4_trace(2.0)

    def run(telemetry=None, shards=1, obs_mode="fused"):
        return Runner(trace, fresh_nodes(builders),
                      ZetaOnlinePolicy(tau_out_predictor=TauOutPredictor()), zeta=0.5,
                      autoscaler=ReactiveIdlePolicy(idle_timeout_s=FIG4_IDLE_TIMEOUT_S),
                      preempter=SLOPreemptionPolicy(slowdown_slo=2.0), telemetry=telemetry,
                      shard_count=shards, obs_mode=obs_mode).run()

    def full():
        return Telemetry(tracer=EventTracer(), auditor=InvariantAuditor(), sample_every_s=5.0)

    bare = run().to_json(include_records=True)
    tel, tel4 = full(), full()
    fused = run(tel)
    sharded = run(tel4, shards=4, obs_mode="sharded")
    check(fused.to_json(include_records=True) == bare, "instrumented report differs from bare")
    check(sharded.to_json(include_records=True) == bare, "sharded-obs report differs from bare")
    check(tel.prometheus_text() == tel4.prometheus_text(),
          "sharded Prometheus text differs from fused")
    check(tel.tracer.to_json() == tel4.tracer.to_json(), "sharded Chrome trace differs from fused")
    rebuilt = ClusterReport.from_registry(tel.registry)
    check(abs(rebuilt.total_energy_j - fused.total_energy_j) < 1e-6,
          "report rebuilt from the registry differs")
    check(partition_residual(fused) <= 1e-9, "telemetry cell: energy partition open")
    print(f"[cluster] telemetry cell: auditor checks={tel.auditor.n_checks} "
          f"prometheus lines={len(tel.prometheus_text().splitlines())} "
          f"trace events={len(tel.tracer)} preemptions={fused.total_preemptions}; "
          f"bare == fused == sharded (4 shards)")


def availability_cells(profiles) -> None:
    """fig4's availability cell: 2x llama2-7b + llama2-13b, 120 requests at
    2 qps, seeded crashes and stragglers at MTTF 5x, 10x and 50x the mean
    isolated service time.  FailoverPolicy rescue under a live auditor, a
    load-only failover and the failure-aware oracle on the same fault
    trace: every partition closes to 1e-9, the oracle is never beaten on
    the objective, the rescue keeps >= 90 % of the no-fault goodput at
    10x, and the audited run equals its bare 4-shard twin."""
    from repro_torch.cluster import (FailoverPolicy, FailureAwareOraclePolicy, FaultInjector,
                                     LeastLoadedPolicy, ZetaOnlinePolicy, fresh_nodes,
                                     simulate_cluster)
    from repro_torch.obs import InvariantAuditor, Telemetry
    builders = fleet_builders(profiles, AVAIL_FLEET, max_batch=4)
    trace = fig4_trace(2.0, AVAIL_N)
    base = simulate_cluster(trace, fresh_nodes(builders), FailoverPolicy(ZetaOnlinePolicy()),
                            zeta=0.5, shards=1)
    check(not base.abandoned, "no-fault baseline abandoned requests")
    mean_service_s = sum(r.isolated_runtime_s for r in base.records) / len(base.records)
    goodput = {}
    for mult in AVAIL_MTTF_MULTS:
        mttf = mult * mean_service_s
        faults = FaultInjector(mttf_s=mttf, mttr_s=2.0 * mean_service_s, straggle_mttf_s=mttf,
                               straggle_mttr_s=2.0 * mean_service_s,
                               slowdown_range=(1.5, 2.5), seed=13,
                               ).generate(range(len(AVAIL_FLEET)), trace.duration_s)
        tel = Telemetry(auditor=InvariantAuditor())
        reps = {
            "failover": simulate_cluster(trace, fresh_nodes(builders),
                                         FailoverPolicy(ZetaOnlinePolicy()), zeta=0.5,
                                         faults=faults, telemetry=tel, shards=1),
            "least_loaded": simulate_cluster(trace, fresh_nodes(builders),
                                             FailoverPolicy(LeastLoadedPolicy()), zeta=0.5,
                                             faults=faults, shards=1),
            "oracle": simulate_cluster(trace, fresh_nodes(builders),
                                       FailureAwareOraclePolicy(faults), zeta=0.5,
                                       faults=faults, shards=1)}
        twin = simulate_cluster(trace, fresh_nodes(builders), FailoverPolicy(ZetaOnlinePolicy()),
                                zeta=0.5, faults=faults, shards=4)
        check(twin.to_json(include_records=True)
              == reps["failover"].to_json(include_records=True),
              f"availability {mult:g}x: 4-shard report differs")
        for tag, rep in reps.items():
            check(partition_residual(rep) <= 1e-9,
                  f"availability {mult:g}x {tag}: energy partition open")
            if tag != "oracle" and len(rep.records) == len(reps["oracle"].records):
                check(reps["oracle"].objective <= rep.objective + 1e-9,
                      f"availability {mult:g}x: failure-aware oracle beaten by {tag}")
        fo = reps["failover"]
        goodput[mult] = fo.goodput() / max(base.goodput(), 1e-12)
        print(f"[cluster] availability mttf={mult:g}x ({mttf} s): faults={len(faults)} "
              f"crashes={fo.total_crashes} migrations={fo.total_migrations} "
              f"goodput failover={fo.goodput()} oracle={reps['oracle'].goodput()} "
              f"auditor checks={tel.auditor.n_checks}")
    check(goodput[10.0] >= 0.9, f"failover kept only {goodput[10.0]} of no-fault goodput at 10x")
    print(f"[cluster] availability: goodput recovery at 10x={goodput[10.0]}")


def bench_cluster() -> None:
    """perf_suite.bench_cluster at its largest size: 20,000 Poisson
    requests at 8 qps over llama2-7b/13b/70b routed by zeta_online, timed
    on the host's clock (the event loop is host code)."""
    from repro_torch.cluster import ZetaOnlinePolicy, fresh_nodes, poisson_trace, simulate_cluster
    from repro_torch.configs import CASE_STUDY_MODELS
    profiles = [analytic_profile(n, CLUSTER_BENCH_POINTS) for n in CASE_STUDY_MODELS]
    trace = poisson_trace(CLUSTER_BENCH_N, CLUSTER_BENCH_QPS, seed=3)
    nodes = fresh_nodes(fleet_builders(profiles))
    t0 = time.perf_counter()
    rep = simulate_cluster(trace, nodes, ZetaOnlinePolicy(), zeta=0.5, shards=1)
    wall = time.perf_counter() - t0
    check(len(rep.records) == CLUSTER_BENCH_N, "bench_cluster dropped requests")
    print(f"[cluster] bench_cluster n={CLUSTER_BENCH_N} at {CLUSTER_BENCH_QPS:g} qps: "
          f"wall s={wall} host requests/s={CLUSTER_BENCH_N / wall} "
          f"slo_attainment={rep.slo_attainment()} (host CPU: {host_cpu()})")


def online_router_live(torch, kda, serve_mod, card_profiles) -> None:
    """`OnlineRouter` live on the card: phase 6's 24 queries routed one at
    a time by zeta_online over the card-fitted profiles, each served at
    once at batch 1 by the KV-cached engine of the model it was routed to,
    then reported complete.  B1's launches must equal layers x max_new
    summed over the served requests."""
    import numpy as np
    from repro_torch.cluster import ZetaOnlinePolicy
    from repro_torch.data import WorkloadSpec, alpaca_like_workload, token_batches
    from repro_torch.energy.meter import NvmlMeter
    from repro_torch.serving import OnlineRouter, Request
    gc.collect()
    torch.cuda.empty_cache()
    engines = {a: serve_mod.build_engine(a, kv_cache=True, device="cuda")
               for a in SERVE_ARCHS}
    router = OnlineRouter(card_profiles, policy=ZetaOnlinePolicy(), zeta=0.5)
    queries = alpaca_like_workload(WorkloadSpec(n_queries=SERVE_QUERIES,
                                                **serve_mod.SERVE_WORKLOAD))
    split = collections.Counter()
    served_j = []
    expected = 0

    def route_and_serve():
        nonlocal expected
        for i, (tin, tout) in enumerate(queries):
            req = Request(i, np.zeros(tin, np.int32), tout)
            model = router.route_one(req)
            eng = engines[model]
            batch = next(token_batches([(tin, tout)], 1, eng.cfg.vocab_size, seed=i))
            gen, stats = eng.generate({"tokens": batch["tokens"]}, tout)
            check(gen.shape == (1, tout), f"request {i}: generate returned {gen.shape}")
            router.complete(req)
            split[model] += 1
            served_j.append(stats.energy_j)
            expected += eng.cfg.n_layers * tout

    kda.launches = 0
    whole = NvmlMeter("cuda")
    _, wall, _ = whole.measure(route_and_serve)
    launches = kda.launches
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[cluster] online router: {sum(split.values())} of {SERVE_QUERIES} routed and "
          f"served, split={dict(split)}, wall s={wall}")
    print(f"[cluster] online router: NVML J over route + serve={whole.last['window_j']}; "
          f"the {len(served_j)} requests' windows {sum(served_j)} J")
    print(f"[cluster] online router: B1 launches={launches} expected={expected} "
          f"(layers x max_new over the served requests)")
    check(sum(split.values()) == SERVE_QUERIES, "the online router lost requests")
    check(all(v.outstanding == 0 for v in router.views), "a model view still has outstanding work")
    check(expected > 0 and launches == expected,
          f"B1 launched {launches} times in the online loop, expected {expected}")


def run_cluster(torch, kda, serve_mod, card_profiles) -> None:
    """Phase 10: (a) fig4 at the reference's sizes, (b) bench_cluster,
    (c) fig4's six policies over the llama2-7b/13b fleet routed by the
    card-fitted profiles, (d) the online router live on the card."""
    from repro_torch.configs import CASE_STUDY_MODELS
    t0 = time.perf_counter()
    profiles = [analytic_profile(n) for n in CASE_STUDY_MODELS]
    for rate in FIG4_RATES_QPS:
        policy_table(profiles, None, rate, "fig4")
    power_cells(profiles)
    telemetry_cell(profiles)
    availability_cells(profiles)
    print(f"[cluster] (a) fig4 at the reference's sizes s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    bench_cluster()
    print(f"[cluster] (b) bench_cluster s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    requests = fig4_trace(2.0).requests
    for p in card_profiles:
        negative = sum(float(p.energy(r.tau_in, r.tau_out)) < 0 for r in requests)
        print(f"[cluster] card-fitted {p.name}: energy coeffs={list(p.energy.coeffs)} "
              f"runtime coeffs={list(p.runtime.coeffs)} a_k={p.accuracy.a_k}; predicted "
              f"energy < 0 for {negative} of {len(requests)} requests")
    reports = policy_table(card_profiles, None, 2.0, "card-fitted")
    for zeta, reps in reports.items():
        split = collections.Counter(r.model for r in reps["zeta_online"].records)
        print(f"[cluster] card-fitted zeta={zeta:g}: zeta_online split={dict(split)}")
    print(f"[cluster] (c) card-fitted profiles in the cluster s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    online_router_live(torch, kda, serve_mod, card_profiles)
    print(f"[cluster] (d) online router live s={time.perf_counter() - t0}")


# ---------------------------------------------------------------------------
# Phase 11: training
# ---------------------------------------------------------------------------


def train_batches(torch, cfg, n, batch, seq, seed, device="cuda") -> list:
    """`lm_train_batches(kind="markov")` moved to `device` up front."""
    from repro_torch.data.workloads import lm_train_batches
    return [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
            for b in lm_train_batches(n, batch, seq, cfg.vocab_size, seed=seed, kind="markov")]


def _train_breakdown(prof, label, shares=None, ranges=True):
    """Where the profiled step's device time goes: the GEMMs (cuBLAS/CUTLASS
    kernels by name), with `ranges` the optimizer's update (the
    `optimizer_update` range, which only an eager step shows: a graph
    replay runs no Python), the kernels named in `shares` (label ->
    substrings of their names) and the top kernels.  Returns the step's
    device busy ms (every kernel; the step starts and ends synchronized),
    None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    rows = prof.key_averages()
    # the range also shows on the device's timeline, where it is no kernel
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key != "optimizer_update"]
    if not kernels:
        return None
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm = sum(e.self_device_time_total for e in kernels
               if any(k in e.key.lower() for k in ("gemm", "cutlass", "nvjet", "xmma"))) / 1e3
    update = ""
    if ranges:
        ms = sum(e.device_time_total for e in rows if e.key == "optimizer_update"
                 and e.device_type == DeviceType.CPU) / 1e3
        update = f", the optimizer's update {ms:.3f} ms ({ms / busy:.3f})"
    print(f"[train] {label}: the profiled step's device time {busy:.3f} ms: GEMM kernels "
          f"{gemm:.3f} ms ({gemm / busy:.3f}){update}, {sum(e.count for e in kernels)} kernels")
    for name, keys in (shares or {}).items():
        mine = [e for e in kernels if any(k in e.key for k in keys)]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        print(f"[train] {label}: {name} kernels {ms:.3f} ms ({ms / busy:.4f} of the busy "
              f"time), {sum(e.count for e in mine)} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8 if ranges else 4]:
        print(f"[train]   {e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:90]}")
    return busy


# A cell's eager steps, before its graphed ones: a warm-up, a profiled
# step and a timed one (the graphed steps: warm-up and capture, a profiled
# replay, timed replays)
EAGER_STEPS = 3


def _run_steps(torch, step, params, state, batches, meter, prof, watch, first) -> tuple:
    """`step` over `batches`, synchronized: the first two timed on the host
    clock (a warm-up, then one under `prof`), the later ones metered by
    `meter` (each NVML window costs ~0.3 s of waiting for the counter's
    steps); `watch` (a probe) told which step is profiled and when each
    is done (numbered from `first`).  Returns (losses, walls ms, joules
    (None where not metered), params, state)."""
    losses, walls, joules = [], [], []
    for i, b in enumerate(batches):
        if watch:
            watch.profiled = i == 1
        if i == 1:
            prof.start()
        run = lambda: step(params, state, b)             # noqa: E731
        if i >= 2:
            (loss, params, state), dt, j = meter.measure(run)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, params, state = run()
            torch.cuda.synchronize()
            dt, j = time.perf_counter() - t0, None
        losses.append(float(loss))
        walls.append(dt * 1e3)
        joules.append(j)
        if i == 1:
            prof.stop()
        if watch:
            watch.step_done(first + i)
    return losses, walls, joules, params, state


def train_cell(torch, label, cfg, batch, seq, steps, meter, *, probe=None, shares=None,
               idle_check=True) -> dict:
    """AdamW steps of `cfg` at full width on the card, random bf16 weights
    drawn on the card (seed 0): EAGER_STEPS eager steps
    (`compile_train_step(graphed=False)`: the same step bodies run
    eagerly), then `steps` through the compiled step
    (`launch.steps.compile_train_step`: step 1 runs the warm-up step and
    captures the CUDA graph, each later step replays it), training on from
    the eager steps' params.  In each mode step 1 warms up, step 2 runs
    under the profiler (device busy ms; the eager step also by range) and
    steps 3 on without it: their wall, tokens/s, NVML J and model-FLOP
    share, and idle share = 1 - busy / that wall.  Prints per step the
    loss, wall ms and, from step 3, NVML J (`meter`, a NvmlMeter), the
    graph's warm-up and capture seconds and pool GiB, each mode's
    max_memory_allocated, and the graphed against the eager numbers.
    With `idle_check` the graphed idle share must be below the eager one.
    The model FLOPs are 6 N T, N the parameters a token touches (MoE: the
    active ones) less the input embedding (a lookup, no matrix FLOPs; the
    share with it is printed beside).  `probe(opt)`, if given, is a
    context manager active over both modes; its `profiled` is set before
    each step and its `step_done(i)` runs after each.  `shares` goes to
    `_train_breakdown`.  Returns the losses, the probe and each mode's
    numbers."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch.steps import build_train_step, compile_train_step
    from repro_torch.models import get_api
    from repro_torch.models.registry import active_params
    api = get_api(cfg)
    n_params, n_active = api.count_params(cfg), active_params(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_embed = 0 if cfg.tie_embeddings else params["embed"].numel()
    step_fn, opt = build_train_step(cfg, lr=TRAIN_LR)
    state = opt.init(params)
    update = opt.update

    def ranged_update(*args):
        with record_function("optimizer_update"):
            return update(*args)

    object.__setattr__(opt, "update", ranged_update)
    batches = train_batches(torch, cfg, EAGER_STEPS + steps, batch, seq, seed=0)
    mb = cfg.microbatch if cfg.microbatch and cfg.microbatch < batch else batch
    print(f"[train] {label}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters ({n_active / 1e9:.3f} B active, "
          f"{cfg.param_dtype}), {cfg.optimizer}, remat {cfg.remat}, batch {batch} x seq "
          f"{seq} in microbatches of {mb} ({batch // mb} accumulated in "
          f"{cfg.grad_accum_dtype}), lr {TRAIN_LR}; {EAGER_STEPS} eager steps, then "
          f"{steps} through the compiled step (CUDA graphs)")
    tokens = batch * seq
    flops = 6 * (n_active - n_embed) * tokens
    losses, modes = [], {}
    with probe(opt) if probe else contextlib.nullcontext() as watch:
        for graphed, run in ((False, batches[:EAGER_STEPS]), (True, batches[EAGER_STEPS:])):
            mode = "graphed" if graphed else "eager"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step = compile_train_step(step_fn, device="cuda", graphed=graphed)
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            torch.cuda.synchronize()
            got, walls, joules, params, state = _run_steps(torch, step, params, state, run,
                                                           meter, prof, watch, len(losses))
            peak = torch.cuda.max_memory_allocated()
            graph = (step.warmup_s, step.capture_s, step.pool_bytes() / 2**30,
                     len(step.steps)) if graphed else None
            del step                                 # its graph and pool go with it
            busy = _train_breakdown(prof, f"{label} {mode}", shares, ranges=not graphed)
            del prof
            n = len(run)
            wall = sum(walls[2:]) / (n - 2)
            m = modes[mode] = {"wall_ms": wall, "busy_ms": busy, "peak_gib": peak / 2**30,
                               "idle": 1 - busy / wall if busy else None,
                               "joules": sum(joules[2:]) / (n - 2), "graph": graph}
            for i in range(n):
                if i == 0:
                    dev = ("warm-up step, then the capture (warm-up s={:.3f}, capture s={:.3f})"
                           .format(*graph[:2]) if graphed else "warm-up, not profiled")
                elif i == 1:
                    dev = (f"under the profiler: device busy {busy:.3f} ms" if busy else
                           "under the profiler: device busy not measured (it saw no device "
                           "time)")
                else:
                    dev = "not profiled"
                kind = "replay, " if graphed and i else ""
                nvml = "not metered" if joules[i] is None else f"{joules[i]:.1f}"
                print(f"[train] {label} {mode} step {i + 1}: loss {got[i]:.5f}, wall "
                      f"{walls[i]:.3f} ms, NVML J {nvml}, {kind}{dev}")
            idle = f"idle share {m['idle']:.3f}" if busy else "idle share not measured"
            print(f"[train] {label} {mode}: steps 3-{n} (not profiled): {wall:.3f} ms a step, "
                  f"device busy {busy or float('nan'):.3f} ms (step 2), {idle}, "
                  f"{tokens / wall * 1e3:.1f} tokens/s, NVML J a step {m['joules']:.1f}, "
                  f"model-FLOP share {flops / (wall / 1e3 * BF16_DENSE_PEAK):.4f} (6 N T = "
                  f"{flops:.4e} FLOP a step, N = {(n_active - n_embed) / 1e9:.3f} B without "
                  f"the input embedding; with it "
                  f"{6 * n_active * tokens / (wall / 1e3 * BF16_DENSE_PEAK):.4f}; over "
                  f"{BF16_DENSE_PEAK:.4g} FLOP/s, the H100 SXM's dense bf16 peak), "
                  f"max_memory_allocated GiB={peak / 2**30}")
            if graphed:
                print(f"[train] {label} graphed: {graph[3]} graph, warm-up s={graph[0]}, "
                      f"capture s={graph[1]}, pool GiB={graph[2]}")
            losses += got
    e, g = modes["eager"], modes["graphed"]
    busy_part = (f", wall / busy {g['wall_ms'] / g['busy_ms']:.4f}, idle share "
                 f"{e['idle']:.3f} -> {g['idle']:.3f}" if e["busy_ms"] and g["busy_ms"] else "")
    print(f"[train] {label}: graphed against eager (this card: {nvidia_smi()}): wall "
          f"{e['wall_ms']:.3f} -> {g['wall_ms']:.3f} ms ({g['wall_ms'] / e['wall_ms']:.3f})"
          f"{busy_part}, NVML J a step {e['joules']:.1f} -> {g['joules']:.1f}, peak GiB "
          f"{e['peak_gib']:.3f} -> {g['peak_gib']:.3f} ({g['peak_gib'] / e['peak_gib']:.3f}), "
          f"capture s / eager step s {g['graph'][1] / e['wall_ms'] * 1e3:.3f}")
    check(all(math.isfinite(x) for x in losses), f"{label}: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall: {losses}")
    check(g["graph"][3] == 1, f"{label}: {g['graph'][3]} graphs for one batch shape")
    if idle_check and e["busy_ms"] and g["busy_ms"]:
        check(g["idle"] < e["idle"], f"{label}: graphed idle share {g['idle']:.3f} is not "
                                     f"below the eager {e['idle']:.3f}")
    del params, state, batches
    return {"losses": losses, "probe": watch, "modes": modes}


class MoEProbe:
    """Over a MoE model's training steps: the pairs dropped past capacity
    in each step's forward (`moe.dispatch_tables` wrapped), whether every
    gradient handed to the optimizer is finite, and, in the profiled eager
    step only, the aten ops that `moe._Dispatch.backward` and
    `moe._Combine.backward` run (a TorchDispatchMode around each).  The
    wrappers run with the step's Python: at every eager step and a
    graphed program's warm-up, whose tensors are that step's; and at its
    capture, whose tensors live in the graph's pool and are rewritten by
    each replay, so `step_done` reads them after each step."""

    def __init__(self, torch, cfg, opt):
        from repro_torch.models import moe
        self.torch, self.moe, self.opt = torch, moe, opt
        self.n_moe = cfg.n_layers - cfg.n_dense_layers
        self.live = {"tables": [], "finite": []}       # eager runs of the step's Python
        self.captured = {"tables": [], "finite": []}   # a capture's: rewritten by replays
        self.marks = {"tables": 0, "finite": 0}
        self.drops, self.finite = [], []
        self.ops = collections.Counter()
        self.profiled = False

    def _log(self, kind, t):
        capturing = self.torch.cuda.is_current_stream_capturing()
        (self.captured if capturing else self.live)[kind].append(t)

    def _tables(self, eidx, n_experts, capacity):
        tab = self.saved["tables"](eidx, n_experts, capacity)
        self._log("tables", (~tab.keep).sum())
        return tab

    def _logged(self, fn):
        from torch.utils._python_dispatch import TorchDispatchMode
        probe, ops = self, self.ops

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops[str(func)] += 1
                return func(*args, **(kwargs or {}))

        def backward(ctx, g):
            if not probe.profiled:
                return fn(ctx, g)
            with Log():
                return fn(ctx, g)
        return staticmethod(backward)

    def _update(self, grads, state, params, lr):
        from repro_torch.checkpoint import flatten_tree
        self._log("finite", self.torch.stack(
            [self.torch.isfinite(g).all() for _, g in flatten_tree(grads)]).all())
        return self.saved["update"](grads, state, params, lr)

    def _step(self, kind):
        """The step's records of `kind`: those its Python made, or, for a
        replay (which ran none), the capture's, which it rewrote."""
        rec = self.live[kind][self.marks[kind]:]
        self.marks[kind] = len(self.live[kind])
        return rec or self.captured[kind]

    def step_done(self, i):
        """The step's forward made the first n_moe dispatches (one
        microbatch; remat repeats them in the backward)."""
        rec = self._step("tables")
        check(len(rec) in (self.n_moe, 2 * self.n_moe),
              f"step {i + 1}: {len(rec)} dispatches for {self.n_moe} MoE layers")
        self.drops.append(int(sum(rec[:self.n_moe])))
        finite = self._step("finite")
        check(len(finite) == 1, f"step {i + 1}: {len(finite)} optimizer updates")
        self.finite.append(bool(finite[0]))

    def __enter__(self):
        moe = self.moe
        self.saved = {"tables": moe.dispatch_tables, "update": self.opt.update,
                      "dispatch": moe._Dispatch.backward, "combine": moe._Combine.backward}
        moe.dispatch_tables = self._tables
        moe._Dispatch.backward = self._logged(self.saved["dispatch"])
        moe._Combine.backward = self._logged(self.saved["combine"])
        object.__setattr__(self.opt, "update", self._update)
        return self

    def __exit__(self, *exc):
        moe = self.moe
        moe.dispatch_tables = self.saved["tables"]
        moe._Dispatch.backward = staticmethod(self.saved["dispatch"])
        moe._Combine.backward = staticmethod(self.saved["combine"])
        object.__setattr__(self.opt, "update", self.saved["update"])
        self.live = self.captured = None       # the capture's tensors hold pool memory


class ScanProbe:
    """Over a scan family's training steps: each step's launches of B3's or
    B4's forward and backward kernels, held to layers x (1 forward, 1 more
    for remat's recompute; 1 backward) x microbatches.  A graph replay
    adds the launches its capture recorded to the counts, so a replayed
    step is held like an eager one."""

    def __init__(self, mod, kernel, layers, passes, microbatches):
        self.mod, self.kernel = mod, kernel
        self.expect = (passes * layers * microbatches, layers * microbatches)
        self.per_step = []
        self.profiled = False

    def counts(self):
        return self.mod.launches, self.mod.bwd_launches

    def step_done(self, i):
        now = self.counts()
        got = (now[0] - self.mark[0], now[1] - self.mark[1])
        self.mark = now
        self.per_step.append(got)
        check(got == self.expect, f"step {i + 1}: {self.kernel} launched {got} times (forward, "
                                  f"backward); the layers need {self.expect}")

    def __enter__(self):
        self.mark = self.counts()
        return self

    def __exit__(self, *exc):
        pass


def scan_layers(cfg) -> int:
    """The layers that run B3 (ssm) or B4 (hybrid's recurrent ones)."""
    from repro_torch.models import hybrid
    return cfg.n_layers if cfg.family == "ssm" else hybrid.n_rec_layers(cfg)


def train_scan_cell(torch, cfg, kernel, mod, batch, seq, steps, meter, full_layers,
                    idle_check=True) -> tuple:
    """(f)/(g): `train_cell` of mamba2 (B3) or recurrentgemma (B4) with the
    scan's launches held each step, eager and graphed, and its kernels'
    share of each profiled step.  Returns (forward, backward) launches
    over the cell."""
    mb = cfg.microbatch if cfg.microbatch and cfg.microbatch < batch else batch
    layers = scan_layers(cfg)
    label = cfg.name if cfg.n_layers == full_layers else (
        f"{cfg.name} ({cfg.n_layers} of {full_layers} layers)")
    out = train_cell(torch, label, cfg, batch, seq, steps, meter,
                     probe=lambda opt: ScanProbe(mod, kernel, layers, 1 + cfg.remat, batch // mb),
                     shares={k: v for k, v in SCAN_KERNEL_KEYS.items() if k.startswith(kernel)},
                     idle_check=idle_check)
    per_step = out["probe"].per_step
    print(f"[train] {label}: {kernel} launches (forward, backward) per step {per_step} "
          f"({EAGER_STEPS} eager, then {steps} graphed: a warm-up step and replays), "
          f"{layers} layers x ({1 + cfg.remat} forward: remat {cfg.remat}; 1 backward) x "
          f"{batch // mb} microbatch(es)")
    return tuple(map(sum, zip(*per_step)))


def train_cli(torch, arch, batch, seq, steps, mod, kernel) -> tuple:
    """(e) `repro_torch.launch.train.main` on its default device, no
    checkpoint: must return 0 with finite losses, the scan launched
    layers x (1 + remat forward, 1 backward) x steps times (its compiled
    step's warm-up step and replays).  Returns those (forward, backward)
    launches."""
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    before = (mod.launches, mod.bwd_launches)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_mod.main(["--arch", arch, "--steps", str(steps), "--batch", str(batch),
                             "--seq", str(seq)])
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[train] main --arch {arch}: {line}")
    got = (mod.launches - before[0], mod.bwd_launches - before[1])
    layers = scan_layers(cfg)
    want = ((1 + cfg.remat) * layers * steps, layers * steps)
    print(f"[train] main --arch {arch}: rc {rc}, {time.perf_counter() - t0:.1f} s, {kernel} "
          f"launches (forward, backward) {got}, the layers need {want}")
    first, last = re.search(r"^loss (\S+) -> (\S+) improved", out, re.M).groups()
    check(rc == 0 and math.isfinite(float(first)) and math.isfinite(float(last)),
          f"launch.train.main --arch {arch}: rc {rc}, loss {first} -> {last}")
    check(got == want, f"launch.train.main --arch {arch}: {kernel} launched {got}, want {want}")
    return got


def train_resume(torch, cfg, full_layers, batch, seq, ckpt_dir) -> None:
    """(c) Under torch.use_deterministic_algorithms(True), from the same
    weights and batches: 4 steps of the compiled step (a warm-up step,
    then replays of its CUDA graph) against 4 eager steps
    (`graphed=False`): losses, params and AdamW state bit-identical.  Then
    the same compiled step is handed fresh trees (copied into its
    statics) for 2 steps, a checkpoint is saved (as `launch.train` saves it,
    step 2 of `ckpt_dir`, which (e) resumes from) and loaded, and 2 more
    steps run from the loaded trees (copied in): params and state must
    equal the 4 straight steps' bit for bit."""
    from repro_torch import checkpoint as ckptlib
    from repro_torch.launch.steps import build_train_step, compile_train_step
    from repro_torch.models import get_api
    api = get_api(cfg)
    step_fn, opt = build_train_step(cfg, lr=TRAIN_LR)
    batches = train_batches(torch, cfg, 4, batch, seq, seed=1)
    path = ckptlib.step_path(ckpt_dir, 2)

    def fresh():
        params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        return params, opt.init(params)

    def flat(p, s):
        return dict(ckptlib.flatten_tree({"p": p, "s": s}))

    def differ(a, b):
        return [k for k in a if not (a.keys() == b.keys() and torch.equal(a[k], b[k]))]

    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    try:
        compiled = compile_train_step(step_fn, device="cuda")
        runs = {}
        for graphed in (True, False):
            step = compiled if graphed else compile_train_step(step_fn, device="cuda",
                                                               graphed=False)
            p, s = fresh()
            losses = [float(step(p, s, b)[0]) for b in batches]
            # the compiled step's statics are reused below: keep a copy
            runs[graphed] = (losses, {k: v.clone() if graphed else v
                                      for k, v in flat(p, s).items()})
            del step, p, s
        p2, s2 = fresh()
        for b in batches[:2]:
            _, p2, s2 = compiled(p2, s2, b)
        t0 = time.perf_counter()
        ckptlib.save_checkpoint(path, {"params": p2, "opt_state": s2}, step=2,
                                metadata={"arch": cfg.name})
        t_save = time.perf_counter() - t0
        del p2, s2
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tree, step_no, _ = ckptlib.load_checkpoint(path, device="cuda")
        t_load = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in path.iterdir())
        p3, s3 = tree["params"], tree["opt_state"]
        for b in batches[2:]:
            _, p3, s3 = compiled(p3, s3, b)
        resumed = flat(p3, s3)
        info = (len(compiled.steps), compiled.warmup_s, compiled.capture_s,
                compiled.pool_bytes() / 2**30)
    finally:
        torch.use_deterministic_algorithms(False)
    (lg, straight), (le, eager) = runs[True], runs[False]
    vs_eager, vs_resumed = differ(straight, eager), differ(straight, resumed)
    n_leaves = len(straight)
    del compiled, tree, p3, s3, straight, eager, resumed, runs
    print(f"[train] resume: {cfg.name} at {cfg.n_layers} of {full_layers} layers (depth cut), "
          f"{api.count_params(cfg) / 1e9:.3f} B parameters, deterministic algorithms on; "
          f"compiled step: {info[0]} graph, warm-up s={info[1]}, capture s={info[2]}, "
          f"pool GiB={info[3]}; 4 graphed steps against 4 eager: losses {lg} vs {le}, "
          f"{n_leaves - len(vs_eager)} of {n_leaves} leaves equal bit for bit")
    print(f"[train] resume: checkpoint {size / 1e9:.2f} GB written in {t_save:.1f} s, read in "
          f"{t_load:.1f} s; after 4 graphed steps straight vs 2 + save/load + 2 (the fresh and "
          f"the loaded trees copied into the compiled step's statics): "
          f"{n_leaves - len(vs_resumed)} of {n_leaves} leaves equal bit for bit")
    check(lg == le and not vs_eager, f"graphed steps are not bit-identical to eager ones: "
                                     f"losses {lg} vs {le}, leaves {vs_eager[:8]}")
    check(step_no == 2 and not vs_resumed,
          f"resume on the card is not bit for bit: {vs_resumed[:8]}")
    check(info[0] == 1, f"the resume's compiled step holds {info[0]} graphs, not 1")


def train_main(torch, arch, batch, seq, cut, ckpt_dir) -> None:
    """(e) The CLI, `repro_torch.launch.train.main`, on the card (its
    default device) at full width and depth: 4 steps through its compiled
    step (step 1 captures the graph), no checkpoint; must return 0 (the
    last loss below the first) with finite losses.  Then the trainer's
    resume: `launch.train.train` of `cut` (the config (c) ran) over
    `ckpt_dir`, which holds (c)'s step-2 checkpoint: it must resume from
    step 2 (the loaded trees become its compiled step's statics) and run
    2 steps with finite losses."""
    import io
    from repro_torch.launch import train as train_mod
    gc.collect()
    torch.cuda.empty_cache()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_mod.main(["--arch", arch, "--batch", str(batch), "--seq", str(seq),
                             "--steps", "4"])
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[train] main --arch {arch}: {line}")
    print(f"[train] main --arch {arch}: rc {rc}, {time.perf_counter() - t0:.1f} s")
    first, last = re.search(r"^loss (\S+) -> (\S+) improved", out, re.M).groups()
    check(rc == 0 and math.isfinite(float(first)) and math.isfinite(float(last)),
          f"launch.train.main --arch {arch}: rc {rc}, loss {first} -> {last}")
    gc.collect()
    torch.cuda.empty_cache()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        losses = train_mod.train(cut, steps=2, batch=batch, seq=seq, lr=TRAIN_LR,
                                 ckpt_dir=str(ckpt_dir), ckpt_every=1000)
    out = buf.getvalue()
    label = f"[train] train ({cut.n_layers} layers, resumed)"
    for line in out.splitlines():
        print(f"{label}: {line}")
    print(f"{label}: {time.perf_counter() - t0:.1f} s, losses {losses}")
    check("resumed from step 2" in out and all(math.isfinite(x) for x in losses),
          f"launch.train.train did not resume from (c)'s step-2 checkpoint: losses {losses}")


class GradLog:
    """Wraps an optimizer's update to keep the gradients of each step: an
    eager run's as it runs; a graph's as the copies its capture made,
    which each replay rewrites (`take` reads them after the step)."""

    def __init__(self, torch, opt):
        self.torch, self.update = torch, opt.update
        self.live, self.captured = [], []
        object.__setattr__(opt, "update", self)

    def __call__(self, grads, state, params, lr):
        from repro_torch.checkpoint import flatten_tree
        g = {k: v.detach().clone() for k, v in flatten_tree(grads)}
        capturing = self.torch.cuda.is_current_stream_capturing()
        (self.captured if capturing else self.live).append(g)
        return self.update(grads, state, params, lr)

    def take(self) -> dict:
        """The last step's gradients, on the CPU."""
        g = self.live.pop() if self.live else self.captured[-1]
        return {k: v.cpu() for k, v in g.items()}


def train_reduced(torch, scan_mods) -> dict:
    """(d) Two steps of each reduced family on the card through the
    compiled step (a warm-up step, then a replay of its CUDA graph)
    against the eager step on the CPU from the same weights and batches:
    each step's loss within 1e-3 and gradients within 1e-2 of the largest,
    the updated params finite; mamba2's and recurrentgemma's gradients on
    the card go through B3's and B4's backward kernels, once a layer each
    step.  Returns kernel -> (forward, backward) launches."""
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step, compile_train_step
    from repro_torch.models import get_api
    launched = collections.Counter()
    for arch in TRAIN_REDUCED:
        cfg = get_config(arch)
        api = get_api(cfg)
        params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card_params = _map(params, lambda t: t.cuda())  # before the CPU steps update params
        batches = [{**train_batches(torch, cfg, 1, 2, 32, seed=2 + i, device="cpu")[0],
                    **frontend_batch(torch, cfg, 2, seed=2 + i, device="cpu")} for i in range(2)]
        kernel = {"ssm": "B3", "hybrid": "B4"}.get(cfg.family)
        want = ((1 + cfg.remat) * scan_layers(cfg), scan_layers(cfg)) if kernel else None
        runs = {}
        for on_card in (False, True):
            step_fn, opt = build_train_step(cfg, lr=TRAIN_LR)
            log = GradLog(torch, opt)
            p = card_params if on_card else params
            s = opt.init(p)
            step = compile_train_step(step_fn, device="cuda") if on_card else step_fn
            losses, grads, counts = [], [], []
            for b in batches:
                if kernel:
                    mod = scan_mods[kernel]
                    before = (mod.launches, mod.bwd_launches)
                loss, p, s = step(p, s, {k: v.cuda() if on_card else v for k, v in b.items()})
                losses.append(float(loss))
                grads.append(log.take())
                if kernel:
                    counts.append((mod.launches - before[0], mod.bwd_launches - before[1]))
            finite = all(bool(torch.isfinite(v).all()) for _, v in flatten_tree(p))
            replayed = on_card and all(st.graph is not None for st in step.steps.values())
            runs[on_card] = (losses, grads, counts, finite, replayed)
            del step, p, s, log
        del card_params
        (cpu_losses, cpu_grads, _, _, _), (losses, grads, counts, finite, replayed) = (
            runs[False], runs[True])
        worst = max(float((v - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
                    for g, ref in zip(grads, cpu_grads) for k, v in g.items())
        if kernel:
            print(f"[train] reduced {arch}: {kernel} launches (forward, backward) per step "
                  f"{counts}, the layers need {want}")
            check(counts == [want] * 2, f"{arch}: {kernel} launched {counts}, want {want}")
            launched[kernel + " forward"] += sum(c[0] for c in counts)
            launched[kernel + " backward"] += sum(c[1] for c in counts)
        print(f"[train] reduced {arch}: losses card (graphed) {losses} cpu {cpu_losses}, "
              f"largest gradient error / largest gradient {worst:.2e}, step 2 a replay "
              f"{replayed}, updated params finite {finite}")
        check(replayed, f"{arch}: the card's step 2 was not a graph replay")
        check(all(abs(a - b) <= 1e-3 for a, b in zip(losses, cpu_losses)),
              f"{arch}: card losses differ")
        check(worst <= 1e-2 and finite, f"{arch}: card gradients differ or go non-finite")
    return launched


def run_train(torch, kernel_mods) -> dict:
    """Phase 11: (a) qwen3-1.7b and (b) granite-moe-3b-a800m trained at
    full width and depth, eager and through the compiled step, (c) graphed
    steps bit-identical to eager ones and the resume bit for bit, (d) the
    reduced families compiled on the card against the CPU, (e) the
    training CLI at full size and the trainer's resume at a cut depth, and
    on B3 (mamba2-130m), (f) mamba2-130m at full size and (g)
    recurrentgemma-9b at full width (TRAIN_DEPTH_CUTS) through B3 and B4
    in both directions, eager and graphed.  B1 and B2 launch 0 times over
    the phase; B3's and B4's forward and backward launches must equal what
    the layers need.  Returns kernel -> (forward, backward) launches over
    the phase."""
    from repro_torch.configs import get_config
    from repro_torch.energy.meter import NvmlMeter
    meter = NvmlMeter("cuda")
    for mod in kernel_mods.values():
        mod.launches = 0
    scan_mods = {"B3": kernel_mods["B3"], "B4": kernel_mods["B4"]}
    for mod in scan_mods.values():
        mod.bwd_launches = 0
    want = collections.Counter()
    t0 = time.perf_counter()
    arch, batch, seq, steps = TRAIN_DENSE
    train_cell(torch, arch, get_config(arch), batch, seq, steps, meter)
    print(f"[train] (a) {arch} s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    arch, batch, seq, steps = TRAIN_MOE
    cfg = get_config(arch)
    check(not cfg.microbatch or batch <= cfg.microbatch,
          f"{arch}: batch {batch} is above microbatch {cfg.microbatch}")
    out = train_cell(torch, arch, cfg, batch, seq, steps, meter,
                     probe=lambda opt: MoEProbe(torch, cfg, opt))
    watch = out["probe"]
    scatter = {op: n for op, n in watch.ops.items()
               if "scatter" in op or "index_add" in op or "index_put" in op}
    pairs = batch * seq * cfg.top_k * watch.n_moe
    drops, finite = watch.drops, watch.finite
    print(f"[train] {arch}: (token, expert) pairs dropped past capacity per step ({EAGER_STEPS} "
          f"eager, then {steps} graphed), over its {watch.n_moe} MoE layers: {drops} of "
          f"{pairs} ({[round(d / pairs, 4) for d in drops]}); every gradient finite {finite}")
    print(f"[train] {arch}: ops in the dispatch/combine backward of the profiled eager step "
          f"{dict(watch.ops)}")
    check(all(finite) and len(finite) == EAGER_STEPS + steps, f"{arch}: a gradient is not finite")
    check(watch.ops and not scatter, f"{arch}: the dispatch/combine backward ran {scatter}")
    print(f"[train] (b) {arch} s={time.perf_counter() - t0}")
    arch, batch, seq, _ = TRAIN_DENSE
    cfg = get_config(arch)
    cut = cfg.replace(n_layers=TRAIN_RESUME_LAYERS)
    ckpt_dir = ROOT / "build" / "train_ckpt"       # (c) saves, (e)'s trainer resumes
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        train_resume(torch, cut, cfg.n_layers, batch, seq, ckpt_dir)
        print(f"[train] (c) graphed vs eager, resume s={time.perf_counter() - t0}")
        t0 = time.perf_counter()
        want.update(train_reduced(torch, scan_mods))
        print(f"[train] (d) reduced families s={time.perf_counter() - t0}")
        t0 = time.perf_counter()
        train_main(torch, arch, batch, seq, cut, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    arch, batch, seq, steps = TRAIN_SSM_CLI
    fwd, bwd = train_cli(torch, arch, batch, seq, steps, scan_mods["B3"], "B3")
    want.update({"B3 forward": fwd, "B3 backward": bwd})
    print(f"[train] (e) launch.train.main s={time.perf_counter() - t0}")
    for tag, (arch, batch, seq, steps), kernel in (("f", TRAIN_SSM, "B3"),
                                                   ("g", TRAIN_HYBRID, "B4")):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        full = cfg.n_layers
        cfg = cfg.replace(n_layers=TRAIN_DEPTH_CUTS.get(arch, full))
        # recurrentgemma's eager steps already idle ~0.03 of their wall
        fwd, bwd = train_scan_cell(torch, cfg, kernel, scan_mods[kernel], batch, seq, steps,
                                   meter, full, idle_check=kernel == "B3")
        want.update({f"{kernel} forward": fwd, f"{kernel} backward": bwd})
        print(f"[train] ({tag}) {arch} s={time.perf_counter() - t0}")
    launches = {name: mod.launches for name, mod in kernel_mods.items()}
    scans = {k: (mod.launches, mod.bwd_launches) for k, mod in scan_mods.items()}
    print(f"[train] kernel launches over the phase: {launches}; B3, B4 (forward, backward) "
          f"{scans}, the layers run need {dict(want)}")
    check(launches["B1"] == 0 and launches["B2"] == 0,
          f"B1 or B2 launched on the training path: {launches}")
    check(all(scans[k] == (want[f"{k} forward"], want[f"{k} backward"]) for k in scans),
          f"B3/B4 launches {scans} differ from the layers' {dict(want)}")
    return scans


def _map(tree, fn):
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Phase 12: the sharding layer on the card, and the dry run against it
# ---------------------------------------------------------------------------

# (a) the sharded runs: qwen3-1.7b trained as phase 11 (a) trains it, and
# llama2-7b prefill + decode under the decode rules
SHARD_TRAIN = TRAIN_DENSE[:3] + (2,)            # (arch, batch, seq, steps)
SHARD_DECODE = ("llama2-7b", 4, 16, 8)          # (arch, batch, prompt, decode steps)
# (c) B1's LSE and the merge of sequence slices, at these decode_shapes rows
LSE_SHAPES = ("llama2-7b serve", "recurrentgemma-9b ring")
LSE_SLICES = (2, 4)
# (d) the dry-run campaign in a child process over the whole script
DRYRUN_ARCHS = ("qwen3-1.7b", "deepseek-v3-671b")
DRYRUN_OUT = ROOT / "build" / "dryrun_smoke"
PEAK_TOL = 0.15             # predicted peak bytes against max_memory_allocated
FLOPS_RTOL = 1e-6           # traced FLOPs against FlopCounterMode on the card


def start_children() -> dict:
    """Phase 12's host-only work, started once the kernels are timed (so
    their host times are taken on a quiet host) and joined at the end:
    (d) the dry-run CLI over DRYRUN_ARCHS x the four shapes on the pod
    mesh (a fake group of 256 ranks), and (b)'s traces of (a)'s two steps
    at the (1, 1) mesh (this script again, with --trace-steps).  An
    earlier run's records are removed first."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_OUT.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmds = {
        "campaign": [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
                     str(DRYRUN_OUT), "--force"] + [x for a in DRYRUN_ARCHS
                                                    for x in ("--arch", a)],
        "trace": [sys.executable, str(ROOT / "chip_smoke.py"), "--trace-steps",
                  str(DRYRUN_OUT / "steps.json")],
    }
    kids = {}
    for name, cmd in cmds.items():
        log = open(DRYRUN_OUT / f"{name}.log", "w")
        kids[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log, time.time())
    return kids


def stop_children(kids: dict) -> None:
    for proc, log, _ in kids.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def train_shape():
    from repro_torch.configs.shapes import InputShape
    arch, batch, seq, _ = SHARD_TRAIN
    return arch, InputShape("phase12_train", seq, batch, "train")


def decode_shape():
    from repro_torch.configs.shapes import InputShape
    arch, batch, prompt, steps = SHARD_DECODE
    return arch, InputShape("phase12_decode", prompt + steps, batch, "decode")


def trace_steps(out_path: str) -> int:
    """(b)'s traces, in a child: (a)'s train and decode steps on fake CUDA
    tensors over a (1, 1) mesh of a fake one-rank group.  Writes their
    per-device FLOPs and peak bytes as JSON."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shardrules
    from repro_torch.launch.dryrun import trace_one
    from repro_torch.launch.mesh import make_test_mesh, start_fake_group
    start_fake_group(1)
    mesh = make_test_mesh((1, 1))
    out = {}
    for kind, (arch, shape) in (("train", train_shape()), ("decode", decode_shape())):
        cfg = get_config(arch)
        rules = shardrules.build_rules(cfg, shape, multi_pod=False)
        totals, peak, secs = trace_one(cfg, shape, mesh, rules, "cuda", full_depth=True)
        out[kind] = {"flops": totals.flops, "peak": peak, "seconds": secs,
                     "collective_bytes": dict(totals.collective_bytes)}
    Path(out_path).write_text(json.dumps(out))
    return 0


class B1Flops:
    """While active, adds to `flops` what FlopCounterMode counts for B1's
    plain version at the shapes of each launch (the kernel itself is
    invisible to it), so a count around a real step holds what the dry
    run counts when it runs the plain version on fake tensors."""

    def __init__(self, torch, kda):
        self.torch, self.kda, self.flops, self.cache = torch, kda, 0.0, {}

    def __enter__(self):
        from torch.utils._python_dispatch import _disable_current_modes
        from torch.utils.flop_counter import FlopCounterMode
        torch, kda = self.torch, self.kda
        self.orig = kda.decode_attention

        def counted(q, k, v, pos, **kw):
            key = (tuple(q.shape), tuple(k.shape), q.dtype, k.dtype, kw.get("lse", False))
            if key not in self.cache:
                meta = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in (q, k, v)]
                # counted alone: the enclosing FlopCounterMode must not see it
                with _disable_current_modes(), FlopCounterMode(display=False) as fc:
                    kda.decode_attention_plain(*meta, 0, **kw)
                self.cache[key] = fc.get_total_flops()
            self.flops += self.cache[key]
            return self.orig(q, k, v, pos, **kw)

        kda.decode_attention = counted
        return self

    def __exit__(self, *exc):
        self.kda.decode_attention = self.orig


def check_lse(torch, kda, shapes) -> None:
    """(c) B1's LSE against the plain version's, and the outputs of B1 run
    on 2 and 4 sequence slices merged by their LSEs against B1's own over
    the whole cache, at B1's check tolerance (1 % of max|plain|)."""
    for name in LSE_SHAPES:
        shape = shapes[name]
        B, Hq, Hkv, D, S, dtype, _ = shape
        q, k, v = decode_inputs(torch, shape, seed=7)
        for pos in (S // 3, S - 1):
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            out, lse = kda.decode_attention(q, k, v, p, lse=True)
            ref_out, ref_lse = kda.decode_attention_plain(q, k, v, p, lse=True)
            lse_err = (lse - ref_lse).abs().max().item()
            print(f"[shard] (c) B1 LSE {name} pos={pos}: max|LSE - plain| {lse_err:.3g} "
                  f"(|LSE| up to {ref_lse.abs().max().item():.3g})")
            check(lse_err <= 1e-2 * max(1.0, ref_lse.abs().max().item()),
                  f"B1's LSE at {name} pos={pos} is off the plain version's by {lse_err}")
            for n in LSE_SLICES:
                L = S // n
                outs, lses = [], []
                for i in range(n):
                    rel = p - i * L
                    o, s = kda.decode_attention(q, k[:, i * L:(i + 1) * L].contiguous(),
                                                v[:, i * L:(i + 1) * L].contiguous(),
                                                rel.clamp(0, L - 1), lse=True)
                    outs.append(o.float())
                    lses.append(torch.where(rel >= 0, s, -torch.inf))
                lse_all = torch.stack(lses)
                w = torch.exp(lse_all - lse_all.max(0).values)
                merged = (torch.stack(outs) * w[..., None]).sum(0) / w.sum(0)[..., None]
                err = (merged - out.float()).abs().max().item()
                big = ref_out.float().abs().max().item()
                print(f"[shard] (c) B1 on {n} slices of {name} pos={pos}, merged by LSE: "
                      f"max|merged - whole| {err:.3g} ({err / big:.3g} of max|plain|)")
                check(err <= 0.01 * big, f"the LSE merge of {n} slices disagrees at {name}")


def shard_train(torch, mesh) -> dict:
    """(a) qwen3-1.7b trained SHARD_TRAIN steps unsharded, then from the
    same weights on FSDP DTensors under the train rules, and one more
    sharded step counted for (b).  Returns its FLOPs and peak, and
    DTensor's host ms on the first step."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import shard
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shardrules
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import get_api
    arch, shape = train_shape()
    steps = SHARD_TRAIN[3]
    cfg = get_config(arch)
    api = get_api(cfg)
    batches = train_batches(torch, cfg, steps + 1, shape.global_batch, shape.seq_len, seed=3)

    def fresh():
        return api.init_params(cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")

    def run(params, step_fn, opt, ctx):
        state = opt.init(params)
        losses, walls = [], []
        with ctx():
            for b in batches[:steps]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, params, state = step_fn(params, state, b)
                losses.append(float(loss.full_tensor() if shard.is_dtensor(loss) else loss))
                walls.append((time.perf_counter() - t0) * 1e3)
        return params, state, losses, walls

    rules = shardrules.build_rules(cfg, shape, multi_pod=False)
    sizes = shardrules.mesh_axis_sizes(mesh)

    @contextlib.contextmanager
    def sharded():
        with implicit_replication(), shard.use_rules(rules, sizes):
            yield

    gc.collect()
    torch.cuda.empty_cache()
    step_fn, opt = build_train_step(cfg, lr=TRAIN_LR)
    params, state, losses, walls = run(fresh(), step_fn, opt, contextlib.nullcontext)
    p_ref = {k: v.cpu() for k, v in flatten_tree(params)}
    del params, state
    gc.collect()
    torch.cuda.empty_cache()

    pspecs = shardrules.fsdp_specs(api.param_defs(cfg), rules, mesh)
    step_fn, opt = build_train_step(cfg, lr=TRAIN_LR, param_pspecs=pspecs)
    with sharded():
        params = shardrules.distribute_tree(fresh(), pspecs, mesh)
        batches = [shardrules.distribute_tree(b, shardrules.input_pspecs(b, rules), mesh)
                   for b in batches]
    params, state, s_losses, s_walls = run(params, step_fn, opt, sharded)
    p_err = 0.0
    for path, p in flatten_tree(params):
        got, ref = p.full_tensor().float(), p_ref[path].to("cuda").float()
        p_err = max(p_err, (got - ref).abs().max().item() / max(1.0, ref.abs().max().item()))
    del p_ref, got, ref
    # (b): one more step under FlopCounterMode (which runs some ops
    # decomposed, so it comes after the comparison), its peak read from
    # the allocator
    with sharded(), FlopCounterMode(display=False) as fc:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_fn(params, state, batches[steps])
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[shard] (a) {arch} FSDP on a (1, 1) mesh, batch {shape.global_batch} x seq "
          f"{shape.seq_len}: losses {s_losses} vs unsharded {losses}; params after {steps} "
          f"steps max|diff| / max(1, max|p|) {p_err:.3g}; step walls ms "
          f"{np.round(s_walls, 1).tolist()} vs unsharded {np.round(walls, 1).tolist()}")
    check(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(s_losses, losses)),
          f"{arch}: sharded losses {s_losses} differ from {losses}")
    check(p_err <= 1e-4, f"{arch}: sharded params off the unsharded ones by {p_err}")
    return {"flops": float(fc.get_total_flops()), "peak": peak,
            "wall_ms": s_walls[0] - walls[0]}


def shard_decode(torch, kda, mesh) -> dict:
    """(a) llama2-7b: prefill SHARD_DECODE's prompt and decode greedily,
    unsharded (B1) and on DTensors under the decode rules (B1 on the
    cache's S shard, outputs merged by LSE); greedy tokens identical,
    logits within check_full_width's relative L2 0.1.  One more decode
    step is counted for (b).  Returns its FLOPs and peak."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import shard
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shardrules
    from repro_torch.models import get_api
    arch, shape = decode_shape()
    _, B, P, steps = SHARD_DECODE
    cfg = get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(6), "cuda")
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (B, P)).astype(np.int32), device="cuda")

    def greedy(params, prompt, lay_out=None):
        logits, cache = api.prefill(cfg, params, {"tokens": prompt}, cache_len=shape.seq_len)
        if lay_out:
            cache = lay_out(cache)
        out = [logits]
        for _ in range(steps - 1):
            tok = out[-1].full_tensor() if shard.is_dtensor(out[-1]) else out[-1]
            tok = tok.argmax(-1).to(torch.int32)
            if lay_out:
                tok = shardrules.to_dtensor(tok, shardrules.input_pspecs(
                    {"token": 0}, rules)["token"], mesh)
            logits, cache = api.decode_step(cfg, params, cache, {"token": tok})
            out.append(logits)
        whole = [(x.full_tensor() if shard.is_dtensor(x) else x).float() for x in out]
        return torch.stack(whole), cache, tok

    rules = shardrules.build_rules(cfg, shape, multi_pod=False)
    sizes = shardrules.mesh_axis_sizes(mesh)
    with torch.no_grad():
        ref, _, _ = greedy(params, prompt)
        with implicit_replication(), shard.use_rules(rules, sizes):
            dparams = shardrules.distribute_tree(params, api.param_specs(cfg, rules), mesh)
            dprompt = shardrules.to_dtensor(prompt, shardrules.input_pspecs(
                {"tokens": 0}, rules)["tokens"], mesh)
            kda.launches = 0
            got, cache, tok = greedy(dparams, dprompt, lambda c: shardrules.redistribute_tree(
                c, shardrules.cache_pspecs(c, rules), mesh))
            launches = kda.launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with FlopCounterMode(display=False) as fc, B1Flops(torch, kda) as b1:
                api.decode_step(cfg, dparams, cache, {"token": tok})
            torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    same = bool((got.argmax(-1) == ref.argmax(-1)).all())
    rel = ((got - ref).norm() / ref.norm()).item()
    per_step = [round(((g - r).norm() / r.norm()).item(), 4) for g, r in zip(got, ref)]
    print(f"[shard] (a) {arch}: relative L2 per step (prefill first) {per_step}")
    print(f"[shard] (a) {arch} prefill {P} + {steps - 1} decode steps on a (1, 1) mesh under "
          f"the decode rules (cache S on 'model': B1 on the shard, merged by LSE): greedy "
          f"tokens identical {same}, logits relative L2 {rel:.3g} (tol 0.1), B1 launches "
          f"{launches} (want {cfg.n_layers * (steps - 1)})")
    check(same and rel <= 0.1, f"{arch}: sharded decode differs from the unsharded one")
    check(launches == cfg.n_layers * (steps - 1), f"{arch}: B1 launched {launches} times")
    del params, dparams, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"flops": float(fc.get_total_flops()) + b1.flops, "peak": peak}


def run_sharded(torch, kda, shapes) -> dict:
    """Phase 12 (a)-(c) on a one-rank NCCL group.  Returns (b)'s real
    counts."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    t0 = time.perf_counter()
    check_lse(torch, kda, shapes)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1))
        real = {"train": shard_train(torch, mesh), "decode": shard_decode(torch, kda, mesh)}
    finally:
        dist.destroy_process_group()
    print(f"[phase] sharding (a)-(c) s={time.perf_counter() - t0}")
    return real


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join_children(kids: dict, real: dict, serve_walls: dict) -> None:
    """(b) the traces against the card's counts, (d) the campaign's
    records and table."""
    from repro_torch.analysis.report import load, markdown_table
    waits = {}
    for name, (proc, log, started) in kids.items():
        rc = proc.wait(timeout=max(30.0, 1100.0 - (time.perf_counter() - T_START)))
        log.flush()
        # the child's own wall: from its start to its log's last write
        waits[name] = os.path.getmtime(log.name) - started
        check(rc == 0, f"child {name} exited {rc}: "
              + (DRYRUN_OUT / f"{name}.log").read_text()[-3000:])
    traced = json.loads((DRYRUN_OUT / "steps.json").read_text())
    for kind in ("train", "decode"):
        t, r = traced[kind], real[kind]
        rel = abs(t["flops"] - r["flops"]) / r["flops"]
        ratio = t["peak"] / r["peak"]
        print(f"[shard] (b) {kind} step traced at (1, 1) on fake CUDA tensors in "
              f"{t['seconds']:.1f} s: FLOPs {t['flops']:.6g} vs FlopCounterMode on the card "
              f"{r['flops']:.6g} (rel {rel:.3g}); peak bytes {t['peak']} vs "
              f"max_memory_allocated {r['peak']} (ratio {ratio:.4f})")
        check(rel <= FLOPS_RTOL, f"(b) {kind}: traced FLOPs off the card's count by {rel}")
        check(abs(ratio - 1) <= PEAK_TOL, f"(b) {kind}: predicted peak off by {ratio}")
    recs = load(DRYRUN_OUT, "pod")
    print("[dryrun] campaign table (H100_SXM pricing, 16 x 16 fake mesh):")
    print(markdown_table(recs))
    print(f"[dryrun] campaign child wall s={waits['campaign']}; (b) traces child wall "
          f"s={waits['trace']}; serve phase walls s={serve_walls}")
    names = {(r["arch"], r["shape"]) for r in recs}
    check(len(recs) == 4 * len(DRYRUN_ARCHS) and len(names) == len(recs),
          f"campaign: {len(recs)} ok records of {4 * len(DRYRUN_ARCHS)}: "
          + (DRYRUN_OUT / "campaign.log").read_text()[-3000:])


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    # cuBLAS is deterministic under torch.use_deterministic_algorithms (phase
    # 11's resume check) only with a fixed workspace, set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] total_memory {torch.cuda.get_device_properties(0).total_memory} B; "
          f"power draw before any work: {power_draw()}")

    kids = {}
    try:
        return run_phases(torch, kids, kind, count, smi)
    finally:
        stop_children(kids)


def run_phases(torch, kids, kind, count, smi) -> int:
    from repro_torch.kernels import _build
    from repro_torch.kernels import cost_batch as kcb
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rglru_scan as krg
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.launch import serve as serve_mod

    counter = counter_report(torch)
    limit_w = power_limit_w(smi)
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"[build] {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[phase] build s={time.perf_counter() - t0}")

    t0 = time.perf_counter()
    shapes = decode_shapes(torch, serve_mod)
    errs = check_decode(torch, kda, shapes)
    scan_errs = check_scans(torch, kss, krg)
    bwd_errs = check_scan_backwards(torch, kss, krg, kref)
    cost_errs = check_cost_batch(torch, kcb)
    print(f"[phase] kernel checks s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    timing = time_decode(torch, kda, shapes)
    timing.update(time_scans(torch, kss, krg))
    timing.update(time_scan_backwards(torch, kss, krg))
    timing.update(time_cost_batch(torch, kcb))
    time_simulate_batch(torch, kcb)
    print(f"[phase] kernel timing s={time.perf_counter() - t0}")
    kids.update(start_children())
    t0 = time.perf_counter()
    analytic_launches = run_analytic(torch, kcb)
    print(f"[phase] analytic path s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    launches, card_profiles = run_serve(torch, kda, serve_mod, limit_w, counter)
    fp8_launches = check_outputs(torch, kda, serve_mod)
    check_graphs(torch, serve_mod)
    serve_walls = {"llama2": time.perf_counter() - t0}
    print(f"[phase] llama2 path (serve + outputs) s={serve_walls['llama2']}")
    t0 = time.perf_counter()
    scan_launches = run_scan_serve(torch, {"B3": kss, "B4": krg, "B1": kda}, serve_mod,
                                   limit_w, counter)
    check_scan_outputs(torch, serve_mod)
    serve_walls["scan"] = time.perf_counter() - t0
    print(f"[phase] mamba2 + recurrentgemma path (serve + outputs) s={serve_walls['scan']}")
    t0 = time.perf_counter()
    moe_launches = run_moe_serve(torch, kda, serve_mod, limit_w, counter)
    check_moe_outputs(torch, kda, serve_mod)
    serve_walls["moe"] = time.perf_counter() - t0
    print(f"[phase] MoE path (serve + outputs) s={serve_walls['moe']}")
    t0 = time.perf_counter()
    ev_launches = run_encdec_vlm_serve(torch, kda, serve_mod, limit_w, counter)
    check_encdec_vlm_outputs(torch, kda, serve_mod)
    serve_walls["encdec_vlm"] = time.perf_counter() - t0
    print(f"[phase] encdec + vlm path (serve + outputs) s={serve_walls['encdec_vlm']}")
    t0 = time.perf_counter()
    run_cluster(torch, kda, serve_mod, card_profiles)
    print(f"[phase] cluster (fig4, bench_cluster, card-fitted profiles, online router) "
          f"s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    train_scans = run_train(torch, {"B1": kda, "B2": kcb, "B3": kss, "B4": krg})
    print(f"[phase] training (qwen3-1.7b, granite-moe-3b-a800m, resume, reduced, CLI, "
          f"mamba2-130m, recurrentgemma-9b) "
          f"s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    real = run_sharded(torch, kda, shapes)
    join_children(kids, real, serve_walls)
    print(f"[phase] sharding and the dry run's children s={time.perf_counter() - t0}")

    def entry(name, source, replaces, n, err, shape):
        return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=n, max_abs_err=err,
                    **{k: timing[shape][k] for k in
                       ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
                       + (("warm_ms", "host_us") if "warm_ms" in timing[shape] else ())})

    b1 = "src/repro/kernels/decode_attention.py:72"
    kernels = [
        entry("decode_attention (B1, flash-decode GQA), llama2 path", "decode_attention.cu",
              b1, launches, errs["llama2-7b serve"], "llama2-7b serve"),
        entry("decode_attention (B1) with an fp8 cache, llama2-7b fp8-cache decode",
              "decode_attention.cu", b1, fp8_launches, errs["llama2-7b serve fp8"],
              "llama2-7b serve fp8"),
        entry("decode_attention (B1) at head dim 256, recurrentgemma-9b path",
              "decode_attention.cu", b1, scan_launches["B1"],
              errs["recurrentgemma-9b ring"], "recurrentgemma-9b ring"),
        entry("decode_attention (B1), MoE path (granite-moe-3b-a800m, mixtral-8x7b)",
              "decode_attention.cu", b1, moe_launches,
              max(errs["granite-moe serve"], errs["mixtral serve"]), "mixtral serve"),
        entry("decode_attention (B1), encdec cross-attention (seamless-m4t-large-v2; "
              "launches: self + cross)", "decode_attention.cu", b1,
              ev_launches["seamless-m4t-large-v2"],
              max(errs["seamless cross"], errs["seamless cross fp8"]), "seamless cross"),
        entry("decode_attention (B1), vlm path (internvl2-2b)", "decode_attention.cu", b1,
              ev_launches["internvl2-2b"],
              max(errs["internvl2 serve"], errs["internvl2 serve fp8"]), "internvl2 serve"),
        entry("pass_costs (B2, analytic pass-cost surface) at simulate_batch's operands "
              "(prefill: one array as new tokens and context, a 0-d batch)", "cost_batch.cu",
              "src/repro/kernels/cost_batch.py:347", analytic_launches,
              cost_errs["float64"], "B2 simulate_batch prefill"),
        entry("ssd_scan (B3, Mamba-2 SSD chunk scan)", "ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:73", scan_launches["B3"],
              scan_errs["B3 bfloat16"], "B3 characterize"),
        entry("rglru_scan (B4, RG-LRU linear recurrence)", "rglru_scan.cu",
              "src/repro/kernels/rglru_scan.py:53", scan_launches["B4"],
              scan_errs["B4 float32"], "B4 characterize"),
        entry("ssd_scan backward (B3)", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:73",
              train_scans["B3"][1], bwd_errs["B3 bwd train bfloat16 abs"], "B3 bwd train"),
        entry("rglru_scan backward (B4)", "rglru_scan.cu", "src/repro/kernels/rglru_scan.py:53",
              train_scans["B4"][1], bwd_errs["B4 bwd train float32 abs"], "B4 bwd train"),
    ]
    print(f"[phase] total wall s={time.perf_counter() - T_START}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--trace-steps"]:
        sys.exit(trace_steps(sys.argv[2]))
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
