#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. device   the card's name and count, and `nvidia-smi`'s name and power limit;
  2. build    every CUDA kernel from src/repro_torch/kernels/csrc (B1, B2,
              B3, B4), with the compiler's register/shared-memory report;
  3. check    each kernel against its plain PyTorch version on the card, at
              the main paths' shapes: B1 (q f32 within 1e-4, q bf16 within
              2e-2, elementwise and of the output's largest magnitude) at
              the llama2 shapes, the MoE path's (granite-moe-3b-a800m,
              mixtral-8x7b), falcon-7b's MQA (71 query heads on one KV
              head) and recurrentgemma-9b's head dim 256 ring, with bf16
              and float8_e4m3fn caches, keys past pos overwritten
              (the output bit-identical); B2 for every family branch and
              both decode modes at m = 1,000,037 (f32 rtol 1e-5, f64 rtol
              1e-12); B3 at mamba2-130m's (f32 atol 2e-4 / rtol 1e-3, bf16 within 2e-2 of
              the output's largest magnitude); B4 at recurrentgemma-9b's
              (1e-4); B3 and B4 also at the edges of their designs (chunk
              and tile boundaries, state sizes 16..256, W % 4 != 0);
  4. timing   each kernel, its plain version and, for B1, a library call
              (CUDA events, L2 flushed between launches), beside the bound
              for its bytes or operations; B1 also back to back with the
              L2 warm and its wrapper's host time a call; the timing's floor, a streaming
              yardstick for B4 and B3's time per chunk, and B3, B4, the
              floor and the yardstick back to back with the L2 warm;
              `simulate_batch` queries/s;
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
              the card: characterize with the KV cache off, fit, route 24
              queries, serve with the KV cache on.  First llama2-7b and
              llama2-13b (characterized up to 32 tokens), where kernel B1's
              launch count must equal the decode work done; then
              mamba2-130m and recurrentgemma-9b (characterized up to 32
              tokens: SCAN_CHAR_MAX_TOKENS), where every prefill must launch
              B3 once per SSM layer or B4 once per recurrent layer, and
              every decode step B1 once per attention layer;
              one KV-on generate of each outside the router makes every
              kernel launch whatever the routing;
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
              of it (profiler);
  8. moe      the MoE family through the same `serve`: granite-moe-3b-a800m
              at full width and depth and mixtral-8x7b at full width cut to
              8 of 32 layers (DEPTH_CUTS: 47 B parameters fit no 80 GB
              card), random bf16 weights, characterized up to 16 tokens,
              24 queries routed and served, and one KV-on generate of each
              outside the router; B1's launches must equal the attention
              layers x decode steps.  Then the reduced mixtral, granite and
              deepseek-v3 (both MLA decode modes) on the card against the
              CPU, full-width decode against a re-forward with the device's
              busy share of a decode step (granite, mixtral, and
              deepseek-v3-671b cut to 4 layers, 3 dense + 1 MoE, in both
              MLA decode modes, where B1 must launch 0 times);
  9. encdec + vlm  seamless-m4t-large-v2 (24 encoder + 24 decoder layers
              over 4,096 frames) and internvl2-2b (24 layers, 256 patches)
              at full width and depth, random bf16 weights, with seeded
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
              max_new over the served requests.

Exits nonzero, printing no result, without a CUDA device, without the
port's sources beside it, or when any phase fails.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import ctypes
import gc
import json
import math
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
# CUDA-core f32, bf16 tensor; f64 outside the tensor cores (H100 SXM data sheet)
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float64": 34e12}
SERVE_ARCHS = ["llama2-7b", "llama2-13b"]
SERVE_CHAR_MAX_TOKENS = 32      # the llama2 path's characterization grid top
SCAN_ARCHS = ["mamba2-130m", "recurrentgemma-9b"]
SCAN_CHAR_MAX_TOKENS = 32       # the scan path's grid top (64 before phase 9 came)
MOE_ARCHS = ["granite-moe-3b-a800m", "mixtral-8x7b"]
MOE_CHAR_MAX_TOKENS = 16        # the MoE path's characterization grid top
# Depth cuts of the MoE phase, at full width: mixtral-8x7b's 32 layers
# (47 B parameters, ~94 GB in bf16) and deepseek-v3-671b's 61 fit no 80 GB card.
DEPTH_CUTS = {"mixtral-8x7b": 8, "deepseek-v3-671b": 4}
ENCDEC_VLM_ARCHS = ["seamless-m4t-large-v2", "internvl2-2b"]
ENCDEC_VLM_CHAR_MAX_TOKENS = 16
SERVE_QUERIES = 24
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


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


class Nvml:
    """The card's cumulative energy counter (millijoules), read
    through libnvidia-ml with ctypes."""

    def __init__(self):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        check(self.lib.nvmlInit_v2() == 0, "nvmlInit failed")
        self.handle = ctypes.c_void_p()
        check(self.lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(self.handle)) == 0,
              "nvmlDeviceGetHandleByIndex failed")

    def millijoules(self) -> int:
        mj = ctypes.c_ulonglong()
        rc = self.lib.nvmlDeviceGetTotalEnergyConsumption(self.handle, ctypes.byref(mj))
        check(rc == 0, f"nvmlDeviceGetTotalEnergyConsumption returned {rc}")
        return mj.value


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


def run_serve(torch, kda, serve_mod) -> tuple[int, list]:
    """Phase 6's llama2 serve.  Returns B1's launches over it and the
    llama2-7b/13b profiles fitted from the card's runs."""
    try:
        nvml = Nvml()
    except (OSError, PhaseError) as e:
        nvml = None
        print(f"[serve] NVML energy: not measured ({e})")
    torch.cuda.reset_peak_memory_stats()
    kda.launches = 0
    e0 = nvml.millijoules() if nvml else None
    t0 = time.perf_counter()
    out = serve_mod.serve(SERVE_ARCHS, n_queries=SERVE_QUERIES, zeta=0.5,
                          char_max_tokens=SERVE_CHAR_MAX_TOKENS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kda.launches
    e1 = nvml.millijoules() if nvml else None

    for prof in out["profiles"]:
        print(f"[serve] {prof.name}: energy R2={prof.energy.r_squared} "
              f"runtime R2={prof.runtime.r_squared}")
        check(math.isfinite(prof.energy.r_squared) and math.isfinite(prof.runtime.r_squared),
              f"{prof.name}: fit is not finite")
    for arch, t in out["totals"].items():
        print(f"[serve] {arch}: queries={t['queries']} tokens={t['tokens']} "
              f"measured_s={t['runtime_s']} host-model_J={t['energy_j']}")
    print(f"[serve] serve() wall s={wall}")
    if nvml:
        print(f"[serve] NVML J over serve() (characterize + serve)={(e1 - e0) / 1e3}")
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


def _breakdown(label, wall_ms, events, why, steps, kernel_keys, kernel_label) -> None:
    if not events:
        print(f"[profile] {label}: wall {wall_ms:.3f} ms; device busy share not measured ({why})")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    mine = [e for e in events if any(k in e.key for k in kernel_keys)]
    k_ms = sum(e.self_device_time_total for e in mine) / 1e3 / steps
    print(f"[profile]   {kernel_label}: {k_ms:.4f} ms per call, "
          f"{k_ms / busy_ms:.3f} of device busy time, over "
          f"{sum(e.count for e in mine) // steps} launches a call of "
          f"{sorted({e.key[:80] for e in mine})}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / steps:.4f} ms per call "
              f"x{e.count // steps} {e.key[:90]}")


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


# ---------------------------------------------------------------------------
# The ssm + hybrid fleet's serve path
# ---------------------------------------------------------------------------


class EngineCalls:
    """Counts the engines' prefill and decode calls per (model, KV mode,
    kind), and the kernel launches each made, by wrapping
    InferenceEngine._prefill/_decode while the block runs."""

    def __init__(self, engine_cls, counters: dict):
        self.cls, self.counters = engine_cls, counters
        self.calls = collections.Counter()
        self.launches = collections.Counter()

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

    def __enter__(self):
        self.orig = self.cls._prefill, self.cls._decode
        self.cls._prefill = self._wrap(self.orig[0], "prefill")
        self.cls._decode = self._wrap(self.orig[1], "decode")
        return self

    def __exit__(self, *exc):
        self.cls._prefill, self.cls._decode = self.orig


def per_call_launches(cfg, kind) -> dict:
    """Kernel launches one engine call of a scan-fleet model must make."""
    from repro_torch.models import hybrid
    is_hybrid = cfg.family == "hybrid"
    if kind == "prefill":
        return {"B3": cfg.n_layers if cfg.family == "ssm" else 0,
                "B4": hybrid.n_rec_layers(cfg) if is_hybrid else 0, "B1": 0}
    return {"B3": 0, "B4": 0, "B1": hybrid.pattern_counts(cfg)[2] if is_hybrid else 0}


def run_scan_serve(torch, counters, serve_mod) -> dict:
    """serve() of the ssm + hybrid fleet, then one KV-on generate of each
    model outside the router.  Every engine call's kernel launches must be
    its layers' count.  Returns kernel -> launches over the whole run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving import InferenceEngine
    try:
        nvml = Nvml()
    except (OSError, PhaseError) as e:
        nvml = None
        print(f"[scan-serve] NVML energy: not measured ({e})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for m in counters.values():
        m.launches = 0
    with EngineCalls(InferenceEngine, counters) as calls:
        e0 = nvml.millijoules() if nvml else None
        t0 = time.perf_counter()
        out = serve_mod.serve(SCAN_ARCHS, n_queries=SERVE_QUERIES, zeta=0.5,
                              char_max_tokens=SCAN_CHAR_MAX_TOKENS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        e1 = nvml.millijoules() if nvml else None
        for arch in SCAN_ARCHS:      # every kernel, whatever the routing
            eng = serve_mod.build_engine(arch, kv_cache=True, device="cuda")
            toks = np.random.default_rng(3).integers(1, eng.cfg.vocab_size, (4, 40))
            gen, _ = eng.generate({"tokens": toks.astype(np.int32)}, 8)
            check(gen.shape == (4, 8), f"{arch}: generate returned {gen.shape}")
            del eng
        torch.cuda.synchronize()
    launches = {k: m.launches for k, m in counters.items()}

    for prof in out["profiles"]:
        print(f"[scan-serve] {prof.name}: energy R2={prof.energy.r_squared} "
              f"runtime R2={prof.runtime.r_squared}")
        check(math.isfinite(prof.energy.r_squared) and math.isfinite(prof.runtime.r_squared),
              f"{prof.name}: fit is not finite")
    for arch, t in out["totals"].items():
        print(f"[scan-serve] {arch}: queries={t['queries']} tokens={t['tokens']} "
              f"measured_s={t['runtime_s']} host-model_J={t['energy_j']}")
    print(f"[scan-serve] serve() wall s={wall} "
          f"(characterized up to {SCAN_CHAR_MAX_TOKENS} tokens)")
    if nvml:
        print(f"[scan-serve] NVML J over serve() (characterize + serve)={(e1 - e0) / 1e3}")
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
    DEPTH_CUTS at full width with that many layers; others unchanged."""

    def __init__(self, serve_mod):
        self.mod = serve_mod
        self.orig = serve_mod.get_config

    def lookup(self, arch):
        cfg = self.orig(arch)
        return cfg.replace(n_layers=DEPTH_CUTS[arch]) if arch in DEPTH_CUTS else cfg

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


def run_moe_serve(torch, kda, serve_mod) -> int:
    """serve() of granite-moe-3b-a800m and mixtral-8x7b (DEPTH_CUTS), then
    one KV-on generate of each outside the router.  Every engine decode
    call must launch B1 once per layer and every prefill never; over the
    run B1's launches must equal the served batches' layers x max_new plus
    the generates'.  Returns B1's launches over the run."""
    import numpy as np
    from repro_torch.serving import InferenceEngine
    try:
        nvml = Nvml()
    except (OSError, PhaseError) as e:
        nvml = None
        print(f"[moe-serve] NVML energy: not measured ({e})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cut = DepthCut(serve_mod)
    for arch in MOE_ARCHS:
        print(f"[moe-serve] {cut.describe(arch)}")
    with cut, EngineCalls(InferenceEngine, {"B1": kda}) as calls:
        kda.launches = 0
        e0 = nvml.millijoules() if nvml else None
        t0 = time.perf_counter()
        out = serve_mod.serve(MOE_ARCHS, n_queries=SERVE_QUERIES, zeta=0.5,
                              char_max_tokens=MOE_CHAR_MAX_TOKENS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        e1 = nvml.millijoules() if nvml else None
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

    for prof in out["profiles"]:
        print(f"[moe-serve] {prof.name}: energy R2={prof.energy.r_squared} "
              f"runtime R2={prof.runtime.r_squared}")
        check(math.isfinite(prof.energy.r_squared) and math.isfinite(prof.runtime.r_squared),
              f"{prof.name}: fit is not finite")
    for arch, t in out["totals"].items():
        print(f"[moe-serve] {arch}: queries={t['queries']} tokens={t['tokens']} "
              f"measured_s={t['runtime_s']} host-model_J={t['energy_j']}")
    print(f"[moe-serve] serve() wall s={wall} (characterized up to {MOE_CHAR_MAX_TOKENS} tokens)")
    if nvml:
        print(f"[moe-serve] NVML J over serve() (characterize + serve)={(e1 - e0) / 1e3}")
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
    launches over those decodes must be 0).  mixtral's 8-layer bf16
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


def characterize_with_frontends(serve_mod, arch):
    """`serve_mod.characterize_fleet`'s campaign for one encdec or vlm model:
    KV off, batch 2, up to ENCDEC_VLM_CHAR_MAX_TOKENS, each (τin, τout)'s
    first call left out, through `measure_fn` (zero frames or patches)."""
    from repro_torch.core.characterize import fit_profile_from_trials, run_campaign
    from repro_torch.serving.engine import measure_fn
    engine = serve_mod.build_engine(arch, kv_cache=False, device="cuda")
    measure = measure_fn(lambda: engine, 2, engine.cfg.vocab_size)
    warmed = set()

    def warm_measure(tin, tout):
        if (tin, tout) not in warmed:
            warmed.add((tin, tout))
            measure(tin, tout)
        return measure(tin, tout)

    trials = run_campaign(arch, warm_measure,
                          serve_mod.campaign_settings(ENCDEC_VLM_CHAR_MAX_TOKENS))
    return fit_profile_from_trials(arch, serve_mod.accuracy_ak(arch), trials)


def serve_with_frontends(torch, serve_mod, archs, *, seed=0) -> dict:
    """`serve_mod.serve` for models whose prefill also takes frames or
    patches: characterize, fit, route SERVE_QUERIES Alpaca-like queries at
    zeta 0.5, and serve each model's batches (batch 4, KV on) with seeded
    random frames/patches.  Returns {"plan", "totals", "profiles"}."""
    import numpy as np
    from repro_torch.data import alpaca_like_workload, token_batches
    from repro_torch.data.workloads import WorkloadSpec
    from repro_torch.serving import EnergyAwareRouter
    from repro_torch.serving.requests import Request

    profiles = []
    for arch in archs:
        profiles.append(characterize_with_frontends(serve_mod, arch))
        gc.collect()
        torch.cuda.empty_cache()
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
    return {"plan": plan, "totals": totals, "profiles": profiles}


def run_encdec_vlm_serve(torch, kda, serve_mod) -> dict:
    """serve_with_frontends over ENCDEC_VLM_ARCHS, then one KV-on generate
    of each outside the router.  Every engine call's B1 launches must be
    `b1_per_call`'s.  Returns arch -> B1's launches in its engines' calls."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.serving import InferenceEngine
    try:
        nvml = Nvml()
    except (OSError, PhaseError) as e:
        nvml = None
        print(f"[encdec-vlm] NVML energy: not measured ({e})")
    for arch in ENCDEC_VLM_ARCHS:
        cfg = get_config(arch)
        layers = (f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers over "
                  f"{cfg.n_frames} frames" if cfg.family == "encdec"
                  else f"{cfg.n_layers} layers, {cfg.n_patches} patches")
        print(f"[encdec-vlm] {arch}: d_model {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads} x {cfg.head_dim_}, {layers}, "
              f"{get_api(cfg).count_params(cfg) / 1e9:.3f} B parameters ({cfg.param_dtype})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with EngineCalls(InferenceEngine, {"B1": kda}) as calls:
        kda.launches = 0
        e0 = nvml.millijoules() if nvml else None
        t0 = time.perf_counter()
        out = serve_with_frontends(torch, serve_mod, ENCDEC_VLM_ARCHS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        e1 = nvml.millijoules() if nvml else None
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

    for prof in out["profiles"]:
        print(f"[encdec-vlm] {prof.name}: energy R2={prof.energy.r_squared} "
              f"runtime R2={prof.runtime.r_squared}")
        check(math.isfinite(prof.energy.r_squared) and math.isfinite(prof.runtime.r_squared),
              f"{prof.name}: fit is not finite")
    for arch, t in out["totals"].items():
        print(f"[encdec-vlm] {arch}: queries={t['queries']} batches={t['batches']} "
              f"tokens={t['tokens']} measured_s={t['runtime_s']} host-model_J={t['energy_j']}")
    print(f"[encdec-vlm] serve wall s={wall} (characterize + fit + route + serve; "
          f"characterized up to {ENCDEC_VLM_CHAR_MAX_TOKENS} tokens)")
    if nvml:
        print(f"[encdec-vlm] NVML J over the serve wall={(e1 - e0) / 1e3}")
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
        want = b1_per_call(get_config(arch), kind)
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


def check_cost_batch(torch, kcb) -> dict:
    """B2 against its plain version for every family branch and both decode
    modes at m = 1,000,037: f32 within rtol 1e-5 (the reference's gate for
    the TPU kernel), f64 within 1e-12.  Returns dtype -> worst max_abs_err."""
    from repro_torch.configs import get_config
    worst = collections.defaultdict(float)
    misses = []
    for i, arch in enumerate(COST_ARCHS):
        cfg = get_config(arch)
        for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            nt, ctx, bt = cost_inputs(torch, 1_000_037, dtype, seed=i)
            name = str(dtype).removeprefix("torch.")
            for decode in (False, True):
                ours = kcb.pass_surface(cfg, nt, ctx, bt, decode=decode)
                plain = kcb.pass_surface_plain(cfg, nt, ctx, bt, decode=decode)
                err = max((a - b).abs().max().item() for a, b in zip(ours, plain))
                rel = max(((a - b).abs() / b.abs()).max().item() for a, b in zip(ours, plain))
                same = all(torch.equal(a, b) for a, b in zip(ours, plain))
                worst[name] = max(worst[name], err)
                label = f"{arch} {name} decode={decode}"
                print(f"[check] B2 {label}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
                      f"bit-identical={same} rtol={rtol:g} {'ok' if rel <= rtol else 'MISS'}")
                if not rel <= rtol:
                    misses.append(label)
    torch.cuda.synchronize()
    check(not misses, f"B2 disagrees with its plain version: {misses}")
    return dict(worst)


def cost_ops_per_query(cfg, decode) -> int:
    """Products, sums and minima B2 does for one query of this config,
    counted from the kernel's branches."""
    clamp = cfg.local_window if cfg.family == "hybrid" else cfg.window
    ops = 2 + bool(clamp)                       # tokens, 2 N tokens, clamp
    ops += 4 if cfg.family == "ssm" else 7 + 7 * (cfg.family == "encdec")
    ops += 4 * (cfg.family == "moe") + (6 if cfg.family == "moe" else 1) + 4
    return ops + (3 + 2 * (cfg.family == "ssm") if decode else 0)


def time_cost_batch(torch, kcb) -> dict:
    """B2 at m = 1,000,000 (llama2-70b, decode probe), f32 and f64, beside
    its plain version and the bound for 3 arrays read and 2 written.  No
    single PyTorch call computes the surface: no library time."""
    from repro_torch.configs import get_config
    cfg = get_config("llama2-70b")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    m = 1_000_000
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        nt, ctx, bt = cost_inputs(torch, m, dtype, seed=11)
        t = {"ms": time_ms(torch, lambda: kcb.pass_surface(cfg, nt, ctx, bt, decode=True), flush),
             "plain_ms": time_ms(torch, lambda: kcb.pass_surface_plain(cfg, nt, ctx, bt,
                                                                        decode=True), flush),
             "library_ms": None}
        size = 4 if dtype == torch.float32 else 8
        t_bytes = 5 * m * size / HBM_BYTES_PER_S
        t_ops = cost_ops_per_query(cfg, True) * m / PEAK_OPS[name]
        t["bound_ms"] = max(t_bytes, t_ops) * 1e3
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        t["shape"] = f"m={m} {name} llama2-70b decode=True"
        print(f"[time] B2 {name} ({t['shape']}): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.1%} of bound")
        out[f"B2 {name}"] = t
    return out


def synthetic_queries(m):
    """benchmarks/perf_suite.py's synthetic (τin, τout) draws."""
    import numpy as np
    rng = np.random.default_rng(m)
    return rng.integers(1, 4096, m), rng.integers(1, 4096, m)


def time_simulate_batch(torch, kcb) -> None:
    """simulate_batch over 10^6 synthetic queries: wall time and queries/s
    (host clock, numpy in and out), the device's busy share of it and B2's
    share of that (profiler)."""
    from repro_torch.configs import PAPER_ZOO
    from repro_torch.energy import AnalyticLLMSimulator
    tin, tout = synthetic_queries(SYNTHETIC_QUERIES)
    for kv in (True, False):
        sim = AnalyticLLMSimulator(PAPER_ZOO["llama2-7b"], batch=ANALYTIC_BATCH, kv_cache=kv,
                                   noise_sigma=0.0)
        wall_ms, events, why = _profile(torch, lambda: kcb.simulate_batch(sim, tin, tout), 3)
        label = f"simulate_batch llama2-7b KV-{'on' if kv else 'off'} m={len(tin)}"
        print(f"[time] {label}: {wall_ms:.2f} ms per call, {len(tin) / wall_ms * 1e3:.4g} "
              f"queries/s (host clock, numpy in and out)")
        _breakdown(label, wall_ms, events, why, 3, ("cost_batch_kernel",), "B2")


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
    from repro_torch.serving import OnlineRouter, Request
    try:
        nvml = Nvml()
    except (OSError, PhaseError) as e:
        nvml = None
        print(f"[cluster] NVML energy: not measured ({e})")
    gc.collect()
    torch.cuda.empty_cache()
    engines = {a: serve_mod.build_engine(a, kv_cache=True, device="cuda")
               for a in SERVE_ARCHS}
    router = OnlineRouter(card_profiles, policy=ZetaOnlinePolicy(), zeta=0.5)
    queries = alpaca_like_workload(WorkloadSpec(n_queries=SERVE_QUERIES,
                                                **serve_mod.SERVE_WORKLOAD))
    split = collections.Counter()
    expected = 0
    torch.cuda.synchronize()
    kda.launches = 0
    e0 = nvml.millijoules() if nvml else None
    t0 = time.perf_counter()
    for i, (tin, tout) in enumerate(queries):
        req = Request(i, np.zeros(tin, np.int32), tout)
        model = router.route_one(req)
        eng = engines[model]
        batch = next(token_batches([(tin, tout)], 1, eng.cfg.vocab_size, seed=i))
        gen, _ = eng.generate({"tokens": batch["tokens"]}, tout)
        check(gen.shape == (1, tout), f"request {i}: generate returned {gen.shape}")
        router.complete(req)
        split[model] += 1
        expected += eng.cfg.n_layers * tout
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kda.launches
    e1 = nvml.millijoules() if nvml else None
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[cluster] online router: {sum(split.values())} of {SERVE_QUERIES} routed and "
          f"served, split={dict(split)}, wall s={wall}")
    if nvml:
        print(f"[cluster] online router: NVML J over route + serve={(e1 - e0) / 1e3}")
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


def _map(tree, fn):
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import cost_batch as kcb
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import rglru_scan as krg
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.launch import serve as serve_mod

    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")

    t0 = time.perf_counter()
    reports = _build.build()
    print(f"[build] {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    shapes = decode_shapes(torch, serve_mod)
    errs = check_decode(torch, kda, shapes)
    scan_errs = check_scans(torch, kss, krg)
    cost_errs = check_cost_batch(torch, kcb)
    timing = time_decode(torch, kda, shapes)
    timing.update(time_scans(torch, kss, krg))
    timing.update(time_cost_batch(torch, kcb))
    time_simulate_batch(torch, kcb)
    t0 = time.perf_counter()
    analytic_launches = run_analytic(torch, kcb)
    print(f"[phase] analytic path s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    launches, card_profiles = run_serve(torch, kda, serve_mod)
    fp8_launches = check_outputs(torch, kda, serve_mod)
    print(f"[phase] llama2 path (serve + outputs) s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    scan_launches = run_scan_serve(torch, {"B3": kss, "B4": krg, "B1": kda}, serve_mod)
    check_scan_outputs(torch, serve_mod)
    print(f"[phase] mamba2 + recurrentgemma path (serve + outputs) s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    moe_launches = run_moe_serve(torch, kda, serve_mod)
    check_moe_outputs(torch, kda, serve_mod)
    print(f"[phase] MoE path (serve + outputs) s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    ev_launches = run_encdec_vlm_serve(torch, kda, serve_mod)
    check_encdec_vlm_outputs(torch, kda, serve_mod)
    print(f"[phase] encdec + vlm path (serve + outputs) s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    run_cluster(torch, kda, serve_mod, card_profiles)
    print(f"[phase] cluster (fig4, bench_cluster, card-fitted profiles, online router) "
          f"s={time.perf_counter() - t0}")

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
        entry("pass_costs (B2, analytic pass-cost surface)", "cost_batch.cu",
              "src/repro/kernels/cost_batch.py:347", analytic_launches,
              cost_errs["float64"], "B2 float64"),
        entry("ssd_scan (B3, Mamba-2 SSD chunk scan)", "ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:73", scan_launches["B3"],
              scan_errs["B3 bfloat16"], "B3 characterize"),
        entry("rglru_scan (B4, RG-LRU linear recurrence)", "rglru_scan.cu",
              "src/repro/kernels/rglru_scan.py:53", scan_launches["B4"],
              scan_errs["B4 float32"], "B4 characterize"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
