#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. device   the card's name and count, and `nvidia-smi`'s name and power limit;
  2. build    every CUDA kernel from src/repro_torch/kernels/csrc, with the
              compiler's register/shared-memory report;
  3. check    each kernel against its plain PyTorch version on the card, at
              the main path's shapes (f32 within 1e-4, bf16 within 2e-2);
  4. timing   each kernel, its plain version and a library call (CUDA events,
              L2 flushed between launches), beside the bound for its bytes;
  5. serve    the paper's serve path through `repro_torch.launch.serve.serve`
              at the full width of llama2-7b and llama2-13b (random bf16
              weights drawn on the card): characterize with the KV cache off,
              fit, route 24 queries, serve with the KV cache on.  Kernel B1's
              launch count over that run must equal the decode work done;
  6. outputs  a reduced model on the card (through the kernels) against the
              same model on the CPU (plain versions), and finite full-width
              decode logits that agree with a full re-forward; then the
              device's busy share of a full-width decode step (profiler).

Exits nonzero, printing no result, without a CUDA device, without the
port's sources beside it, or when any phase fails.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # CUDA-core f32, bf16 tensor
SERVE_ARCHS = ["llama2-7b", "llama2-13b"]
SERVE_QUERIES = 24


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


def decode_shapes(torch, serve_mod):
    s_serve = max(serve_mod.SERVE_BUCKET, math.ceil(
        (serve_mod.SERVE_WORKLOAD["max_in"] + serve_mod.SERVE_WORKLOAD["max_out"])
        / serve_mod.SERVE_BUCKET) * serve_mod.SERVE_BUCKET)
    return {   # name -> (B, Hq, Hkv, D, S, dtype)
        "llama2-7b serve": (4, 32, 32, 128, s_serve, torch.bfloat16),
        "llama2-13b serve": (4, 40, 40, 128, s_serve, torch.bfloat16),
        "llama2-70b GQA": (4, 64, 8, 128, 4096, torch.bfloat16),
        "reduced": (2, 4, 2, 32, s_serve, torch.float32),
    }


def decode_inputs(torch, shape, seed):
    B, Hq, Hkv, D, S, dtype = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    return q, k, v


def check_decode(torch, kda, shapes) -> dict:
    """B1 against its plain version: pos 0/mid/S-1, ring full and not,
    softcap, and keys beyond pos set to +-1e4.  Returns name -> max error."""
    errs = {}
    misses = []
    for i, (name, shape) in enumerate(shapes.items()):
        S, dtype = shape[4], shape[5]
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
            ok = bool(((a - b).abs() <= tol + tol * b.abs()).all())
            worst = max(worst, err)
            print(f"[check] B1 {name} {label}: max_abs_err={err:.3e} tol={tol:g} "
                  f"{'ok' if ok else 'MISS'}")
            if not ok:
                misses.append(f"{name} {label}")
        pos = S // 2
        k2, v2 = k.clone(), v.clone()
        k2[:, pos + 1:] = 1e4
        v2[:, pos + 1:] = -1e4
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        clean = kda.decode_attention(q, k, v, p)
        dirty = kda.decode_attention(q, k2, v2, p)
        plain = kda.decode_attention_plain(q, k2, v2, p)
        diff = (dirty.float() - plain.float()).abs()
        err = diff.max().item()
        ok = torch.equal(clean, dirty) and bool((diff <= tol + tol * plain.float().abs()).all())
        worst = max(worst, err)
        print(f"[check] B1 {name} garbage tail: bit-identical={torch.equal(clean, dirty)} "
              f"max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'MISS'}")
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


def decode_bound(shape, pos, dtype_name) -> tuple[float, str]:
    """Least time for one call: K/V rows up to pos read once, q read, out
    written, against the card's memory rate; or its multiply-adds against
    the peak rate for the input type, whichever is larger."""
    B, Hq, Hkv, D, S, _ = shape
    size = 4 if dtype_name == "float32" else 2
    n_valid = min(pos + 1, S)
    bytes_ = 2 * B * n_valid * Hkv * D * size + 2 * B * Hq * D * size + 4
    ops = 4 * B * Hq * n_valid * D
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_decode(torch, kda, shapes) -> dict:
    import torch.nn.functional as F
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for i, (name, shape) in enumerate(shapes.items()):
        B, Hq, Hkv, D, S, dtype = shape
        q, k, v = decode_inputs(torch, shape, seed=100 + i)
        pos = S - 1
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        # yardstick: one library call over the same cache, same mask
        q4, k4, v4 = q[:, :, None], k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        mask = (torch.arange(S, device="cuda") <= pos)[None, None, None]
        if Hq != Hkv:
            k4, v4 = k4.repeat_interleave(Hq // Hkv, 1), v4.repeat_interleave(Hq // Hkv, 1)
        dtype_name = str(dtype).removeprefix("torch.")
        t = {
            "ms": time_ms(torch, lambda: kda.decode_attention(q, k, v, p), flush),
            "plain_ms": time_ms(torch, lambda: kda.decode_attention_plain(q, k, v, p), flush),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask), flush),
        }
        t["bound_ms"], t["bound_by"] = decode_bound(shape, pos, dtype_name)
        t["shape"] = f"B={B} Hq={Hq} Hkv={Hkv} D={D} S={S} pos={pos} {dtype_name}"
        print(f"[time] B1 {name} ({t['shape']}): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of bound")
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# Main path and output checks
# ---------------------------------------------------------------------------


def expected_decode_launches(serve_mod, out) -> int:
    """Layers x max_new summed over the served batches, batched as `serve`
    batches them; the KV-off characterization never decodes."""
    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    n = 0
    for arch, reqs in out["plan"].per_model.items():
        if not reqs:
            continue
        cfg = get_config(arch)
        qs = [(r.tau_in, r.max_new_tokens) for r in reqs]
        for b in token_batches(qs, 4, cfg.vocab_size):
            n += cfg.n_layers * int(b["tau_out"].max())
    return n


def run_serve(torch, kda, serve_mod) -> int:
    try:
        nvml = Nvml()
    except (OSError, PhaseError) as e:
        nvml = None
        print(f"[serve] NVML energy: not measured ({e})")
    torch.cuda.reset_peak_memory_stats()
    kda.launches = 0
    e0 = nvml.millijoules() if nvml else None
    t0 = time.perf_counter()
    out = serve_mod.serve(SERVE_ARCHS, n_queries=SERVE_QUERIES, zeta=0.5, device="cuda")
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
    return launches


def check_outputs(torch, serve_mod) -> None:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.serving import InferenceEngine

    # reduced f32: card (through B1) against CPU (plain), same weights
    cfg = get_config("llama2-7b-reduced")
    api = get_api(cfg)
    cpu = api.init_params(cfg, torch.Generator().manual_seed(1), torch.device("cpu"))
    gpu = _map(cpu, lambda t: t.to("cuda"))
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    a, _ = InferenceEngine(cfg, gpu, kv_cache=True, device="cuda").generate({"tokens": toks}, 8)
    b, _ = InferenceEngine(cfg, cpu, kv_cache=False, device="cpu").generate({"tokens": toks}, 8)
    print(f"[outputs] reduced greedy tokens, card KV-on vs CPU KV-off: identical={np.array_equal(a, b)}")
    check(np.array_equal(a, b), "reduced greedy tokens differ between card and CPU")
    worst = 0.0
    with torch.no_grad():
        lg, cg = api.prefill(cfg, gpu, {"tokens": torch.as_tensor(toks, device="cuda")}, cache_len=32)
        lc, cc = api.prefill(cfg, cpu, {"tokens": torch.as_tensor(toks)}, cache_len=32)
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        for t in range(4):
            tok = torch.as_tensor(a[:, t])
            lg, cg = api.decode_step(cfg, gpu, cg, {"token": tok.to("cuda")})
            lc, cc = api.decode_step(cfg, cpu, cc, {"token": tok})
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
    print(f"[outputs] reduced logits, card vs CPU: max_abs_err={worst:.3e} tol=1e-4")
    check(worst <= 1e-4, "reduced logits differ between card and CPU")

    # full width: decode logits finite and close to a full re-forward
    eng = serve_mod.build_engine("llama2-7b", kv_cache=True, device="cuda")
    cfg, api = eng.cfg, eng.api
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (4, 16)).astype(np.int32), device="cuda")
    with torch.no_grad():
        _, cache = api.prefill(cfg, eng.params, {"tokens": toks[:, :12]}, cache_len=48)
        for t in range(12, 16):
            logits, cache = api.decode_step(cfg, eng.params, cache, {"token": toks[:, t]})
        full, _ = api.prefill(cfg, eng.params, {"tokens": toks}, cache_len=16)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all())
    rel = ((logits - full).norm() / full.norm()).item()
    print(f"[outputs] {cfg.name} decode logits {tuple(logits.shape)} finite={finite}; "
          f"relative L2 difference from a full re-forward={rel:.4f} (tol 0.1)")
    check(finite and tuple(logits.shape) == (4, cfg.vocab_size), "full-width logits bad")
    # bf16 rounds at other points in the two paths, through 32 layers
    check(rel <= 0.1, "full-width decode disagrees with the re-forward")
    decode_breakdown(torch, api, cfg, eng.params, cache, toks[:, 15])


def decode_breakdown(torch, api, cfg, params, cache, token, steps=8) -> None:
    """Wall time of a full-width decode step (unprofiled) against the
    device's busy time in it (torch.profiler: the sum of the kernels'
    device time), and the kernels that take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(steps):
            _, cache = api.decode_step(cfg, params, cache, {"token": token})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    _, cache = api.decode_step(cfg, params, cache, {"token": token})
                torch.cuda.synchronize()
            # kernels only: an operator's row repeats its kernels' device time
            events = [e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA
                      and e.self_device_time_total > 0]
        except (RuntimeError, AssertionError) as e:   # reporting only: no tracer
            events, why = [], str(e)
        else:
            why = "the profiler saw no device time"
    if not events:
        print(f"[profile] {cfg.name} decode step: wall {wall_ms:.3f} ms; device busy "
              f"share not measured ({why})")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    print(f"[profile] {cfg.name} decode step, B={token.shape[0]}: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    b1_ms = sum(e.self_device_time_total for e in events
                if "decode_split_kernel" in e.key or "decode_combine_kernel" in e.key) / 1e3 / steps
    print(f"[profile]   B1 (split + combine kernels): {b1_ms:.4f} ms/step, "
          f"{b1_ms / busy_ms:.3f} of device busy time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
              f"x{e.count // steps} {e.key[:90]}")


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
    from repro_torch.kernels import decode_attention as kda
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
    timing = time_decode(torch, kda, shapes)
    launches = run_serve(torch, kda, serve_mod)
    check_outputs(torch, serve_mod)

    main_shape = "llama2-7b serve"
    kernels = [dict(
        name="decode_attention (B1, flash-decode GQA)", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:72",
        launches=launches, max_abs_err=errs[main_shape],
        **{k: timing[main_shape][k] for k in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")})]
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
