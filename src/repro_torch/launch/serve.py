"""Serving entry point: the paper's system end-to-end, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet llama2-7b,llama2-13b \
        --queries 24 --zeta 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve --fleet mamba2-130m,recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --fleet mixtral-8x7b-reduced,granite-moe-3b-a800m-reduced --device cpu

Port of `repro.launch.serve`:

1. Characterize each hosted model by REAL execution (KV cache disabled —
   the paper's measurement mode), each engine call metered: on CUDA by the
   card's NVML energy counter (`energy.meter.NvmlMeter`, one window a
   call, a short trial repeated inside its window for at least
   `TRIAL_WINDOW_S`), on the CPU by wall clock x the modeled host power.
2. Fit the per-model e_K / r_K workload models (Eq. 6/7).
3. Route an Alpaca-like workload with the offline scheduler at the given
   zeta and serve every batch through the real engines (KV cache ON — the
   production path, whose decode attention is kernel B1), reporting
   measured energy/runtime per model.

`serve()` takes the token-only families: dense (llama2, mistral), moe
(mixtral-8x7b, granite-moe-3b-a800m: B1 in every decode step;
deepseek-v3-671b's MLA attends in plain PyTorch), ssm (mamba2-130m, whose
prefill runs kernel B3) and hybrid (recurrentgemma-9b: kernel B4 in
prefill, B1 at head dim 256 in decode).  Like the reference's, it passes
tokens only, so an encdec (seamless-m4t-large-v2) or vlm (internvl2-2b)
fleet, whose prefill also needs the stubbed frontends' "frames" or
"patches", is driven through the engine instead: `InferenceEngine.generate`
with those inputs in the batch, and `serving.engine.measure_fn` (zero
embeddings) for characterization (`chip_smoke.py` phase 9 builds the same
characterize -> fit -> route -> serve pipeline that way).

Weights are random, drawn on the device from a seeded torch.Generator in
the config's dtype.  Runs on CUDA unless `device="cpu"` is passed.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import TABLE1, get_config
from repro_torch.core.characterize import (
    CampaignSettings,
    fit_profile_from_trials,
    run_campaign,
)
from repro_torch.data import alpaca_like_workload, token_batches
from repro_torch.data.workloads import WorkloadSpec
from repro_torch.energy.meter import NvmlMeter, WallClockMeter
from repro_torch.models import get_api
from repro_torch.serving import EnergyAwareRouter, InferenceEngine
from repro_torch.serving.engine import frontend_inputs
from repro_torch.serving.requests import Request

# the workload `serve` routes: Alpaca-like lengths, cut to a short run
SERVE_WORKLOAD = dict(max_in=48, max_out=32, in_log_mean=2.8, out_log_mean=2.5)
SERVE_BUCKET = 16
WARMUP_SEED = 1             # the warm-up's tokens; the campaign's rng is seeded 0
# A trial's NVML window lasts at least this long (the engine repeats a
# shorter trial inside it): the meter's error, ~2 J a window on an H100
# (the idle power's error over up to three counter steps of ~100 ms), is
# then under 5 % of a trial's joules down to ~110 W.
TRIAL_WINDOW_S = 0.4


def build_engine(arch: str, *, kv_cache: bool, seed: int = 0, min_window_s: float = 0.0,
                 device: str | torch.device = "cuda") -> InferenceEngine:
    """The engine of `arch` with seeded random weights, metered by the
    card's NVML counter on CUDA (each call's window at least
    `min_window_s` long) and by `WallClockMeter` on the CPU."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    meter = NvmlMeter(dev) if dev.type == "cuda" else WallClockMeter()
    return InferenceEngine(cfg, params, kv_cache=kv_cache, meter=meter,
                           min_window_s=min_window_s, bucket=SERVE_BUCKET, device=dev)


def campaign_settings(max_tokens: int) -> CampaignSettings:
    """The characterization grid: τin, τout in powers of two from 8 to
    `max_tokens`, 2 to 3 trials a point."""
    return CampaignSettings(
        vary_input_range=(8, max_tokens), vary_output_range=(8, max_tokens),
        grid_range=(8, max_tokens), max_trials=3, min_trials=2,
        ci_tolerance_s=0.5)


def accuracy_ak(arch: str) -> float:
    """A_K of Eq. 2: the paper's Table 1, else the config's own figure."""
    base = arch.replace("-reduced", "")
    return TABLE1.get(base, {"a_k": get_config(base).accuracy_ak})["a_k"]


def warm_up(engine: InferenceEngine, batch: int, max_tokens: int) -> None:
    """One KV-off generate from 8 tokens to 8 + 2 `max_tokens`: every
    sequence length a campaign up to `max_tokens` runs, run once before its
    first trial.  On CUDA it captures the engine's graph of each length
    (before its metered window), so the campaign's trials only replay them
    (the reference warms each (τin, τout) to keep XLA's compiles out of
    the measured energy).  Its tokens come from their own generator, so
    the campaign's draws stay the reference's."""
    toks = np.random.default_rng(WARMUP_SEED).integers(
        1, engine.cfg.vocab_size, (batch, 8)).astype(np.int32)
    engine.generate({"tokens": toks, **frontend_inputs(engine.cfg, batch)}, 2 * max_tokens)


def host_model(trials: list) -> list:
    """The same trials charged as `WallClockMeter` charges: the modeled
    host power x each trial's seconds."""
    power = WallClockMeter().power_w
    return [dataclasses.replace(t, energy_j=power * t.runtime_s) for t in trials]


def characterize(arch: str, *, batch: int = 2, max_tokens: int = 64,
                 device: str | torch.device = "cuda") -> list:
    """The KV-off campaign of one model up to `max_tokens`: its trials."""
    engine = build_engine(arch, kv_cache=False, min_window_s=TRIAL_WINDOW_S, device=device)
    warm_up(engine, batch, max_tokens)
    rng = np.random.default_rng(0)

    def measure(tin, tout):
        toks = rng.integers(1, engine.cfg.vocab_size, (batch, tin)).astype(np.int32)
        _, stats = engine.generate({"tokens": toks}, tout)
        return stats.energy_j, stats.runtime_s

    return run_campaign(arch, measure, campaign_settings(max_tokens))


def fit_and_report(arch: str, trials: list):
    """Eq. 6/7 fitted to the trials' metered joules and seconds; prints
    R² beside that of the host model's joules for the same trials."""
    a_k = accuracy_ak(arch)
    prof = fit_profile_from_trials(arch, a_k, trials)
    modeled = fit_profile_from_trials(arch, a_k, host_model(trials))
    print(f"{arch}: energy R2={prof.energy.r_squared:.3f} "
          f"runtime R2={prof.runtime.r_squared:.3f} "
          f"(host-model energy R2={modeled.energy.r_squared:.3f})")
    return prof


def characterize_fleet(archs: list[str], *, batch: int = 2, max_tokens: int = 64,
                       device: str | torch.device = "cuda") -> list:
    """Real-execution campaign -> fitted profiles.  One model's engine is
    alive at a time."""
    return [fit_and_report(arch, characterize(arch, batch=batch, max_tokens=max_tokens,
                                              device=device))
            for arch in archs]


def serve(archs: list[str], *, n_queries: int, zeta: float,
          batch_size: int = 4, char_max_tokens: int = 64,
          device: str | torch.device = "cuda") -> dict:
    """Characterize (τin, τout up to `char_max_tokens`), route and serve.
    Returns {"plan", "totals", "profiles", "trials"} (trials per arch)."""
    trials = {a: characterize(a, max_tokens=char_max_tokens, device=device) for a in archs}
    profiles = [fit_and_report(a, trials[a]) for a in archs]
    router = EnergyAwareRouter(profiles, zeta=zeta)

    spec = WorkloadSpec(n_queries=n_queries, **SERVE_WORKLOAD)
    queries = alpaca_like_workload(spec)
    reqs = [Request(i, np.zeros(q[0], np.int32), q[1])
            for i, q in enumerate(queries)]
    plan = router.route(reqs)

    engines = {a: build_engine(a, kv_cache=True, device=device) for a in archs}
    totals: dict = {}
    for arch, rs in plan.per_model.items():
        if not rs:
            continue
        eng = engines[arch]
        e_j = t_s = 0.0
        n_tok = n_batches = 0
        qs = [(r.tau_in, r.max_new_tokens) for r in rs]
        for b in token_batches(qs, batch_size, eng.cfg.vocab_size):
            max_new = int(b["tau_out"].max())
            _, stats = eng.generate({"tokens": b["tokens"]}, max_new)
            e_j += stats.energy_j
            t_s += stats.runtime_s
            n_tok += int(b["lengths"].sum()) + max_new * batch_size
            n_batches += 1
        totals[arch] = {"queries": len(rs), "energy_j": e_j,
                        "runtime_s": t_s, "tokens": n_tok, "batches": n_batches}
        print(f"{arch}: {len(rs)} queries, {e_j:.1f} J, {t_s:.1f}s measured")
    return {"plan": plan, "totals": totals, "profiles": profiles, "trials": trials}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--fleet", default="llama2-7b-reduced,llama2-70b-reduced")
    p.add_argument("--queries", type=int, default=24)
    p.add_argument("--zeta", type=float, default=0.5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = serve(args.fleet.split(","), n_queries=args.queries, zeta=args.zeta,
                device=args.device)
    total_e = sum(t["energy_j"] for t in out["totals"].values())
    print(f"TOTAL measured energy: {total_e:.1f} J "
          f"(objective={out['plan'].assignment.objective:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
