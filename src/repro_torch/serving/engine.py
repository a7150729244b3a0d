"""Batched inference engine: prefill + decode with explicit KV-cache control.

Port of `repro.serving.engine`.  Two modes, both first-class because the
paper *measures* with KV caching disabled (§3, §5.1) while production
serving uses it:

  * kv_cache=True  — prefill once, then one decode_step per token, which
    writes the cache in place and attends through kernel B1 on CUDA.
  * kv_cache=False — the paper's measurement mode: every generated token
    re-runs the full forward pass over the exact growing sequence
    (runtime superlinear in τout — the source of the τin·τout interaction
    term in Eq. 6/7).

The engine runs on `device` ("cuda" unless the caller asks for "cpu") and
raises when that device is missing; the params must already be there.
An optional meter (repro_torch.energy.meter) wraps each phase and returns
joules; GenStats feeds the characterization campaign directly.  A meter
that meters whole calls (`per_call`: NVML's counter, which steps too
seldom to meter one step) wraps the whole generate instead, and the
phases are only timed.  The vlm and encdec families also take the
stubbed frontends' embeddings ("patches", "frames") in the batch; they
go to the device once a call.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.energy.meter import block_until_ready
from repro_torch.models import get_api
from repro_torch.models.common import ModelConfig
from repro_torch.models.vlm import VISION_DIM
from repro_torch.serving.sampler import Sampler


@dataclasses.dataclass
class GenStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_energy_j: float = 0.0
    decode_energy_j: float = 0.0
    tau_in: int = 0
    tau_out: int = 0
    call_energy_j: float | None = None      # a per-call meter's window

    @property
    def runtime_s(self) -> float:
        return self.prefill_s + self.decode_s

    @property
    def energy_j(self) -> float:
        if self.call_energy_j is not None:
            return self.call_energy_j
        return self.prefill_energy_j + self.decode_energy_j

    @property
    def tokens_per_s(self) -> float:
        return self.tau_out / self.decode_s if self.decode_s > 0 else float("inf")


class _NullMeter:
    """Measures wall time only; energy reported as 0."""

    def measure(self, fn):
        t0 = time.perf_counter()
        out = block_until_ready(fn())
        return out, time.perf_counter() - t0, 0.0


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        kv_cache: bool = True,
        sampler: Sampler = Sampler(),
        bucket: int = 32,
        long_context: bool = False,
        meter: Any = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        wrong = {str(p.device) for p in _leaves(params) if p.device.type != self.device.type}
        if wrong:
            raise ValueError(f"params live on {sorted(wrong)}, engine on {self.device}")
        # f32 configs compute in f32 on the card, not in TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.params = params
        self.api = get_api(cfg)
        self.kv_cache = kv_cache
        self.sampler = sampler
        self.bucket = bucket
        self.long_context = long_context
        self.meter = meter or _NullMeter()
        self.step_meter = _NullMeter() if getattr(meter, "per_call", False) else self.meter
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def _pad_len(self, n: int) -> int:
        return max(self.bucket, int(math.ceil(n / self.bucket)) * self.bucket)

    def _extra_inputs(self, batch: dict) -> dict:
        """The stubbed frontends' inputs ("patches", "frames") on the device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()
                if k in ("patches", "frames")}

    def _prefill(self, inputs: dict, cache_len: int):
        return self.api.prefill(self.cfg, self.params, inputs,
                                cache_len=cache_len, long_context=self.long_context)

    def _decode(self, cache, token: torch.Tensor):
        logits, cache = self.api.decode_step(self.cfg, self.params, cache,
                                             {"token": token})
        return self.sampler(logits, self.generator), cache

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, batch: dict, max_new_tokens: int) -> tuple[np.ndarray, GenStats]:
        """batch: {"tokens": [B, S0] int32, (+"patches"/"frames")}.
        Returns (generated [B, max_new_tokens] int32, stats)."""
        run = self._generate_cached if self.kv_cache else self._generate_uncached
        if self.step_meter is self.meter:
            return run(batch, max_new_tokens)
        (out, stats), _, joules = self.meter.measure(lambda: run(batch, max_new_tokens))
        stats.call_energy_j = joules
        return out, stats

    def _generate_cached(self, batch, max_new):
        tokens = torch.as_tensor(np.asarray(batch["tokens"], np.int32), device=self.device)
        B, S0 = tokens.shape
        inputs = {"tokens": tokens, **self._extra_inputs(batch)}
        cache_len = self._pad_len(prefix_positions(self.cfg) + S0 + max_new)

        (logits, cache), t_prefill, e_prefill = self.step_meter.measure(
            lambda: self._prefill(inputs, cache_len))

        stats = GenStats(prefill_s=t_prefill, prefill_energy_j=e_prefill,
                         tau_in=S0, tau_out=max_new)
        out = np.zeros((B, max_new), np.int32)
        token = self.sampler(logits, self.generator)

        t0 = time.perf_counter()
        e_total = 0.0
        for t in range(max_new):
            out[:, t] = token.cpu().numpy()
            (token, cache), dt, de = self.step_meter.measure(
                lambda tok=token, c=cache: self._decode(c, tok))
            e_total += de
        stats.decode_s = time.perf_counter() - t0
        stats.decode_energy_j = e_total
        return out, stats

    def _generate_uncached(self, batch, max_new):
        tokens = np.asarray(batch["tokens"], np.int32)
        B, S0 = tokens.shape
        extra = self._extra_inputs(batch)
        # The cache is sized as the KV-on path sizes it: a vlm prefix of L
        # tokens fills n_patches + L positions.  (The reference passes
        # cache_len = L, which its vlm prefill cannot pad to.)
        n_prefix = prefix_positions(self.cfg)
        buf = np.zeros((B, S0 + max_new), np.int32)
        buf[:, :S0] = tokens

        stats = GenStats(tau_in=S0, tau_out=max_new)
        out = np.zeros((B, max_new), np.int32)
        e_total = 0.0
        t_start = time.perf_counter()
        first_step_s = None
        for t in range(max_new):
            L = S0 + t
            inputs = {"tokens": torch.as_tensor(buf[:, :L], device=self.device), **extra}
            # full re-forward over the exact prefix — the paper's mode
            (logits, _cache), dt, de = self.step_meter.measure(
                lambda i=inputs, lp=n_prefix + L: self._prefill(i, lp))
            e_total += de
            if first_step_s is None:
                first_step_s = dt
            token = self.sampler(logits, self.generator).cpu().numpy()
            out[:, t] = token
            buf[:, L] = token
        total = time.perf_counter() - t_start
        # attribute the first full-prefix pass as "prefill", rest as decode
        stats.prefill_s = first_step_s or 0.0
        stats.decode_s = total - stats.prefill_s
        stats.prefill_energy_j = 0.0
        stats.decode_energy_j = e_total
        return out, stats


def prefix_positions(cfg: ModelConfig) -> int:
    """Cache positions ahead of the tokens: the vlm's patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def frontend_inputs(cfg: ModelConfig, batch_size: int) -> dict:
    """Zero embeddings from the stubbed frontends, f32, as the reference's
    `measure_fn` supplies them: "patches" for vlm, "frames" for encdec."""
    if cfg.family == "vlm":
        return {"patches": np.zeros((batch_size, cfg.n_patches, VISION_DIM), np.float32)}
    if cfg.family == "encdec":
        return {"frames": np.zeros((batch_size, cfg.n_frames, cfg.d_model), np.float32)}
    return {}


def measure_fn(engine_factory: Callable[[], InferenceEngine], batch_size: int,
               vocab_size: int, *, seed: int = 0):
    """Adapter: (tau_in, tau_out) -> (energy_j, runtime_s), the callback the
    characterization campaign (repro_torch.core.characterize) consumes.
    Runs a real generation of the requested shape on the engine."""
    engine = engine_factory()
    rng = np.random.default_rng(seed)

    def measure(tau_in: int, tau_out: int) -> tuple[float, float]:
        toks = rng.integers(1, vocab_size, size=(batch_size, tau_in), dtype=np.int64)
        batch = {"tokens": toks.astype(np.int32), **frontend_inputs(engine.cfg, batch_size)}
        _, stats = engine.generate(batch, tau_out)
        return stats.energy_j, stats.runtime_s

    return measure
