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

Compiled steps.  The reference jits `prefill` (static `cache_len`,
`long_context`) and the decode step plus sampler (cache donated), so each
call runs one program compiled for its shapes.  Here each such program is
a `repro_torch.graphs.Step`, keyed as XLA keys its programs:
the input tensors' shapes and dtypes, plus `cache_len` and `long_context`
for a prefill.  A step's body reads static buffers that each call first
copies its inputs into.  On
CUDA the body is captured once into a `torch.cuda.CUDAGraph` (an eager
warm-up on the engine's side stream first, which also loads the kernels'
modules and sizes B1's workspace) and every call replays it; all graphs
of an engine share one memory pool and replay one at a time.  `generate`
knows every shape it runs before it runs, so it captures what is missing
before the meter's window opens (the reference warms up to keep XLA's
compiles out of the measured energy).  On the CPU the body runs eagerly
each call.  A failed capture or replay raises: there is no eager fallback
on CUDA.

The KV-on cache is the engine's own static buffers (one set per cache
shape): the prefill's step copies the cache it builds into them, and the
decode step writes them in place (the reference's donation), its
`pos + 1` copied into the static `pos` and its token into the static
token buffer.  A KV-off step keeps only the logits: the cache its prefill
builds is freed when its capture ends, and that memory is reused by the
engine's other graphs.
An optional meter (repro_torch.energy.meter) wraps each phase and returns
joules; GenStats feeds the characterization campaign directly.  A meter
that meters whole calls (`per_call`: NVML's counter, which steps too
seldom to meter one step) wraps the whole generate instead, and the
phases are only timed.  Such a window's error is a fixed number of
joules, too large a share of a short call's: with `min_window_s` the
engine repeats a call inside its one window until the repeats have
lasted that long, and reports one call's mean seconds and joules.  The
vlm and encdec families also take the stubbed frontends' embeddings
("patches", "frames") in the batch; they go to the device once a call.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device, shard
from repro_torch.energy.meter import block_until_ready
from repro_torch.graphs import (COUNTERS, Step, capture, copy_into, pool_bytes, signature,
                                tensors, warm_up)
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
    call_energy_j: float | None = None      # a per-call meter's window / repeats
    repeats: int = 1                        # the calls that window held

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


# The launch counts a replay adds to (B1, B3 and B4; the backward counts
# stay 0 in serving).  The graph parts live in `repro_torch.graphs`, shared
# with the training step; the engine's tests import them by these names.
KERNELS = COUNTERS
_tensors, _Step = tensors, Step


def _static_cache(caches: dict, cache):
    """The static cache of `cache`'s shapes in `caches`, `cache` copied into
    it; the first of its shapes (made eagerly: the warm-up on CUDA, the
    first call on the CPU) becomes it."""
    sig = signature(cache)
    static = caches.get(sig)
    if static is None:
        if cache.pos.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a static cache would be made inside a capture")
        static = caches[sig] = cache
    else:
        copy_into(static, cache)
    return static


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
        min_window_s: float = 0.0,
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
        self.min_window_s = min_window_s
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps: dict[tuple, Step] = {}     # key -> program, as jit's cache
        self._buffers: dict[tuple, torch.Tensor] = {}   # static inputs by (name, shape, dtype)
        self._caches: dict[tuple, Any] = {}     # static KV-on caches by signature
        self.capture_s = 0.0                    # warm-ups and captures, all graphs
        self.capture_launches = {m.__name__: 0 for m in KERNELS}   # the warm-ups'
        # Graphs exist only on CUDA; the CPU runs each step's body eagerly.
        # A comparison may set it False on a CUDA engine to run the same
        # steps eagerly there (chip_smoke.py, the gpu tests).
        self.graphed = self.device.type == "cuda"
        if self.graphed:
            if any(shard.is_dtensor(p) for p in _leaves(params)):
                raise NotImplementedError(
                    "InferenceEngine captures its steps into CUDA graphs, and steps over "
                    "DTensor params are not captured; drive sharded models through "
                    "the model API (models.get_api) instead")
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    # ------------------------------------------------------------------
    def _pad_len(self, n: int) -> int:
        return max(self.bucket, int(math.ceil(n / self.bucket)) * self.bucket)

    def _extra_inputs(self, batch: dict) -> dict:
        """The stubbed frontends' inputs ("patches", "frames") on the device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()
                if k in ("patches", "frames")}

    def _cache_len(self, S0: int, max_new: int) -> int:
        return self._pad_len(prefix_positions(self.cfg) + S0 + max_new)

    def _prefill(self, inputs: dict, cache_len: int):
        """The reference's jitted prefill: (logits, the static cache) KV-on,
        (logits, None) KV-off."""
        return self._step(self._prefill_key(inputs, cache_len),
                          lambda: self._prefill_step(inputs, cache_len))({"batch": inputs})

    def _decode(self, cache, token: torch.Tensor):
        """The reference's jitted decode step and sampler: (next token, the
        cache), both the engine's static buffers."""
        return self._step(self._decode_key(cache, token),
                          lambda: self._decode_step(cache, token))(
            {"cache": cache, "token": token})[:2]

    def _prefill_key(self, inputs: dict, cache_len: int) -> tuple:
        return ("prefill", signature(inputs), cache_len, self.long_context)

    def _decode_key(self, cache, token: torch.Tensor) -> tuple:
        return ("decode", signature(cache), signature(token))

    def _step(self, key: tuple, make: Callable[[], Step]) -> Step:
        """The step of `key`.  The CPU makes it at its first call; CUDA
        only replays what `_prepare` captured."""
        step = self.steps.get(key)
        if step is None:
            if self.graphed:
                raise RuntimeError(f"no CUDA graph was captured for {key}: generate "
                                   f"captures every step it runs before it runs")
            step = self.steps[key] = make()
        return step

    def _buffer(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The engine's static input buffer of `like`'s name, shape and dtype
        (one per engine: graphs replay one at a time, each after its copy)."""
        key = (name, tuple(like.shape), like.dtype)
        if key not in self._buffers:
            self._buffers[key] = torch.zeros(like.shape, dtype=like.dtype, device=self.device)
        return self._buffers[key]

    # The step bodies close over the engine's parts, never the engine: an
    # engine in a reference cycle would keep its weights and graphs on the
    # card after its last use, until the garbage collector ran.
    def _prefill_step(self, inputs: dict, cache_len: int) -> Step:
        static = {k: self._buffer(k, v) for k, v in inputs.items()}
        api, cfg, params, kv_cache, caches = (self.api, self.cfg, self.params,
                                              self.kv_cache, self._caches)
        kw = dict(cache_len=cache_len, long_context=self.long_context)

        def body():
            logits, cache = api.prefill(cfg, params, static, **kw)
            return logits, (_static_cache(caches, cache) if kv_cache else None)

        return Step(self._prefill_key(inputs, cache_len), {"batch": static}, body)

    def _decode_step(self, cache, token: torch.Tensor) -> Step:
        static = self._caches[signature(cache)]
        tok = self._buffer("token", token)
        api, cfg, params, sampler, generator = (self.api, self.cfg, self.params,
                                                self.sampler, self.generator)

        def body():
            logits, new = api.decode_step(cfg, params, static, {"token": tok})
            for f in dataclasses.fields(static):
                if f.name != "pos" and getattr(new, f.name) is not getattr(static, f.name):
                    raise RuntimeError(f"{cfg.family} decode_step returned a new "
                                       f"{f.name}: the static cache must be written in place")
            static.pos.copy_(new.pos)
            tok.copy_(sampler(logits, generator))
            return tok, static, logits

        return Step(self._decode_key(cache, token), {"cache": static, "token": tok}, body)

    # ------------------------------------------------------------------
    def _prepare(self, batch: dict, max_new: int) -> bool:
        """Capture the CUDA graphs this generate replays and the engine lacks:
        KV-on the prefill at (B, S0, cache_len) and the decode at the cache's
        shapes; KV-off one prefill per sequence length, longest first (so
        the pool's blocks, freed at the end of each capture, fit the next).
        Whether it captured any (ran work on the device)."""
        if not self.graphed:
            return False
        n = len(self.steps)
        spec = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in self._specs(batch).items()}
        B, S0 = spec["tokens"].shape
        if self.kv_cache:
            cache_len = self._cache_len(S0, max_new)
            key = self._prefill_key(spec, cache_len)
            if key not in self.steps:
                self._capture(self._prefill_step(spec, cache_len))
            cache = self.steps[key].outputs[1]
            token = torch.empty((B,), dtype=torch.int32, device="meta")
            if self._decode_key(cache, token) not in self.steps:
                self._capture(self._decode_step(cache, token))
        else:
            for L in range(S0 + max_new - 1, S0 - 1, -1):
                inputs = {**spec, "tokens": torch.empty((B, L), dtype=torch.int32,
                                                        device="meta")}
                lp = prefix_positions(self.cfg) + L
                if self._prefill_key(inputs, lp) not in self.steps:
                    self._capture(self._prefill_step(inputs, lp))
        return len(self.steps) != n

    def _specs(self, batch: dict) -> dict:
        """Shapes and dtypes of a generate's device inputs, as meta tensors'
        (nothing is copied)."""
        out = {"tokens": torch.empty(np.shape(batch["tokens"]), dtype=torch.int32,
                                     device="meta")}
        for k, v in batch.items():
            if k in ("patches", "frames"):
                dtype = (v.dtype if isinstance(v, torch.Tensor)
                         else torch.from_numpy(np.empty(0, np.asarray(v).dtype)).dtype)
                out[k] = torch.empty(tuple(v.shape), dtype=dtype, device="meta")
        return out

    def _capture(self, step: Step) -> None:
        """Capture `step` into a CUDA graph (`graphs.warm_up` on the engine's
        side stream, then `graphs.capture` on the same stream into the
        engine's pool).  Each replay adds the launches the capture recorded
        to the modules' counts.  The counts stay those of the engine's
        calls: the capture runs nothing on the device, and the warm-up's
        launches are tallied in `capture_launches` instead."""
        t0 = time.perf_counter()
        before = [m.launches for m in KERNELS]
        generators = ()
        if step.key[0] == "decode" and self.sampler.temperature > 0:
            if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
                raise RuntimeError("sampling at temperature > 0 draws from the engine's "
                                   "generator, which this torch cannot register with a "
                                   "CUDA graph")
            generators = (self.generator,)
        with torch.cuda.device(self.device):
            warm_up(step, self._stream)
            for m, b in zip(KERNELS, before):
                self.capture_launches[m.__name__] += m.launches - b
                m.launches = b
            capture(step, pool=self._pool, stream=self._stream, generators=generators)
        self.steps[step.key] = step
        self.capture_s += time.perf_counter() - t0

    def pool_bytes(self) -> int:
        """Device memory the engine's graph pool holds (reserved segments)."""
        return pool_bytes(self._pool) if self.graphed else 0

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, batch: dict, max_new_tokens: int) -> tuple[np.ndarray, GenStats]:
        """batch: {"tokens": [B, S0] int32, (+"patches"/"frames")}.
        Returns (generated [B, max_new_tokens] int32, stats)."""
        run = self._generate_cached if self.kv_cache else self._generate_uncached
        captured = self._prepare(batch, max_new_tokens)
        if self.step_meter is self.meter:
            return run(batch, max_new_tokens)
        if captured:
            self.meter.invalidate()
        runs = []

        def repeat():
            t0 = time.perf_counter()
            runs.append(run(batch, max_new_tokens))
            while time.perf_counter() - t0 < self.min_window_s:
                runs.append(run(batch, max_new_tokens))
            return runs[-1]

        (out, stats), _, joules = self.meter.measure(repeat)
        n = len(runs)
        stats.prefill_s = sum(st.prefill_s for _, st in runs) / n
        stats.decode_s = sum(st.decode_s for _, st in runs) / n
        stats.call_energy_j = joules / n
        stats.repeats = n
        return out, stats

    def _generate_cached(self, batch, max_new):
        tokens = torch.as_tensor(np.asarray(batch["tokens"], np.int32), device=self.device)
        B, S0 = tokens.shape
        inputs = {"tokens": tokens, **self._extra_inputs(batch)}
        cache_len = self._cache_len(S0, max_new)

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
            (logits, _), dt, de = self.step_meter.measure(
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
