"""The step functions: the train step and the serving pair.

Port of `repro.launch.steps`.  train_step: the family's `train_loss`,
gradients accumulated over microbatches of `cfg.microbatch` in
`cfg.grad_accum_dtype` and divided by their count (the reference's
`lax.scan`), then the optimizer's update, in place.  prefill_step /
serve_step: the serving pair.  `compile_train_step` is the port of the
reference trainer's `jax.jit(train_step, donate_argnums=(0, 1))`: one
program per input signature, a CUDA graph on the card.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch import graphs, resolve_device, shard
from repro_torch.checkpoint import flatten_tree, unflatten_tree
from repro_torch.models import get_api
from repro_torch.models.common import ModelConfig
from repro_torch.optim import Optimizer, get_optimizer


def value_and_grad(loss_fn: Callable, params: dict, batch: dict):
    """(loss, grads): loss_fn(params, batch)'s value, detached, and its
    gradient with respect to every leaf of params (zeros for a leaf the
    loss does not reach), as a tree shaped like params."""
    leaves = flatten_tree(params)
    tensors = [t for _, t in leaves]
    for t in tensors:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    finally:
        for t in tensors:
            t.requires_grad_(False)
    return loss.detach(), unflatten_tree({
        path: (torch.zeros_like(t) if g is None else g)
        for (path, t), g in zip(leaves, grads)})


def build_train_step(cfg: ModelConfig, *, lr: float = 1e-4,
                     param_pspecs=None) -> tuple[Callable, Optimizer]:
    """Returns (train_step(params, opt_state, batch) -> (loss, params,
    opt_state), optimizer).  The batch is a dict of tensors on the
    params' device; its leading axis is split into microbatches of
    cfg.microbatch when that is smaller.  params and opt_state are
    updated in place and returned.

    param_pspecs (optional): the spec tree params were laid out by (their
    leaves are DTensors) — each gradient is redistributed to its
    parameter's placements before it is accumulated, so grads stay
    FSDP-sharded (a reduce-scatter) instead of being all-reduced
    replicated, and the accumulator keeps those placements across
    microbatches."""
    api = get_api(cfg)
    opt = get_optimizer(cfg.optimizer)
    accum_dtype = getattr(torch, cfg.grad_accum_dtype)

    def loss_fn(p, mb):
        loss, _ = api.train_loss(cfg, p, mb)
        return loss

    def train_step(params, opt_state, batch):
        leaves = dict(flatten_tree(params))

        def constrain(path, g):
            return g if param_pspecs is None else shard.redistribute_like(g, leaves[path])

        B = batch["tokens"].shape[0]
        mb_size = cfg.microbatch or B
        if mb_size >= B:
            loss, grads = value_and_grad(loss_fn, params, batch)
            grads = unflatten_tree({path: constrain(path, g)
                                    for path, g in flatten_tree(grads)})
        else:
            if B % mb_size:
                raise ValueError(f"batch {B} is not a multiple of microbatch {mb_size}")
            n = B // mb_size
            acc = {path: torch.zeros_like(t, dtype=accum_dtype)
                   for path, t in flatten_tree(params)}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(n):
                mb = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
                mb_loss, g = value_and_grad(loss_fn, params, mb)
                for path, gg in flatten_tree(g):
                    acc[path] += constrain(path, gg).to(accum_dtype)
                loss = loss + mb_loss
                del g
            grads = unflatten_tree({path: a.div_(n) for path, a in acc.items()})
            loss = loss / n
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return loss, params, opt_state

    return train_step, opt


class CompiledTrainStep:
    """`train_step(params, opt_state, batch) -> (loss, params, opt_state)`
    as `jax.jit(train_step, donate_argnums=(0, 1))` runs it: one program
    (`graphs.Step`) per signature of the three inputs (each tensor's path,
    shape and dtype; `steps` holds them, as jit's cache), `lr` and `cfg`
    static in `train_step`.

    Donation: the first call's params and opt_state trees become the
    programs' static buffers (no copy); a later call that passes other
    trees of the same signature (a loaded checkpoint) has them copied in.
    Each batch is copied into a static batch buffer.  Every call returns
    the static trees, updated in place, and the loss.

    On CUDA (`graphed`) a program's first call runs one real step eagerly
    on a side stream (`graphs.warm_up`: its results are the call's), frees
    the warm-up's cached blocks (so they and the graph's pool are not both
    held), and captures the step into a CUDA graph in the compiled step's
    own pool; every later call replays it and returns the loss copied out
    of the pool.  Replays add the launches the capture recorded, forward
    and backward, to the kernel modules' counts; the warm-up's stay
    counted as its step's.  The CPU runs the step eagerly each call, as
    does a CUDA step built with `graphed=False` (for comparisons; nothing
    picks that by itself).  A failed capture or replay raises, and so do
    DTensor params on CUDA: sharded steps run through `build_train_step`.

    The programs close over `train_step` and the static buffers, never
    over the compiled step, so dropping it frees its graphs and pool."""

    def __init__(self, train_step: Callable, *, device: str | torch.device = "cuda",
                 graphed: bool | None = None):
        self.device = resolve_device(device)
        if graphed is None:
            graphed = self.device.type == "cuda"
        if graphed and self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.train_step = train_step
        self.graphed = graphed
        self.steps: dict[tuple, graphs.Step] = {}    # key -> program, as jit's cache
        self._trees: dict[tuple, dict] = {}         # params and opt_state statics by signature
        self._batches: dict[tuple, dict] = {}       # static batches by signature
        self.warmup_s = 0.0                         # the warm-ups (real steps), all programs
        self.capture_s = 0.0                        # the captures, all programs
        if graphed:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def __call__(self, params: dict, opt_state: dict, batch: dict):
        inputs = {"params": params, "opt_state": opt_state, "batch": batch}
        step = self.steps.get(graphs.signature(inputs))
        if step is None:
            return self._first(inputs)
        loss, params, opt_state = step(inputs)
        return (loss.clone() if step.graph is not None else loss), params, opt_state

    def _first(self, inputs: dict):
        """A new signature's call: its program made (and on CUDA warmed up
        and captured), and its step run."""
        trees = {k: inputs[k] for k in ("params", "opt_state")}
        for name, t in graphs.tensors(inputs):
            if t.device.type != self.device.type:
                raise ValueError(f"{name} lives on {t.device}, the step on {self.device}")
        if self.graphed and any(shard.is_dtensor(t) for _, t in graphs.tensors(trees)):
            raise NotImplementedError(
                "compile_train_step captures its steps into CUDA graphs, and steps over "
                "DTensor params are not captured; run sharded steps through "
                "build_train_step")
        tsig, bsig = graphs.signature(trees), graphs.signature(inputs["batch"])
        if tsig not in self._trees:
            self._trees[tsig] = trees                # donated: they become the statics
        if bsig not in self._batches:
            self._batches[bsig] = {k: torch.empty_like(v) for k, v in inputs["batch"].items()}
        static = {**self._trees[tsig], "batch": self._batches[bsig]}
        step = graphs.Step(graphs.signature(inputs), static,
                           _train_body(self.train_step, static))
        if not self.graphed:
            self.steps[step.key] = step
            return step(inputs)
        for k, v in inputs.items():
            graphs.copy_into(static[k], v)
        loss = self._warm_up(step)
        torch.cuda.empty_cache()
        self._capture(step)
        self.steps[step.key] = step
        return loss, static["params"], static["opt_state"]

    def _warm_up(self, step: graphs.Step) -> torch.Tensor:
        """One real step, eagerly on the side stream; its loss, copied onto
        the current stream."""
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            loss = graphs.warm_up(step, self._stream)[0].clone()
            torch.cuda.synchronize(self.device)
        self.warmup_s += time.perf_counter() - t0
        return loss

    def _capture(self, step: graphs.Step) -> None:
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            graphs.capture(step, pool=self._pool, stream=self._stream)
        self.capture_s += time.perf_counter() - t0

    def pool_bytes(self) -> int:
        """Device memory the compiled step's graph pool holds."""
        return graphs.pool_bytes(self._pool) if self.graphed else 0


def _train_body(train_step: Callable, static: dict) -> Callable:
    """The program's body: `train_step` over the static buffers, which it
    must update in place."""
    params, opt_state, batch = static["params"], static["opt_state"], static["batch"]

    def body():
        loss, p, s = train_step(params, opt_state, batch)
        for got, want in ((p, params), (s, opt_state)):
            if any(a is not b for (_, a), (_, b) in zip(graphs.tensors(got),
                                                         graphs.tensors(want), strict=True)):
                raise RuntimeError("the train step returned new parameter or optimizer "
                                   "tensors: a compiled step updates them in place")
        return loss, params, opt_state

    return body


def compile_train_step(train_step: Callable, *, device: str | torch.device = "cuda",
                       graphed: bool | None = None) -> CompiledTrainStep:
    """The port of `jax.jit(train_step, donate_argnums=(0, 1))`: see
    `CompiledTrainStep`.  `graphed=False` runs the same steps eagerly on
    the card, for comparisons."""
    return CompiledTrainStep(train_step, device=device, graphed=graphed)


def build_prefill_step(cfg: ModelConfig, *, cache_len: int,
                       long_context: bool = False) -> Callable:
    api = get_api(cfg)

    def prefill_step(params, inputs):
        return api.prefill(cfg, params, inputs, cache_len=cache_len,
                           long_context=long_context)

    return prefill_step


def build_serve_step(cfg: ModelConfig) -> Callable:
    """ONE new token against the cache."""
    api = get_api(cfg)

    def serve_step(params, cache, inputs):
        return api.decode_step(cfg, params, cache, inputs)

    return serve_step
