"""The step functions: the train step and the serving pair.

Port of `repro.launch.steps`.  train_step: the family's `train_loss`,
gradients accumulated over microbatches of `cfg.microbatch` in
`cfg.grad_accum_dtype` and divided by their count (the reference's
`lax.scan`), then the optimizer's update, in place.  prefill_step /
serve_step: the serving pair.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import shard
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
