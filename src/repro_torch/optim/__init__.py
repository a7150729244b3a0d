"""In-house optimizers: AdamW, Adafactor and SGD with momentum.

Port of `repro.optim`:

    opt = get_optimizer(name)
    state = opt.init(params)
    params, state = opt.update(grads, state, params, lr)

The reference's hyperparameters, f32 state and state keys (AdamW `m`,
`v`, `step`; Adafactor `f` with per-leaf `vr`/`vc` or `v`, and `step`;
SGD `m`), so an optimizer state moves between the packages through a
checkpoint.  Each update works in f32 and casts back to the parameter's
dtype.  `update` writes the parameters and the state in place, under
`torch.no_grad()`, and returns the same trees: the card holds one copy of
each, as the reference's donated buffers do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state)


def _map(fn, tree: dict, *rest: dict) -> dict:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    return {k: (_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros shaped like p (laid out as p is, when p is a DTensor)."""
    return torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)


def _step0(params: dict) -> torch.Tensor:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """x as an f32 scalar on like's device, filled there: no host-to-device
    copy, which a CUDA graph capture of the update would refuse."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


# Where the reference computes a*b + c, XLA contracts it to one fused
# multiply-add (one rounding).  `torch.addcmul(c, a, b)` does the same on
# the CPU and on CUDA, so the state matches the reference's where the two
# terms cancel; a separate multiply and add would round twice.


def _adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        return {"m": _map(_f32_zeros, params), "v": _map(_f32_zeros, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"].add_(1)
        t = step.float()
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        b1_, b2_, wd_, neg_lr = (_scalar(x, t) for x in (b1, b2, weight_decay, -lr))

        def upd(g, m, v, p):
            gf = g.float()          # g itself when g is f32: never written
            torch.addcmul(gf * (1 - b1), m, b1_, out=m)
            torch.addcmul(gf.mul(1 - b2).mul_(gf), v, b2_, out=v)
            delta = (m / c1).div_((v / c2).sqrt_().add_(eps))
            delta.addcmul_(p.float(), wd_)
            p.copy_(torch.addcmul(p.float(), delta, neg_lr))

        _map(upd, grads, state["m"], state["v"], params)
        return params, state

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ---------------------------------------------------------------------------


def _adafactor(decay=0.8, eps=1e-30, clip=1.0) -> Optimizer:
    def init(params):
        def leaf(p):
            if p.dim() >= 2:
                return {"vr": _f32_zeros(p[..., 0]), "vc": _f32_zeros(p[..., 0, :])}
            return {"v": _f32_zeros(p)}
        return {"f": _map(leaf, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"].add_(1)
        beta = 1.0 - torch.pow(step.float() + 1.0, -decay)
        eps_, tiny, neg_lr = (_scalar(x, beta) for x in (eps, 1e-12, -lr))

        def upd(g, s, p):
            gf = g.float()
            g2 = torch.addcmul(eps_, gf, gf)
            if p.dim() >= 2:
                vr = torch.addcmul((1 - beta) * g2.mean(dim=-1), s["vr"], beta, out=s["vr"])
                vc = torch.addcmul((1 - beta) * g2.mean(dim=-2), s["vc"], beta, out=s["vc"])
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = gf / torch.addcmul(tiny, torch.sqrt(r)[..., None],
                                       torch.sqrt(vc)[..., None, :])
            else:
                v = torch.addcmul((1 - beta) * g2, s["v"], beta, out=s["v"])
                u = gf / (torch.sqrt(v) + 1e-12)
            norm = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(norm / clip, min=1.0)
            p.copy_(torch.addcmul(p.float(), u, neg_lr))

        for g, s, p in _zip_leaves(grads, state["f"], params):
            upd(g, s, p)
        return params, state

    return Optimizer("adafactor", init, update)


def _zip_leaves(grads: dict, state: dict, params: dict):
    """(grad, state dict, param) for every param leaf: Adafactor's state
    holds a dict where the params hold a tensor."""
    for k, g in grads.items():
        if isinstance(g, dict):
            yield from _zip_leaves(g, state[k], params[k])
        else:
            yield g, state[k], params[k]


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------


def _sgd(momentum=0.9) -> Optimizer:
    def init(params):
        return {"m": _map(_f32_zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        def upd(g, m, p):
            torch.addcmul(g.float(), m, _scalar(momentum, m), out=m)
            p.copy_(torch.addcmul(p.float(), m, _scalar(-lr, m)))

        _map(upd, grads, state["m"], params)
        return params, state

    return Optimizer("sgd", init, update)


_REGISTRY = {
    "adamw": _adamw,
    "adafactor": _adafactor,
    "sgd": _sgd,
}


def get_optimizer(name: str, **kw) -> Optimizer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}")
    return _REGISTRY[name](**kw)
