"""Seeded weights in the port's parameter layout, made on the device.

The tree is the one `repro_torch` serves from (the reference package's
paths: layer-stacked leaves `[L, ...]`, norm gains stored as offsets from
1), written out here from the configuration so that the reference reads
it without importing the port.  Every leaf is drawn in the served type
from one `torch.Generator` on the device, one call a leaf, in sorted path
order, and scaled so that every sublayer moves the residual stream: unit
embeddings, fan-in scaled projections, query and key scaled so that
attention scores spread with a standard deviation near 3 (attention picks
keys rather than averaging a long context), and norm offsets N(0, 0.1).
The experts' down-projection is scaled besides by 1 / sqrt(2 L), the
residual scaling of the reference package's own init: a routing decision
that rounding tips (a near-tie of the k-th and the next expert) swaps a
whole expert's output, and at full size that jump, spread by peaked
attention through the later positions, made a bfloat16 run read as far
from float32 as a float8 one (PERF.md).
"""

from __future__ import annotations

import math

import torch

from bench.spec import Spec

QK_GAIN = 1.7          # q and k entries ~ N(0, 1.7^2): scores' std ~ 1.7^2
NORM_STD = 0.1


def layout(s: Spec) -> dict[str, tuple[tuple[int, ...], float]]:
    """path -> (shape, standard deviation) of every leaf."""
    L, d, hq, hkv, hd, f = s.n_layers, s.d_model, s.n_heads, s.n_kv_heads, s.head_dim, s.d_ff
    vp = -(-s.vocab_size // 128) * 128        # rows padded to 128, as the port pads
    blk = "blocks/moe_blocks" if s.moe else "blocks"
    qk = QK_GAIN / math.sqrt(d)
    out = {
        "embed": ((vp, d), 1.0),
        "head": ((d, vp), 1.0 / math.sqrt(d)),
        "final_norm/w": ((d,), NORM_STD),
        f"{blk}/attn/wq": ((L, d, hq, hd), qk),
        f"{blk}/attn/wk": ((L, d, hkv, hd), qk),
        f"{blk}/attn/wv": ((L, d, hkv, hd), 1.0 / math.sqrt(d)),
        f"{blk}/attn/wo": ((L, hq, hd, d), 1.0 / math.sqrt(hq * hd)),
        f"{blk}/ln_attn/w": ((L, d), NORM_STD),
        f"{blk}/ln_mlp/w": ((L, d), NORM_STD),
    }
    if s.moe:
        E = s.n_experts
        out.update({
            f"{blk}/moe/router": ((L, d, E), 1.0 / math.sqrt(d)),
            f"{blk}/moe/w_gate": ((L, E, d, f), 1.0 / math.sqrt(d)),
            f"{blk}/moe/w_up": ((L, E, d, f), 1.0 / math.sqrt(d)),
            f"{blk}/moe/w_down": ((L, E, f, d), 1.0 / math.sqrt(f * 2 * L)),
        })
    else:
        out.update({
            f"{blk}/mlp/w_gate": ((L, d, f), 1.0 / math.sqrt(d)),
            f"{blk}/mlp/w_up": ((L, d, f), 1.0 / math.sqrt(d)),
            f"{blk}/mlp/w_down": ((L, f, d), 1.0 / math.sqrt(f)),
        })
    return dict(sorted(out.items()))


def _set(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def leaves(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], path)
        else:
            yield path, tree[k]


def make(s: Spec, seed: int, device) -> dict:
    """The weight tree of `s` drawn from `seed` on `device`."""
    tree: dict = {}
    for path, (shape, _) in layout(s).items():
        _set(tree, path, torch.empty(shape, dtype=getattr(torch, s.dtype), device=device))
    fill(s, tree, seed)
    return tree


def fill(s: Spec, tree: dict, seed: int) -> None:
    """Draw `tree`'s leaves anew from `seed`, in place (what a captured
    CUDA graph reads stays where it is)."""
    dev = next(leaves(tree))[1].device
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    shapes = layout(s)
    for path, t in leaves(tree):
        t.normal_(0.0, shapes[path][1], generator=gen)
