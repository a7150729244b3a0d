"""Operations and bytes of the work the benchmark counts, from shapes alone.

`request_flops` is the model work one request needs, served unpadded: its
τin prompt tokens and τout − 1 fed-back output tokens through every layer
(the last output token is never fed back), the LM head at the τout
positions whose logits pick a token, and attention over each token's own
context (the window's keys at most).  Matmuls count 2 FLOPs a
multiply-add over the active parameters: the routed experts' top-k, not
the experts an implementation runs besides; the embedding lookup counts
none.  What the program computes for padding is not useful work.

`b1_call` counts one call of the decode-attention kernel B1: K and V of
the attended positions, q read and the output written, each once.
"""

from __future__ import annotations

from bench import peaks
from bench.spec import Spec

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def layer_params(s: Spec) -> int:
    """Active matmul parameters of one layer, a token."""
    d, hd = s.d_model, s.head_dim
    attn = d * s.n_heads * hd + 2 * d * s.n_kv_heads * hd + s.n_heads * hd * d
    if s.moe:
        return attn + d * s.n_experts + s.top_k * 3 * d * s.d_ff
    return attn + 3 * d * s.d_ff


def context_sum(n: int, window: int) -> int:
    """sum over positions p < n of the keys position p attends: p + 1, at
    most `window` (0: no window)."""
    if not window or n <= window:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def request_flops(s: Spec, tau_in: int, tau_out: int) -> int:
    """Model FLOPs of one request served unpadded."""
    n = tau_in + tau_out - 1
    layers = 2 * layer_params(s) * n * s.n_layers
    head = 2 * s.d_model * s.vocab_size * tau_out
    attn = 4 * s.n_heads * s.head_dim * context_sum(n, s.window) * s.n_layers
    return layers + head + attn


def b1_call(s: Spec, batch: int, keys: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one B1 call over `keys` attended positions."""
    item = ITEMSIZE[s.dtype]
    kv = 2 * batch * keys * s.n_kv_heads * s.head_dim * item
    q_out = 2 * batch * s.n_heads * s.head_dim * item
    return 4 * batch * s.n_heads * s.head_dim * keys, kv + q_out


def b1_least_s(flops: int, nbytes: int) -> float:
    """The least time the H100 takes for a call: the larger of its
    operations over the bf16 peak and its bytes over HBM's."""
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)


def b1_batch(s: Spec, batch: int, prompt: int, steps: int) -> tuple[int, float]:
    """(calls, least seconds) of B1 over a generate's `steps` decode steps
    after a `prompt`-token prefill: one call a layer a step, step t
    attending positions 0 .. prompt + t (the window's keys at most)."""
    least = 0.0
    for t in range(steps):
        keys = prompt + t + 1
        if s.window:
            keys = min(keys, s.window)
        least += b1_least_s(*b1_call(s, batch, keys)) * s.n_layers
    return steps * s.n_layers, least
