"""The plain reference: Mistral's and Mixtral's forward pass in float32.

Written from the published description (Mistral 7B, arXiv:2310.06825;
Mixtral of Experts, arXiv:2401.04088; the `MistralForCausalLM` and
`MixtralForCausalLM` configs): pre-norm decoder blocks, RMSNorm, rotary
embeddings (rotate-half form), grouped-query causal attention within the
sliding window, a SwiGLU MLP, or for Mixtral a router whose softmax's top
k experts' SwiGLU outputs are summed with the top-k probabilities
renormalized.  No cache, no kernels, no batching: each sequence is run
whole, layer by layer (one layer's weights widened to float32 at a time,
so that Mixtral's 16 layers fit beside the served ones), attention in
blocks of query rows.  TF32 is off.

Departures, each of layout and not of mathematics: the weights are the
port's tree (`bench.weights`), so the norm gains are read as 1 + the
stored offset, and the vocabulary's rows are padded to a multiple of 128
(the logits keep the first `vocab_size` columns).

`fp8=True` is the correctness check's control: the same pass with both
operands of every weight product (projections, MLP, experts, router and
LM head) rounded to float8 e4m3, weights scaled per output column and
activations per row, then multiplied in float32; attention's scores and
softmax stay float32.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

from bench.spec import Spec

E4M3_MAX = 448.0
Q_BLOCK = 512              # query rows an attention block takes


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along `dim` (amax to 448)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    def __init__(self, s: Spec, tree: dict, *, fp8: bool = False):
        self.s, self.tree, self.fp8 = s, tree, fp8
        self.blocks = tree["blocks"]["moe_blocks"] if s.moe else tree["blocks"]

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [n, k] @ w [k, m], both float32."""
        if self.fp8:
            return fp8_round(x, -1) @ fp8_round(w, 0)
        return x @ w

    def rmsnorm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.s.rms_eps) * (1.0 + w)

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x [n, H, D] at positions 0 .. n - 1."""
        n, _, D = x.shape
        inv = 1.0 / (self.s.rope_theta ** (torch.arange(0, D, 2, device=x.device,
                                                        dtype=torch.float32) / D))
        ang = torch.arange(n, device=x.device, dtype=torch.float32)[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :D // 2], x[..., D // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        s = self.s
        n, d = x.shape
        G = s.n_heads // s.n_kv_heads
        q = self.rope(self.mm(x, w["wq"].reshape(d, -1)).reshape(n, s.n_heads, s.head_dim))
        k = self.rope(self.mm(x, w["wk"].reshape(d, -1)).reshape(n, s.n_kv_heads, s.head_dim))
        v = self.mm(x, w["wv"].reshape(d, -1)).reshape(n, s.n_kv_heads, s.head_dim)
        q = q.reshape(n, s.n_kv_heads, G, s.head_dim)
        kpos = torch.arange(n, device=x.device)
        out = []
        for i in range(0, n, Q_BLOCK):
            qpos = torch.arange(i, min(i + Q_BLOCK, n), device=x.device)
            sc = torch.einsum("qhgd,khd->hgqk", q[qpos], k) / s.head_dim ** 0.5
            mask = kpos[None, :] <= qpos[:, None]
            if s.window:
                mask &= kpos[None, :] > qpos[:, None] - s.window
            sc = sc.masked_fill(~mask, float("-inf"))
            out.append(torch.einsum("hgqk,khd->qhgd", torch.softmax(sc, dim=-1), v))
        o = torch.cat(out).reshape(n, s.n_heads * s.head_dim)
        return self.mm(o, w["wo"].reshape(-1, d))

    def swiglu(self, x, w_gate, w_up, w_down):
        return self.mm(torch.nn.functional.silu(self.mm(x, w_gate)) * self.mm(x, w_up), w_down)

    def moe(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        probs = torch.softmax(self.mm(x, w["router"]), dim=-1)
        top, idx = torch.topk(probs, self.s.top_k, dim=-1)
        gates = top / top.sum(-1, keepdim=True)
        y = torch.zeros_like(x)
        for e in range(self.s.n_experts):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel():
                h = self.swiglu(x[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e])
                y.index_add_(0, rows, gates[rows, slot, None] * h)
        return y

    def _layer(self, l: int) -> dict:
        b = self.blocks
        w = {k: b["attn"][k][l].float() for k in ("wq", "wk", "wv", "wo")}
        w["ln_attn"], w["ln_mlp"] = b["ln_attn"]["w"][l].float(), b["ln_mlp"]["w"][l].float()
        ffn = b["moe"] if self.s.moe else b["mlp"]
        w.update({k: v[l].float() for k, v in ffn.items()})
        return w

    @torch.no_grad()
    def logits(self, seqs: list[torch.Tensor], first: list[int]) -> list[torch.Tensor]:
        """Float32 logits [n_i - first_i, vocab] at positions first_i .. n_i - 1
        of each token sequence seqs[i] (1-d, on the weights' device)."""
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            emb = self.tree["embed"]
            hs = [emb[t.long()].float() for t in seqs]
            for l in range(self.s.n_layers):
                w = self._layer(l)
                for i, h in enumerate(hs):
                    h = h + self.attention(self.rmsnorm(h, w["ln_attn"]), w)
                    x = self.rmsnorm(h, w["ln_mlp"])
                    hs[i] = h + (self.moe(x, w) if self.s.moe
                                 else self.swiglu(x, w["w_gate"], w["w_up"], w["w_down"]))
                del w
            norm = self.tree["final_norm"]["w"].float()
            head = self.tree["head"][:, :self.s.vocab_size].float()
            return [self.mm(self.rmsnorm(h[f:], norm), head) for h, f in zip(hs, first)]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
