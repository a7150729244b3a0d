"""Token samplers for the decode loop.

Port of `repro.serving.sampler`.  Sampling draws from a `torch.Generator`,
so its tokens are not expected to match the reference's `jax.random`
draws; greedy decoding matches exactly."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Sampler:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => no truncation

    def __call__(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """logits [B, V] -> token ids [B] int32."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = logits / self.temperature
        if self.top_k:
            kth = torch.topk(scaled, self.top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, -torch.inf, scaled)
        probs = torch.softmax(scaled.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
