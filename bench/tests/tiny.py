"""Tiny cells for the CPU tests: the benchmark's configurations at a few
dozen widths (bfloat16, as served), the same traffic generator over short
buckets, and a sliding window short enough that the ring wraps."""

from __future__ import annotations

import copy

from bench.spec import Cell

DENSE = {
    "name": "tiny-dense", "family": "dense", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "sliding_window": 24,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "vocab_size": 256,
}
MOE = {**DENSE, "name": "tiny-moe", "family": "moe", "sliding_window": None,
       "rope_theta": 1e6, "num_local_experts": 4, "num_experts_per_tok": 2}
TRAFFIC = {
    "prompt": {"log_mean": 2.4, "log_sigma": 0.6, "min": 4, "max": 16, "buckets": [8, 16]},
    "output": {"log_mean": 2.2, "log_sigma": 0.6, "min": 2, "max": 16, "buckets": [8, 16]},
    "pairing_seed": 0,
}
CELL = {"batch": 4, "job_requests": 12}
# Readings over 33 seeds, program (largest) against float8 control
# (smallest): dense widest gap 0.0326 vs 0.0869; MoE mean gap 0.0007 vs
# 0.0020 (its widest, 0.0181 vs 0.0394, separates less at this size).
LIMITS = {"dense": {"widest_gap": 0.06}, "moe": {"mean_gap": 0.0013}}


def cell(config: dict = DENSE, sample: int = 4, **over) -> Cell:
    c = copy.deepcopy(CELL)
    c["check"] = {"sample_requests": sample, "limits": dict(LIMITS[config["family"]])}
    c.update(over)
    return Cell(name=f"{config['name']}.tiny", chips=1, config=dict(config),
                traffic=copy.deepcopy(TRAFFIC), cell=c)
