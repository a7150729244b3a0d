"""The paper's own 7-model fleet (Table 1) with leaderboard accuracy A_K.

Port copy of `repro.configs.paper_zoo`: the same configs, field for field.

| LLM (params)   | vRAM (GB) | # A100s | A_K (%) |
|----------------|-----------|---------|---------|
| Falcon 7B      | 14.48     | 1       | 44.17   |
| Falcon 40B     | 83.66     | 3       | 58.07   |
| Llama-2 7B     | 13.48     | 1       | 50.97   |
| Llama-2 13B    | 26.03     | 1       | 55.69   |
| Llama-2 70B    | 137.98    | 4       | 64.52   |
| Mistral 7B     | 15.00     | 1       | 60.97   |
| Mixtral 8x7B   | 93.37     | 3       | 68.47   |
"""

from repro_torch.models.common import ModelConfig

# paper Table 1 metadata keyed by config name
TABLE1 = {
    "falcon-7b": {"vram_gb": 14.48, "n_a100": 1, "a_k": 44.17},
    "falcon-40b": {"vram_gb": 83.66, "n_a100": 3, "a_k": 58.07},
    "llama2-7b": {"vram_gb": 13.48, "n_a100": 1, "a_k": 50.97},
    "llama2-13b": {"vram_gb": 26.03, "n_a100": 1, "a_k": 55.69},
    "llama2-70b": {"vram_gb": 137.98, "n_a100": 4, "a_k": 64.52},
    "mistral-7b": {"vram_gb": 15.00, "n_a100": 1, "a_k": 60.97},
    "mixtral-8x7b": {"vram_gb": 93.37, "n_a100": 3, "a_k": 68.47},
}

# Falcon's MLP is 2 matrices of width 4d (8d^2 params); our SwiGLU block has
# 3 matrices (3*d*d_ff), so d_ff = 8d/3 keeps the parameter count (and hence
# weight traffic / FLOPs per token) faithful to the real model.
FALCON_7B = ModelConfig(
    name="falcon-7b", family="dense", n_layers=32, d_model=4544,
    n_heads=71, n_kv_heads=1, head_dim=64, d_ff=12096, vocab_size=65024,
    rope_theta=10000.0, param_dtype="bfloat16", accuracy_ak=44.17,
    source="tiiuae/falcon-7b", n_params_note="7B (MQA)")

FALCON_40B = ModelConfig(
    name="falcon-40b", family="dense", n_layers=60, d_model=8192,
    n_heads=128, n_kv_heads=8, head_dim=64, d_ff=21824, vocab_size=65024,
    rope_theta=10000.0, param_dtype="bfloat16", accuracy_ak=58.07,
    source="tiiuae/falcon-40b", n_params_note="40B (GQA)")

LLAMA2_7B = ModelConfig(
    name="llama2-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, head_dim=128, d_ff=11008, vocab_size=32000,
    rope_theta=10000.0, param_dtype="bfloat16", accuracy_ak=50.97,
    source="meta-llama/Llama-2-7b", n_params_note="7B (MHA)")

LLAMA2_13B = ModelConfig(
    name="llama2-13b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=40, head_dim=128, d_ff=13824, vocab_size=32000,
    rope_theta=10000.0, param_dtype="bfloat16", accuracy_ak=55.69,
    source="meta-llama/Llama-2-13b", n_params_note="13B (MHA)")

LLAMA2_70B = ModelConfig(
    name="llama2-70b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672, vocab_size=32000,
    rope_theta=10000.0, param_dtype="bfloat16", accuracy_ak=64.52,
    source="meta-llama/Llama-2-70b", n_params_note="70B (GQA)")

MISTRAL_7B = ModelConfig(
    name="mistral-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=32000,
    window=4096, rope_theta=10000.0, param_dtype="bfloat16",
    accuracy_ak=60.97, source="mistralai/Mistral-7B-v0.1",
    n_params_note="7B (SWA 4096)")

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2, capacity_factor=1.25, rope_theta=10000.0,
    param_dtype="bfloat16", accuracy_ak=68.47,
    source="mistralai/Mixtral-8x7B-v0.1", n_params_note="47B total, 13B active")

PAPER_ZOO = {
    c.name: c for c in [
        FALCON_7B, FALCON_40B, LLAMA2_7B, LLAMA2_13B, LLAMA2_70B,
        MISTRAL_7B, MIXTRAL_8X7B,
    ]
}

# the three-model case study of §6.3
CASE_STUDY_MODELS = ("llama2-7b", "llama2-13b", "llama2-70b")
CASE_STUDY_GAMMA = (0.05, 0.2, 0.75)
