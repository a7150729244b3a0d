"""The plain reference held to the port at the port's reduced Mistral and
Mixtral (float32 on the CPU): a prefill, then decode steps through the
cache (Mistral's window ring wraps), logits at every scored position."""

import pytest
import torch

from bench import weights
from bench.reference import Reference, fp8_round
from bench.spec import Spec


def spec_of_port(cfg) -> Spec:
    return Spec(name=cfg.name, family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                d_ff=cfg.d_ff, vocab_size=cfg.vocab_size, window=cfg.window,
                rope_theta=cfg.rope_theta, rms_eps=cfg.rmsnorm_eps, dtype=cfg.param_dtype,
                n_experts=cfg.n_experts, top_k=cfg.top_k)


def port_logits(cfg, tree, toks, steps):
    """The port's prefill and `steps - 1` greedy decode steps: (logits
    [B, steps, V] at positions S0 - 1 .., the sequences fed)."""
    from repro_torch.models import get_api

    api = get_api(cfg)
    logits, cache = api.prefill(cfg, tree, {"tokens": toks}, cache_len=toks.shape[1] + steps)
    got, seq = [logits], [toks]
    for _ in range(steps - 1):
        tok = logits.argmax(-1).to(torch.int32)
        seq.append(tok[:, None])
        logits, cache = api.decode_step(cfg, tree, cache, {"token": tok})
        got.append(logits)
    return torch.stack(got, 1), torch.cat(seq, 1)


@pytest.mark.parametrize("arch", ["mistral-7b-reduced", "mixtral-8x7b-reduced"])
def test_reference_matches_the_port(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    s = spec_of_port(cfg)
    if s.window:
        assert s.window < 56 + 20              # the ring wraps during the decode
    tree = weights.make(s, 11, "cpu")
    toks = torch.randint(1, cfg.vocab_size, (2, 56), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    got, seq = port_logits(cfg, tree, toks, 20)
    ref = Reference(s, tree).logits(list(seq), [55, 55])
    for b in range(2):
        tol = 1e-4 * float(ref[b].abs().max())
        torch.testing.assert_close(got[b], ref[b], rtol=0, atol=tol)


def test_fp8_rounding_keeps_e4m3_values_and_bounds_the_error():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(1))
    y = fp8_round(x, -1)
    amax = x.abs().amax(-1, keepdim=True)
    # e4m3 keeps 3 mantissa bits: half a step is 2^-4 of the value, and
    # values below the normal range keep 2^-9 of the scale
    assert ((y - x).abs() <= torch.maximum(x.abs() / 16, amax / 448 * 2**-9) + 1e-7).all()
    assert torch.equal(fp8_round(y, -1), y)


def test_the_fp8_control_departs_from_the_reference():
    from repro_torch.configs import get_config

    s = spec_of_port(get_config("mistral-7b-reduced"))
    tree = weights.make(s, 3, "cpu")
    seq = [torch.randint(1, s.vocab_size, (40,), generator=torch.Generator().manual_seed(2))]
    ref = Reference(s, tree).logits(seq, [30])[0]
    ctl = Reference(s, tree, fp8=True).logits(seq, [30])[0]
    rel = float((ctl - ref).abs().max() / ref.abs().max())
    assert 1e-3 < rel < 0.5
