"""The ssm family (Mamba-2) of the PyTorch port against the JAX package.

Weights move by value from the reference's `init_params`
(`repro_torch.weights.from_jax_params`); inputs are drawn with numpy.  At
`mamba2-130m-reduced` (2 layers, 32 SSD heads of 16, state 16, chunk 16,
f32) prefill and decode logits and the SSD and conv states are held to
1e-4, and greedy tokens must be identical to the reference engine's and
across the port's KV modes.

The reference's prefill needs S to be a multiple of min(ssm_chunk, S)
(`repro/models/ssm.py:91`); the port's does not.  At a ragged length L the
port's prefill is held against the reference's prefill at an aligned S0
followed by L - S0 decode steps, the same recurrence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_api as jget_api
from repro.serving import InferenceEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import cache, get_api
from repro_torch.serving import InferenceEngine
from repro_torch.weights import from_jax_params

ARCH = "mamba2-130m-reduced"
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here.  At these tiny shapes its
    intra-op threads only add overhead, and with several pytest-xdist
    workers on one machine they oversubscribe the cores: six concurrent
    CPU `serve()` runs took over 15 minutes with the default threads and
    about 10 s each with one.  One thread also avoids a fault seen in the
    first multi-threaded float32 `torch.exp` of a process (values ~1e-4
    off, relative, in about one process in twenty)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = jget_config(ARCH)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(ARCH)
    return jcfg, jparams, cfg, from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")


def _tokens(cfg, S, seed=3, batch=2):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (batch, S)).astype(np.int32)


def _close_cache(c, jc):
    _close(c.state, jc.state)
    _close(c.conv, jc.conv)
    assert int(c.pos) == int(jc.pos)


class TestConfig:
    @pytest.mark.parametrize("arch", ["mamba2-130m", ARCH])
    def test_config_and_param_count_match_reference(self, arch):
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.d_inner, cfg.ssm_nheads) == (jcfg.d_inner, jcfg.ssm_nheads)
        assert get_api(cfg).count_params(cfg) == jget_api(jcfg).count_params(jcfg)

    def test_published_widths(self):
        cfg = get_config("mamba2-130m")
        assert (cfg.n_layers, cfg.d_model, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                cfg.ssm_ngroups, cfg.ssm_chunk, cfg.dtype, cfg.accuracy_ak) == \
            (24, 768, 24, 64, 128, 1, 256, torch.bfloat16, 35.0)

    def test_weights_carry_by_value(self, carried):
        _, jparams, _, params = carried
        np.testing.assert_array_equal(params["blocks"]["in_proj"].numpy(),
                                      np.asarray(jparams["blocks"]["in_proj"]))
        np.testing.assert_array_equal(params["head"].numpy(), np.asarray(jparams["head"]))


class TestModel:
    @pytest.mark.parametrize("S", [16, 32, 48])
    def test_prefill_and_decode_match(self, carried, S):
        """Prefill at a multiple of the chunk, then 8 decode steps: logits
        and states against the reference at 1e-4."""
        jcfg, jparams, cfg, params = carried
        japi, api = jget_api(jcfg), get_api(cfg)
        toks = _tokens(cfg, S)
        jlogits, jc = jax.jit(lambda p, b: japi.prefill(jcfg, p, b))(
            jparams, {"tokens": jnp.asarray(toks)})
        logits, c = api.prefill(cfg, params, {"tokens": _t(toks, torch.int32)})
        _close(logits, jlogits)
        assert isinstance(c, cache.SSMCache) and type(jc).__name__ == "SSMCache"
        _close_cache(c, jc)
        jstep = jax.jit(lambda p, c, t: japi.decode_step(jcfg, p, c, {"token": t}))
        rng = np.random.default_rng(S)
        for _ in range(8):
            tok = rng.integers(1, cfg.vocab_size, (2,)).astype(np.int32)
            jlogits, jc = jstep(jparams, jc, jnp.asarray(tok))
            logits, c = api.decode_step(cfg, params, c, {"token": _t(tok, torch.int32)})
            _close(logits, jlogits)
        _close_cache(c, jc)

    @pytest.mark.parametrize("L,S0", [(20, 16), (37, 32), (9, 8)])
    def test_ragged_prefill_matches_aligned_prefill_then_decode(self, carried, L, S0):
        jcfg, jparams, cfg, params = carried
        japi, api = jget_api(jcfg), get_api(cfg)
        toks = _tokens(cfg, L, seed=L)
        jlogits, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S0])})
        for t in range(S0, L):
            jlogits, jc = japi.decode_step(jcfg, jparams, jc, {"token": jnp.asarray(toks[:, t])})
        logits, c = api.prefill(cfg, params, {"tokens": _t(toks, torch.int32)})
        _close(logits, jlogits)
        _close_cache(c, jc)

    def test_init_cache_matches_reference_layout(self):
        cfg, jcfg = get_config(ARCH), jget_config(ARCH)
        ours = get_api(cfg).init_cache(cfg, 3, device="cpu")
        ref = jget_api(jcfg).init_cache(jcfg, 3)
        assert tuple(ours.conv.shape) == ref.conv.shape
        assert tuple(ours.state.shape) == ref.state.shape
        assert ours.state.dtype == torch.float32 and ours.pos.dtype == torch.int32


class TestEngine:
    @pytest.mark.parametrize("kv_cache", [True, False])
    def test_greedy_tokens_identical_to_reference(self, carried, kv_cache):
        """Prompt 9 + 5 new tokens: every KV-off prefix is at most 16 long,
        where the reference's prefill runs."""
        jcfg, jparams, cfg, params = carried
        toks = _tokens(cfg, 9, seed=4)
        ref, _ = JEngine(jcfg, jparams, kv_cache=kv_cache, bucket=16).generate(
            {"tokens": toks}, 5)
        ours, _ = InferenceEngine(cfg, params, kv_cache=kv_cache, bucket=16,
                                  device="cpu").generate({"tokens": toks}, 5)
        np.testing.assert_array_equal(ours, ref)

    def test_port_kv_modes_agree_at_ragged_lengths(self, carried):
        """KV-off prefills every prefix 37..44, which the reference cannot."""
        _, _, cfg, params = carried
        toks = _tokens(cfg, 37, seed=5)
        a, _ = InferenceEngine(cfg, params, kv_cache=True, device="cpu").generate(
            {"tokens": toks}, 8)
        b, _ = InferenceEngine(cfg, params, kv_cache=False, device="cpu").generate(
            {"tokens": toks}, 8)
        np.testing.assert_array_equal(a, b)
