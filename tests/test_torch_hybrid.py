"""The hybrid family (RecurrentGemma) of the PyTorch port against the JAX
package, and the port's serve path over the ssm + hybrid pair.

Weights move by value from the reference's `init_params`
(`repro_torch.weights.from_jax_params`); inputs are drawn with numpy.  At
`recurrentgemma-9b-reduced` (one (rec, rec, attn) unit plus two tail rec
layers, lru width 128, MQA head dim 64, local window 32, f32) prefill and
decode logits, the RG-LRU and conv states and the ring K/V are held to
1e-4, at prompt lengths below and past the window and through the ring's
wrap, and greedy tokens must be identical to the reference engine's and
across the port's KV modes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_api as jget_api
from repro.models import hybrid as jhybrid
from repro.serving import InferenceEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import cache, get_api, hybrid
from repro_torch.serving import InferenceEngine
from repro_torch.weights import from_jax_params

ARCH = "recurrentgemma-9b-reduced"
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
    for name in ("lru", "conv", "k", "v"):
        _close(getattr(c, name), getattr(jc, name))
    assert int(c.pos) == int(jc.pos)


class TestConfig:
    @pytest.mark.parametrize("arch", ["recurrentgemma-9b", ARCH])
    def test_config_and_param_count_match_reference(self, arch):
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert get_api(cfg).count_params(cfg) == jget_api(jcfg).count_params(jcfg)
        assert hybrid.pattern_counts(cfg) == jhybrid.pattern_counts(jcfg)
        assert hybrid.n_rec_layers(cfg) == jhybrid.n_rec_layers(jcfg)

    def test_published_widths(self):
        cfg = get_config("recurrentgemma-9b")
        assert hybrid.pattern_counts(cfg) == (12, 2, 12)
        assert (cfg.d_model, cfg.lru_width, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
                cfg.local_window, cfg.vocab_size, cfg.dtype, cfg.accuracy_ak) == \
            (4096, 4096, 16, 1, 256, 2048, 256000, torch.bfloat16, 60.0)
        assert 10.4e9 < get_api(cfg).count_params(cfg) < 10.5e9

    def test_weights_carry_by_value(self, carried):
        """The stacked unit and tail trees, leaf for leaf."""
        _, jparams, _, params = carried
        for path in (("units", "rec_a", "w_a"), ("units", "attn", "attn", "wq"),
                     ("tail", "rec", "lam"), ("units", "rec_b", "mlp", "w_down")):
            ours, ref = params, jparams
            for key in path:
                ours, ref = ours[key], ref[key]
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


class TestModel:
    @pytest.mark.parametrize("S", [7, 37, 50])
    def test_prefill_and_decode_match(self, carried, S):
        """Prefill below and past the 32-slot window, then 10 decode steps,
        which overwrite ring slots once the window is full: logits, states
        and ring K/V against the reference at 1e-4."""
        jcfg, jparams, cfg, params = carried
        japi, api = jget_api(jcfg), get_api(cfg)
        toks = _tokens(cfg, S)
        jlogits, jc = jax.jit(lambda p, b: japi.prefill(jcfg, p, b))(
            jparams, {"tokens": jnp.asarray(toks)})
        logits, c = api.prefill(cfg, params, {"tokens": _t(toks, torch.int32)})
        _close(logits, jlogits)
        assert isinstance(c, cache.HybridCache) and type(jc).__name__ == "HybridCache"
        assert c.window == cfg.local_window
        _close_cache(c, jc)
        jstep = jax.jit(lambda p, c, t: japi.decode_step(jcfg, p, c, {"token": t}))
        rng = np.random.default_rng(S)
        for _ in range(10):
            tok = rng.integers(1, cfg.vocab_size, (2,)).astype(np.int32)
            jlogits, jc = jstep(jparams, jc, jnp.asarray(tok))
            logits, c = api.decode_step(cfg, params, c, {"token": _t(tok, torch.int32)})
            _close(logits, jlogits)
        _close_cache(c, jc)

    def test_decode_from_an_empty_cache_matches(self, carried):
        """init_cache, then decode only: the ring fills from slot 0."""
        jcfg, jparams, cfg, params = carried
        japi, api = jget_api(jcfg), get_api(cfg)
        jc = japi.init_cache(jcfg, 2)
        c = api.init_cache(cfg, 2, device="cpu")
        assert all(tuple(getattr(c, n).shape) == getattr(jc, n).shape
                   for n in ("lru", "conv", "k", "v"))
        for tok in _tokens(cfg, 6, seed=9).T:
            jlogits, jc = japi.decode_step(jcfg, jparams, jc, {"token": jnp.asarray(tok)})
            logits, c = api.decode_step(cfg, params, c, {"token": _t(tok, torch.int32)})
            _close(logits, jlogits)
        _close_cache(c, jc)


class TestEngine:
    @pytest.mark.parametrize("kv_cache", [True, False])
    def test_greedy_tokens_identical_to_reference(self, carried, kv_cache):
        jcfg, jparams, cfg, params = carried
        toks = _tokens(cfg, 28, seed=4)
        ref, _ = JEngine(jcfg, jparams, kv_cache=kv_cache, bucket=16).generate(
            {"tokens": toks}, 8)
        ours, _ = InferenceEngine(cfg, params, kv_cache=kv_cache, bucket=16,
                                  device="cpu").generate({"tokens": toks}, 8)
        np.testing.assert_array_equal(ours, ref)

    def test_port_kv_modes_agree(self, carried):
        _, _, cfg, params = carried
        toks = _tokens(cfg, 37, seed=5)
        a, _ = InferenceEngine(cfg, params, kv_cache=True, device="cpu").generate(
            {"tokens": toks}, 8)
        b, _ = InferenceEngine(cfg, params, kv_cache=False, device="cpu").generate(
            {"tokens": toks}, 8)
        np.testing.assert_array_equal(a, b)


class TestServe:
    def test_serve_the_ssm_hybrid_pair_on_cpu(self):
        """characterize -> fit -> route -> serve, unchanged, with A_K from
        the configs (35 and 60)."""
        archs = ["mamba2-130m-reduced", "recurrentgemma-9b-reduced"]
        out = port_serve.serve(archs, n_queries=8, zeta=0.5, char_max_tokens=16,
                               device="cpu")
        assert [p.name for p in out["profiles"]] == archs
        assert [p.accuracy.a_k for p in out["profiles"]] == [35.0, 60.0]
        assert all(np.isfinite(p.energy.coeffs + p.runtime.coeffs).all()
                   for p in out["profiles"])
        routed = {a for a, rs in out["plan"].per_model.items() if rs}
        assert routed and set(out["totals"]) == routed
        assert sum(t["queries"] for t in out["totals"].values()) == 8
        for t in out["totals"].values():
            assert t["energy_j"] > 0 and t["runtime_s"] > 0 and t["tokens"] > 0
