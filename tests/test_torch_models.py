"""Dense models of the PyTorch port against the JAX package.

Weights move by value: the reference draws them with `jax.random`, they go
to numpy and through `repro_torch.weights.from_jax_params`.  Inputs are
drawn with numpy.  Logits are compared at 1e-4 (f32 throughout; the two
frameworks differ only in reduction order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PAPER_ZOO as J_ZOO
from repro.configs import get_config as jget_config
from repro.models import common as jcommon
from repro.models import attention as jattn
from repro.models import cache as jcache
from repro.models import get_api as jget_api
import repro_torch
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ZOO, get_config
from repro_torch.models import attention, cache, common, get_api
from repro_torch.weights import from_jax_params

FLEET = ["llama2-7b-reduced", "llama2-13b-reduced", "llama2-70b-reduced",
         "mistral-7b-reduced", "falcon-7b-reduced", "falcon-40b-reduced",
         # assigned dense archs: QKV bias (qwen2.5), qk-norm (qwen3)
         "qwen2.5-14b-reduced", "qwen3-1.7b-reduced", "llama3.2-3b-reduced",
         "deepseek-67b-reduced"]
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


def carried(arch, seed=0):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = jget_config(arch)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = get_config(arch)
    return jcfg, jparams, cfg, from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")


class TestConfigs:
    @pytest.mark.parametrize("arch", sorted(J_ZOO) + FLEET)
    def test_config_matches_reference(self, arch):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))

    @pytest.mark.parametrize("arch", sorted(a for a, c in J_ZOO.items() if c.family == "dense"))
    def test_count_params_matches_reference(self, arch):
        ref = jget_api(jget_config(arch)).count_params(jget_config(arch))
        assert get_api(get_config(arch)).count_params(get_config(arch)) == ref

    def test_archs_resolve_and_count_params(self):
        """Every assigned arch resolves, and every family counts its
        parameters as the reference does."""
        for arch in ASSIGNED_ARCHS:
            assert get_config(arch).name == arch
            assert get_config(arch + "-reduced").family == get_config(arch).family
        for arch in ("mixtral-8x7b", "deepseek-v3-671b", "seamless-m4t-large-v2",
                     "internvl2-2b"):
            cfg, jcfg = get_config(arch), jget_config(arch)
            assert get_api(cfg).count_params(cfg) == jget_api(jcfg).count_params(jcfg)
        with pytest.raises(KeyError, match="unknown arch"):
            get_config("gpt-5")

    @pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "encdec", "vlm"])
    def test_every_family_runs(self, family):
        """prefill, init_cache and decode_step of every family run on a
        reduced config (the registry raises for none), the stubbed
        frontends' inputs supplied as `measure_fn` supplies them."""
        from repro_torch.serving.engine import frontend_inputs
        arch = next(a for a in ASSIGNED_ARCHS if get_config(a).family == family)
        cfg = get_config(arch + "-reduced")
        api = get_api(cfg)
        params = api.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (2, 5), dtype=torch.int32),
                 **{k: torch.as_tensor(v) for k, v in frontend_inputs(cfg, 2).items()}}
        with torch.no_grad():
            logits, cache = api.prefill(cfg, params, batch, cache_len=cfg.n_patches + 8)
            token = logits.argmax(-1).int()
            logits2, cache2 = api.decode_step(cfg, params, cache, {"token": token})
            fresh = api.init_cache(cfg, 2, cfg.n_patches + 8, device="cpu")
            logits3, _ = api.decode_step(cfg, params, fresh, {"token": token})
        for lg in (logits, logits2, logits3):
            assert lg.shape == (2, common.padded_vocab(cfg.vocab_size))
            assert torch.isfinite(lg[:, :cfg.vocab_size]).all()
        assert int(cache2.pos) == int(cache.pos) + 1 and int(fresh.pos) == 0

    def test_dtypes_are_torch(self):
        assert get_config("llama2-7b").dtype == torch.bfloat16
        assert get_config("llama2-7b-reduced").kv_dtype == torch.float32


class TestCommon:
    def test_norm_rope_mlp_embed_head_loss(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2, 6, 3, 32)).astype(np.float32)
        w = rng.normal(size=(32,)).astype(np.float32) * 0.1
        _close(common.rmsnorm(_t(x), _t(w)), jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
        pos = np.arange(6)[None].repeat(2, 0) + 7
        _close(common.rope(_t(x), _t(pos, torch.int32), 10000.0),
               jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
        h = rng.normal(size=(2, 5, 16)).astype(np.float32)
        wg, wu = (rng.normal(size=(16, 24)).astype(np.float32) for _ in range(2))
        wd = rng.normal(size=(24, 16)).astype(np.float32)
        _close(common.swiglu(_t(h), _t(wg), _t(wu), _t(wd)),
               jcommon.swiglu(*map(jnp.asarray, (h, wg, wu, wd))))
        emb = rng.normal(size=(128, 16)).astype(np.float32)
        toks = rng.integers(0, 100, (2, 5)).astype(np.int32)
        _close(common.embed_tokens(_t(emb), _t(toks, torch.int32)),
               jcommon.embed_tokens(jnp.asarray(emb), jnp.asarray(toks)))
        head = rng.normal(size=(16, 128)).astype(np.float32)
        logits = common.lm_logits(_t(h), _t(head), 100)
        _close(logits, jcommon.lm_logits(jnp.asarray(h), jnp.asarray(head), 100))
        labels = rng.integers(-1, 100, (2, 5)).astype(np.int32)
        loss, n = common.cross_entropy(logits, _t(labels, torch.int32))
        jloss, jn = jcommon.cross_entropy(jnp.asarray(np.asarray(logits)), jnp.asarray(labels))
        _close(loss, jloss)
        assert float(n) == float(jn)
        assert common.padded_vocab(32000) == jcommon.padded_vocab(32000) == 32000


class TestAttention:
    @pytest.mark.parametrize("kw", [
        dict(),
        dict(window=5),
        dict(q_offset=4, causal=True),
        dict(softcap=3.0),
        dict(chunk_q=4),              # chunked-query branch (Sq=12 = 3 chunks)
        dict(chunk_q=4, window=6, q_offset=2),
        dict(causal=False),
    ])
    def test_full_attention_matches_reference(self, kw):
        rng = np.random.default_rng(1)
        q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
        k = rng.normal(size=(2, 12 + kw.get("q_offset", 0), 2, 16)).astype(np.float32)
        v = rng.normal(size=k.shape).astype(np.float32)
        _close(attention.full_attention(_t(q), _t(k), _t(v), **kw),
               jattn.full_attention(*map(jnp.asarray, (q, k, v)), **kw))

    def test_ring_pack_matches_reference(self):
        rng = np.random.default_rng(2)
        ks = rng.normal(size=(2, 1, 11, 2, 4)).astype(np.float32)
        vs = rng.normal(size=ks.shape).astype(np.float32)
        for window, pos_end in [(4, 11), (16, 11), (8, 20)]:
            ours = cache.ring_pack(_t(ks), _t(vs), window, pos_end)
            ref = jcache.ring_pack(jnp.asarray(ks), jnp.asarray(vs), window, pos_end)
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class TestDense:
    @pytest.mark.parametrize("arch", FLEET)
    def test_prefill_and_decode_logits_match(self, arch):
        """Prefill, then decode steps past the mistral ring's wrap (window
        64), every logit against the reference at 1e-4."""
        jcfg, jparams, cfg, params = carried(arch)
        japi, api = jget_api(jcfg), get_api(cfg)
        rng = np.random.default_rng(3)
        toks = rng.integers(1, cfg.vocab_size, (2, 60)).astype(np.int32)
        jlogits, jc = jax.jit(lambda p, b: japi.prefill(jcfg, p, b, cache_len=80))(
            jparams, {"tokens": jnp.asarray(toks)})
        logits, c = api.prefill(cfg, params, {"tokens": _t(toks, torch.int32)}, cache_len=80)
        _close(logits, jlogits)
        assert type(c).__name__ == type(jc).__name__
        _close(c.k, jc.k)
        jstep = jax.jit(lambda p, c, t: japi.decode_step(jcfg, p, c, {"token": t}))
        for _ in range(8):
            tok = rng.integers(1, cfg.vocab_size, (2,)).astype(np.int32)
            jlogits, jc = jstep(jparams, jc, jnp.asarray(tok))
            logits, c = api.decode_step(cfg, params, c, {"token": _t(tok, torch.int32)})
            _close(logits, jlogits)
            assert int(c.pos) == int(jc.pos)
        _close(c.k, jc.k)
        _close(c.v, jc.v)

    def test_init_cache_matches_reference_layout(self):
        for arch in ("llama2-7b-reduced", "mistral-7b-reduced"):
            cfg, jcfg = get_config(arch), jget_config(arch)
            ours = get_api(cfg).init_cache(cfg, 2, 100, device="cpu")
            ref = jget_api(jcfg).init_cache(jcfg, 2, 100)
            assert type(ours).__name__ == type(ref).__name__
            assert tuple(ours.k.shape) == ref.k.shape
            assert ours.pos.dtype == torch.int32 and ours.pos.dim() == 0

    def test_init_params_paths_shapes_and_seed(self):
        cfg = get_config("llama2-70b-reduced")
        api = get_api(cfg)
        a = api.init_params(cfg, torch.Generator().manual_seed(7), torch.device("cpu"))
        b = api.init_params(cfg, torch.Generator().manual_seed(7), torch.device("cpu"))
        jshapes = jget_api(jget_config(cfg.name)).param_shapes(jget_config(cfg.name))
        flat = jax.tree_util.tree_leaves_with_path(jshapes)
        assert len(flat) == len(jax.tree_util.tree_leaves(a))
        for path, sds in flat:
            keys = [p.key for p in path]
            ta, tb = a, b
            for key in keys:
                ta, tb = ta[key], tb[key]
            assert tuple(ta.shape) == sds.shape and ta.dtype == torch.float32
            assert torch.equal(ta, tb)
        assert not a["final_norm"]["w"].any()     # zero-init, as the reference
        assert 0.015 < float(a["embed"].std()) < 0.025   # scale 0.02


class TestWeightsCarrier:
    def test_rejects_bad_trees(self):
        jcfg, jparams, cfg, _ = carried("llama2-7b-reduced")
        tree = jax.tree.map(np.asarray, jparams)
        missing = dict(tree, final_norm={})
        with pytest.raises(ValueError, match="missing"):
            from_jax_params(cfg, missing, "cpu")
        extra = dict(tree, bonus=np.zeros(3, np.float32))
        with pytest.raises(ValueError, match="extra"):
            from_jax_params(cfg, extra, "cpu")
        bad_shape = dict(tree, head=np.zeros((3, 3), np.float32))
        with pytest.raises(ValueError, match="shape"):
            from_jax_params(cfg, bad_shape, "cpu")
        bad_dtype = dict(tree, head=tree["head"].astype(np.float64))
        with pytest.raises(ValueError, match="float64"):
            from_jax_params(cfg, bad_dtype, "cpu")

    def test_copies_by_value(self):
        _, jparams, _, params = carried("llama2-7b-reduced")
        np.testing.assert_array_equal(params["blocks"]["attn"]["wq"].numpy(),
                                      np.asarray(jparams["blocks"]["attn"]["wq"]))

    def test_bfloat16_leaves_copy_exactly(self):
        cfg = get_config("llama2-7b-reduced").replace(param_dtype="bfloat16")
        jcfg = jget_config("llama2-7b-reduced").replace(param_dtype="bfloat16")
        jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(1))
        params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
        assert params["head"].dtype == torch.bfloat16
        np.testing.assert_array_equal(params["head"].float().numpy(),
                                      np.asarray(jparams["head"], np.float32))


class TestDevice:
    def test_cuda_default_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.resolve_device()
        assert repro_torch.resolve_device("cpu") == torch.device("cpu")
        with pytest.raises(ValueError):
            repro_torch.resolve_device("meta")
