"""The MoE family of the PyTorch port against the JAX package.

mixtral-8x7b-, granite-moe-3b-a800m- and deepseek-v3-671b-reduced (MLA,
a leading dense layer, a shared expert, MTP), f32.  Weights move by value
through `repro_torch.weights.from_jax_params`; inputs are drawn with
numpy.  The capacity dispatch's index tables (`slot2tok`, `slot2pair`,
`tok2slot`, `keep`, `counts`) are held equal to the reference's exactly,
taken from the reference's own run: its `_dispatch`, `_combine` and
`jax.lax.top_k` are wrapped to record their arguments while it runs with
jit disabled (so its chunk scan runs eagerly too).  Outputs, aux losses,
logits and caches are compared at 1e-4 (f32; the frameworks differ only
in reduction order); greedy tokens must be identical.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_api as jget_api
from repro.models import moe as jmoe
from repro.serving import InferenceEngine as JEngine
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as port_serve
from repro_torch.models import get_api, moe
from repro_torch.models.common import unstack_layers
from repro_torch.serving import InferenceEngine
from repro_torch.weights import from_jax_params

TOL = 1e-4
DENSE_ATTN = ["mixtral-8x7b-reduced", "granite-moe-3b-a800m-reduced"]
# (arch, config fields replaced): deepseek-v3 in both MLA decode modes
MODELS = [("mixtral-8x7b-reduced", {}), ("granite-moe-3b-a800m-reduced", {}),
          ("deepseek-v3-671b-reduced", {"mla_absorb": True}),
          ("deepseek-v3-671b-reduced", {"mla_absorb": False})]
MODEL_IDS = ["mixtral", "granite", "deepseek-absorb", "deepseek-expand"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port tests do: with
    several pytest-xdist workers its default threads oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def carried(arch, seed=0, **fields):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = jget_config(arch).replace(**fields)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = get_config(arch).replace(**fields)
    return jcfg, jparams, cfg, from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")


def moe_layer(jparams, params, **edit):
    """Layer 0's MoE params of both packages, with leaves replaced by the
    numpy arrays in `edit` (in both)."""
    jpl = jax.tree.map(lambda a: np.asarray(a[0]), jparams["blocks"]["moe_blocks"]["moe"])
    jpl.update(edit)
    pl = unstack_layers(params["blocks"]["moe_blocks"])[0]["moe"]
    pl.update({k: _t(v) for k, v in edit.items()})
    return jax.tree.map(jnp.asarray, jpl), pl


@contextlib.contextmanager
def reference_tables(monkeypatch):
    """Record, per dispatch the reference makes: the experts `top_k`
    chose and the tables handed to `_dispatch` and `_combine`."""
    rec = []
    top_k, dispatch, combine = jax.lax.top_k, jmoe._dispatch, jmoe._combine

    def rec_top_k(x, k):
        out = top_k(x, k)
        rec.append({"eidx": np.asarray(out[1])})
        return out

    def rec_dispatch(xt, slot2tok, tok2slot):
        rec[-1]["slot2tok"] = np.asarray(slot2tok)
        return dispatch(xt, slot2tok, tok2slot)

    def rec_combine(y, gates, tok2slot, slot2pair):
        rec[-1].update(tok2slot=np.asarray(tok2slot), slot2pair=np.asarray(slot2pair),
                       capacity=y.shape[1])
        return combine(y, gates, tok2slot, slot2pair)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jmoe, "_dispatch", rec_dispatch)
    monkeypatch.setattr(jmoe, "_combine", rec_combine)
    with jax.disable_jit():
        yield rec


def check_tables(cfg, pl, x, ref):
    """The port's routing and tables for tokens x [T, d] equal the
    reference's record `ref` exactly.  Returns the port's tables."""
    _, _, eidx = moe.route(cfg, pl["router"], x)
    np.testing.assert_array_equal(eidx.numpy(), ref["eidx"])
    tab = moe.dispatch_tables(eidx, cfg.n_experts, ref["capacity"])
    for name in ("slot2tok", "slot2pair", "tok2slot"):
        np.testing.assert_array_equal(getattr(tab, name).numpy(), ref[name], err_msg=name)
    np.testing.assert_array_equal(
        tab.counts.numpy(), np.bincount(ref["eidx"].reshape(-1), minlength=cfg.n_experts))
    # keep (per pair in expert-sorted order) taken back to the pairs' own
    # order: a pair is kept where the reference gave it a slot
    ref_kept = ref["tok2slot"].reshape(-1) < cfg.n_experts * ref["capacity"]
    np.testing.assert_array_equal(tab.keep[tab.inv_order].numpy(), ref_kept)
    return tab


def skewed_router(jparams, cfg, x):
    """A router whose expert 0 takes every token (and x shifted to make it
    so): more pairs than the capacity-factor capacity, so pairs drop."""
    router = np.asarray(jparams["blocks"]["moe_blocks"]["moe"]["router"][0]).copy()
    router[:, 0] = 0.5
    return router, x + 1.0


class TestDispatch:
    @pytest.mark.parametrize("dropless", [True, False])
    @pytest.mark.parametrize("arch", DENSE_ATTN)
    def test_tables_output_and_aux_match(self, arch, dropless, monkeypatch):
        jcfg, jparams, cfg, params = carried(arch)
        x = np.random.default_rng(0).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
        jpl, pl = moe_layer(jparams, params)
        with reference_tables(monkeypatch) as rec:
            jy, jaux = jmoe.moe_ffn(jcfg, jpl, jnp.asarray(x), dropless=dropless)
        y, aux = moe.moe_ffn(cfg, pl, _t(x), dropless=dropless)
        _close(y, jy)
        _close(aux, jaux)
        assert len(rec) == 1 and rec[0]["capacity"] == moe.expert_capacity(
            48, cfg, dropless=dropless) == jmoe.expert_capacity(48, jcfg, dropless=dropless)
        check_tables(cfg, pl, _t(x).reshape(48, -1), rec[0])

    @pytest.mark.parametrize("dropless", [True, False])
    @pytest.mark.parametrize("arch", DENSE_ATTN)
    def test_dropped_pairs_match(self, arch, dropless, monkeypatch):
        """A skewed router: without dropless, expert 0's pairs past the
        capacity drop, the same pairs as in the reference; dropless keeps
        them all."""
        jcfg, jparams, cfg, params = carried(arch)
        x = np.random.default_rng(1).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
        router, x = skewed_router(jparams, cfg, x)
        jpl, pl = moe_layer(jparams, params, router=router)
        with reference_tables(monkeypatch) as rec:
            jy, jaux = jmoe.moe_ffn(jcfg, jpl, jnp.asarray(x), dropless=dropless)
        y, aux = moe.moe_ffn(cfg, pl, _t(x), dropless=dropless)
        _close(y, jy)
        _close(aux, jaux)
        tab = check_tables(cfg, pl, _t(x).reshape(64, -1), rec[0])
        n_dropped = int((~tab.keep).sum())
        assert int(tab.counts[0]) == 64
        assert (n_dropped > 0) == (not dropless)

    @pytest.mark.parametrize("arch", DENSE_ATTN)
    def test_router_ties_pick_the_lower_expert(self, arch, monkeypatch):
        """Duplicated router columns (experts 1 = 0 and 3 = 2) tie exactly;
        top-k must list the lower index first, as `jax.lax.top_k` does."""
        jcfg, jparams, cfg, params = carried(arch)
        x = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
        router = np.asarray(jparams["blocks"]["moe_blocks"]["moe"]["router"][0]).copy()
        router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
        jpl, pl = moe_layer(jparams, params, router=router)
        probs, _, eidx = moe.route(cfg, pl["router"], _t(x).reshape(48, -1))
        assert torch.equal(probs[:, 0], probs[:, 1]) and torch.equal(probs[:, 2], probs[:, 3])
        # every token's top 2 is a tied pair: the lower index comes first
        assert bool((eidx[:, 0] < eidx[:, 1]).all())
        with reference_tables(monkeypatch) as rec:
            jy, _ = jmoe.moe_ffn(jcfg, jpl, jnp.asarray(x), dropless=True)
        _close(moe.moe_ffn(cfg, pl, _t(x), dropless=True)[0], jy)
        check_tables(cfg, pl, _t(x).reshape(48, -1), rec[0])

    @pytest.mark.parametrize("dropless", [True, False])
    def test_chunked_dispatch_matches(self, dropless, monkeypatch):
        """moe_token_chunk = 16 over 48 tokens: three chunks, each with its
        own capacity and tables; the aux loss is the chunks' mean."""
        jcfg, jparams, cfg, params = carried("mixtral-8x7b-reduced", moe_token_chunk=16)
        x = np.random.default_rng(3).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
        router, x = skewed_router(jparams, cfg, x)
        jpl, pl = moe_layer(jparams, params, router=router)
        with reference_tables(monkeypatch) as rec:
            jy, jaux = jmoe.moe_ffn(jcfg, jpl, jnp.asarray(x), dropless=dropless)
        y, aux = moe.moe_ffn(cfg, pl, _t(x), dropless=dropless)
        _close(y, jy)
        _close(aux, jaux)
        assert len(rec) == 3
        chunks = _t(x).reshape(3, 16, -1)
        for i, ref in enumerate(rec):
            assert ref["capacity"] == moe.expert_capacity(16, cfg, dropless=dropless)
            check_tables(cfg, pl, chunks[i], ref)
        # the chunks' own capacities drop pairs that one dispatch of all 48
        # would keep: the chunking is what the output shows
        whole = moe.moe_ffn(cfg.replace(moe_token_chunk=0), pl, _t(x), dropless=dropless)[0]
        assert torch.equal(whole, y) == dropless

    def test_decode_token_path_matches(self):
        jcfg, jparams, cfg, params = carried("granite-moe-3b-a800m-reduced")
        x = np.random.default_rng(4).normal(size=(3, cfg.d_model)).astype(np.float32)
        jpl, pl = moe_layer(jparams, params)
        jy, jaux = jmoe.moe_ffn_token(jcfg, jpl, jnp.asarray(x))
        y, aux = moe.moe_ffn_token(cfg, pl, _t(x))
        _close(y, jy)
        _close(aux, jaux)


class TestModels:
    @pytest.mark.parametrize("arch,fields", MODELS, ids=MODEL_IDS)
    def test_prefill_and_decode_match(self, arch, fields):
        """Prefill logits and caches, then 8 decode steps, every logit and
        the final caches against the reference at 1e-4."""
        jcfg, jparams, cfg, params = carried(arch, **fields)
        japi, api = jget_api(jcfg), get_api(cfg)
        rng = np.random.default_rng(5)
        toks = rng.integers(1, cfg.vocab_size, (2, 20)).astype(np.int32)
        jlogits, jc = jax.jit(lambda p, b: japi.prefill(jcfg, p, b, cache_len=32))(
            jparams, {"tokens": jnp.asarray(toks)})
        logits, c = api.prefill(cfg, params, {"tokens": _t(toks, torch.int32)}, cache_len=32)
        names = ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")
        assert type(c).__name__ == type(jc).__name__

        def same_caches():
            for n in names:
                _close(getattr(c, n), getattr(jc, n))
            assert int(c.pos) == int(jc.pos)

        _close(logits, jlogits)
        same_caches()
        jstep = jax.jit(lambda p, c, t: japi.decode_step(jcfg, p, c, {"token": t}))
        for _ in range(8):
            tok = rng.integers(1, cfg.vocab_size, (2,)).astype(np.int32)
            jlogits, jc = jstep(jparams, jc, jnp.asarray(tok))
            logits, c = api.decode_step(cfg, params, c, {"token": _t(tok, torch.int32)})
            _close(logits, jlogits)
        same_caches()

    @pytest.mark.parametrize("arch,fields", MODELS, ids=MODEL_IDS)
    def test_greedy_tokens_identical(self, arch, fields):
        """Greedy tokens: the port KV-on, the port KV-off and the
        reference's engine KV-on all agree."""
        jcfg, jparams, cfg, params = carried(arch, **fields)
        toks = np.random.default_rng(6).integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
        ref, _ = JEngine(jcfg, jparams, kv_cache=True, bucket=16).generate({"tokens": toks}, 8)
        on, _ = InferenceEngine(cfg, params, kv_cache=True, bucket=16,
                                device="cpu").generate({"tokens": toks}, 8)
        off, _ = InferenceEngine(cfg, params, kv_cache=False, bucket=16,
                                 device="cpu").generate({"tokens": toks}, 8)
        np.testing.assert_array_equal(on, np.asarray(ref))
        np.testing.assert_array_equal(off, on)

    def test_mla_full_attention_chunks_match(self):
        """The chunked-query branch of MLA full attention (S = 3 chunks)."""
        from repro.models import attention as jattn
        from repro_torch.models import attention
        rng = np.random.default_rng(7)
        B, S, H, Dn, Dr, Dv = 2, 12, 3, 8, 4, 6
        arrays = [rng.normal(size=s).astype(np.float32) for s in
                  ((B, S, H, Dn), (B, S, H, Dr), (B, S, H, Dn), (B, S, Dr), (B, S, H, Dv))]
        for kw in (dict(chunk_q=4), dict(chunk_q=4, window=5), dict()):
            _close(attention.mla_full_attention(*map(_t, arrays), **kw),
                   jattn.mla_full_attention(*map(jnp.asarray, arrays), **kw))

    def test_init_cache_matches_reference_layout(self):
        for arch in ("mixtral-8x7b-reduced", "deepseek-v3-671b-reduced", "mixtral-8x7b",
                     "granite-moe-3b-a800m", "deepseek-v3-671b"):
            cfg, jcfg = get_config(arch), jget_config(arch)
            ours = get_api(cfg).init_cache(cfg, 2, 24, device="cpu")
            ref = jget_api(jcfg).init_cache(jcfg, 2, 24)
            assert type(ours).__name__ == type(ref).__name__
            for n in (("c_kv", "k_rope") if cfg.use_mla else ("k", "v")):
                assert tuple(getattr(ours, n).shape) == getattr(ref, n).shape
                assert str(getattr(ours, n).dtype).removeprefix("torch.") == \
                    getattr(ref, n).dtype.name
            assert ours.pos.dtype == torch.int32 and ours.pos.dim() == 0

    def test_fp8_latent_cache_casts_as_the_kv_caches(self):
        """An fp8 MLA cache: prefill casts the latents through
        `to_cache_dtype`, decode writes through `write_token` and reads
        the cache back in the model's dtype; equal to the reference's
        cache values after the prefill and a decode step."""
        f8 = "float8_e4m3fn"
        jcfg, jparams, cfg, params = carried("deepseek-v3-671b-reduced", cache_dtype=f8)
        japi, api = jget_api(jcfg), get_api(cfg)
        toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 10)).astype(np.int32)
        jlogits, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, cache_len=16)
        logits, c = api.prefill(cfg, params, {"tokens": _t(toks, torch.int32)}, cache_len=16)
        assert c.c_kv.dtype == torch.float8_e4m3fn
        _close(logits, jlogits)
        tok = np.array([3, 4], np.int32)
        jlogits, jc = japi.decode_step(jcfg, jparams, jc, {"token": jnp.asarray(tok)})
        logits, c = api.decode_step(cfg, params, c, {"token": _t(tok, torch.int32)})
        _close(logits, jlogits)
        for n in ("c_kv", "k_rope"):
            np.testing.assert_array_equal(getattr(c, n).float().numpy(),
                                          np.asarray(getattr(jc, n), np.float32))


class TestRegistryAndWeights:
    def test_every_moe_config_runs_through_the_registry(self):
        """Every MoE arch's reduced variant prefills and decodes through
        `get_api`; the full configs resolve to the same functions."""
        archs = [a for a in list_archs() if get_config(a).family == "moe"]
        assert {"mixtral-8x7b", "granite-moe-3b-a800m", "deepseek-v3-671b"} <= set(archs)
        for arch in archs:
            api = get_api(get_config(arch))
            assert (api.prefill, api.init_cache, api.decode_step) == \
                (moe.prefill, moe.init_cache, moe.decode_step)
            cfg = get_config(arch + "-reduced") if not arch.endswith("-reduced") else \
                get_config(arch)
            params = api.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
            toks = torch.randint(1, cfg.vocab_size, (2, 5), generator=torch.Generator())
            logits, c = api.prefill(cfg, params, {"tokens": toks}, cache_len=8)
            logits, c = api.decode_step(cfg, params, c, {"token": toks[:, 0]})
            assert torch.isfinite(logits[:, :cfg.vocab_size]).all() and int(c.pos) == 6

    def test_weights_carry_the_whole_tree(self):
        """dense_blocks, the shared expert and the MTP head cross by value."""
        _, jparams, _, params = carried("deepseek-v3-671b-reduced")
        for path in (("blocks", "dense_blocks", "mlp", "w_up"),
                     ("blocks", "moe_blocks", "moe", "shared", "w_gate"),
                     ("blocks", "moe_blocks", "attn", "w_kv_b"),
                     ("mtp", "proj"), ("mtp", "mlp", "w_down"), ("mtp", "ln", "w")):
            ours, ref = params, jparams
            for k in path:
                ours, ref = ours[k], ref[k]
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert len(jax.tree_util.tree_leaves(jparams)) == len(
            jax.tree_util.tree_leaves(params))


class TestServe:
    def test_serve_moe_fleet_on_cpu(self):
        archs = ["mixtral-8x7b-reduced", "granite-moe-3b-a800m-reduced"]
        out = port_serve.serve(archs, n_queries=8, zeta=0.5, char_max_tokens=16,
                               device="cpu")
        assert sum(len(rs) for rs in out["plan"].per_model.values()) == 8
        routed = {a for a, rs in out["plan"].per_model.items() if rs}
        assert routed and set(out["totals"]) == routed
        assert sum(t["queries"] for t in out["totals"].values()) == 8
        for t in out["totals"].values():
            assert t["runtime_s"] > 0 and t["tokens"] > 0
        assert [p.name for p in out["profiles"]] == archs
        assert all(np.isfinite(p.energy.coeffs + p.runtime.coeffs).all()
                   for p in out["profiles"])
