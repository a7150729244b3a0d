"""The encdec and vlm families of the PyTorch port against the JAX package.

seamless-m4t-large-v2-reduced (2 encoder + 2 decoder layers, 32 frames)
and internvl2-2b-reduced (2 layers, 8 patches), f32.  Weights move by
value through `repro_torch.weights.from_jax_params`; tokens, frames and
patches are drawn with numpy.  Logits and caches are compared at 1e-4
(f32: the frameworks differ only in reduction order), fp8 caches as
values (equal); greedy tokens must be identical.  Each model runs with an
f32 cache, an fp8 one (`cache_dtype="float8_e4m3fn"`) and in
`long_context` mode (a 64-slot ring that the decode steps wrap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import long_context_note as j_long_context_note
from repro.configs import token_specs as j_token_specs
from repro.models import encdec as jencdec
from repro.models import get_api as jget_api
from repro.models import vlm as jvlm
from repro.serving import InferenceEngine as JEngine
from repro.serving.engine import measure_fn as j_measure_fn
from repro_torch.configs import INPUT_SHAPES, get_config, long_context_note, token_specs
from repro_torch.models import encdec, get_api, vlm
from repro_torch.serving import InferenceEngine
from repro_torch.serving.engine import frontend_inputs, measure_fn
from repro_torch.weights import from_jax_params

TOL = 1e-4
ENCDEC, VLM = "seamless-m4t-large-v2-reduced", "internvl2-2b-reduced"
F8 = "float8_e4m3fn"
# (config fields replaced, long_context, prompt length): the long-context
# prompt of 60 tokens (+ 8 patches for vlm) fills the 64-slot ring, which
# the 8 decode steps wrap.
CACHES = {"f32": ({}, False, 12), "fp8": ({"cache_dtype": F8}, False, 12),
          "long_context": ({}, True, 60)}
STEPS = 8


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
    return torch.as_tensor(np.array(a)).to(dtype)


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _same_cache(ours, ref):
    """f32 caches within TOL.  fp8 caches equal as values, but for rare
    elements one rounding step apart (adjacent bytes of one sign): where
    the two packages' f32 values, equal to ~1e-7, lie on either side of a
    rounding midpoint of e4m3's 3-bit mantissa.  At most 0.1 % of them."""
    if ours.dtype != torch.float8_e4m3fn:
        _close(ours, ref)
        return
    assert ref.dtype == jnp.float8_e4m3fn
    a, b = ours.float().numpy(), np.asarray(ref, np.float32)
    differ = ~((a == b) | (np.isnan(a) & np.isnan(b)))
    bits_a = ours.view(torch.uint8).numpy()[differ].astype(int)
    bits_b = np.asarray(ref).view(np.uint8)[differ].astype(int)
    assert (np.abs(bits_a - bits_b) == 1).all() and ((bits_a ^ bits_b) & 0x80 == 0).all(), \
        (a[differ], b[differ])
    assert differ.mean() <= 1e-3, differ.mean()


def carried(arch, seed=0, **fields):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = jget_config(arch).replace(**fields)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = get_config(arch).replace(**fields)
    return jcfg, jparams, cfg, from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")


def frontend(cfg, B, seed):
    """Random frames (encdec) or patches (vlm), f32."""
    rng = np.random.default_rng(seed)
    shapes = {k: v.shape for k, v in frontend_inputs(cfg, B).items()}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _both(batch):
    """The same numpy batch for the reference (jnp) and the port (torch)."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _caches(c):
    if hasattr(c, "self_k"):
        return {"self_k": c.self_k, "self_v": c.self_v, "cross_k": c.cross_k,
                "cross_v": c.cross_v}
    return {"k": c.k, "v": c.v}


def check_prefill_and_decode(arch, fields, long_context, prompt):
    """prefill, then STEPS decode steps: logits and every cache within TOL
    of the reference's (fp8 caches equal), positions alike."""
    jcfg, jparams, cfg, params = carried(arch, **fields)
    japi, api = jget_api(jcfg), get_api(cfg)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (2, prompt)).astype(np.int32),
             **frontend(cfg, 2, seed=4)}
    P = cfg.n_patches if cfg.family == "vlm" else 0
    kw = dict(cache_len=P + prompt + 16, long_context=long_context)
    jb, b = _both(batch)
    jlogits, jc = jax.jit(lambda p, b: japi.prefill(jcfg, p, b, **kw))(jparams, jb)
    logits, c = api.prefill(cfg, params, b, **kw)
    _close(logits, jlogits)
    for name, t in _caches(c).items():
        _same_cache(t, _caches(jc)[name])
    jstep = jax.jit(lambda p, c, t: japi.decode_step(jcfg, p, c, {"token": t}))
    for _ in range(STEPS):
        tok = rng.integers(1, cfg.vocab_size, (2,)).astype(np.int32)
        jlogits, jc = jstep(jparams, jc, jnp.asarray(tok))
        logits, c = api.decode_step(cfg, params, c, {"token": torch.as_tensor(tok)})
        _close(logits, jlogits)
    assert int(c.pos) == int(jc.pos) == P + prompt + STEPS
    for name, t in _caches(c).items():
        _same_cache(t, _caches(jc)[name])
    return c


class TestEncDec:
    def test_encode_and_decode_full_match(self):
        jcfg, jparams, cfg, params = carried(ENCDEC)
        frames = frontend(cfg, 2, seed=1)["frames"]
        toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 10)).astype(np.int32)
        jmem = jencdec.encode(jcfg, jparams, jnp.asarray(frames))
        mem = encdec.encode(cfg, params, _t(frames))
        _close(mem, jmem)
        assert mem.shape == (2, cfg.n_frames, cfg.d_model)
        for window in (0, 4):
            jh, jkv = jencdec.decode_full(jcfg, jparams, jnp.asarray(toks), jmem,
                                          window=window, collect=True)
            h, kv = encdec.decode_full(cfg, params, _t(toks, torch.int32), _t(np.asarray(jmem)),
                                       window=window, collect=True)
            _close(h, jh)
            for ours, ref in zip(kv, jkv):
                assert ours.shape == ref.shape
                _close(ours, ref)
        h, kv = encdec.decode_full(cfg, params, _t(toks, torch.int32), mem)
        assert kv is None and h.shape == (2, 10, cfg.d_model)

    @pytest.mark.parametrize("case", list(CACHES))
    def test_prefill_and_decode_steps_match(self, case):
        fields, long_context, prompt = CACHES[case]
        c = check_prefill_and_decode(ENCDEC, fields, long_context, prompt)
        cfg = get_config(ENCDEC)
        # self K/V in the cache's dtype, cross K/V in the compute dtype
        assert c.self_k.dtype == (torch.float8_e4m3fn if fields else torch.float32)
        assert c.cross_k.dtype == torch.float32
        assert c.cross_k.shape == (cfg.dec_layers, 2, cfg.n_frames, cfg.n_kv_heads,
                                   cfg.head_dim_)
        assert c.cache_len == (cfg.long_context_window if long_context else prompt + 16)

    def test_init_cache_matches(self):
        cfg, jcfg = get_config(ENCDEC), jget_config(ENCDEC)
        for long_context in (False, True):
            c = get_api(cfg).init_cache(cfg, 3, 100, long_context=long_context, device="cpu")
            jc = jget_api(jcfg).init_cache(jcfg, 3, 100, long_context=long_context)
            for name, t in _caches(c).items():
                ref = _caches(jc)[name]
                assert t.shape == ref.shape and str(t.dtype)[6:] == str(ref.dtype)
                assert not t.any()
            assert int(c.pos) == 0

    def test_decode_from_init_cache_matches(self):
        """decode_step on a fresh cache (zero memory), as a serve loop that
        skips prefill would run it."""
        jcfg, jparams, cfg, params = carried(ENCDEC)
        jc = jget_api(jcfg).init_cache(jcfg, 2, 16)
        c = get_api(cfg).init_cache(cfg, 2, 16, device="cpu")
        for tok in ([3, 7], [11, 5]):
            jl, jc = jget_api(jcfg).decode_step(jcfg, jparams, jc,
                                                {"token": jnp.asarray(tok, jnp.int32)})
            lg, c = get_api(cfg).decode_step(cfg, params, c,
                                             {"token": torch.tensor(tok, dtype=torch.int32)})
            _close(lg, jl)
        _close(c.self_k, jc.self_k)


class TestVLM:
    def test_project_patches_matches(self):
        jcfg, jparams, cfg, params = carried(VLM)
        patches = frontend(cfg, 3, seed=1)["patches"]
        for dtype, jdtype, tol in ((torch.float32, jnp.float32, TOL),
                                   (torch.bfloat16, jnp.bfloat16, 2e-2)):
            # the projector in the model's dtype, as a bf16 model holds it
            proj = {"projector": {k: v.to(dtype) for k, v in params["projector"].items()}}
            jproj = {"projector": jax.tree.map(lambda a: a.astype(jdtype),
                                               jparams["projector"])}
            ours = vlm.project_patches(proj, _t(patches), dtype)
            ref = jvlm.project_patches(jproj, jnp.asarray(patches), jdtype)
            assert ours.shape == (3, cfg.n_patches, cfg.d_model)
            assert ours.dtype == dtype and ref.dtype == jdtype
            _close(ours, ref, tol)
        assert vlm.VISION_DIM == jvlm.VISION_DIM

    @pytest.mark.parametrize("case", list(CACHES))
    def test_prefill_and_decode_steps_match(self, case):
        fields, long_context, prompt = CACHES[case]
        c = check_prefill_and_decode(VLM, fields, long_context, prompt)
        assert c.k.dtype == (torch.float8_e4m3fn if fields else torch.float32)

    def test_kv_off_forward_matches_the_reference_prefill(self):
        """The reference's KV-off engine cannot run the vlm family: it
        passes cache_len = L for an L-token prefix, while vlm.prefill runs
        n_patches + L positions, so `dense._finish_cache` pads by a negative
        width (ROADMAP queue 3).  The port's KV-off engine sizes the cache
        as its KV-on path does; each of its re-forwards equals the
        reference's `vlm.prefill` called directly with cache_len = P + L."""
        jcfg, jparams, cfg, params = carried(VLM)
        japi = jget_api(jcfg)
        batch = {"tokens": np.random.default_rng(5).integers(
            1, cfg.vocab_size, (2, 9)).astype(np.int32), **frontend(cfg, 2, seed=6)}
        with pytest.raises(ValueError):
            JEngine(jcfg, jparams, kv_cache=False).generate(batch, 2)
        seen = []
        eng = InferenceEngine(cfg, params, kv_cache=False, device="cpu")
        orig = eng._prefill

        def record(inputs, cache_len):
            out = orig(inputs, cache_len)
            seen.append((inputs["tokens"].numpy().copy(), cache_len, out[0]))
            return out

        eng._prefill = record
        out, _ = eng.generate(batch, 4)
        assert [s[1] for s in seen] == [cfg.n_patches + 9 + t for t in range(4)]
        for toks, cache_len, logits in seen:
            jb = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(batch["patches"])}
            jlogits, jc = japi.prefill(jcfg, jparams, jb, cache_len=cache_len)
            _close(logits, jlogits)
            assert int(jc.pos) == cache_len
        assert out.shape == (2, 4)


class TestEngines:
    @pytest.mark.parametrize("arch", [ENCDEC, VLM])
    def test_greedy_tokens_match_in_both_kv_modes(self, arch):
        """Greedy tokens: the port's KV-on and KV-off runs equal each other
        and the reference's KV-on run (and its KV-off run for encdec; the
        reference's KV-off engine cannot run vlm, see
        TestVLM.test_kv_off_forward_matches_the_reference_prefill)."""
        jcfg, jparams, cfg, params = carried(arch)
        batch = {"tokens": np.random.default_rng(7).integers(
            1, cfg.vocab_size, (2, 11)).astype(np.int32), **frontend(cfg, 2, seed=8)}
        ref, _ = JEngine(jcfg, jparams, kv_cache=True).generate(batch, STEPS)
        if cfg.family == "encdec":
            ref_off, _ = JEngine(jcfg, jparams, kv_cache=False).generate(batch, STEPS)
            np.testing.assert_array_equal(ref_off, ref)
        for kv in (True, False):
            out, stats = InferenceEngine(cfg, params, kv_cache=kv, device="cpu").generate(
                batch, STEPS)
            np.testing.assert_array_equal(out, np.asarray(ref))
            assert stats.tau_in == 11 and stats.tau_out == STEPS

    @pytest.mark.parametrize("arch", [ENCDEC, VLM])
    def test_measure_fn_supplies_the_frontend_inputs(self, arch):
        """measure_fn runs the engine with zero frames/patches, as the
        reference's does, in both KV modes; the inputs it builds have the
        reference's shapes and dtype."""
        cfg = get_config(arch)
        params = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                          torch.device("cpu"))
        calls = []
        for kv in (True, False):
            eng = InferenceEngine(cfg, params, kv_cache=kv, device="cpu")
            orig = eng._prefill

            def record(inputs, cache_len, orig=orig):
                calls.append({k: (tuple(v.shape), v.dtype, bool(v.any()))
                              for k, v in inputs.items() if k != "tokens"})
                return orig(inputs, cache_len)

            eng._prefill = record
            e, r = measure_fn(lambda: eng, 2, cfg.vocab_size)(5, 3)
            assert e == 0.0 and r > 0
        key = "patches" if cfg.family == "vlm" else "frames"
        jcfg = jget_config(arch)
        width = vlm.VISION_DIM if cfg.family == "vlm" else cfg.d_model
        n = cfg.n_patches if cfg.family == "vlm" else cfg.n_frames
        assert len(calls) == 1 + 3           # one KV-on prefill, three re-forwards
        assert all(c == {key: ((2, n, width), torch.float32, False)} for c in calls)
        # the reference's adapter builds the same shapes and runs
        jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
        je, jr = j_measure_fn(lambda: JEngine(jcfg, jparams, kv_cache=True), 2,
                              jcfg.vocab_size)(5, 3)
        assert je == 0.0 and jr > 0


# one config per family
FAMILY_ARCHS = {jget_config(a).family: a for a in sorted(J_ASSIGNED)}


class TestShapes:
    @pytest.mark.parametrize("shape", sorted(J_SHAPES))
    @pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
    def test_token_specs_match_the_reference(self, family, shape):
        arch = FAMILY_ARCHS[family]
        ours = token_specs(get_config(arch), INPUT_SHAPES[shape])
        ref = j_token_specs(jget_config(arch), J_SHAPES[shape])
        assert list(ours) == list(ref)
        for k, spec in ours.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(ref[k].shape), k
            assert str(spec.dtype).removeprefix("torch.") == str(ref[k].dtype), k

    def test_shapes_and_notes_match_the_reference(self):
        assert {k: vars(v) for k, v in INPUT_SHAPES.items()} == \
            {k: vars(v) for k, v in J_SHAPES.items()}
        for family, arch in FAMILY_ARCHS.items():
            assert long_context_note(get_config(arch)) == j_long_context_note(jget_config(arch))
        assert set(FAMILY_ARCHS) == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
