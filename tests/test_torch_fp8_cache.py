"""float8_e4m3fn KV caches in the PyTorch port against the JAX package.

The reference runs `cache_dtype="float8_e4m3fn"` through the dense and
hybrid decode (`repro.models.common`, `repro.models.cache.onehot_write`,
`repro.models.attention.decode_attention`).  Here the port is held to it:
the cast of a value into the cache (NaN past the largest finite value, as
the reference's cast gives, where torch's cast saturates), the prefill
caches (equal), the decode logits of four reduced models over several
steps (1e-4, f32 models: the caches round alike, the rest is reduction
order) and the plain B1 over an fp8 cache (1e-4 with q in f32, 2e-2 with
q in bf16, the gates of tests/test_torch_kernels.py).  At llama2-7b's
widths (bf16, two layers) the fp8-vs-bf16 cache gap of the port equals the
reference's within the bf16 noise between the two packages.  On a card the
kernel's fp8 path is checked by tests/test_torch_kernels_gpu.py and
`chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import get_api as jget_api
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as kda
from repro_torch.models import cache, get_api
from repro_torch.weights import from_jax_params

F8 = "float8_e4m3fn"
# (arch, prompt length, decode steps): the mistral ring (64 slots) and the
# recurrentgemma ring (32 slots) wrap during the steps.
ARCHS = [("llama2-7b-reduced", 20, 4), ("qwen3-1.7b-reduced", 20, 4),
         ("mistral-7b-reduced", 60, 6), ("recurrentgemma-9b-reduced", 30, 4)]
VALUES = [448.0, 464.0, 465.0, 500.0, np.inf, -np.inf, -448.0, -464.0, -465.0, -500.0,
          0.0, -0.0, 1e-3, -1e-4, 240.5, -17.3, 3e-3]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port tests do: with
    several pytest-xdist workers its default threads oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_of_reference_cast(x, dtype):
    cast = jax.jit(lambda a: a.astype(jnp.dtype(dtype)).astype(jnp.float8_e4m3fn))
    return np.asarray(cast(jnp.asarray(x))).view(np.uint8)


class TestCast:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_cast_matches_the_reference(self, dtype):
        x = np.array(VALUES, np.float32)
        ours = cache.to_cache_dtype(torch.as_tensor(x).to(getattr(torch, dtype)),
                                    torch.float8_e4m3fn)
        assert ours.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(ours.view(torch.uint8).numpy(),
                                      _bits_of_reference_cast(x, dtype))

    def test_torch_alone_saturates(self):
        """The fact the helper repairs: torch's own cast gives +-448."""
        x = torch.tensor([465.0, 500.0, float("inf"), -500.0])
        np.testing.assert_array_equal(x.to(torch.float8_e4m3fn).float().numpy(),
                                      [448.0, 448.0, 448.0, -448.0])
        assert torch.isnan(cache.to_cache_dtype(x, torch.float8_e4m3fn).float()).all()

    def test_other_cache_dtypes_cast_as_torch(self):
        x = torch.tensor(VALUES)
        for dtype in (torch.float32, torch.bfloat16):
            assert torch.equal(cache.to_cache_dtype(x, dtype), x.to(dtype))

    def test_write_token_writes_one_fp8_slot(self):
        rng = np.random.default_rng(0)
        c = torch.as_tensor(rng.normal(size=(2, 7, 3, 4)).astype(np.float32)).to(
            torch.float8_e4m3fn)
        before = c.clone()
        new = torch.as_tensor(rng.normal(size=(2, 3, 4)).astype(np.float32) * 300)
        new[0, 0, 0] = 1000.0
        cache.write_token(c, new, torch.tensor(5, dtype=torch.int32))
        keep = torch.ones(7, dtype=torch.bool)
        keep[5] = False
        assert torch.equal(c.view(torch.uint8)[:, keep], before.view(torch.uint8)[:, keep])
        np.testing.assert_array_equal(
            c.view(torch.uint8)[:, 5].numpy(),
            _bits_of_reference_cast(new.numpy(), "float32"))
        assert torch.isnan(c[0, 5, 0, 0].float())


def _carried(arch):
    """(reference cfg, params) and (port cfg, params) with an fp8 cache."""
    jcfg = jget_config(arch).replace(cache_dtype=F8)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch).replace(cache_dtype=F8)
    return jcfg, jparams, cfg, from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")


def _same_values(ours, ref):
    """Cache contents equal as values (NaN equal to NaN; the reference's
    blend may turn a -0 into +0)."""
    assert ours.dtype == torch.float8_e4m3fn and ref.dtype == jnp.float8_e4m3fn
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


class TestModels:
    @pytest.mark.parametrize("arch,prompt,steps", ARCHS)
    def test_prefill_caches_and_decode_logits_match(self, arch, prompt, steps):
        jcfg, jparams, cfg, params = _carried(arch)
        japi, api = jget_api(jcfg), get_api(cfg)
        rng = np.random.default_rng(3)
        toks = rng.integers(1, cfg.vocab_size, (2, prompt)).astype(np.int32)
        kw = {} if cfg.family == "hybrid" else {"cache_len": prompt + 16}
        jlogits, jc = jax.jit(lambda p, b: japi.prefill(jcfg, p, b, **kw))(
            jparams, {"tokens": jnp.asarray(toks)})
        logits, c = api.prefill(cfg, params, {"tokens": torch.as_tensor(toks)}, **kw)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
        _same_values(c.k, jc.k)
        _same_values(c.v, jc.v)
        jstep = jax.jit(lambda p, c, t: japi.decode_step(jcfg, p, c, {"token": t}))
        for _ in range(steps):
            tok = rng.integers(1, cfg.vocab_size, (2,)).astype(np.int32)
            jlogits, jc = jstep(jparams, jc, jnp.asarray(tok))
            logits, c = api.decode_step(cfg, params, c, {"token": torch.as_tensor(tok)})
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       atol=1e-4, rtol=1e-4)
        _same_values(c.k, jc.k)
        _same_values(c.v, jc.v)


MODEL_CASES = [             # (B, Hq, Hkv, D, S, pos, ring, softcap)
    (2, 4, 2, 32, 80, 3, False, 0.0),
    (2, 4, 2, 32, 80, 79, False, 0.0),
    (2, 4, 2, 32, 64, 70, True, 0.0),
    (2, 8, 1, 64, 96, 40, False, 2.0),
    (1, 16, 2, 128, 130, 129, True, 5.0),
    (2, 16, 1, 256, 64, 20, True, 0.0),
]


class TestPlainKernel:
    @pytest.mark.parametrize("qdtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
    @pytest.mark.parametrize("case", MODEL_CASES)
    def test_plain_b1_matches_the_model_path(self, case, qdtype, tol):
        B, Hq, Hkv, D, S, pos, ring, softcap = case
        rng = np.random.default_rng(S)
        q = rng.normal(size=(B, Hq, D)).astype(np.float32)
        k8, v8 = (rng.normal(size=(B, S, Hkv, D)).astype(ml_dtypes.float8_e4m3fn)
                  for _ in range(2))
        tq = torch.as_tensor(q).to(getattr(torch, qdtype))
        tk, tv = (torch.as_tensor(a.view(np.uint8)).view(torch.float8_e4m3fn) for a in (k8, v8))
        ours = kda.decode_attention(tq, tk, tv, torch.tensor(pos, dtype=torch.int32),
                                    ring=ring, softcap=softcap)
        ref = jattn.decode_attention(jnp.asarray(q, jnp.dtype(qdtype)), jnp.asarray(k8),
                                     jnp.asarray(v8), jnp.asarray(pos, jnp.int32),
                                     ring=ring, softcap=softcap)
        assert ours.dtype == tq.dtype
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)


class TestFullWidthGap:
    def test_fp8_gap_matches_the_reference_at_llama2_7b_width(self):
        """llama2-7b's widths (d_model 4096, 32 x 128 heads, d_ff 11008,
        bf16) at 2 layers, the vocabulary cut to 4096 (mean |delta logit|
        is a mean per logit, so fewer head columns do not change what it
        measures), weights carried by value.  Per decode step, the gap is
        the mean |delta logit| between the fp8-cache and the bf16-cache
        decode of the same tokens.  The port's gap (plain B1 on the CPU)
        must equal the reference's within the bf16 noise between the two
        packages: the mean |delta logit| of their bf16-cache logits.  The
        gap itself must stand well above that noise.  With `-s` it prints
        the gaps per step."""
        widths = dict(n_layers=2, vocab_size=4096)
        jcfg = jget_config("llama2-7b").replace(**widths)
        jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
        cfg = get_config("llama2-7b").replace(**widths)
        params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
        toks = np.random.default_rng(5).integers(1, 4096, (4, 16)).astype(np.int32)
        logits = {}
        for cd in ("bfloat16", F8):
            jc_, c_ = jcfg.replace(cache_dtype=cd), cfg.replace(cache_dtype=cd)
            japi, api = jget_api(jc_), get_api(c_)
            _, jc = jax.jit(lambda p, b: japi.prefill(jc_, p, b, cache_len=48))(
                jparams, {"tokens": jnp.asarray(toks[:, :12])})
            _, c = api.prefill(c_, params, {"tokens": torch.as_tensor(toks[:, :12])},
                               cache_len=48)
            jstep = jax.jit(lambda p, c, t: japi.decode_step(jc_, p, c, {"token": t}))
            logits[cd] = ([], [])
            for t in range(12, 16):
                jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, t]))
                pl, c = api.decode_step(c_, params, c, {"token": torch.as_tensor(toks[:, t])})
                logits[cd][0].append(np.asarray(jl, np.float32))
                logits[cd][1].append(pl.float().numpy())
        for step in range(4):
            ref_bf, port_bf = (x[step] for x in logits["bfloat16"])
            ref_f8, port_f8 = (x[step] for x in logits[F8])
            ref_gap, port_gap = np.abs(ref_f8 - ref_bf).mean(), np.abs(port_f8 - port_bf).mean()
            noise = np.abs(port_bf - ref_bf).mean()
            print(f"step {step}: fp8-vs-bf16 cache gap, reference {ref_gap:.5f}, port "
                  f"{port_gap:.5f}; bf16 noise between the packages {noise:.5f}")
            assert abs(port_gap - ref_gap) <= noise, (step, ref_gap, port_gap, noise)
            assert ref_gap > 3 * noise, (step, ref_gap, noise)
