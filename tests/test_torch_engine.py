"""The PyTorch port's inference engine against the JAX package's.

Greedy tokens must be identical to the reference engine's, with the same
weights (carried by value), in both KV modes, and the port's two modes
must agree with each other.  Sampled tokens come from a torch.Generator
and are checked within the port only.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_api as jget_api
from repro.serving import InferenceEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.energy.meter import WallClockMeter
from repro_torch.models import get_api
from repro_torch.serving import InferenceEngine, Sampler, measure_fn
from repro_torch.weights import from_jax_params

FLEET = ["llama2-7b-reduced", "llama2-13b-reduced", "llama2-70b-reduced",
         "mistral-7b-reduced",
         # assigned dense archs: QKV bias (qwen2.5), qk-norm (qwen3)
         "qwen2.5-14b-reduced", "qwen3-1.7b-reduced", "llama3.2-3b-reduced",
         "deepseek-67b-reduced"]
# (prompt length, new tokens): mistral's prompt runs past its 64-slot ring
SHAPES = {"mistral-7b-reduced": (60, 8)}


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


@pytest.fixture(scope="module", params=FLEET)
def fleet_model(request):
    arch = request.param
    jcfg = jget_config(arch)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch)
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    s0, new = SHAPES.get(arch, (9, 5))
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, s0)).astype(np.int32)
    return jcfg, jparams, cfg, params, toks, new


@pytest.fixture(scope="module")
def small():
    """A reduced model with the port's own seeded weights."""
    cfg = get_config("llama2-7b-reduced")
    params = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                      torch.device("cpu"))
    return cfg, params


class TestGreedyAgainstReference:
    @pytest.mark.parametrize("kv_cache", [True, False])
    def test_tokens_identical_to_jax_engine(self, fleet_model, kv_cache):
        jcfg, jparams, cfg, params, toks, new = fleet_model
        ref, _ = JEngine(jcfg, jparams, kv_cache=kv_cache, bucket=16).generate(
            {"tokens": toks}, new)
        ours, _ = InferenceEngine(cfg, params, kv_cache=kv_cache, bucket=16,
                                  device="cpu").generate({"tokens": toks}, new)
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, ref)

    def test_port_kv_modes_agree(self, fleet_model):
        _, _, cfg, params, toks, new = fleet_model
        a, _ = InferenceEngine(cfg, params, kv_cache=True, bucket=8,
                               device="cpu").generate({"tokens": toks}, new)
        b, _ = InferenceEngine(cfg, params, kv_cache=False,
                               device="cpu").generate({"tokens": toks}, new)
        np.testing.assert_array_equal(a, b)


class TestEngine:
    @pytest.mark.parametrize("kv_cache", [True, False])
    def test_stats_and_meter(self, small, kv_cache):
        cfg, params = small
        meter = WallClockMeter()
        eng = InferenceEngine(cfg, params, kv_cache=kv_cache, meter=meter, bucket=8,
                              device="cpu")
        out, stats = eng.generate({"tokens": np.ones((2, 8), np.int32)}, 4)
        assert out.shape == (2, 4)
        assert ((out >= 0) & (out < cfg.vocab_size)).all()
        assert stats.tau_in == 8 and stats.tau_out == 4
        assert stats.prefill_s > 0 and stats.decode_s > 0
        assert stats.energy_j > 0 and stats.decode_energy_j > 0
        assert meter.total_j > 0 and meter.total_s > 0
        assert stats.tokens_per_s > 0

    def test_measure_fn(self, small):
        cfg, params = small
        measure = measure_fn(lambda: InferenceEngine(cfg, params, kv_cache=False,
                                                     meter=WallClockMeter(), device="cpu"),
                             2, cfg.vocab_size)
        energy, runtime = measure(8, 3)
        assert energy > 0 and runtime > 0

    def test_temperature_sampling_is_seeded(self, small):
        cfg, params = small
        toks = np.ones((2, 8), np.int32)

        def sample(seed, top_k=0):
            eng = InferenceEngine(cfg, params, kv_cache=True, bucket=8, seed=seed,
                                  sampler=Sampler(temperature=1.0, top_k=top_k),
                                  device="cpu")
            return eng.generate({"tokens": toks}, 6)[0]

        np.testing.assert_array_equal(sample(42), sample(42))
        greedy = InferenceEngine(cfg, params, kv_cache=True, bucket=8,
                                 device="cpu").generate({"tokens": toks}, 6)[0]
        np.testing.assert_array_equal(sample(3, top_k=1), greedy)

    def test_top_k_keeps_the_k_largest(self):
        logits = torch.tensor([[0.0, 5.0, 1.0, 4.0, -2.0, 3.0]])
        gen = torch.Generator().manual_seed(0)
        sampler = Sampler(temperature=2.0, top_k=3)
        drawn = {int(sampler(logits, gen)[0]) for _ in range(200)}
        assert drawn == {1, 3, 5}
        assert Sampler()(logits, gen).dtype == torch.int32

    def test_refuses_cuda_without_a_card_and_params_elsewhere(self, small, monkeypatch):
        cfg, params = small
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(cfg, params)
        with pytest.raises(ValueError, match="params live on"):
            InferenceEngine(cfg, {"embed": params["embed"].to("meta")}, device="cpu")
