"""The engine's compiled steps: keyed as the reference's jitted programs.

The reference's `InferenceEngine` jits `prefill` (static `cache_len` and
`long_context`) and the decode step with its sampler, so XLA compiles one
program per input signature.  The port keeps one `_Step` per such key; on
CUDA each is a captured CUDA graph, on the CPU its body runs eagerly.
These tests hold, on the CPU:

- the number of steps a sequence of generate calls makes to the number of
  programs the reference's jits hold after the same calls (jax's own
  count, `_cache_size()`), KV on and off, for the dense, ssm, hybrid and
  vlm families (the reference's KV-off engine cannot run vlm: there the
  count comes from the static signatures, one program per length);
- that `_prepare`, which captures on CUDA before the meter's window,
  makes every step the calls then use (run here with a stand-in capture
  that registers each step as the CUDA path does, without a graph);
- that the static cache is written in place: after N decode steps its
  tensors are the same objects and `pos` is S0 + N;
- that a replay copies the inputs into the static buffers and adds the
  launches its capture recorded to the kernel modules' counts;
- that the CPU path runs eagerly (no step holds a graph) and its greedy
  tokens equal the reference engine's;
- that an engine is freed when its last reference goes (its steps close
  over its parts, not over it), so a served model's weights and graphs
  leave the card when the caller drops its engine.
"""

import dataclasses
import gc
import types
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_api as jget_api
from repro.serving import InferenceEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import cache as cachelib
from repro_torch.serving import InferenceEngine
from repro_torch.serving import engine as englib
from repro_torch.weights import from_jax_params

ARCHS = ["llama2-7b-reduced", "mamba2-130m-reduced", "recurrentgemma-9b-reduced",
         "internvl2-2b-reduced"]
# (prompt length, new tokens) of the generate calls, in order: repeated
# shapes, one prompt length under two cache lengths, one past the first
# bucket.  Every KV-off length stays <= 16, where the reference's ssm
# prefill runs (S % min(ssm_chunk, S) == 0).
CALLS = [(5, 3), (5, 3), (6, 2), (4, 4), (5, 6)]
BUCKET = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here (see tests/test_torch_engine.py:
    with several pytest-xdist workers the default threads oversubscribe
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    arch = request.param
    jcfg = jget_config(arch)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch)
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def batches(cfg, calls=CALLS, seed=3):
    """One batch of 2 per call: tokens, and patches for vlm."""
    rng = np.random.default_rng(seed)
    for s0, new in calls:
        b = {"tokens": rng.integers(1, cfg.vocab_size, (2, s0)).astype(np.int32)}
        if cfg.family == "vlm":
            b["patches"] = rng.standard_normal((2, cfg.n_patches, 1024)).astype(np.float32)
        yield b, new


def run(engine, cfg, calls=CALLS):
    return [engine.generate(b, new)[0] for b, new in batches(cfg, calls)]


class FakeCapture:
    """Stands in for `InferenceEngine._capture` on the CPU: the warm-up's
    eager run of the body (which makes a KV-on static cache) and the
    step's registration, as the CUDA path does, without a graph."""

    def __init__(self, engine):
        self.engine, self.keys = engine, []
        engine.graphed = True
        engine._capture = self

    def __call__(self, step):
        step.outputs = step.body()
        self.engine.steps[step.key] = step
        self.keys.append(step.key)


class TestProgramCount:
    @pytest.mark.parametrize("kv_cache", [True, False])
    def test_steps_equal_the_reference_programs(self, carried, kv_cache):
        jcfg, jparams, cfg, params = carried
        eng = InferenceEngine(cfg, params, kv_cache=kv_cache, bucket=BUCKET, device="cpu")
        ours = run(eng, cfg)
        assert all(s.graph is None for s in eng.steps.values())
        prefills = {k for k in eng.steps if k[0] == "prefill"}
        decodes = {k for k in eng.steps if k[0] == "decode"}
        if kv_cache or cfg.family != "vlm":
            ref = JEngine(jcfg, jparams, kv_cache=kv_cache, bucket=BUCKET)
            theirs = run(ref, cfg)
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)
            assert len(prefills) == ref._prefill._cache_size()
            assert len(decodes) == (ref._decode._cache_size() if kv_cache else 0)
        else:
            # one program per sequence length, as the reference would compile
            lengths = {s0 + t for s0, new in CALLS for t in range(new)}
            assert len(prefills) == len(lengths) and not decodes

    @pytest.mark.parametrize("kv_cache", [True, False])
    def test_prepare_makes_every_step_the_calls_use(self, carried, kv_cache):
        _, _, cfg, params = carried
        ref = run(InferenceEngine(cfg, params, kv_cache=kv_cache, bucket=BUCKET,
                                  device="cpu"), cfg)
        eng = InferenceEngine(cfg, params, kv_cache=kv_cache, bucket=BUCKET, device="cpu")
        capture = FakeCapture(eng)
        ours = run(eng, cfg)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        # every step was made before its call, none twice; a missing one raises
        assert sorted(capture.keys, key=repr) == sorted(eng.steps, key=repr)
        assert len(set(capture.keys)) == len(capture.keys)
        assert set(k[0] for k in capture.keys) == ({"prefill", "decode"} if kv_cache
                                                    else {"prefill"})
        with pytest.raises(RuntimeError, match="no CUDA graph was captured"):
            eng._prefill({"tokens": torch.zeros((3, 5), dtype=torch.int32)}, 8)

    def test_kv_off_lengths_are_captured_longest_first(self, carried):
        _, _, cfg, params = carried
        eng = InferenceEngine(cfg, params, kv_cache=False, bucket=BUCKET, device="cpu")
        capture = FakeCapture(eng)
        (b, _), = batches(cfg, [(4, 5)])
        eng.generate(b, 5)
        lengths = [dict((n, s) for n, s, _ in k[1])["tokens"][1] for k in capture.keys]
        assert lengths == [8, 7, 6, 5, 4]


class TestStaticCache:
    def test_decode_writes_the_static_cache_in_place(self, carried):
        _, _, cfg, params = carried
        eng = InferenceEngine(cfg, params, kv_cache=True, bucket=BUCKET, device="cpu")
        (b, _), = batches(cfg, [(5, 3)])
        inputs = {"tokens": torch.as_tensor(b["tokens"]), **eng._extra_inputs(b)}
        logits, cache = eng._prefill(inputs, 32)
        assert list(eng._caches.values()) == [cache]
        before = [id(t) for _, t in englib._tensors(cache)]
        token = eng.sampler(logits, eng.generator)
        n = 4
        for _ in range(n):
            token, out = eng._decode(cache, token)
            assert out is cache
        assert [id(t) for _, t in englib._tensors(cache)] == before
        P = cfg.n_patches if cfg.family == "vlm" else 0
        assert int(cache.pos) == P + 5 + n
        # the token buffer is the decode step's own, written in place
        assert token is eng.steps[eng._decode_key(cache, token)].inputs["token"]
        # a second prefill of the same shapes refills the same tensors
        eng._prefill(inputs, 32)
        assert [id(t) for _, t in englib._tensors(cache)] == before
        assert int(cache.pos) == P + 5

    def test_a_decode_step_that_returns_new_tensors_is_refused(self, carried, monkeypatch):
        _, _, cfg, params = carried
        eng = InferenceEngine(cfg, params, kv_cache=True, bucket=BUCKET, device="cpu")
        (b, _), = batches(cfg, [(5, 3)])
        logits, cache = eng._prefill({"tokens": torch.as_tensor(b["tokens"]),
                                      **eng._extra_inputs(b)}, 32)
        orig = eng.api.decode_step

        def copying(cfg_, params_, c, batch):
            lg, new = orig(cfg_, params_, c, batch)
            first = next(f.name for f in dataclasses.fields(new) if f.name != "pos")
            return lg, dataclasses.replace(new, **{first: getattr(new, first).clone()})

        monkeypatch.setattr(eng, "api", types.SimpleNamespace(decode_step=copying))
        with pytest.raises(RuntimeError, match="written in place"):
            eng._decode(cache, eng.sampler(logits, eng.generator))


class TestReplay:
    def test_a_replay_copies_inputs_and_counts_the_recorded_launches(self):
        calls = []
        static = {"batch": {"tokens": torch.zeros((2, 3), dtype=torch.int32)}}
        step = englib._Step(("prefill",), static, lambda: calls.append(1))
        mod = types.SimpleNamespace(launches=5)
        replays = []
        step.graph = types.SimpleNamespace(replay=lambda: replays.append(1))
        step.outputs = ("logits", None)
        step.launches = ((mod, 3),)
        src = {"batch": {"tokens": torch.arange(6, dtype=torch.int32).reshape(2, 3)}}
        assert step(src) == ("logits", None)
        assert step(src) == ("logits", None)
        assert mod.launches == 11 and len(replays) == 2 and not calls
        assert torch.equal(static["batch"]["tokens"], src["batch"]["tokens"])

    def test_signature_names_shapes_and_dtypes(self):
        c = cachelib.KVCache(torch.zeros((2, 1, 8, 2, 4)), torch.zeros((2, 1, 8, 2, 4)),
                             torch.zeros((), dtype=torch.int32))
        sig = englib.signature({"cache": c, "token": torch.zeros(1, dtype=torch.int32)})
        assert sig == (("cache.k", (2, 1, 8, 2, 4), torch.float32),
                       ("cache.v", (2, 1, 8, 2, 4), torch.float32),
                       ("cache.pos", (), torch.int32),
                       ("token", (1,), torch.int32))
        meta = torch.empty((1,), dtype=torch.int32, device="meta")
        assert englib.signature(meta) == englib.signature(torch.zeros(1, dtype=torch.int32))

    def test_the_kernel_modules_keep_a_launch_count(self):
        for mod in englib.KERNELS:
            assert isinstance(mod.launches, int)


class TestLifetime:
    @pytest.mark.parametrize("kv_cache", [True, False])
    def test_an_engine_is_freed_without_the_garbage_collector(self, carried, kv_cache):
        _, _, cfg, params = carried
        eng = InferenceEngine(cfg, params, kv_cache=kv_cache, bucket=BUCKET, device="cpu")
        run(eng, cfg, CALLS[:2])
        assert eng.steps
        ref = weakref.ref(eng)
        gc.disable()
        try:
            del eng
            assert ref() is None
        finally:
            gc.enable()
