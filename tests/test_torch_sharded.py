"""The port sharded: qwen3-1.7b-reduced and granite-moe-3b-a800m-reduced
on a 2 x 2 ("data", "model") mesh of four gloo CPU ranks, against the
reference run whole, weights carried by value.

  * prefill + 8 greedy decode steps under the decode rules: the cache
    sharded along S, B1's plain version on each shard, the shards merged
    by their log-sum-exps (`models.attention`); logits within 1e-4, greedy
    tokens identical;
  * one FSDP step's gradients under the train rules, within
    1e-4 x max(1, max|g|), each in its parameter's placements;
  * the MoE forward with the experts sharded (the dispatch's all-to-all);
  * DTensor's split order for a dim sharded over two mesh axes.

The four ranks are processes of `tests/torch_sharded_worker.py`, started
once for the module; rank 0 writes what they computed."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_api as jget_api
from repro_torch.checkpoint import flatten_tree
from repro_torch.kernels import decode_attention as kda

ROOT = Path(__file__).resolve().parents[1]
B, PROMPT, CACHE_LEN, STEPS = 4, 12, 32, 8
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np_tree(prefix, params) -> dict:
    return {prefix + path: np.asarray(v) for path, v in
            flatten_tree(jax.tree.map(np.asarray, params))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(reference results, the ranks' results)."""
    tmp = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    ref: dict = {}

    jcfg = jget_config("qwen3-1.7b-reduced")
    japi = jget_api(jcfg)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    prompt = rng.integers(1, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    logits, cache = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)},
                                 cache_len=CACHE_LEN)
    steps = [np.asarray(logits)]
    for _ in range(STEPS):
        tok = jnp.asarray(steps[-1].argmax(-1).astype(np.int32))
        logits, cache = japi.decode_step(jcfg, jparams, cache, {"token": tok})
        steps.append(np.asarray(logits))
    ref["qwen_logits"] = np.stack(steps)

    tokens = rng.integers(1, jcfg.vocab_size, (B, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, 16)).astype(np.int32)
    labels[:, -2:] = -1
    loss, grads = jax.value_and_grad(
        lambda p: japi.train_loss(jcfg, p, {"tokens": tokens, "labels": labels})[0])(jparams)
    ref["train_loss"] = np.asarray(loss)
    ref["grads"] = dict(flatten_tree(jax.tree.map(np.asarray, grads)))

    gcfg = jget_config("granite-moe-3b-a800m-reduced")
    gapi = jget_api(gcfg)
    gparams = gapi.init_params(gcfg, jax.random.PRNGKey(1))
    gtokens = rng.integers(1, gcfg.vocab_size, (B, 16)).astype(np.int32)
    glogits, _ = gapi.prefill(gcfg, gparams, {"tokens": jnp.asarray(gtokens)}, cache_len=16)
    ref["granite_logits"] = np.asarray(glogits)

    src = tmp / "in.npz"
    np.savez(src, prompt=prompt, cache_len=CACHE_LEN, steps=STEPS, train_tokens=tokens,
             train_labels=labels, granite_tokens=gtokens, granite_cache_len=16,
             **_np_tree("qwen/", jparams), **_np_tree("granite/", gparams))
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_sharded_worker.py"),
                               str(r), "4", port, str(src), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        logs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    got = np.load(tmp / "out.npz")
    return ref, {k: got[k] for k in got.files}


def test_decode_rules_shard_the_cache_along_s(run):
    _, got = run
    assert bool(got["k_seq_sharded"])


def test_sharded_prefill_and_decode_logits(run):
    ref, got = run
    assert got["qwen_logits"].shape == ref["qwen_logits"].shape
    np.testing.assert_allclose(got["qwen_logits"], ref["qwen_logits"], rtol=0, atol=TOL)


def test_sharded_greedy_tokens_identical(run):
    ref, got = run
    assert (got["qwen_logits"].argmax(-1) == ref["qwen_logits"].argmax(-1)).all()


def test_fsdp_gradients(run):
    ref, got = run
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-5, atol=0)
    for path, g in ref["grads"].items():
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got["grad/" + path], g, rtol=0, atol=TOL * scale,
                                   err_msg=path)
        assert bool(got["grad_fsdp/" + path]), path


def test_moe_forward_with_sharded_experts(run):
    ref, got = run
    assert bool(got["experts_sharded"])
    np.testing.assert_allclose(got["granite_logits"], ref["granite_logits"], rtol=0, atol=TOL)


def test_two_axis_split_is_major_first(run):
    _, got = run
    assert bool(got["split_order_ok"])


@pytest.mark.parametrize("ring", [False, True])
def test_plain_lse_is_logsumexp_of_the_valid_scores(ring):
    """decode_attention_plain's LSE against numpy's on the same masked,
    scaled, softcapped scores."""
    rng = np.random.default_rng(3)
    Bq, Hq, Hkv, S, D, pos, cap = 2, 4, 2, 24, 16, 13, 30.0
    q = rng.normal(size=(Bq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(Bq, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(Bq, S, Hkv, D)).astype(np.float32)
    out, lse = kda.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), pos, ring=ring,
                                          softcap=cap, lse=True)
    assert out.shape == (Bq, Hq, D) and lse.shape == (Bq, Hq) and lse.dtype == torch.float32
    qg = q.reshape(Bq, Hkv, Hq // Hkv, D).astype(np.float64)
    s = np.einsum("bhgd,bkhd->bhgk", qg, k.astype(np.float64)) / np.sqrt(D)
    s = np.tanh(s / cap) * cap
    s = s[..., : pos + 1]
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(Bq, Hq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
