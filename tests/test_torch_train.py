"""The port's training path against the JAX package: every family's
`train_loss` and its gradients, `maybe_remat`, the MoE dispatch/combine
VJPs, the microbatched train step and `launch/train.py`.

Weights move by value through `repro_torch.weights.from_jax_params`;
tokens, labels, frames and patches are drawn with numpy.  The reduced
configs are f32 with remat off.  Each loss must match the reference's
`jax.value_and_grad` within rel 1e-5 and each gradient leaf within
1e-4 x max(1, max|g_ref|): f32 throughout, the frameworks differ only in
reduction order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import get_api as jget_api
from repro.models import moe as jmoe
from repro_torch.checkpoint import flatten_tree
from repro_torch.configs import get_config
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import build_train_step, value_and_grad
from repro_torch.models import get_api, moe
from repro_torch.weights import from_jax_params

B, S = 2, 16
# (test id, arch, config fields replaced in both packages)
FAMILIES = [
    ("llama2", "llama2-7b-reduced", {}),
    ("qwen3", "qwen3-1.7b-reduced", {}),
    ("qwen3-tied", "qwen3-1.7b-reduced", {"tie_embeddings": True}),
    ("mixtral", "mixtral-8x7b-reduced", {}),
    ("granite", "granite-moe-3b-a800m-reduced", {}),
    ("granite-drops", "granite-moe-3b-a800m-reduced", {"capacity_factor": 0.25}),
    ("granite-chunks", "granite-moe-3b-a800m-reduced", {"moe_token_chunk": B * S // 2}),
    ("deepseek-absorb", "deepseek-v3-671b-reduced", {"mla_absorb": True}),
    ("deepseek-expand", "deepseek-v3-671b-reduced", {"mla_absorb": False}),
    ("mamba2", "mamba2-130m-reduced", {}),
    ("recurrentgemma", "recurrentgemma-9b-reduced", {}),
    ("seamless", "seamless-m4t-large-v2-reduced", {}),
    ("internvl2", "internvl2-2b-reduced", {}),
]
IDS = [f[0] for f in FAMILIES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port tests do: with
    several pytest-xdist workers its default threads oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(arch, seed=0, **fields):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = jget_config(arch).replace(**fields)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = get_config(arch).replace(**fields)
    return jcfg, jparams, cfg, from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")


def np_batch(cfg, seed=0, batch=B, seq=S) -> dict:
    """Tokens and next-token labels (a few ignored, -1), with the frames
    or patches the encdec and vlm families read."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels[:, -2:] = -1
    out = {"tokens": rng.integers(1, cfg.vocab_size, (batch, seq)).astype(np.int32),
           "labels": labels}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(batch, cfg.n_patches, 1024)).astype(np.float32)
    return out


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def ref_value_and_grad(jcfg, jparams, batch):
    api = jget_api(jcfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: api.train_loss(jcfg, p, b)[0]))
    loss, grads = fn(jparams, jax.tree.map(jnp.asarray, batch))
    return float(loss), dict(flatten_tree(jax.tree.map(np.asarray, grads)))


def port_value_and_grad(cfg, params, batch):
    api = get_api(cfg)
    loss, grads = value_and_grad(lambda p, b: api.train_loss(cfg, p, b)[0], params,
                                 torch_batch(batch))
    return float(loss), {k: v.numpy() for k, v in flatten_tree(grads)}


def assert_grads_close(ours: dict, ref: dict, bf16_rounds: int = 0):
    """Each leaf within 1e-4 x max(1, max|g_ref|), plus one bf16 ulp of
    the leaf's largest gradient (2^-7 of it) per bf16 rounding the two
    packages may flip apart (`bf16_rounds`)."""
    assert ours.keys() == ref.keys()
    for path, g_ref in ref.items():
        top = float(np.abs(g_ref).max())
        tol = 1e-4 * max(1.0, top) + bf16_rounds * 2.0 ** -7 * top
        np.testing.assert_allclose(ours[path], g_ref, rtol=0, atol=tol, err_msg=path)


class TestTrainLoss:
    @pytest.mark.parametrize("arch,fields", [f[1:] for f in FAMILIES], ids=IDS)
    def test_loss_and_grads_match_reference(self, arch, fields):
        jcfg, jparams, cfg, params = carried(arch, **fields)
        batch = np_batch(cfg)
        ref_loss, ref_grads = ref_value_and_grad(jcfg, jparams, batch)
        loss, grads = port_value_and_grad(cfg, params, batch)
        assert loss == pytest.approx(ref_loss, rel=1e-5)
        assert_grads_close(grads, ref_grads)
        assert all(np.isfinite(g).all() for g in grads.values())

    def test_capacity_drops_happen(self):
        """The forced-drop case really drops pairs, and the default one at
        this size keeps them all: both dispatch paths are covered."""
        _, _, cfg, params = carried("granite-moe-3b-a800m-reduced", capacity_factor=0.25)
        pl = {k: v[0] for k, v in params["blocks"]["moe_blocks"]["moe"].items()}
        x = torch.randn(B * S, cfg.d_model, generator=torch.Generator().manual_seed(0))
        _, _, eidx = moe.route(cfg, pl["router"], x)
        tab = moe.dispatch_tables(eidx, cfg.n_experts, moe.expert_capacity(B * S, cfg))
        assert not bool(tab.keep.all())

    @pytest.mark.parametrize("arch,fields", [f[1:] for f in FAMILIES], ids=IDS)
    def test_metrics_match_reference(self, arch, fields):
        """The MoE aux and MTP losses the step reports equal the reference's."""
        jcfg, jparams, cfg, params = carried(arch, **fields)
        batch = np_batch(cfg, seed=1)
        _, jm = jax.jit(lambda p, b: jget_api(jcfg).train_loss(jcfg, p, b))(
            jparams, jax.tree.map(jnp.asarray, batch))
        with torch.no_grad():
            _, m = get_api(cfg).train_loss(cfg, params, torch_batch(batch))
        assert m.keys() == jm.keys()
        for k in m:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7)


class TestRemat:
    @pytest.mark.parametrize("arch", ["qwen3-1.7b-reduced", "granite-moe-3b-a800m-reduced",
                                      "deepseek-v3-671b-reduced", "mamba2-130m-reduced",
                                      "recurrentgemma-9b-reduced",
                                      "seamless-m4t-large-v2-reduced"])
    def test_remat_grads_bitwise_equal(self, arch):
        _, _, cfg, params = carried(arch)
        batch = np_batch(cfg)
        loss0, g0 = port_value_and_grad(cfg, params, batch)
        loss1, g1 = port_value_and_grad(cfg.replace(remat=True), params, batch)
        assert loss0 == loss1
        for k in g0:
            np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)

    def test_remat_recomputes_each_layer(self, monkeypatch):
        """With remat on, each layer's forward runs again in the backward
        pass (nothing inside it saved); with it off, once."""
        from repro_torch.models import dense
        _, _, cfg, params = carried("qwen3-1.7b-reduced")
        calls = []
        orig = dense.attention_full
        monkeypatch.setattr(dense, "attention_full",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
        for remat, want in ((False, cfg.n_layers), (True, 2 * cfg.n_layers)):
            calls.clear()
            port_value_and_grad(cfg.replace(remat=remat), params, np_batch(cfg))
            assert len(calls) == want


def _x64():
    """f64 in jax: `jax.enable_x64` since jax 0.9, `jax.experimental`'s before."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    return jax.experimental.enable_x64()


def _dispatch_case():
    """Tables of a tiny dispatch (T=5, K=2, E=3, C=3) with empty slots and
    dropped pairs, from the port's `dispatch_tables`."""
    eidx = torch.tensor([[0, 1], [0, 2], [0, 1], [1, 0], [0, 2]])
    tab = moe.dispatch_tables(eidx, 3, 3)
    assert int((tab.slot2tok == 5).sum()) > 0          # an empty slot (expert 2)
    assert int((tab.tok2slot == 9).sum()) > 0          # a dropped pair (expert 0)
    return tab


class TestDispatchCombineVJP:
    def test_gradcheck_f64(self):
        tab = _dispatch_case()
        g = torch.Generator().manual_seed(0)
        xt = torch.randn(5, 4, dtype=torch.float64, generator=g, requires_grad=True)
        y = torch.randn(3, 3, 4, dtype=torch.float64, generator=g, requires_grad=True)
        gates = torch.rand(5, 2, dtype=torch.float64, generator=g, requires_grad=True)
        assert torch.autograd.gradcheck(
            lambda x: moe._Dispatch.apply(x, tab.slot2tok, tab.tok2slot), (xt,))
        assert torch.autograd.gradcheck(
            lambda yy, gg: moe._Combine.apply(yy, gg, tab.tok2slot, tab.slot2pair),
            (y, gates))

    def test_grads_equal_reference_custom_vjp(self):
        tab = _dispatch_case()
        rng = np.random.default_rng(0)
        xt, y = rng.normal(size=(5, 4)), rng.normal(size=(3, 3, 4))
        gates = rng.random((5, 2))
        g_buf, g_out = rng.normal(size=(3, 3, 4)), rng.normal(size=(5, 4))
        s2t, t2s, s2p = (jnp.asarray(getattr(tab, n).numpy()) for n in
                         ("slot2tok", "tok2slot", "slot2pair"))
        with _x64():
            _, vjp = jax.vjp(lambda x: jmoe._dispatch(x, s2t, t2s), jnp.asarray(xt))
            ref_dx, = vjp(jnp.asarray(g_buf))
            _, vjp = jax.vjp(lambda a, b: jmoe._combine(a, b, t2s, s2p),
                             jnp.asarray(y), jnp.asarray(gates))
            ref_dy, ref_dg = vjp(jnp.asarray(g_out))
            ref = [np.asarray(a) for a in (ref_dx, ref_dy, ref_dg)]
        x_t, y_t, gates_t = (torch.tensor(a, requires_grad=True) for a in (xt, y, gates))
        moe._Dispatch.apply(x_t, tab.slot2tok, tab.tok2slot).backward(torch.tensor(g_buf))
        moe._Combine.apply(y_t, gates_t, tab.tok2slot, tab.slot2pair).backward(
            torch.tensor(g_out))
        for ours, want in zip((x_t.grad, y_t.grad, gates_t.grad), ref):
            np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=1e-6)

    def test_backward_gathers(self, monkeypatch):
        """The VJPs gather through the tables: no scatter or index_add runs
        in the dispatch/combine backward."""
        tab = _dispatch_case()
        ops = []

        class Log(torch.utils._python_dispatch.TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(str(func))
                return func(*args, **(kwargs or {}))

        xt = torch.randn(5, 4, requires_grad=True)
        y = torch.randn(3, 3, 4, requires_grad=True)
        gates = torch.rand(5, 2, requires_grad=True)
        out = moe._Combine.apply(moe._Dispatch.apply(xt, tab.slot2tok, tab.tok2slot) * y,
                                 gates, tab.tok2slot, tab.slot2pair)
        with Log():
            out.sum().backward()
        assert any("index_select" in op for op in ops)
        assert not [op for op in ops if "scatter" in op or "index_add" in op or
                    "index_put" in op]


# ---------------------------------------------------------------------------
# The microbatched train step
# ---------------------------------------------------------------------------


def _run_steps(optimizer, accum="float32", n_steps=3, lr=1e-3):
    """n_steps of both packages' build_train_step on qwen3-1.7b-reduced at
    batch 4, microbatch 2, from the same weights and batches.  Returns
    {"ref"/"port": (losses, final params, the gradients each step handed
    its optimizer)}, every tree flattened to numpy."""
    fields = dict(microbatch=2, optimizer=optimizer, grad_accum_dtype=accum)
    jcfg, jparams, cfg, params = carried("qwen3-1.7b-reduced", **fields)
    jstep, jopt = jbuild_train_step(jcfg, lr=lr)
    step, opt = build_train_step(cfg, lr=lr)
    out = {"ref": ([], None, []), "port": ([], None, [])}

    def record(name, to_numpy):
        return lambda g: out[name][2].append({k: to_numpy(v) for k, v in flatten_tree(g)})

    def jcapture(g, st, p, lr_, update=jopt.update):       # runs under jit
        jax.debug.callback(record("ref", lambda a: np.asarray(a, np.float32)), g,
                           ordered=True)
        return update(g, st, p, lr_)

    def capture(g, st, p, lr_, update=opt.update):
        record("port", lambda t: t.float().numpy().copy())(g)
        return update(g, st, p, lr_)

    object.__setattr__(jopt, "update", jcapture)
    object.__setattr__(opt, "update", capture)
    jstep = jax.jit(jstep)
    jstate, state = jopt.init(jparams), opt.init(params)
    rng = np.random.default_rng(5)
    for _ in range(n_steps):
        b = {"tokens": rng.integers(1, cfg.vocab_size, (4, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32)}
        jl, jparams, jstate = jstep(jparams, jstate, jax.tree.map(jnp.asarray, b))
        loss, params, state = step(params, state, torch_batch(b))
        out["ref"][0].append(float(jl))
        out["port"][0].append(float(loss))
    out["ref"] = (out["ref"][0], dict(flatten_tree(jax.tree.map(np.asarray, jparams))),
                  out["ref"][2])
    out["port"] = (out["port"][0], {k: v.numpy() for k, v in flatten_tree(params)},
                   out["port"][2])
    return out


class TestTrainStep:
    def test_sgd_three_steps(self):
        out = _run_steps("sgd")
        (ref_losses, ref_params, _), (losses, params, _) = out["ref"], out["port"]
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
        for path, p in params.items():
            np.testing.assert_allclose(p, ref_params[path], rtol=0, atol=1e-5, err_msg=path)

    @pytest.mark.parametrize("accum", ["float32", "bfloat16"])
    def test_adamw_three_steps(self, accum):
        """Losses within 1e-4 and each step's accumulated gradients as in
        TestTrainLoss.  Parameters are not compared: a sign flip of a
        near-zero gradient moves an element by 2 lr."""
        out = _run_steps("adamw", accum)
        (ref_losses, _, ref_grads), (losses, _, grads) = out["ref"], out["port"]
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
        assert len(grads) == len(ref_grads) == 3
        for g, g_ref in zip(grads, ref_grads):
            # a bf16 accumulator rounds each microbatch's gradient and their sum
            assert_grads_close(g, g_ref, bf16_rounds=2 if accum == "bfloat16" else 0)

    def test_microbatches_average(self):
        """Two microbatches of 2 give the mean of their gradients: with no
        ignored label, the gradient of the whole batch of 4 (SGD at lr 0
        leaves it in the momentum)."""
        _, _, cfg, params = carried("qwen3-1.7b-reduced", optimizer="sgd")
        b = np_batch(cfg, batch=4)
        b["labels"][:] = np.abs(b["labels"])
        loss, grads = port_value_and_grad(cfg, params, b)
        step, opt = build_train_step(cfg.replace(microbatch=2), lr=0.0)
        loss_mb, _, opt_state = step(params, opt.init(params), torch_batch(b))
        assert float(loss_mb) == pytest.approx(loss, rel=1e-6)
        for path, m in flatten_tree(opt_state["m"]):
            np.testing.assert_allclose(m.numpy(), grads[path], rtol=0,
                                       atol=1e-6 * max(1.0, float(np.abs(grads[path]).max())))

    def test_batch_not_a_multiple_raises(self):
        _, _, cfg, params = carried("qwen3-1.7b-reduced", microbatch=3)
        step, opt = build_train_step(cfg)
        with pytest.raises(ValueError, match="multiple of microbatch"):
            step(params, opt.init(params), torch_batch(np_batch(cfg, batch=4)))


class TestServingSteps:
    def test_prefill_and_serve_steps_are_the_api(self):
        """build_prefill_step / build_serve_step call the family's prefill
        and decode_step: the same logits as the reference's steps."""
        from repro.launch.steps import build_prefill_step as jprefill
        from repro.launch.steps import build_serve_step as jserve
        from repro_torch.launch.steps import build_prefill_step, build_serve_step
        jcfg, jparams, cfg, params = carried("qwen3-1.7b-reduced")
        toks = np_batch(cfg)["tokens"]
        jlogits, jcache = jprefill(jcfg, cache_len=24)(jparams, {"tokens": jnp.asarray(toks)})
        jnext, _ = jserve(jcfg)(jparams, jcache, {"token": jnp.asarray(toks[:, 0])})
        with torch.no_grad():
            logits, cache = build_prefill_step(cfg, cache_len=24)(
                params, {"tokens": torch.from_numpy(toks)})
            nxt, _ = build_serve_step(cfg)(params, cache, {"token": torch.from_numpy(toks[:, 0])})
        for ours, ref in ((logits, jlogits), (nxt, jnext)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


class TestTrainCLI:
    def test_main_lowers_the_loss_and_resumes(self, tmp_path, capsys):
        args = ["--arch", "qwen3-1.7b-reduced", "--device", "cpu", "--steps", "6",
                "--batch", "4", "--seq", "32", "--lr", "1e-3",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
        assert port_train.main(args) == 0
        assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003",
                                                              "step_00000006"]
        assert port_train.main(args[:5] + ["2"] + args[6:]) == 0
        out = capsys.readouterr().out
        assert "resumed from step 6" in out
        assert "step    8" in out

    def test_cuda_default_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_train.train("qwen3-1.7b-reduced", steps=1, batch=2, seq=8)


class TestPlainKernelsCarryGradients:
    """On CPU tensors the wrappers of B1, B3 and B4 run their plain
    versions, which autograd differentiates (on CUDA tensors they raise
    instead: tests/test_torch_kernels_gpu.py).  The plain versions compute
    in f32 whatever their inputs, so the finite differences take steps of
    1e-3 and the Jacobians are held within 2e-3 + 1e-2 relative."""

    GRADCHECK = dict(eps=1e-3, atol=2e-3, rtol=1e-2)

    def test_ssd_scan(self):
        from repro_torch.kernels import ssd_scan as kss
        g = torch.Generator().manual_seed(0)
        b, s, h, p, n = 1, 12, 2, 3, 4
        args = (torch.randn(b, s, h, p, generator=g, dtype=torch.float64) * 0.5,
                -torch.rand(b, s, h, generator=g, dtype=torch.float64) * 0.3,
                torch.randn(b, s, 1, n, generator=g, dtype=torch.float64) * 0.5,
                torch.randn(b, s, 1, n, generator=g, dtype=torch.float64) * 0.5,
                torch.randn(b, h, p, n, generator=g, dtype=torch.float64) * 0.5)
        args = tuple(a.requires_grad_() for a in args)
        assert torch.autograd.gradcheck(
            lambda x, dA, B_, C_, h0: kss.ssd_scan(x, dA, B_, C_, chunk=5, h0=h0), args,
            **self.GRADCHECK)

    def test_rglru_scan(self):
        from repro_torch.kernels import rglru_scan as krg
        g = torch.Generator().manual_seed(0)
        a = (0.7 + 0.29 * torch.rand(2, 9, 5, generator=g, dtype=torch.float64))
        b = 0.1 * torch.randn(2, 9, 5, generator=g, dtype=torch.float64)
        h0 = torch.randn(2, 5, generator=g, dtype=torch.float64)
        assert torch.autograd.gradcheck(krg.rglru_scan, tuple(
            t.requires_grad_() for t in (a, b, h0)), **self.GRADCHECK)

    def test_decode_attention(self):
        from repro_torch.kernels import decode_attention as kda
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(shape, generator=g, dtype=torch.float64).requires_grad_()
                   for shape in ((2, 4, 8), (2, 6, 2, 8), (2, 6, 2, 8)))
        pos = torch.tensor(4, dtype=torch.int32)
        assert torch.autograd.gradcheck(
            lambda q_, k_, v_: kda.decode_attention(q_, k_, v_, pos, softcap=5.0), (q, k, v),
            **self.GRADCHECK)
