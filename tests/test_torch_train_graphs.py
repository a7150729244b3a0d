"""The compiled training step: the port of the reference trainer's
`jax.jit(train_step, donate_argnums=(0, 1))`.

`launch.steps.compile_train_step` keeps one program per signature of
(params, opt_state, batch); on CUDA each is a CUDA graph, on the CPU its
body runs eagerly.  These tests hold, on the CPU, for the reduced qwen3
(also microbatched), granite-moe (with capacity drops), mamba2 and
recurrentgemma configs and for AdamW, Adafactor and SGD:

- the compiled step's losses, params and optimizer state equal
  `build_train_step`'s eager step bit for bit over 3 steps;
- they equal the reference's jitted, donated step over 3 steps within
  tests/test_torch_train.py's tolerances: losses within 1e-4 (SGD: rel
  1e-5), each step's gradients within 1e-4 x max(1, max|g|), SGD's
  params within 1e-5 (AdamW and Adafactor params are not compared:
  their division by sqrt(v) + eps turns a small gradient difference into
  a step of up to lr; the scan families run SGD here, see REF_CASES);
- after calls with two batch shapes the number of programs equals the
  reference jit's `_cache_size()`;
- the first call's trees are the statics (the same objects come back),
  and a later call with other trees of the same signature copies them in;
- a stand-in for the CUDA path's warm-up and capture (the engine tests'
  pattern) runs the warm-up as the first call's step, captures once per
  program, replays afterwards with the same results, returns the loss
  copied out of the graph's outputs, and adds the launches the capture
  recorded, forward and backward, at each replay;
- the compiled step is freed when its last reference goes;
- `launch.train.main` trains through it, lowers the loss and resumes.
"""

import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import get_api as jget_api
from repro_torch import graphs
from repro_torch.checkpoint import flatten_tree
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as kss
from repro_torch.launch import steps as steplib
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import build_train_step, compile_train_step
from repro_torch.models import get_api
from repro_torch.weights import from_jax_params

S = 16
# (test id, arch, config fields replaced in both packages, batch)
FAMILIES = [
    ("qwen3", "qwen3-1.7b-reduced", {}, 2),
    ("qwen3-microbatched", "qwen3-1.7b-reduced", {"microbatch": 2}, 4),
    ("granite-drops", "granite-moe-3b-a800m-reduced", {"capacity_factor": 0.25}, 2),
    ("mamba2", "mamba2-130m-reduced", {}, 2),
    ("recurrentgemma", "recurrentgemma-9b-reduced", {}, 2),
]
OPTIMIZERS = ["adamw", "adafactor", "sgd"]
# The reference comparison: qwen3 with each optimizer, the dense and MoE
# families with AdamW, the scan families with SGD.  AdamW divides each
# update by sqrt(v) + 1e-8, so where a gradient is small it turns the two
# packages' gradient differences, far inside 1e-4, into steps of a
# fraction of lr: in mamba2 and recurrentgemma that moves the params apart
# and puts the next steps' gradients past 1e-4 (their first step's are
# within 1 % of it), while SGD keeps every step's within 1 % of it.
# tests/test_torch_train_adamw_anchor.py holds their AdamW steps to the
# reference one at a time from its own params and state.
REF_CASES = ([(FAMILIES[0], o) for o in OPTIMIZERS] + [(f, "adamw") for f in FAMILIES[1:3]]
             + [(f, "sgd") for f in FAMILIES[3:]])
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port tests do: with
    several pytest-xdist workers its default threads oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_batches(cfg, n, batch, seed=0, seq=S) -> list[dict]:
    """n batches of tokens and next-token labels (a few ignored, -1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        labels[:, -2:] = -1
        out.append({"tokens": rng.integers(1, cfg.vocab_size, (batch, seq)).astype(np.int32),
                    "labels": labels})
    return out


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def port_setup(arch, fields, optimizer, seed=0):
    """(cfg, train_step, optimizer, params, opt_state), params drawn by the
    port from a seeded generator."""
    cfg = get_config(arch).replace(optimizer=optimizer, **fields)
    step_fn, opt = build_train_step(cfg, lr=LR)
    params = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, step_fn, opt, params, opt.init(params)


def clone(tree: dict) -> dict:
    return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def leaves_equal(a: dict, b: dict) -> bool:
    fa, fb = dict(flatten_tree(a)), dict(flatten_tree(b))
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)


def same_objects(tree, leaves: list) -> bool:
    """Whether tree's leaves are the very tensors of `leaves` ((name,
    tensor) pairs, as `graphs.tensors` gives them)."""
    now = list(graphs.tensors(tree))
    return len(now) == len(leaves) and all(a is b for (_, a), (_, b) in zip(now, leaves))


def run(step, params, state, batches):
    losses = []
    for b in batches:
        loss, params, state = step(params, state, torch_batch(b))
        losses.append(loss)
    return losses, params, state


# ---------------------------------------------------------------------------
# Bit for bit against the eager step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("arch,fields,batch", [f[1:] for f in FAMILIES],
                         ids=[f[0] for f in FAMILIES])
def test_equals_the_eager_step_bit_for_bit(arch, fields, batch, optimizer):
    cfg, step_fn, opt, params, state = port_setup(arch, fields, optimizer)
    eager = (clone(params), clone(state))
    batches = np_batches(cfg, 3, batch)
    compiled = compile_train_step(step_fn, device="cpu")
    losses, p, s = run(compiled, params, state, batches)
    ref_losses, ref_p, ref_s = run(step_fn, *eager, batches)
    assert [float(x) for x in losses] == [float(x) for x in ref_losses]
    assert leaves_equal(p, ref_p) and leaves_equal(s, ref_s)
    assert len(compiled.steps) == 1 and not compiled.graphed
    assert all(st.graph is None for st in compiled.steps.values())


# ---------------------------------------------------------------------------
# Against the reference's jax.jit(train_step, donate_argnums=(0, 1))
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_runs():
    """Per reference case, both packages over 3 steps at the family's batch
    and one more at batch 1 (a second program): (reference, port), each
    (losses, final params, the gradients each step handed its optimizer,
    the program count), trees flattened to numpy."""
    cache = {}

    def get(case):
        (name, arch, fields, batch), optimizer = case
        key = (name, optimizer)
        if key not in cache:
            cache[key] = _both(arch, fields, batch, optimizer)
        return cache[key]

    return get


def _both(arch, fields, batch, optimizer):
    fields = {"optimizer": optimizer, **fields}
    jcfg = jget_config(arch).replace(**fields)
    jparams = jget_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch).replace(**fields)
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    jstep, jopt = jbuild_train_step(jcfg, lr=LR)
    step, opt = build_train_step(cfg, lr=LR)
    grads = {"ref": [], "port": []}

    def jrecord(g, st, p, lr_, update=jopt.update):       # runs under jit
        jax.debug.callback(lambda g_: grads["ref"].append(
            {k: np.asarray(v, np.float32) for k, v in flatten_tree(g_)}), g, ordered=True)
        return update(g, st, p, lr_)

    def record(g, st, p, lr_, update=opt.update):
        grads["port"].append({k: v.float().numpy().copy() for k, v in flatten_tree(g)})
        return update(g, st, p, lr_)

    object.__setattr__(jopt, "update", jrecord)
    object.__setattr__(opt, "update", record)
    jitted = jax.jit(jstep, donate_argnums=(0, 1))
    compiled = compile_train_step(step, device="cpu")
    jstate, state = jopt.init(jparams), opt.init(params)
    batches = np_batches(cfg, 3, batch, seed=5) + np_batches(cfg, 1, 1, seed=6)
    out = {"ref": [], "port": []}
    for b in batches:
        jl, jparams, jstate = jitted(jparams, jstate, jax.tree.map(jnp.asarray, b))
        loss, params, state = compiled(params, state, torch_batch(b))
        out["ref"].append(float(jl))
        out["port"].append(float(loss))
    jax.effects_barrier()
    return ((out["ref"], dict(flatten_tree(jax.tree.map(np.asarray, jparams))),
             grads["ref"], jitted._cache_size()),
            (out["port"], {k: v.numpy() for k, v in flatten_tree(params)},
             grads["port"], len(compiled.steps)))


def assert_grads_close(ours: dict, ref: dict):
    """Each leaf within 1e-4 x max(1, max|g_ref|) (f32; the frameworks
    differ in reduction order), as tests/test_torch_train.py holds them."""
    assert ours.keys() == ref.keys()
    for path, g_ref in ref.items():
        tol = 1e-4 * max(1.0, float(np.abs(g_ref).max()))
        np.testing.assert_allclose(ours[path], g_ref, rtol=0, atol=tol, err_msg=path)


REF_IDS = [f"{f[0]}-{o}" for f, o in REF_CASES]


@pytest.mark.parametrize("case", REF_CASES, ids=REF_IDS)
def test_matches_the_reference_jitted_donated_step(ref_runs, case):
    (ref_losses, ref_params, ref_grads, _), (losses, params, grads, _) = ref_runs(case)
    if case[1] == "sgd":
        np.testing.assert_allclose(losses[:3], ref_losses[:3], rtol=1e-5)
    else:
        np.testing.assert_allclose(losses[:3], ref_losses[:3], rtol=0, atol=1e-4)
    assert len(grads) == len(ref_grads) == 4
    for g, g_ref in zip(grads[:3], ref_grads[:3]):
        assert_grads_close(g, g_ref)
    if case[1] == "sgd":
        for path, p in params.items():
            np.testing.assert_allclose(p, ref_params[path], rtol=0, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("case", REF_CASES, ids=REF_IDS)
def test_programs_equal_the_jit_cache(ref_runs, case):
    (_, _, _, jit_programs), (_, _, _, programs) = ref_runs(case)
    assert programs == jit_programs == 2


# ---------------------------------------------------------------------------
# Donation: the static trees
# ---------------------------------------------------------------------------


def test_the_first_calls_trees_are_the_statics():
    cfg, step_fn, _, params, state = port_setup("qwen3-1.7b-reduced", {}, "adamw")
    compiled = compile_train_step(step_fn, device="cpu")
    batches = np_batches(cfg, 3, 2)
    leaves = (list(graphs.tensors(params)), list(graphs.tensors(state)))
    for b in batches:
        _, p, s = compiled(params, state, torch_batch(b))
        assert p is params and s is state
    assert same_objects(params, leaves[0]) and same_objects(state, leaves[1])
    # the static batch is the step's own buffer, not the caller's tensors
    (step,) = compiled.steps.values()
    assert step.inputs["params"] is params
    assert torch.equal(step.inputs["batch"]["tokens"], torch.from_numpy(batches[-1]["tokens"]))


def test_a_later_call_with_other_trees_copies_them_in():
    cfg, step_fn, opt, params, state = port_setup("qwen3-1.7b-reduced", {}, "adamw")
    compiled = compile_train_step(step_fn, device="cpu")
    batches = np_batches(cfg, 3, 2)
    run(compiled, params, state, batches[:2])
    other = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    other_state = opt.init(other)
    kept = (clone(other), clone(other_state))
    loss, p, s = compiled(other, other_state, torch_batch(batches[2]))
    assert p is params and s is state                  # the statics, refilled
    ref_loss, ref_p, ref_s = step_fn(clone(kept[0]), clone(kept[1]), torch_batch(batches[2]))
    assert float(loss) == float(ref_loss)
    assert leaves_equal(p, ref_p) and leaves_equal(s, ref_s)
    assert leaves_equal(other, kept[0]) and leaves_equal(other_state, kept[1])
    assert len(compiled.steps) == 1


# ---------------------------------------------------------------------------
# The CUDA path's bookkeeping, with a stand-in capture
# ---------------------------------------------------------------------------


class FakeCapture:
    """Stands in for the compiled step's warm-up and capture on the CPU, as
    the engine tests' FakeCapture does for the engine: the warm-up runs the
    body eagerly (a real step, whose loss the first call returns), and the
    capture registers a stand-in graph whose replay runs the body, with
    `launches` as the launches a replay adds."""

    def __init__(self, compiled, launches=()):
        self.events, self.launches = [], launches
        compiled.graphed = True
        compiled._warm_up = self.warm_up
        compiled._capture = self.capture

    def warm_up(self, step):
        self.events.append(("warm-up", step.key))
        return step.body()[0].clone()

    def capture(self, step):
        self.events.append(("capture", step.key))

        def replay():
            step.outputs = step.body()

        step.graph = types.SimpleNamespace(replay=replay)
        step.launches = self.launches


def test_a_stand_in_capture_registers_programs_as_the_cuda_path():
    cfg, step_fn, _, params, state = port_setup("qwen3-1.7b-reduced", {"microbatch": 2},
                                                "adamw")
    eager = (clone(params), clone(state))
    compiled = compile_train_step(step_fn, device="cpu")
    capture = FakeCapture(compiled)
    batches = np_batches(cfg, 3, 4) + np_batches(cfg, 2, 2, seed=1)
    losses, p, s = run(compiled, params, state, batches)
    ref_losses, ref_p, ref_s = run(step_fn, *eager, batches)
    assert [float(x) for x in losses] == [float(x) for x in ref_losses]
    assert leaves_equal(p, ref_p) and leaves_equal(s, ref_s)
    keys = list(compiled.steps)
    assert capture.events == [("warm-up", keys[0]), ("capture", keys[0]),
                              ("warm-up", keys[1]), ("capture", keys[1])]
    # a replay's loss is a copy: the graph's output is rewritten by the next
    for loss, st in ((losses[2], compiled.steps[keys[0]]), (losses[4], compiled.steps[keys[1]])):
        assert loss is not st.outputs[0] and torch.equal(loss, st.outputs[0])


def test_a_replay_adds_the_recorded_forward_and_backward_launches(monkeypatch):
    monkeypatch.setattr(kss, "launches", 5)
    monkeypatch.setattr(kss, "bwd_launches", 7)
    (bwd,) = [c for c in graphs.COUNTERS if getattr(c, "mod", None) is kss]
    assert bwd.launches == 7 and bwd.__name__.endswith("ssd_scan.bwd_launches")
    cfg, step_fn, _, params, state = port_setup("mamba2-130m-reduced", {}, "adamw")
    compiled = compile_train_step(step_fn, device="cpu")
    FakeCapture(compiled, launches=((kss, 48), (bwd, 24)))
    run(compiled, params, state, np_batches(cfg, 3, 2))
    # the warm-up ran the first step (on the CPU: the plain scans, uncounted)
    assert (kss.launches, kss.bwd_launches) == (5 + 2 * 48, 7 + 2 * 24)


def test_dtensor_params_are_checked_before_a_capture(monkeypatch):
    """The CUDA path refuses DTensor params before it runs anything (the
    gpu tests hold a real DTensor); eager steps take them."""
    cfg, step_fn, _, params, state = port_setup("qwen3-1.7b-reduced", {}, "sgd")
    compiled = compile_train_step(step_fn, device="cpu")
    capture = FakeCapture(compiled)
    monkeypatch.setattr(steplib.shard, "is_dtensor", lambda t: t is params["embed"])
    with pytest.raises(NotImplementedError, match="DTensor"):
        compiled(params, state, torch_batch(np_batches(cfg, 1, 2)[0]))
    assert not capture.events and not compiled.steps


# ---------------------------------------------------------------------------
# Lifetime and the trainer
# ---------------------------------------------------------------------------


def test_the_compiled_step_is_freed_without_the_garbage_collector():
    cfg, step_fn, _, params, state = port_setup("qwen3-1.7b-reduced", {}, "sgd")
    compiled = compile_train_step(step_fn, device="cpu")
    run(compiled, params, state, np_batches(cfg, 2, 2))
    ref = weakref.ref(compiled)
    step_ref = weakref.ref(next(iter(compiled.steps.values())))
    gc.disable()
    try:
        del compiled
        assert ref() is None and step_ref() is None
    finally:
        gc.enable()


def test_main_trains_through_the_compiled_step_and_resumes(tmp_path, capsys, monkeypatch):
    made = []

    def spy(step_fn, **kw):
        made.append(compile_train_step(step_fn, **kw))
        return made[-1]

    monkeypatch.setattr(port_train, "compile_train_step", spy)
    args = ["--arch", "qwen3-1.7b-reduced", "--device", "cpu", "--steps", "4",
            "--batch", "4", "--seq", "32", "--lr", "1e-3",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    assert port_train.main(args) == 0
    assert port_train.main(args[:5] + ["2"] + args[6:]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step    6" in out
    assert len(made) == 2 and all(len(m.steps) == 1 for m in made)
    assert all(m.device.type == "cpu" and not m.graphed for m in made)
