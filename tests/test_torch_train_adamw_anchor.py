"""The scan families' AdamW training steps held to the reference one step at
a time, each from the reference's own starting point.

tests/test_torch_train_graphs.py compares mamba2 and recurrentgemma with
the reference under SGD only: run freely under AdamW, their params part
after the first step and the later steps' gradients leave 1e-4.  Here each
of three steps (lr 1e-3, batch 2 x 16, AdamW) is anchored: the port starts
step k from the reference's params and AdamW state after its step k - 1,
carried by value (`from_jax_params`; the state's leaves as numpy), and

- the port's train step hands its optimizer gradients within tests/
  test_torch_train.py's 1e-4 x max(1, max|g_ref|) of the reference's;
- the port's AdamW fed the reference's gradients gives the reference's
  params and state within tests/test_torch_optim.py's rtol 1e-6 / atol
  1e-6 x max|ref|;
- wherever the port's whole step leaves params that differ from the
  reference's by more than that (when measured, hundreds of elements at
  the first step), the difference is the two packages' gradient
  difference passed through AdamW: the reference's AdamW fed the port's
  gradients lands on the port's params within the same tolerance.

So the gap is no fault of the port.  Nor is it a sign flip of near-zero
gradients, the explanation REF_CASES carried before it was measured: few
of the elements off have a flipped gradient sign (none in mamba2).  AdamW
divides each update by sqrt(v) + 1e-8, so an element whose gradient is
small moves by up to lr |Δg| / 1e-8: its params amplify gradient
differences well inside the gradient tolerance into steps of a fraction of
lr.  `python tests/test_torch_train_adamw_anchor.py` prints, per family and
step, the gradients' worst error over their tolerance, the elements off,
how many of them flipped sign, and the largest |Δp| / (lr |Δg|) among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_api as jget_api
from repro.optim import get_optimizer as jget_optimizer
from repro_torch.checkpoint import flatten_tree, unflatten_tree
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_train_step
from repro_torch.weights import from_jax_params

ARCHS = ["mamba2-130m-reduced", "recurrentgemma-9b-reduced"]
STEPS = 3
LR = 1e-3
BATCH, SEQ = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port tests do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_batches(cfg, n, seed=5) -> list[dict]:
    """tests/test_torch_train_graphs.py's batches: tokens and next-token
    labels, the last two ignored (-1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        labels[:, -2:] = -1
        out.append({"tokens": rng.integers(1, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
                    "labels": labels})
    return out


def flat_np(tree) -> dict:
    """A reference tree's leaves as f32 numpy, by path."""
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_tree(jax.tree.map(np.asarray, tree))}


def flat_t(tree) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in flatten_tree(tree)}


def state_to_port(jstate) -> dict:
    """The reference's AdamW state as the port's, by value."""
    return unflatten_tree({k: torch.tensor(np.array(v)) for k, v in
                           flatten_tree(jax.tree.map(np.asarray, jstate))})


def off(ours: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Where ours misses ref by more than tests/test_torch_optim.py's
    rtol 1e-6 / atol 1e-6 x max|ref|."""
    return np.abs(ours - ref) > 1e-6 * np.abs(ref) + 1e-6 * np.abs(ref).max()


def anchored(arch) -> list[dict]:
    """Per step k: the reference's gradients, params and state after the
    step; the port's gradients from the reference's point before it; the
    port's AdamW fed the reference's gradients; the port's whole step; and
    the reference's AdamW fed the port's gradients.  Trees flattened to
    numpy."""
    jcfg = jget_config(arch).replace(optimizer="adamw")
    cfg = get_config(arch).replace(optimizer="adamw")
    japi = jget_api(jcfg)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jget_optimizer("adamw")
    jstate = jopt.init(jparams)
    jgrad = jax.jit(jax.grad(lambda p, b: japi.train_loss(jcfg, p, b)[0]))
    jupdate = jax.jit(lambda g, s, p: jopt.update(g, s, p, LR))
    step, opt = build_train_step(cfg, lr=LR)
    adamw = opt.update
    seen = []

    def record(g, st, p, lr_):
        seen.append(flat_t(g))
        return adamw(g, st, p, lr_)

    object.__setattr__(opt, "update", record)
    out = []
    for b in np_batches(cfg, STEPS):
        jb = jax.tree.map(jnp.asarray, b)
        g_ref = jgrad(jparams, jb)
        ref_params, ref_state = jupdate(g_ref, jstate, jparams)

        def start():
            return (from_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu"),
                    state_to_port(jstate))

        p, s = start()
        _, p, s = step(p, s, {k: torch.from_numpy(v) for k, v in b.items()})
        g_port = seen.pop()
        p0, s0 = start()
        fed_p, fed_s = adamw(unflatten_tree({k: torch.from_numpy(v.copy())
                                            for k, v in flat_np(g_ref).items()}), s0, p0, LR)
        via_ref, _ = jupdate(jax.tree.map(jnp.asarray, unflatten_tree(g_port)), jstate, jparams)
        out.append({"g_ref": flat_np(g_ref), "g_port": g_port,
                    "ref_params": flat_np(ref_params), "ref_state": flat_np(ref_state),
                    "fed_params": flat_t(fed_p), "fed_state": flat_t(fed_s),
                    "port_params": flat_t(p), "via_ref_params": flat_np(via_ref)})
        jparams, jstate = ref_params, ref_state
    return out


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = anchored(arch)
        return cache[arch]

    return get


CASES = [(a, k) for a in ARCHS for k in range(STEPS)]
IDS = [f"{a.split('-')[0]}-step{k}" for a, k in CASES]


@pytest.mark.parametrize("arch,k", CASES, ids=IDS)
def test_anchored_gradients_match_the_reference(runs, arch, k):
    r = runs(arch)[k]
    assert r["g_port"].keys() == r["g_ref"].keys()
    for path, g in r["g_ref"].items():
        tol = 1e-4 * max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(r["g_port"][path], g, rtol=0, atol=tol, err_msg=path)


@pytest.mark.parametrize("arch,k", CASES, ids=IDS)
def test_adamw_update_from_the_reference_gradients_matches(runs, arch, k):
    r = runs(arch)[k]
    for ours, ref in ((r["fed_params"], r["ref_params"]), (r["fed_state"], r["ref_state"])):
        assert ours.keys() == ref.keys()
        for path in ref:
            assert not off(ours[path], ref[path]).any(), path


@pytest.mark.parametrize("arch,k", CASES, ids=IDS)
def test_param_gap_is_the_gradient_gap_through_adamw(runs, arch, k):
    r = runs(arch)[k]
    for path, ref in r["via_ref_params"].items():
        assert not off(r["port_params"][path], ref).any(), path


def report() -> None:
    for arch in ARCHS:
        for k, r in enumerate(anchored(arch)):
            g_worst = max(float(np.abs(r["g_port"][p] - g).max())
                          / (1e-4 * max(1.0, float(np.abs(g).max())))
                          for p, g in r["g_ref"].items())
            n_off = flips = 0
            gain = 0.0
            for path, ref in r["ref_params"].items():
                bad = off(r["port_params"][path], ref)
                if not bad.any():
                    continue
                g_ref, g_port = r["g_ref"][path][bad], r["g_port"][path][bad]
                n_off += int(bad.sum())
                flips += int((np.sign(g_ref) != np.sign(g_port)).sum())
                dp = np.abs(r["port_params"][path] - ref)[bad]
                gain = max(gain, float((dp / (LR * np.maximum(np.abs(g_port - g_ref),
                                                              1e-30))).max()))
            print(f"{arch} step {k}: gradients' worst error {g_worst:.4f} of tolerance; "
                  f"{n_off} params off, {flips} of them with a flipped gradient sign; "
                  f"largest |dp| / (lr |dg|) among them {gain:.3g}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    report()
