"""Checkpoints of the port (`repro_torch.checkpoint`) against the JAX
package's format, and resume.

A checkpoint written by either package loads in the other bit for bit
(f32, bf16 and float8 leaves, ints, nested dicts, an optimizer state),
and both write the same manifest.  Resume is held as the reference holds
its own (`tests/test_checkpoint.py::test_train_resume_bitwise`): four
steps straight against two, a save, a load and two more.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.optim import get_optimizer as jget_optimizer
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_train_step
from repro_torch.models import get_api


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port tests do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree():
    """Leaves of every stored kind, as numpy (ml_dtypes for bf16/fp8),
    with NaN, -0 and subnormal bit patterns among the floats."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    f32[0, :3] = [np.nan, -0.0, 1e-40]
    bf16 = rng.normal(size=(2, 5)).astype(ml_dtypes.bfloat16)
    bf16[0, 0] = np.nan
    return {
        "a": f32,
        "b": {"w": bf16, "s": np.asarray(7, np.int32)},
        "c": (rng.normal(size=(4,)) * 100).astype(ml_dtypes.float8_e4m3fn),
        "d": {"e": {"f": rng.integers(-5, 5, (2, 2)).astype(np.int32)}},
    }


def as_torch(tree):
    """numpy leaves -> tensors of the same dtype and bits."""
    def leaf(a):
        name = a.dtype.name
        if name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        if "float8" in name:
            return torch.from_numpy(a.view(np.uint8).copy()).view(getattr(torch, name))
        return torch.from_numpy(np.array(a))
    return {k: (as_torch(v) if isinstance(v, dict) else leaf(v)) for k, v in tree.items()}


def bits(x) -> tuple[str, bytes]:
    """A leaf's dtype name and raw bytes, from either package."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        x = x.contiguous().view(torch.uint8) if x.element_size() == 1 else x
        raw = (x.view(torch.int16) if name == "bfloat16" else x).numpy().tobytes()
        return name, raw
    a = np.asarray(x)
    return a.dtype.name, a.tobytes()


def flat_bits(tree):
    return {k: bits(v) for k, v in ckpt.flatten_tree(tree)}


class TestInterchange:
    def test_reference_checkpoint_loads_bitwise(self, tmp_path):
        tree = np_tree()
        jckpt.save_checkpoint(tmp_path / "ck", jax.tree.map(jnp.asarray, tree), step=7,
                              metadata={"arch": "x"})
        back, step, meta = ckpt.load_checkpoint(tmp_path / "ck", device="cpu")
        assert step == 7 and meta == {"arch": "x"}
        assert back["b"]["w"].dtype == torch.bfloat16
        assert back["c"].dtype == torch.float8_e4m3fn
        assert back["b"]["s"].dtype == torch.int32 and back["b"]["s"].dim() == 0
        assert flat_bits(back) == flat_bits(tree)

    def test_port_checkpoint_loads_bitwise_in_reference(self, tmp_path):
        tree = np_tree()
        ckpt.save_checkpoint(tmp_path / "ck", as_torch(tree), step=3, metadata={"k": 1})
        back, step, meta = jckpt.load_checkpoint(tmp_path / "ck")
        assert step == 3 and meta == {"k": 1}
        assert flat_bits(back) == flat_bits(tree)

    def test_manifests_match(self, tmp_path):
        tree = np_tree()
        jckpt.save_checkpoint(tmp_path / "ref", jax.tree.map(jnp.asarray, tree), step=1)
        ckpt.save_checkpoint(tmp_path / "port", as_torch(tree), step=1)
        ref = json.loads((tmp_path / "ref" / "manifest.json").read_text())
        ours = json.loads((tmp_path / "port" / "manifest.json").read_text())
        assert ours == ref
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
            p.name for p in (tmp_path / "ref").iterdir())
        for info in ref["tensors"].values():
            a = np.load(tmp_path / "ref" / info["file"])
            b = np.load(tmp_path / "port" / info["file"])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
    def test_optimizer_state_moves_both_ways(self, tmp_path, name):
        """A training state (bf16 params and the reference optimizer's
        state after one update) goes reference -> port -> reference
        unchanged, and the port's optimizer takes it up."""
        from repro_torch.optim import get_optimizer
        rng = np.random.default_rng(1)
        params = {"w": jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16),
                  "b": jnp.asarray(rng.normal(size=(6,)), jnp.bfloat16)}
        jopt = jget_optimizer(name)
        params, state = jopt.update(jax.tree.map(jnp.ones_like, params),
                                    jopt.init(params), params, 1e-2)
        tree = {"params": params, "opt_state": state}
        jckpt.save_checkpoint(tmp_path / "ref", tree, step=1)
        back, _, _ = ckpt.load_checkpoint(tmp_path / "ref", device="cpu")
        assert flat_bits(back) == flat_bits(jax.tree.map(np.asarray, tree))
        ckpt.save_checkpoint(tmp_path / "port", back, step=1)
        again, _, _ = jckpt.load_checkpoint(tmp_path / "port")
        assert flat_bits(again) == flat_bits(jax.tree.map(np.asarray, tree))
        get_optimizer(name).update({k: torch.ones_like(v) for k, v in back["params"].items()},
                                   back["opt_state"], back["params"], 1e-2)


class TestFormat:
    """The reference's own checkpoint tests (`tests/test_checkpoint.py`), on the port."""

    def test_overwrite_is_atomic(self, tmp_path):
        p = tmp_path / "ck"
        ckpt.save_checkpoint(p, {"a": torch.zeros(2)}, step=1)
        ckpt.save_checkpoint(p, {"a": torch.ones(2)}, step=2)
        back, step, _ = ckpt.load_checkpoint(p, device="cpu")
        assert step == 2 and back["a"].tolist() == [1.0, 1.0]
        assert [q.name for q in tmp_path.iterdir()] == ["ck"]     # no temporary left

    def test_failed_write_leaves_the_old_checkpoint(self, tmp_path):
        p = tmp_path / "ck"
        ckpt.save_checkpoint(p, {"a": torch.zeros(2)}, step=1)
        with pytest.raises(AttributeError):
            ckpt.save_checkpoint(p, {"a": torch.ones(2), "b": object()}, step=2)
        back, step, _ = ckpt.load_checkpoint(p, device="cpu")
        assert step == 1 and back["a"].tolist() == [0.0, 0.0]
        assert [q.name for q in tmp_path.iterdir()] == ["ck"]

    def test_latest_step_discovery(self, tmp_path):
        assert ckpt.latest_step(tmp_path / "none") is None
        for s in (10, 200, 30):
            ckpt.save_checkpoint(ckpt.step_path(tmp_path, s), {"a": torch.zeros(1)}, step=s)
        assert ckpt.latest_step(tmp_path) == 200
        assert ckpt.step_path(tmp_path, 200).name == jckpt.step_path(tmp_path, 200).name

    def test_load_onto_a_device(self, tmp_path, monkeypatch):
        """The card by default, as the port's other entry points: without
        one it raises and names the way to the CPU."""
        ckpt.save_checkpoint(tmp_path / "ck", {"a": torch.arange(3.0)})
        back, _, _ = ckpt.load_checkpoint(tmp_path / "ck", device="cpu")
        assert back["a"].device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ckpt.load_checkpoint(tmp_path / "ck")


class TestResume:
    @pytest.mark.parametrize("optimizer", ["adamw", "sgd", "adafactor"])
    def test_train_resume_bitwise(self, tmp_path, optimizer):
        """Save at step 2, restore, continue: identical to 4 straight steps."""
        cfg = get_config("qwen3-1.7b-reduced").replace(optimizer=optimizer)
        api = get_api(cfg)
        step_fn, opt = build_train_step(cfg, lr=1e-3)
        rng = np.random.default_rng(0)
        bs = [{"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16),
                                                       dtype=np.int32)),
               "labels": torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 16),
                                                       dtype=np.int32))}
              for _ in range(4)]

        def fresh():
            params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            return params, opt.init(params)

        p1, s1 = fresh()
        for b in bs:
            _, p1, s1 = step_fn(p1, s1, b)
        p2, s2 = fresh()
        for b in bs[:2]:
            _, p2, s2 = step_fn(p2, s2, b)
        ckpt.save_checkpoint(tmp_path / "mid", {"params": p2, "opt": s2}, step=2)
        back, step, _ = ckpt.load_checkpoint(tmp_path / "mid", device="cpu")
        p3, s3 = back["params"], back["opt"]
        for b in bs[2:]:
            _, p3, s3 = step_fn(p3, s3, b)
        assert step == 2
        assert flat_bits({"p": p1, "s": s1}) == flat_bits({"p": p3, "s": s3})
