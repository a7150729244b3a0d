"""The PyTorch port's examples (`examples/torch_*.py`) against the JAX
package's (`examples/*.py`): the three host examples print the same text
byte for byte, the serving example hands `launch.serve.main` the
reference's arguments, the training example builds the reference's model
config and trains it on the CPU when asked, and the two device examples
refuse to run without a card.
"""

import dataclasses
import importlib.util
import runpy
import sys
from pathlib import Path

import pytest
import torch

import repro.launch.serve as ref_serve
import repro.launch.train as ref_train
import repro_torch.launch.serve as port_serve
import repro_torch.launch.train as port_train

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port test files do:
    with several pytest-xdist workers, the default threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def repo_root_on_path(monkeypatch):
    """The reference examples import `benchmarks`, which lives at the
    repository's root."""
    monkeypatch.syspath_prepend(str(ROOT))


def _load(path: Path):
    """The example file as a module, its `__main__` block not run."""
    spec = importlib.util.spec_from_file_location(f"_example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(path: Path, argv: list[str], monkeypatch) -> None:
    """Run the example file as a script with `argv` after its name; a
    `SystemExit` with code 0 or None is a normal end."""
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    try:
        runpy.run_path(str(path), run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), e.code


@pytest.mark.parametrize("name", ["quickstart", "zeta_sweep", "cluster_sim"])
def test_host_examples_print_the_references_text(name, capsys, repo_root_on_path):
    _load(EXAMPLES / f"{name}.py").main()
    ref = capsys.readouterr().out
    _load(EXAMPLES / f"torch_{name}.py").main()
    ours = capsys.readouterr().out
    assert ref.count("\n") > 3
    assert ours == ref


@pytest.mark.parametrize("extra", [[], ["--device", "cpu"]])
def test_serve_endtoend_passes_the_references_argv(extra, monkeypatch):
    seen = {}

    def record(tag):
        def main(argv=None):
            seen[tag] = list(argv)
            return 0
        return main

    monkeypatch.setattr(ref_serve, "main", record("ref"))
    monkeypatch.setattr(port_serve, "main", record("port"))
    _run_main(EXAMPLES / "serve_endtoend.py", extra, monkeypatch)
    _run_main(EXAMPLES / "torch_serve_endtoend.py", extra, monkeypatch)
    assert seen["ref"] == ["--fleet", "llama2-7b-reduced,llama2-70b-reduced",
                           "--queries", "16", "--zeta", "0.5"]
    assert seen["port"] == seen["ref"] + extra


@pytest.mark.parametrize("argv", [[], ["--steps", "7", "--d-model", "768", "--layers", "12",
                                       "--vocab", "512"]])
def test_train_small_builds_the_references_config(argv, monkeypatch):
    seen = {}

    def record(tag):
        def train(cfg, **kw):
            seen[tag] = (cfg, kw)
            return [2.0, 1.0]
        return train

    monkeypatch.setattr(ref_train, "train", record("ref"))
    monkeypatch.setattr(port_train, "train", record("port"))
    _run_main(EXAMPLES / "train_small.py", argv, monkeypatch)
    _run_main(EXAMPLES / "torch_train_small.py", argv + ["--device", "cpu"], monkeypatch)
    (rcfg, rkw), (pcfg, pkw) = seen["ref"], seen["port"]
    fields = [f.name for f in dataclasses.fields(rcfg)]
    assert fields == [f.name for f in dataclasses.fields(pcfg)]
    for f in fields:
        assert getattr(pcfg, f) == getattr(rcfg, f), f
    assert pkw == dict(rkw, device="cpu")
    assert rkw == {"steps": int(argv[1]) if argv else 200, "batch": 4, "seq": 64}


def test_train_small_trains_on_the_cpu(monkeypatch, capsys):
    """The example's own `assert losses[-1] < losses[0]` holds."""
    _run_main(EXAMPLES / "torch_train_small.py",
              ["--steps", "4", "--d-model", "64", "--layers", "2", "--vocab", "256",
               "--device", "cpu"], monkeypatch)
    out = capsys.readouterr().out
    assert "arch=llama3-small-64d2L" in out and "device=cpu" in out
    assert "final loss" in out


@pytest.mark.parametrize("name", ["serve_endtoend", "train_small"])
def test_device_examples_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_main(EXAMPLES / f"torch_{name}.py", [], monkeypatch)
