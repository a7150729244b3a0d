"""B1's timing tools without a card: the A/B timer
(`repro_torch/launch/decode_ab.py`: its alternation of fresh processes
between two trees and its summary, with the processes' output stood in
for) and the cut timer (`repro_torch/launch/decode_cuts.py`: how it makes
its variants, on a stand-in source).  The timing itself needs a card."""

import importlib.util
import json
import subprocess
from pathlib import Path

import pytest

SCRIPT = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "launch" / "decode_ab.py"


@pytest.fixture(scope="module")
def ab():
    spec = importlib.util.spec_from_file_location("decode_ab", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_alternates_trees_and_takes_medians(ab, monkeypatch, capsys):
    order = []

    def fake_run(cmd, check, capture_output, text):
        src = cmd[cmd.index("--src") + 1]
        order.append(src)
        ms = {"old": 0.02, "new": 0.01}[src] + 0.001 * len(order)
        rows = {"serve": {"ms": ms, "warm_ms": ms / 2, "host_us": 30.0, "library_ms": 0.018,
                          "bound_ms": 0.0016},
                "serve fp8": None if src == "old" else {"ms": ms, "warm_ms": ms / 2,
                                                        "host_us": 31.0, "library_ms": None,
                                                        "bound_ms": 0.0008}}
        return subprocess.CompletedProcess(cmd, 0, stdout="noise\n" + json.dumps(
            {"device": "stand-in", "rows": rows, "package": src}))

    monkeypatch.setattr(subprocess, "run", fake_run)
    summary = ab.run_ab("old", "new", 2)
    assert order == ["old", "new", "new", "old"]
    old, new = summary["A"]["median"], summary["B"]["median"]
    assert old["serve fp8"] is None and new["serve fp8"]["library_ms"] is None
    assert old["serve"]["ms"] == pytest.approx((0.021 + 0.024) / 2)
    assert new["serve"]["ms"] == pytest.approx((0.012 + 0.013) / 2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and "summary" in json.loads(lines[-1])


def test_passes_its_row_and_sample_options_to_each_run(ab, monkeypatch):
    cmds = []

    def fake_run(cmd, check, capture_output, text):
        cmds.append(cmd)
        rows = {"serve": {"ms": 0.01, "warm_ms": 0.005, "host_us": 30.0, "library_ms": None,
                          "bound_ms": 0.0016}}
        return subprocess.CompletedProcess(cmd, 0, stdout=json.dumps(
            {"device": "stand-in", "rows": rows, "package": "x"}))

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(ab, "run_ab", lambda *a: cmds.append(a) or {})
    ab.main(["--ab", "old", "new", "--pairs", "1", "--shape", "serve", "--host-reps", "5"])
    assert cmds == [("old", "new", 1, ["--shape", "serve", "--host-reps", "5"])]
    cmds.clear()
    monkeypatch.undo()
    monkeypatch.setattr(subprocess, "run", fake_run)
    ab.run_ab("old", "new", 1, ["--shape", "serve", "--host-reps", "5"])
    assert [c[c.index("--src") + 1:] for c in cmds] == [
        ["old", "--shape", "serve", "--host-reps", "5"],
        ["new", "--shape", "serve", "--host-reps", "5"]]


def test_load_trees_keeps_each_trees_modules(ab):
    """Two trees' B1 wrappers side by side (here the same tree twice): each
    a module of its own, both computing on CPU tensors, and the package
    importable again afterwards."""
    import sys

    import torch

    src = str(SCRIPT.parents[2])
    before = {m: sys.modules[m] for m in sys.modules if m.split(".")[0] == "repro_torch"}
    try:
        (kda_a, _), (kda_b, serve_b) = ab.load_trees(src, src)
        assert kda_a is not kda_b and kda_a._build is not kda_b._build
        assert serve_b.__name__ == "repro_torch.launch.serve"
        g = torch.Generator().manual_seed(0)
        q, k = torch.randn(1, 4, 8, generator=g), torch.randn(1, 6, 2, 8, generator=g)
        assert torch.equal(kda_a.decode_attention(q, k, k, 3),
                           kda_b.decode_attention(q, k, k, 3))
    finally:
        for m in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[m]
        sys.modules.update(before)


def test_every_cut_still_finds_its_piece():
    """Each cut replaces its piece where the piece occurs once, leaves the
    rest of the source as it is, and is an error where the piece is gone
    (the timer then stops rather than time the whole kernel under a cut's
    name).  The stand-in source holds every piece once."""
    spec = importlib.util.spec_from_file_location(
        "decode_cuts", SCRIPT.parent / "decode_cuts.py")
    cuts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cuts)
    source = "// head\n" + "\n// between\n".join(p for p, _ in cuts.CUTS.values()) + "\n// tail"
    out = cuts.variants(source)
    assert out["whole"] == source and set(out) == {"whole", *cuts.CUTS}
    for name, (piece, cut) in cuts.CUTS.items():
        assert out[name] == source.replace(piece, cut) and piece not in out[name]
    with pytest.raises(ValueError, match="merge"):
        cuts.variants(source.replace(cuts.CUTS["merge"][0], ""))
    with pytest.raises(ValueError, match="merge"):
        cuts.variants(source + cuts.CUTS["merge"][0])
