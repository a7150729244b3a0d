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
