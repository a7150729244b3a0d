"""B3 backward's timing tools without a card: the split timer
(`repro_torch/launch/scan_bwd_split.py`: its alternation of fresh processes
between two trees and its medians, with the processes' output stood in
for) and the cut timer (`repro_torch/launch/scan_bwd_cuts.py`: how it makes
its variants, on a stand-in source and on the kernel's own).  The timing
itself needs a card."""

import importlib.util
import json
import subprocess
from pathlib import Path

import pytest

LAUNCH = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "launch"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, LAUNCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_split_alternates_trees_and_takes_medians(monkeypatch, capsys):
    split = _load("scan_bwd_split")
    order = []

    def fake_run(cmd, check, capture_output, text):
        src = cmd[cmd.index("--src") + 1]
        order.append(src)
        ms = {"old": 3.0, "new": 0.5}[src] + 0.01 * len(order)
        kernels = ({"ssd_bwd_states_kernel": 1.2, "ssd_bwd_chunk_kernel": 1.7,
                    "ssd_bwd_group_sum_kernel": 0.07} if src == "old" else
                   {"ssd_bwd_states_kernel": 0.2 + 0.01 * len(order),
                    "ssd_bwd_chunk_kernel": 0.3})
        return subprocess.CompletedProcess(cmd, 0, stdout="noise\n" + json.dumps(
            {"device": "stand-in", "ms": ms, "split_ms": kernels, "package": src}))

    monkeypatch.setattr(subprocess, "run", fake_run)
    summary = split.run_ab("old", "new", 2)
    assert order == ["old", "new", "new", "old"]
    old, new = summary["A"], summary["B"]
    assert old["ms"] == pytest.approx((3.01 + 3.04) / 2)
    assert new["ms"] == pytest.approx((0.52 + 0.53) / 2)
    assert set(old["split_ms"]) == {"ssd_bwd_states_kernel", "ssd_bwd_chunk_kernel",
                                    "ssd_bwd_group_sum_kernel"}
    assert new["split_ms"]["ssd_bwd_states_kernel"] == pytest.approx(0.225)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and "summary" in json.loads(lines[-1])


def test_every_cut_still_finds_its_piece():
    """Each cut replaces its piece where the piece occurs once, leaves the
    rest of the source as it is, and is an error where the piece is gone
    or repeated (the timer then stops rather than time the whole kernel
    under a cut's name).  The kernel's own source holds every piece once."""
    cuts = _load("scan_bwd_cuts")
    source = "// head\n" + "\n// between\n".join(p for p, _ in cuts.CUTS.values()) + "\n// tail"
    out = cuts.variants(source)
    assert out["whole"] == source and set(out) == {"whole", *cuts.CUTS}
    for name, (piece, cut) in cuts.CUTS.items():
        assert out[name] == source.replace(piece, cut) and piece not in out[name]
    with pytest.raises(ValueError, match="chunk_units"):
        cuts.variants(source.replace(cuts.CUTS["chunk_units"][0], ""))
    with pytest.raises(ValueError, match="states_store"):
        cuts.variants(source + cuts.CUTS["states_store"][0])
    assert set(cuts.variants(cuts.SRC.read_text())) == {"whole", *cuts.CUTS}
