"""The prefill-wall timer (`repro_torch/launch/prefill_wall.py`) on the CPU
at a reduced size: one sample set in this process, and the alternating
A/B across fresh processes."""

import importlib.util
import json
import os
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "src" / "repro_torch" / "launch" / "prefill_wall.py"


@pytest.fixture(scope="module")
def pw():
    spec = importlib.util.spec_from_file_location("prefill_wall", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield mod
    torch.set_num_threads(threads)


def test_time_prefills_hybrid(pw):
    rec = pw.time_prefills("recurrentgemma-9b-reduced", 2, 12, 3, "cpu")
    assert len(rec["wall_ms"]) == len(rec["cpu_ms"]) == 3
    assert all(w > 0 for w in rec["wall_ms"]) and rec["median_wall_ms"] > 0
    assert rec["b4_wrapper_host_us"] > 0
    assert Path(rec["package"]) == ROOT / "src" / "repro_torch"


def test_time_prefills_no_b4(pw):
    rec = pw.time_prefills("llama2-7b-reduced", 2, 8, 2, "cpu")
    assert len(rec["wall_ms"]) == 2 and rec["b4_wrapper_host_us"] is None


def test_ab_alternates_trees(pw, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    src = str(ROOT / "src")
    assert pw.main(["--ab", src, src, "--pairs", "2", "--arch", "recurrentgemma-9b-reduced",
                    "--batch", "1", "--seq", "8", "--reps", "2", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    runs, summary = lines[:-1], lines[-1]["summary"]
    assert [r["tree"] for r in runs] == ["A", "B", "B", "A"]
    assert [r["pair"] for r in runs] == [0, 0, 1, 1]
    assert all(len(r["wall_ms"]) == 2 and r["package"] == os.path.join(src, "repro_torch")
               for r in runs)
    assert set(summary) == {"A", "B"} and summary["A"]["median_of_medians_wall_ms"] > 0
