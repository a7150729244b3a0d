"""The yardstick's arithmetic and files: FLOP and byte counts against hand
counts, the traffic generator's determinism and bucketing, the useful
token and gap counts, every cell's files found by name, the imports a chip
run loads, and the result line's schema."""

import ast
import collections
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from bench import flops, traffic
from bench.measure import Run, Served
from bench.spec import BENCH, ROOT, Spec, load_cell, metric_entries
from bench.tests import tiny

DENSE = Spec(name="d", family="dense", n_layers=3, d_model=8, n_heads=4, n_kv_heads=2,
             head_dim=2, d_ff=16, vocab_size=10, window=5, rope_theta=1e4, rms_eps=1e-5,
             dtype="bfloat16")
MOE = dataclasses.replace(DENSE, family="moe", window=0, n_experts=4, top_k=2)


def test_layer_params_by_hand():
    # q 8x8, k and v 8x4 each, o 8x8; SwiGLU 3 x 8 x 16
    assert flops.layer_params(DENSE) == 64 + 32 + 32 + 64 + 384
    # router 8x4, two of four experts
    assert flops.layer_params(MOE) == 192 + 32 + 2 * 384


@pytest.mark.parametrize("n,window", [(1, 0), (4, 0), (4, 5), (9, 5), (40, 7)])
def test_context_sum_by_hand(n, window):
    want = sum(min(p + 1, window) if window else p + 1 for p in range(n))
    assert flops.context_sum(n, window) == want


def test_request_flops_by_hand():
    tin, tout = 4, 3
    n = tin + tout - 1                       # positions fed through the layers
    attn = sum(min(p + 1, 5) for p in range(n)) * 4 * 4 * 2 * 3
    want = 2 * 576 * n * 3 + 2 * 8 * 10 * tout + attn
    assert flops.request_flops(DENSE, tin, tout) == want


def test_b1_counts_by_hand():
    f, b = flops.b1_call(DENSE, batch=3, keys=7)
    assert f == 4 * 3 * 4 * 2 * 7
    assert b == 2 * 3 * 7 * 2 * 2 * 2 + 2 * 3 * 4 * 2 * 2
    calls, least = flops.b1_batch(DENSE, batch=3, prompt=3, steps=4)
    assert calls == 4 * 3
    keys = [4, 5, 5, 5]                      # prompt + t + 1, at most the window
    assert least == pytest.approx(sum(flops.b1_least_s(*flops.b1_call(DENSE, 3, k)) * 3
                                      for k in keys))


def test_job_is_fixed_by_its_seed_and_serves_the_same_sizes_for_every_seed():
    tr = tiny.TRAFFIC
    a = traffic.job(tr, 12, 4, 256, 2**40 + 3, 0)
    b = traffic.job(tr, 12, 4, 256, 2**40 + 3, 0)
    c = traffic.job(tr, 12, 4, 256, 9, 0)
    assert [x.requests for x in a] == [x.requests for x in b]
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))
    sizes = lambda j: sorted((r.tau_in, r.tau_out) for x in j for r in x.requests)  # noqa: E731
    assert sizes(a) == sizes(c) == sorted(traffic.sizes(tr, 12))
    assert [x.requests for x in a] != [x.requests for x in c]
    assert not np.array_equal(a[0].tokens, c[0].tokens) or a[0].requests != c[0].requests


def test_batches_group_requests_by_bucket_pair_and_pad_rows():
    tr = tiny.TRAFFIC
    for x in traffic.job(tr, 12, 4, 256, 5, 1):
        assert x.tokens.shape == (4, x.prompt) and x.tokens.dtype == np.int32
        assert 1 <= len(x.requests) <= 4
        for row, r in enumerate(x.requests):
            assert traffic.bucket(r.tau_in, tr["prompt"]["buckets"]) == x.prompt
            assert traffic.bucket(r.tau_out, tr["output"]["buckets"]) == x.steps
            assert (x.tokens[row, :r.tau_in] > 0).all() and (x.tokens[row, r.tau_in:] == 0).all()
        last = x.requests[-1].tau_in           # padding rows repeat the last request's length
        for row in range(len(x.requests), 4):
            assert (x.tokens[row, :last] > 0).all() and (x.tokens[row, last:] == 0).all()


def test_sizes_follow_the_traffic_files_clips():
    for path in sorted((BENCH / "traffic").glob("*.json")):
        tr = json.loads(path.read_text())
        for a, b in traffic.sizes(tr, 256):
            assert tr["prompt"]["min"] <= a <= tr["prompt"]["max"]
            assert tr["output"]["min"] <= b <= tr["output"]["max"]
    chat = json.loads((BENCH / "traffic" / "chat.json").read_text())
    tin = [a for a, _ in traffic.sizes(chat, 1000)]
    assert np.median(tin) == pytest.approx(np.exp(3.4), rel=0.05)


def _served(tr, job, steps_s=0.01):
    out = []
    t = 0.0
    for x in job:
        walls = []
        for _ in range(1 + x.steps):
            walls.append((t, t + steps_s))
            t += steps_s
        out.append(Served(x, np.zeros((4, x.steps), np.int32), walls))
    return out


def test_useful_tokens_and_gaps_count_only_each_requests_own_tokens():
    job = traffic.job(tiny.TRAFFIC, 12, 4, 256, 5, 0)
    run = Run(cell=tiny.cell(), served=_served(tiny.TRAFFIC, job), window_s=1.0,
              setup_s=0.0, capture_s=0.0)
    assert run.out_tokens() == sum(b for _, b in traffic.sizes(tiny.TRAFFIC, 12))
    gaps = run.gaps()
    assert gaps.size == sum(b - 1 for _, b in traffic.sizes(tiny.TRAFFIC, 12))
    assert gaps == pytest.approx(np.full(gaps.size, 0.01))


def test_every_cell_finds_its_files_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["bench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.spec.name == w["config"]
        conf = cell.config
        assert sorted(conf["reduced"]) == sorted(configs[w["config"]]["reduced"])
        for key in conf["reduced"]:
            assert conf["published"][key] != conf[key]
        assert cell.cell["batch"] > 0 and all(v > 0 for v in cell.cell["check"]["limits"].values())
        for trace in (False, True):
            for m in metric_entries(w["name"], trace):
                assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


# Modules a chip run of `bench/run.py` loads; the reference and the metric
# readers may not import the program either.
RUN_MODULES = ["run", "harness", "spec", "traffic", "weights", "reference", "check", "measure",
               "flops", "peaks", "nvml", "devtrace", "result", "calibrate"]
PROGRAM_FREE = ["reference", "check", "measure", "flops", "peaks", "traffic", "weights", "spec",
                "devtrace", "nvml", "result"]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", [BENCH / f"{m}.py" for m in RUN_MODULES]
                         + sorted((BENCH / "metrics").glob("*.py")), ids=lambda p: p.name)
def test_no_module_a_run_loads_imports_jax_or_the_reference_package(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "repro"}, found
    if path.stem in PROGRAM_FREE or path.parent.name == "metrics":
        assert "repro_torch" not in found, found


def test_top_level_names_are_compared_whole():
    from bench.harness import FORBIDDEN

    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


def test_result_line_schema(monkeypatch):
    from bench import harness
    from bench.result import result_line

    monkeypatch.setattr(harness, "WARM_SECONDS", 0.0)
    cell = tiny.cell()
    run, device, found = harness.run_cell(cell, 2**33 + 1, 0.0, False, device="cpu",
                                          energy=False)
    out = result_line(cell, run, device, found, False)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert out["correct"] is True and out["attempted"] == 12 and out["failed"] == 0
    assert set(out["metrics"]) == {"out_tokens_per_s", "itl_p95_ms", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert set(out["check"]["widest_gap"]) == {"value", "limit"}
    json.dumps(out)
    units = collections.Counter(m["unit"] for m in out["metrics"].values())
    assert units["ms"] == 1


def test_run_without_a_card_prints_no_result(tmp_path):
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                           "mistral-7b.chat", "--seed", str(2**40), "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                                            "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
