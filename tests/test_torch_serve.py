"""The PyTorch port's serve slice against the JAX package: the numpy-only
copies (workloads, statistics, profiles, scheduler, router) must give the
reference's answers exactly; the port's `serve` must run end to end on the
CPU; and no port module, nor `chip_smoke.py`, may load JAX or `repro`.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import characterize as jchar
from repro.core.energy_model import AccuracyModel as JAcc
from repro.core.energy_model import BilinearModel as JBil
from repro.core.energy_model import LLMProfile as JProfile
from repro.core.energy_model import fit_profile as jfit
from repro.data import workloads as jwl
from repro.serving import EnergyAwareRouter as JRouter
from repro.serving import Request as JRequest
from repro_torch.core import characterize
from repro_torch.core.energy_model import AccuracyModel, BilinearModel, LLMProfile, fit_profile
from repro_torch.data import workloads
from repro_torch.launch import serve as port_serve
from repro_torch.serving import EnergyAwareRouter, Request

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here.  At these tiny shapes its
    intra-op threads only add overhead, and with several pytest-xdist
    workers on one machine they oversubscribe the cores: six concurrent
    CPU `serve()` runs took over 15 minutes with the default threads and
    about 10 s each with one.  One thread also avoids a fault seen in the
    first multi-threaded float32 `torch.exp` of a process (values ~1e-4
    off, relative, in about one process in twenty)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestWorkloads:
    @pytest.mark.parametrize("kw", [dict(), dict(n_queries=24, max_in=48, max_out=32,
                                                 in_log_mean=2.8, out_log_mean=2.5),
                                    dict(n_queries=64, seed=9)])
    def test_alpaca_like_and_token_batches_identical(self, kw):
        ours = workloads.alpaca_like_workload(workloads.WorkloadSpec(**kw))
        ref = jwl.alpaca_like_workload(jwl.WorkloadSpec(**kw))
        assert ours == ref
        for seed in (0, 3):
            for a, b in zip(workloads.token_batches(ours, 4, 32000, seed=seed),
                            jwl.token_batches(ref, 4, 32000, seed=seed), strict=True):
                assert a.keys() == b.keys()
                for key in a:
                    assert a[key].dtype == b[key].dtype
                    assert a[key].tobytes() == b[key].tobytes()


def _profiles(port: bool):
    B, A, P = (BilinearModel, AccuracyModel, LLMProfile) if port else (JBil, JAcc, JProfile)
    return [P("small", B((0.1, 0.4, 1e-4)), B((1e-3, 4e-3, 1e-6)), A(50.0)),
            P("mid", B((0.3, 1.1, 3e-4)), B((3e-3, 1e-2, 3e-6)), A(58.0)),
            P("big", B((0.5, 2.0, 5e-4)), B((5e-3, 2e-2, 5e-6)), A(65.0))]


class TestCoreAndRouter:
    def test_campaign_and_fit_identical(self):
        settings = dict(vary_input_range=(8, 64), vary_output_range=(8, 64),
                        grid_range=(8, 64), max_trials=3, min_trials=2, ci_tolerance_s=0.5)

        def measure_with(rng):
            def measure(tin, tout):
                return (0.3 * tin + 0.9 * tout + 1e-3 * tin * tout + rng.random(),
                        1e-3 * tin + 4e-3 * tout + 1e-3 * rng.random())
            return measure

        ours = characterize.run_campaign("m", measure_with(np.random.default_rng(5)),
                                         characterize.CampaignSettings(**settings))
        ref = jchar.run_campaign("m", measure_with(np.random.default_rng(5)),
                                 jchar.CampaignSettings(**settings))
        assert [tuple(vars(t).values()) for t in ours] == [tuple(vars(t).values()) for t in ref]
        a = characterize.fit_profile_from_trials("m", 50.0, ours)
        b = jchar.fit_profile_from_trials("m", 50.0, ref)
        assert a.to_dict() == b.to_dict()
        tin, tout = np.array([8.0, 16, 64, 32]), np.array([8.0, 64, 16, 32])
        e = 0.2 * tin + tout + 0.01 * tin * tout
        assert fit_profile("x", 1.0, tin, tout, e, e).to_dict() == \
            jfit("x", 1.0, tin, tout, e, e).to_dict()

    @pytest.mark.parametrize("zeta", [0.0, 0.5, 1.0])
    @pytest.mark.parametrize("gamma", [None, (0.2, 0.3, 0.5)])
    def test_router_partition_matches_reference(self, zeta, gamma):
        queries = jwl.alpaca_like_workload(jwl.WorkloadSpec(n_queries=40, seed=2))
        ours = EnergyAwareRouter(_profiles(True), zeta=zeta, gamma=gamma).route(
            [Request(i, np.zeros(a, np.int32), b) for i, (a, b) in enumerate(queries)])
        ref = JRouter(_profiles(False), zeta=zeta, gamma=gamma).route(
            [JRequest(i, np.zeros(a, np.int32), b) for i, (a, b) in enumerate(queries)])
        assert {k: [r.request_id for r in v] for k, v in ours.per_model.items()} == \
            {k: [r.request_id for r in v] for k, v in ref.per_model.items()}
        assert ours.assignment.objective == ref.assignment.objective
        np.testing.assert_array_equal(ours.assignment.assignee, ref.assignment.assignee)


class TestServe:
    def test_serve_end_to_end_on_cpu(self):
        archs = ["llama2-7b-reduced", "llama2-70b-reduced"]
        out = port_serve.serve(archs, n_queries=8, zeta=0.5, device="cpu")
        routed = {a for a, rs in out["plan"].per_model.items() if rs}
        assert routed and set(out["totals"]) == routed
        assert sum(t["queries"] for t in out["totals"].values()) == 8
        for t in out["totals"].values():
            assert t["energy_j"] > 0 and t["runtime_s"] > 0 and t["tokens"] > 0
        assert [p.name for p in out["profiles"]] == archs
        assert all(np.isfinite(p.energy.coeffs + p.runtime.coeffs).all()
                   for p in out["profiles"])

    def test_served_batches_repeat_inside_their_window(self, monkeypatch):
        """With a per-call meter (NVML's on the card) each served batch is
        repeated inside one window of at least TRIAL_WINDOW_S, as a trial
        is, and the totals keep each batch's repeats."""
        from repro_torch.serving import InferenceEngine

        class PerCallMeter:
            per_call, power_w = True, 100.0

            def invalidate(self):
                pass

            def measure(self, fn):
                out = fn()
                return out, 0.01, 1.0

        built, kv_on_calls = [], []
        build, cached = port_serve.build_engine, InferenceEngine._generate_cached

        def recording_build(arch, **kw):
            built.append((kw["kv_cache"], kw.get("min_window_s", 0.0)))
            return build(arch, **kw)

        def counting_cached(eng, *args):
            kv_on_calls.append(eng.cfg.name)
            return cached(eng, *args)

        monkeypatch.setattr(port_serve, "WallClockMeter", PerCallMeter)
        monkeypatch.setattr(port_serve, "TRIAL_WINDOW_S", 0.1)
        monkeypatch.setattr(port_serve, "build_engine", recording_build)
        monkeypatch.setattr(InferenceEngine, "_generate_cached", counting_cached)
        out = port_serve.serve(["llama2-7b-reduced", "llama2-70b-reduced"], n_queries=8,
                               zeta=0.5, char_max_tokens=16, device="cpu")
        assert {w for kv, w in built} == {0.1}
        assert sum(kv for kv, _ in built) == 2
        repeats = [r for t in out["totals"].values() for r in t["repeats"]]
        assert [len(t["repeats"]) for t in out["totals"].values()] == \
            [t["batches"] for t in out["totals"].values()]
        assert min(repeats) >= 1 and len(kv_on_calls) == sum(repeats) > len(repeats)
        for arch, t in out["totals"].items():
            assert t["energy_j"] == pytest.approx(sum(1.0 / r for r in t["repeats"]))

    def test_entry_points_default_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_serve.build_engine("llama2-7b-reduced", kv_cache=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_serve.main(["--fleet", "llama2-7b-reduced", "--queries", "2"])


PROBE = """
import pkgutil, sys, importlib
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, {root!r})
import chip_smoke
import runpy
for name in ("quickstart", "zeta_sweep", "cluster_sim", "serve_endtoend", "train_small"):
    runpy.run_path({root!r} + f"/examples/torch_{{name}}.py", run_name="probe")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
print("loaded", len([m for m in sys.modules if m.startswith("repro_torch")]), bad)
assert not bad, bad
"""


ALONE = """
import sys, importlib
importlib.import_module({mod!r})
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""


RUN_CLUSTER = """
import sys
import numpy as np
from repro_torch.cluster import (CheckpointConfig, ClusterNode, FailoverPolicy,
                                 FaultInjector, PrefixCacheConfig,
                                 SessionAffinityPolicy, session_trace)
from repro_torch.cluster.engine import Runner
from repro_torch.configs import PAPER_ZOO, TABLE1
from repro_torch.core.energy_model import fit_profile
from repro_torch.energy import AnalyticLLMSimulator, SWING_NODE
from repro_torch.obs import EventTracer, InvariantAuditor, Telemetry
from repro_torch.serving import OnlineRouter, Request

pts = [(8, 8), (64, 64), (256, 128), (512, 512), (128, 32)]
profiles = {}
for name in ("llama2-7b", "llama2-13b"):
    sim = AnalyticLLMSimulator(PAPER_ZOO[name], SWING_NODE, batch=1,
                               kv_cache=True, noise_sigma=0.0)
    pbs = [sim.simulate(a, b) for a, b in pts]
    profiles[name] = fit_profile(name, TABLE1[name]["a_k"], [p[0] for p in pts],
                                 [p[1] for p in pts], [pb.energy_j for pb in pbs],
                                 [pb.runtime_s for pb in pbs])
nodes = [ClusterNode(i, PAPER_ZOO[n], profiles[n], SWING_NODE, max_batch=2,
                     prefix_cache=PrefixCacheConfig(),
                     checkpoint=CheckpointConfig(interval_tokens=16))
         for i, n in enumerate(("llama2-7b", "llama2-13b", "llama2-7b", "llama2-13b"))]
trace = session_trace(6, turns=3, think_s=4.0, rate_qps=1.0, seed=0)
faults = FaultInjector(mttf_s=5.0, mttr_s=3.0, seed=0).generate(range(4), trace.duration_s)
tel = Telemetry(tracer=EventTracer(), auditor=InvariantAuditor(), sample_every_s=2.0)
rep = Runner(trace, nodes, FailoverPolicy(SessionAffinityPolicy()), zeta=0.5,
             faults=faults, telemetry=tel, shard_count=4, obs_mode="sharded").run()
# the auditor's lazy imports run on a KV migration, a checkpoint and a cache hit
assert len(rep.records) == len(trace) and tel.auditor.n_checks > 0
assert rep.total_migrations and rep.total_checkpoints and rep.total_cache_hits
assert "sim_" in tel.prometheus_text() and len(tel.tracer) > 0
router = OnlineRouter(list(profiles.values()))
req = Request(request_id=0, tokens=np.zeros(12, np.int32), max_new_tokens=8)
assert router.route_one(req) in profiles
router.complete(req)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""


class TestIsolation:
    def test_port_and_chip_smoke_load_no_jax_or_repro(self):
        """Every port module, `chip_smoke.py` and the five port examples
        (their imports only: `run_name` is not `__main__`)."""
        res = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                             env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr
        assert "loaded" in res.stdout

    @pytest.mark.parametrize("mod", ["repro_torch.models.encdec", "repro_torch.models.vlm",
                                     "repro_torch.configs.shapes", "repro_torch.optim",
                                     "repro_torch.checkpoint", "repro_torch.launch.steps",
                                     "repro_torch.launch.train", "repro_torch.kernels.ref",
                                     "repro_torch.kernels.ops", "repro_torch.shard",
                                     "repro_torch.launch.mesh", "repro_torch.launch.sharding",
                                     "repro_torch.launch.dryrun", "repro_torch.analysis",
                                     "repro_torch.analysis.trace",
                                     "repro_torch.analysis.roofline",
                                     "repro_torch.analysis.report", "repro_torch.graphs"])
    def test_encdec_vlm_modules_alone_load_no_jax_or_repro(self, mod):
        """The encdec and vlm ports, the input shapes, the training path's
        modules and the kernels' oracles and public names, each imported
        first in a fresh interpreter (the JAX package's counterparts import
        JAX)."""
        res = subprocess.run([sys.executable, "-c", ALONE.format(mod=mod)],
                             env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0 and "ok" in res.stdout, res.stdout + res.stderr

    def test_cluster_run_and_online_route_load_no_jax_or_repro(self):
        """A sharded, audited simulation with full telemetry and an online
        route, run in a fresh interpreter: the imports these make only when
        they run (the auditor's `energy.costs`, the runner's sharded `obs`,
        the router's `cluster`) are the port's own."""
        res = subprocess.run([sys.executable, "-c", RUN_CLUSTER],
                             env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0 and "ok" in res.stdout, res.stdout + res.stderr

    def test_chip_smoke_fails_without_a_card(self, tmp_path):
        """No CUDA here: a nonzero exit and no result line, both from the
        checkout and from a directory holding only the script."""
        alone = tmp_path / "chip_smoke.py"
        alone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
            res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                                 capture_output=True, text=True, timeout=120)
            assert res.returncode != 0
            assert '"ok": true' not in res.stdout
