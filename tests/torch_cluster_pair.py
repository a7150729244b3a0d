"""The cluster stacks of the JAX package and of its PyTorch port, side by
side, for the differential tests `tests/test_torch_obs.py`,
`tests/test_torch_cluster*.py`.

The reference's objects cannot be handed to the port, so every scenario
here is a function of one `Stack` and builds its fleet from plain inputs:
configs from that package's own `PAPER_ZOO`, Eq. 6/7 profiles fitted in
that package from the same probe points.  Scenarios return plain strings
(`ClusterReport.to_json(include_records=True)`, Prometheus text, Chrome
trace JSON), which the tests compare with `==`.
"""

from __future__ import annotations

import importlib
import json

import torch

# fig4_online_gap.py's (τin, τout) probe grid for the Eq. 6/7 fits
FIT_POINTS = ((8, 8), (64, 64), (256, 128), (1024, 256), (32, 512),
              (512, 512), (128, 32), (2048, 64), (2048, 1024))
MAX_BATCH = 8          # fig4_online_gap.MAX_BATCH
IDLE_TIMEOUT_S = 30.0  # fig4_online_gap.IDLE_TIMEOUT_S


class Stack:
    """One package's cluster, obs, config, energy and data modules."""

    MODULES = {"cluster": "cluster", "faults": "cluster.faults",
               "engine": "cluster.engine",
               "obs": "obs", "metrics": "obs.metrics",
               "configs": "configs", "energy": "energy",
               "em": "core.energy_model", "data": "data",
               "serving": "serving"}

    def __init__(self, pkg: str):
        self.pkg = pkg
        for attr, mod in self.MODULES.items():
            setattr(self, attr, importlib.import_module(f"{pkg}.{mod}"))
        self._profiles: dict = {}

    def __repr__(self) -> str:
        return self.pkg

    def profile(self, name: str, hw=None, points=FIT_POINTS):
        """llama2 Eq. 6/7 profile fitted against the analytic simulator
        on `hw` (SWING_NODE by default), as fig4 fits its fleet."""
        hw = hw if hw is not None else self.energy.SWING_NODE
        key = (name, repr(hw), points)
        if key not in self._profiles:
            sim = self.energy.AnalyticLLMSimulator(
                self.configs.PAPER_ZOO[name], hw, batch=1, kv_cache=True,
                noise_sigma=0.0)
            pbs = [sim.simulate(a, b) for a, b in points]
            self._profiles[key] = self.em.fit_profile(
                name, self.configs.TABLE1[name]["a_k"],
                [p[0] for p in points], [p[1] for p in points],
                [pb.energy_j for pb in pbs], [pb.runtime_s for pb in pbs])
        return self._profiles[key]

    def fig4_profiles(self):
        return [self.profile(n) for n in self.configs.CASE_STUDY_MODELS]

    def node_builders(self, names=None, *, hw=None, **kw):
        """Zero-arg node factories, node i hosting names[i] (fig4's
        case-study fleet by default) with fig4's max batch."""
        names = names or self.configs.CASE_STUDY_MODELS
        hw = hw if hw is not None else self.energy.SWING_NODE
        kw.setdefault("max_batch", MAX_BATCH)
        return [
            (lambda i=i, n=n: self.cluster.ClusterNode(
                i, self.configs.PAPER_ZOO[n], self.profile(n, hw), hw, **kw))
            for i, n in enumerate(names)]

    def nodes(self, names=None, **kw):
        return self.cluster.fresh_nodes(self.node_builders(names, **kw))

    def alpaca_trace(self, rate: float, n: int = 200, **spec):
        """fig4's trace: the Alpaca-like case-study workload (seed 7)
        replayed at `rate` qps with arrival seed 11."""
        queries = self.data.alpaca_like_workload(
            self.data.WorkloadSpec(n_queries=n, seed=7, **spec))
        return self.cluster.replay_trace(queries, rate, seed=11,
                                         name=f"alpaca@{rate:g}qps")

    def fig4_policies(self):
        """fig4_online_gap.make_policies()."""
        c = self.cluster
        return [c.RoundRobinPolicy(), c.RandomPolicy(seed=0),
                c.LeastLoadedPolicy(), c.GreedyEnergyPolicy(),
                c.ZetaOnlinePolicy(), c.OfflineOraclePolicy()]


REF = Stack("repro")
PORT = Stack("repro_torch")
STACKS = (REF, PORT)


def profiles_json(profiles) -> str:
    return json.dumps([p.to_dict() for p in profiles], sort_keys=True)


def report_json(rep) -> str:
    return rep.to_json(include_records=True)


def both(scenario, *args, **kw):
    """(reference result, port result) of one scenario."""
    return tuple(scenario(s, *args, **kw) for s in STACKS)


def one_thread():
    """Body of each differential file's module fixture: torch on one
    thread (the port's energy stack imports torch; with several xdist
    workers its default threads oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
