"""Port copy of `repro.serving.router`, numpy only, with its imports renamed;
tests/test_torch_serve.py and tests/test_torch_cluster.py hold it to the
reference.

Energy-aware request routing — the paper's scheduler applied to serving.

The offline scheduler (repro_torch.core.scheduler) partitions a known workload;
the EnergyAwareRouter wraps it for the serving path: given a batch of
Requests with known/estimated output lengths (the paper assumes offline
knowledge, citing Zheng et al. for online estimation), it assigns each to
a hosted model and groups them into per-model batches.

OnlineRouter is the streaming counterpart: it routes one request at a
time through any repro_torch.cluster policy (zeta_online by default) over live
per-model load counters — the adapter that lets the serving engine use the
cluster simulator's policies against real traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.energy_model import LLMProfile, normalized_costs
from repro_torch.core.scheduler import Assignment, schedule, schedule_capacitated
from repro_torch.serving.requests import Request


@dataclasses.dataclass
class RoutingPlan:
    assignment: Assignment
    per_model: dict[str, list[Request]]


class EnergyAwareRouter:
    def __init__(self, profiles: Sequence[LLMProfile], *, zeta: float = 0.5,
                 gamma: Sequence[float] | None = None):
        self.profiles = list(profiles)
        self.zeta = zeta
        self.gamma = gamma

    def route(self, requests: Sequence[Request],
              tau_out_estimates: Sequence[int] | None = None) -> RoutingPlan:
        if tau_out_estimates is None:
            tau_out_estimates = [r.max_new_tokens for r in requests]
        queries = [(r.tau_in, int(t)) for r, t in zip(requests, tau_out_estimates)]
        if self.gamma is not None:
            asg = schedule_capacitated(self.profiles, queries, self.zeta, self.gamma)
        else:
            asg = schedule(self.profiles, queries, self.zeta)
        per_model: dict[str, list[Request]] = {p.name: [] for p in self.profiles}
        for req, k in zip(requests, asg.assignee):
            name = self.profiles[int(k)].name
            req.model = name
            per_model[name].append(req)
        return RoutingPlan(assignment=asg, per_model=per_model)

    def predicted_costs(self, requests: Sequence[Request]) -> np.ndarray:
        queries = [(r.tau_in, r.max_new_tokens) for r in requests]
        return normalized_costs(self.profiles, queries).energy


# ---------------------------------------------------------------------------
# Online (streaming) adapter over the cluster policies
# ---------------------------------------------------------------------------


class _ModelView:
    """The minimal node surface a cluster policy reads: identity, profile,
    a live load signal (outstanding requests on this model), and the
    power/wake signals — constant here, since a live router's models are
    always-on (power_rank 0, no pending wake energy)."""

    power_rank = 0
    pending_wake_j = 0.0

    def __init__(self, node_id: int, profile: LLMProfile):
        self.node_id = node_id
        self.profile = profile
        self.outstanding = 0

    def load(self) -> int:
        return self.outstanding


class OnlineRouter:
    """Route requests one at a time as they arrive (no batching window).

    Wraps a repro_torch.cluster RoutingPolicy over per-model load views; the
    caller reports completions so load-aware policies see live queue
    depths.  Offline-information policies (the oracle) need a full trace
    and are rejected here — they belong in the cluster simulator.
    """

    def __init__(self, profiles: Sequence[LLMProfile], *,
                 policy=None, zeta: float = 0.5):
        from repro_torch.cluster.policies import OfflineOraclePolicy, ZetaOnlinePolicy
        from repro_torch.cluster.trace import ArrivalTrace

        if isinstance(policy, OfflineOraclePolicy):
            raise ValueError("the offline oracle needs the full trace — "
                             "use repro_torch.cluster.simulate_cluster")
        self.views = [_ModelView(i, p) for i, p in enumerate(profiles)]
        self.policy = policy or ZetaOnlinePolicy()
        self.policy.attach(self.views, ArrivalTrace("live", ()), zeta)
        self._clock = 0
        self._view_of: dict[int, int] = {}  # request_id -> view index

    def route_one(self, request: Request,
                  tau_out_estimate: int | None = None) -> str:
        """Assign one request to a hosted model; returns the model name."""
        from repro_torch.cluster.trace import TracedRequest

        tau_out = int(tau_out_estimate if tau_out_estimate is not None
                      else request.max_new_tokens)
        traced = TracedRequest(request.request_id, float(self._clock),
                               request.tau_in, tau_out)
        self._clock += 1
        nid = self.policy.select(traced, self.views, float(self._clock))
        view = self.views[nid]
        view.outstanding += 1
        self._view_of[request.request_id] = nid
        request.model = view.profile.name
        return view.profile.name

    def complete(self, request: Request) -> None:
        """Report a finished request so load signals stay accurate."""
        nid = self._view_of.pop(request.request_id, None)
        if nid is not None and self.views[nid].outstanding > 0:
            self.views[nid].outstanding -= 1
