"""Energy-aware request routing — the paper's scheduler applied to serving.

Port of `repro.serving.router` (the offline router; `OnlineRouter` waits
for the cluster slice).  Given a batch of Requests with known/estimated
output lengths (the paper assumes offline knowledge), the
EnergyAwareRouter assigns each to a hosted model with the offline
scheduler (`repro_torch.core.scheduler`) and groups them into per-model
batches.
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
