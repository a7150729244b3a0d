"""Three-term roofline analysis of a traced dry-run step.

Port of `repro.analysis.roofline`, same formula and defaults:

    compute term    = FLOPs / (chips x peak_FLOP/s)
    memory term     = HBM_bytes / (chips x HBM_bw)
    collective term = collective_bytes / (chips x link_bw x links)

FLOPs and collective_bytes are the per-device counts of the traced step
(repro_torch.analysis.trace) times the chips; HBM bytes come from the
analytic cost model.  MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D
(forward-only); the ratio MODEL_FLOPS / FLOPs measures how much of the
traced compute is "useful".  The dry run prices with `H100_SXM` and its
NVLink links; the defaults are the reference's.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis.trace import Totals
from repro_torch.energy.hardware import TPU_V5E, AcceleratorSpec


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    # global quantities
    hlo_flops: float            # per-device FLOPs x chips
    hbm_bytes: float            # analytic model, global
    collective_bytes: float     # per-device x chips
    model_flops: float          # 6·N·D or 2·N·D
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else float("nan")

    def to_dict(self) -> dict:
        return {
            **dataclasses.asdict(self),
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "step_s": self.step_s,
        }


def roofline_terms(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    hlo_totals: Totals,
    hbm_bytes_global: float,
    model_flops: float,
    accel: AcceleratorSpec = TPU_V5E,
    ici_links: int = 4,
) -> RooflineTerms:
    hlo_flops_global = hlo_totals.flops * chips
    coll_global = hlo_totals.total_collective_bytes * chips
    compute_s = hlo_flops_global / (chips * accel.peak_flops)
    memory_s = hbm_bytes_global / (chips * accel.hbm_bw)
    collective_s = coll_global / (chips * accel.ici_bw * ici_links)
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=hlo_flops_global, hbm_bytes=hbm_bytes_global,
        collective_bytes=coll_global, model_flops=model_flops,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
    )
