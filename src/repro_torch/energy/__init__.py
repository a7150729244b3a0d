"""Energy substrate: hardware specs, meters, the analytic cost model and
simulator."""

from repro_torch.energy.costs import (  # noqa: F401
    PassCosts,
    PassCostsBatch,
    decode_step_polys,
    kv_bytes_per_token,
    pass_costs,
    pass_costs_batch,
)
from repro_torch.energy.hardware import (  # noqa: F401
    A100_40GB,
    EPYC_7742,
    GENERIC_HOST,
    Node,
    SWING_NODE,
    TPU_NODE,
    TPU_V5E,
    min_accelerators,
)
from repro_torch.energy.meter import ModeledMeter, WallClockMeter  # noqa: F401
from repro_torch.energy.simulator import AnalyticLLMSimulator, PhaseBreakdown  # noqa: F401
