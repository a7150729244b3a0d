"""Energy substrate: hardware specs and meters (the analytic simulator is
not ported yet)."""

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
