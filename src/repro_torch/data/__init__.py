"""Data pipeline: synthetic workloads and token streams."""

from repro_torch.data.workloads import (  # noqa: F401
    WorkloadSpec,
    alpaca_like_workload,
    arrival_times,
    grid_workload,
    timestamped_workload,
    token_batches,
)
