"""Port copy of `repro.energy.hardware`, numpy only, with its imports renamed;
tests/test_torch_serve.py holds it to the reference.

Hardware specifications and power models.

The paper profiles A100-40GB + AMD EPYC 7742; our deployment target is
TPU v5e pods with a CPU host.  Both are described by the same spec so the
workload-based energy models can be fit per (model, system) combination —
the paper's stated goal ("parameters determined ... for each model and
system combination").

Dynamic energy is split between compute and memory traffic:
    P_dyn = peak_w - idle_w
    e_flop = COMPUTE_SHARE * P_dyn / peak_flops      [J/FLOP]
    e_byte = (1 - COMPUTE_SHARE) * P_dyn / hbm_bw    [J/B]
so a fully compute-bound kernel at peak FLOP/s draws peak_w, and a fully
memory-bound kernel at peak bandwidth draws the same — the roofline power
model used by POLCA-style studies.

DVFS (per-phase frequency scaling)
----------------------------------
``AcceleratorSpec.at_frequency(s)`` returns the spec at core-clock scale
s ∈ (0, 1] with the roofline moved per the standard DVFS laws:

    peak_flops(s) = s · peak_flops            (compute rate ∝ core clock)
    hbm_bw(s)     = (μ + (1 − μ)·s) · hbm_bw  (HBM clock is a separate
                                               domain; μ = dvfs_bw_floor is
                                               the bandwidth fraction kept
                                               as s → 0, i.e. only the
                                               on-chip fabric/L2 share of
                                               the pipe follows the core)
    dyn_w(s)      = s^α · dyn_w               (P ∝ f·V², V roughly ∝ f ⇒
                                               α ≈ 3; measured GPU curves
                                               sit nearer α ≈ 2.4 because
                                               voltage floors flatten the
                                               tail — dvfs_power_exp)
    idle_w(s)     = idle_w                    (leakage, fans, HBM refresh)

Compute-bound prefill therefore loses throughput ∝ 1/s but saves dynamic
energy ∝ s^(α−1), while bandwidth-bound decode keeps most of its
throughput (μ close to 1) and still takes the full s^α dynamic-power win —
the opposite-payoffs-per-phase structure Fernandez et al. (arXiv:
2504.17674) measure.  ``dvfs_scales`` is the discrete set of operating
points a governor may pick from (real parts expose discrete P-states);
``scale=1.0`` is always the last entry so "no DVFS" stays expressible.
"""

from __future__ import annotations

import dataclasses

COMPUTE_SHARE = 0.6

# default governor-visible operating points (fractions of the max core clock)
DVFS_SCALES = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    name: str
    peak_flops: float          # FLOP/s (bf16)
    hbm_bw: float              # B/s
    ici_bw: float              # B/s per link (interconnect)
    hbm_bytes: float
    idle_w: float
    peak_w: float
    flops_efficiency: float = 0.55   # achievable fraction of peak (matmul)
    bw_efficiency: float = 0.8
    # --- DVFS law (see module docstring) -------------------------------
    dvfs_scales: tuple[float, ...] = DVFS_SCALES
    dvfs_power_exp: float = 2.4      # dyn_w ∝ s^α
    dvfs_bw_floor: float = 0.8       # hbm_bw fraction retained as s → 0

    @property
    def dyn_w(self) -> float:
        return self.peak_w - self.idle_w

    def at_frequency(self, scale: float) -> "AcceleratorSpec":
        """This accelerator at core-clock scale ∈ (0, 1]: peak_flops ∝ s,
        hbm_bw partially coupled (μ + (1−μ)·s), dyn_w ∝ s^α, idle_w fixed.
        FLOP/byte *counts* of a pass never change — only rates and power —
        so the closed-form phase integrals stay exact at any point."""
        if scale == 1.0:
            return self
        if not 0.0 < scale <= 1.0:
            raise ValueError(f"frequency scale must be in (0, 1], got {scale}")
        bw_frac = self.dvfs_bw_floor + (1.0 - self.dvfs_bw_floor) * scale
        dyn = self.dyn_w * scale ** self.dvfs_power_exp
        return dataclasses.replace(
            self,
            name=f"{self.name}@{scale:g}x",
            peak_flops=self.peak_flops * scale,
            hbm_bw=self.hbm_bw * bw_frac,
            peak_w=self.idle_w + dyn,
        )

    @property
    def j_per_flop(self) -> float:
        return COMPUTE_SHARE * self.dyn_w / self.peak_flops

    @property
    def j_per_byte_hbm(self) -> float:
        return (1.0 - COMPUTE_SHARE) * self.dyn_w / self.hbm_bw

    @property
    def j_per_byte_ici(self) -> float:
        # interconnect energy ~ 2x HBM per byte (serdes + both endpoints)
        return 2.0 * self.j_per_byte_hbm


@dataclasses.dataclass(frozen=True)
class HostSpec:
    name: str
    n_cores: int
    idle_w: float
    active_w_per_core: float
    serving_cores: int         # cores busy during inference (paper's psutil residency)


# --- target hardware: TPU v5e (the numbers given in the brief) -------------

TPU_V5E = AcceleratorSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16e9,
    idle_w=70.0,
    peak_w=220.0,
)

# --- the port's card: NVIDIA H100 SXM (prices the port's dry run) ----------
# Dense bf16 peak, HBM3 rate and NVLink 4 (18 links of 25 GB/s a direction)
# from NVIDIA's H100 SXM specification; hbm_bytes as
# torch.cuda.get_device_properties(0).total_memory reports it on an
# "NVIDIA H100 80GB HBM3", idle_w as nvidia-smi's power.draw read that card
# before any work, peak_w its power limit (700.00 W).

H100_SXM = AcceleratorSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=25e9,
    hbm_bytes=85017493504.0,
    idle_w=71.66,
    peak_w=700.0,
)
H100_NVLINK_LINKS = 18

# --- the paper's hardware (for reproducing its absolute numbers) -----------

A100_40GB = AcceleratorSpec(
    name="a100-40gb",
    peak_flops=312e12,          # bf16 dense
    hbm_bw=1555e9,
    ici_bw=300e9,               # NVLink3 per direction aggregate
    hbm_bytes=40e9,
    idle_w=55.0,
    peak_w=400.0,
)

EPYC_7742 = HostSpec(
    name="epyc-7742",
    n_cores=64,
    idle_w=90.0,
    active_w_per_core=2.1,      # AMD uProf-style per-core draw under load
    serving_cores=8,
)

GENERIC_HOST = HostSpec(
    name="container-host", n_cores=8, idle_w=20.0,
    active_w_per_core=6.0, serving_cores=4)


@dataclasses.dataclass(frozen=True)
class Node:
    """A heterogeneous accelerator+CPU serving node (paper §3.2)."""

    accel: AcceleratorSpec
    host: HostSpec
    n_accel: int = 1
    dispatch_overhead_s: float = 30e-6   # per device pass (kernel launch/queue)

    def with_accelerators(self, n: int) -> "Node":
        return dataclasses.replace(self, n_accel=n)


SWING_NODE = Node(accel=A100_40GB, host=EPYC_7742)         # the paper's node
TPU_NODE = Node(accel=TPU_V5E, host=GENERIC_HOST)          # our target


def min_accelerators(param_bytes: float, accel: AcceleratorSpec,
                     overhead: float = 1.15) -> int:
    """Paper Table 1's '# A100s': minimum devices to hold the weights."""
    import math
    return max(1, math.ceil(param_bytes * overhead / accel.hbm_bytes))
