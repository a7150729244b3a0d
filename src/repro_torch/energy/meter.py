"""Energy meters — the PyJoules/uProf adaptation layer (paper §3.2).

Port of `repro.energy.meter`.  `WallClockMeter` measures real wall time
and converts to joules with the host power model (the AMD-uProf method:
power-per-active-core x time).  `ModeledMeter` instead charges an analytic
roofline energy for a declared cost.  `NvmlMeter` reads the joules: the
card's total-energy counter through NVML, as the paper reads an NVIDIA
GPU through PyJoules.  The CPU keeps `WallClockMeter`; on a CUDA device
the energy is NVML's, and a counter that cannot be opened or read raises.

All expose  measure(fn) -> (result, seconds, joules)  — the engine's
metering contract.  A timed window ends when the device has finished the
work: `torch.cuda.synchronize()` when the result holds a CUDA tensor,
where the reference calls `jax.block_until_ready`.
"""

from __future__ import annotations

import ctypes
import time

import torch

from repro_torch.energy.hardware import GENERIC_HOST, HostSpec, Node

NVML_LIBRARY = "libnvidia-ml.so.1"
TICK_TIMEOUT_S = 2.0        # the counter steps far more often than this


def block_until_ready(out):
    """Wait for the device work behind `out` (a tensor or a tuple/list
    holding some), then return it."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for x in items:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            break
    return out


class WallClockMeter:
    """E = P·t with P from the host spec (cores actively serving)."""

    def __init__(self, host: HostSpec = GENERIC_HOST):
        self.host = host
        self.total_s = 0.0
        self.total_j = 0.0

    @property
    def power_w(self) -> float:
        return self.host.idle_w / 4.0 + self.host.active_w_per_core * self.host.serving_cores

    def measure(self, fn):
        t0 = time.perf_counter()
        out = block_until_ready(fn())
        dt = time.perf_counter() - t0
        joules = self.power_w * dt
        self.total_s += dt
        self.total_j += joules
        return out, dt, joules


class ModeledMeter:
    """Wall time measured; energy charged from a per-call cost estimate
    produced by `cost_fn() -> (flops, bytes)` against a Node power model."""

    def __init__(self, node: Node, cost_fn):
        self.node = node
        self.cost_fn = cost_fn
        self.total_s = 0.0
        self.total_j = 0.0

    def measure(self, fn):
        t0 = time.perf_counter()
        out = block_until_ready(fn())
        dt = time.perf_counter() - t0
        flops, bytes_ = self.cost_fn()
        a = self.node.accel
        joules = (a.idle_w * self.node.n_accel * dt
                  + a.j_per_flop * flops + a.j_per_byte_hbm * bytes_)
        self.total_s += dt
        self.total_j += joules
        return out, dt, joules


class NvmlError(RuntimeError):
    pass


_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlDeviceGetCount_v2": [ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)],
    "nvmlDeviceGetUUID": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetTotalEnergyConsumption": [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_ulonglong)],
}


def load_nvml():
    """libnvidia-ml with the calls the meter makes declared."""
    try:
        lib = ctypes.CDLL(NVML_LIBRARY)
    except OSError as e:
        raise NvmlError(f"cannot load {NVML_LIBRARY}: {e}") from e
    for name, args in _SIGNATURES.items():
        f = getattr(lib, name)
        f.argtypes, f.restype = args, ctypes.c_int
    return lib


def _bare_uuid(uuid: str) -> str:
    """'GPU-8c1e…' (NVML) and '8c1e…' (torch) -> '8c1e…'."""
    uuid = uuid.strip().lower()
    return uuid[4:] if uuid.startswith("gpu-") else uuid


class NvmlMeter:
    """E read from the card: NVML's total-energy counter (a running total
    in millijoules) of the device `device` names, found by its UUID, so
    that CUDA_VISIBLE_DEVICES cannot point it at another card.

    The counter steps only every ~100 ms on an H100, so a window read at
    arbitrary times would be off by up to one step at each end: more than
    a short engine call draws.  `measure` therefore opens and closes its
    window on steps of the counter.  At a load's edges the counter
    conserves energy but can report part of it a step early or late, so
    both of a window's edges lie a whole step away from any device work:
    it waits for the device and opens on the step that closed its
    previous window if the counter has not stepped since (back-to-back
    calls with no device work between them, which `invalidate` rules
    out), else a step after the next one; runs `fn`; waits for the
    device; and closes on the second step after.  The counter's
    difference between the two steps holds, besides `fn`'s energy, the
    card idling in the window's head (from the opening step to `fn`'s
    start) and tail (from the end of `fn`'s device work to the closing
    step).  Both are charged at the card's idle power, measured over one
    whole counter period (from one step to the next, the device idle for
    a step before it) before a window that cannot reuse a step, and
    subtracted.  `last` keeps the window's parts.

    The seconds are `fn`'s own, to the end of its device work.  Every
    NVML call is checked: a missing library, a non-zero return code or a
    counter that stops stepping raises `NvmlError`.

    The engine meters whole calls (`per_call`) with it: one window a
    generate, as the paper's PyJoules decorator wraps one.  `lib` is the
    NVML library, or a stand-in for its functions (tests)."""

    per_call = True

    def __init__(self, device: str | torch.device = "cuda", *, lib=None):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"NvmlMeter reads a CUDA device's counter, not {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.lib = load_nvml() if lib is None else lib
        self._check("nvmlInit_v2")
        self.uuid = _bare_uuid(str(torch.cuda.get_device_properties(dev).uuid))
        self.handle = self._find(self.uuid)
        self.total_s = 0.0
        self.total_j = 0.0
        self.idle_w = None
        self.last = {}
        self._closed = None           # (mJ, time) of the last closing step

    def _check(self, name: str, *args) -> None:
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise NvmlError(f"{name} returned {rc}")

    def _find(self, uuid: str):
        count = ctypes.c_uint()
        self._check("nvmlDeviceGetCount_v2", ctypes.byref(count))
        for i in range(count.value):
            handle = ctypes.c_void_p()
            self._check("nvmlDeviceGetHandleByIndex_v2", i, ctypes.byref(handle))
            buf = ctypes.create_string_buffer(96)
            self._check("nvmlDeviceGetUUID", handle, buf, len(buf))
            if _bare_uuid(buf.value.decode()) == uuid:
                return handle
        raise NvmlError(f"no NVML device has the UUID of {self.device} ({uuid})")

    def millijoules(self) -> int:
        """The counter as it reads now."""
        mj = ctypes.c_ulonglong()
        self._check("nvmlDeviceGetTotalEnergyConsumption", self.handle, ctypes.byref(mj))
        return mj.value

    def next_step(self, first: int | None = None) -> tuple[int, float]:
        """Spin until the counter steps from `first` (default: its value
        now): its new value, and when it was seen."""
        if first is None:
            first = self.millijoules()
        deadline = time.perf_counter() + TICK_TIMEOUT_S
        while True:
            mj = self.millijoules()
            now = time.perf_counter()
            if mj != first:
                return mj, now
            if now > deadline:
                raise NvmlError(f"the energy counter of {self.device} did not step "
                                f"in {TICK_TIMEOUT_S} s")

    def invalidate(self) -> None:
        """Device work ran outside any window since the last one closed (a
        graph capture): the next window must not reuse that closing step,
        whose period after it holds the work."""
        self._closed = None

    def _open(self) -> tuple[int, float]:
        """The step a window opens on, measuring the idle power first
        unless it reuses the previous window's closing step."""
        mj = self.millijoules()
        if self._closed is not None and mj == self._closed[0]:
            return self._closed
        e_a, t_a = self.next_step(self.next_step(mj)[0])
        e_b, t_b = self.next_step(e_a)
        self.idle_w = (e_b - e_a) / 1e3 / (t_b - t_a)
        return e_b, t_b

    def measure(self, fn):
        window = self.begin()
        out = fn()
        dt, joules = self.end(window)
        return out, dt, joules

    def begin(self) -> tuple:
        """Open a window as `measure` does before calling its `fn`, for
        work that is not one call (a training loop's steps after its
        first); `end` closes it."""
        torch.cuda.synchronize(self.device)
        e0, t0 = self._open()
        return e0, t0, time.perf_counter()

    def end(self, window: tuple) -> tuple[float, float]:
        """Close a window `begin` opened, as `measure` closes its own:
        the seconds from `begin` to the end of the device's work, and the
        joules net of the idle head and tail."""
        e0, t0, start = window
        torch.cuda.synchronize(self.device)
        end = time.perf_counter()
        e1, t1 = self.next_step(self.next_step()[0])
        self._closed = (e1, t1)
        window_j = (e1 - e0) / 1e3
        idle_s = (start - t0) + (t1 - end)
        joules = window_j - self.idle_w * idle_s
        dt = end - start
        self.last = {"window_j": window_j, "idle_s": idle_s, "opened": t0, "closed": t1}
        self.total_s += dt
        self.total_j += joules
        return dt, joules
