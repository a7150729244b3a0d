"""The card's energy counter, read through NVML by the benchmark itself.

A frozen copy of the reading in `repro_torch.energy.meter.NvmlMeter`:
`nvmlDeviceGetTotalEnergyConsumption` (millijoules since the driver
loaded) of the card a torch device names, found by UUID.  The counter
steps about every 100 ms on an H100, so a window opens on a step and
closes on the second step after the device's work has ended (the counter
can report a load's edge a step late); its joules include the card's draw
over that short tail.
"""

from __future__ import annotations

import ctypes
import time

import torch

LIBRARY = "libnvidia-ml.so.1"
STEP_TIMEOUT_S = 2.0

_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlDeviceGetCount_v2": [ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)],
    "nvmlDeviceGetUUID": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetTotalEnergyConsumption": [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_ulonglong)],
    "nvmlDeviceGetEnforcedPowerLimit": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)],
}


def _bare(uuid: str) -> str:
    uuid = uuid.strip().lower()
    return uuid[4:] if uuid.startswith("gpu-") else uuid


class EnergyCounter:
    def __init__(self, device: torch.device):
        self.device = device
        self.lib = ctypes.CDLL(LIBRARY)
        for name, args in _SIGNATURES.items():
            f = getattr(self.lib, name)
            f.argtypes, f.restype = args, ctypes.c_int
        self._check("nvmlInit_v2")
        want = _bare(str(torch.cuda.get_device_properties(device).uuid))
        count = ctypes.c_uint()
        self._check("nvmlDeviceGetCount_v2", ctypes.byref(count))
        self.handle = None
        for i in range(count.value):
            h = ctypes.c_void_p()
            self._check("nvmlDeviceGetHandleByIndex_v2", i, ctypes.byref(h))
            buf = ctypes.create_string_buffer(96)
            self._check("nvmlDeviceGetUUID", h, buf, len(buf))
            if _bare(buf.value.decode()) == want:
                self.handle = h
        if self.handle is None:
            raise RuntimeError(f"no NVML device has the UUID of {device}")

    def _check(self, name: str, *args) -> None:
        rc = getattr(self.lib, name)(*args)
        if rc:
            raise RuntimeError(f"{name} returned {rc}")

    def millijoules(self) -> int:
        mj = ctypes.c_ulonglong()
        self._check("nvmlDeviceGetTotalEnergyConsumption", self.handle, ctypes.byref(mj))
        return mj.value

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._check("nvmlDeviceGetEnforcedPowerLimit", self.handle, ctypes.byref(mw))
        return mw.value / 1e3

    def next_step(self) -> tuple[int, float]:
        """Spin until the counter steps: (its new value, when it was seen)."""
        first = self.millijoules()
        deadline = time.perf_counter() + STEP_TIMEOUT_S
        while True:
            mj, now = self.millijoules(), time.perf_counter()
            if mj != first:
                return mj, now
            if now > deadline:
                raise RuntimeError(f"the energy counter did not step in {STEP_TIMEOUT_S} s")

    def open(self) -> tuple[int, float]:
        torch.cuda.synchronize(self.device)
        return self.next_step()

    def close(self) -> tuple[int, float]:
        torch.cuda.synchronize(self.device)
        self.next_step()
        return self.next_step()
