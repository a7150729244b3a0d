"""The card's energy counter (NVML) over the energy window, over its seconds."""


def read(run):
    return None if run.joules is None else run.joules / run.energy_s
