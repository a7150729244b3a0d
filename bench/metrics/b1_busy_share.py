"""Kernel B1's summed kernel time over all device-busy time of the traced
span (the union of the device's operations)."""


def read(run):
    if not run.trace or not run.trace["b1_s"]:
        return None
    return run.trace["b1_s"] / run.trace["busy_s"]
