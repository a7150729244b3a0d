"""1 - the union of the device's operation intervals over the traced
span's host-clock length."""


def read(run):
    if not run.trace:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]
