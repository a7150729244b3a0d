"""The card's energy counter (NVML) over the window, over the same tokens
as `out_tokens_per_s`."""


def read(run):
    return None if run.joules is None else run.joules / run.out_tokens()
