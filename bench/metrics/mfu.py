"""Model FLOPs of the useful work the window finished (each request
unpadded: `bench.flops.request_flops`), over the window's seconds, as a
percentage of the H100's bf16 peak."""

from bench import peaks


def read(run):
    return run.useful_flops() / run.window_s / peaks.BF16_FLOPS * 100
