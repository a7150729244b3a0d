"""Process start to the window's opening: imports, CUDA start, weights,
kernel builds, the engine's graph captures and the warm-up pass."""


def read(run):
    return run.setup_s
