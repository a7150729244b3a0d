"""The engine's own counter of seconds spent warming up and capturing its
CUDA graphs (`InferenceEngine.capture_s`), read after the warm-up."""


def read(run):
    return run.capture_s
