"""The correctness check's control: the plain reference computed in float8
(e4m3) in the program's place has to come out not correct.

On the CPU at the tiny cells' size (bfloat16, as served): over three seeds
the program's reading stays under the tiny cell's limit and the control's
lies above it.  On the card (`gpu`), the same at each benchmark cell's own
size and limit, on one seed; `bench/calibrate.py` takes the readings over a
dozen seeds that set the limits (see PERF.md)."""

import gc

import pytest
import torch

from bench import check, harness, weights
from bench.measure import Run
from bench.spec import load_cell
from bench.tests import tiny


def readings(cell, seed, device):
    """(program's numbers, control's numbers) of one job of `cell`."""
    cfg = harness.model_config(cell.config)
    tree = weights.make(cell.spec, seed, device)
    engine, timer = harness.build_engine(cfg, tree, device)
    served, window_s = harness.serve_window(engine, timer, cell, seed, 0.0)
    run = Run(cell=cell, served=served, window_s=window_s, setup_s=0.0, capture_s=0.0)
    picked = check.sample(run, cell.cell["check"]["sample_requests"], seed)
    del engine, timer
    gc.collect()               # as a run frees the engine's graphs and caches first
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = harness.judge(cell, tree, picked, fp8_control=True)
    return found, found["control"]


@pytest.mark.parametrize("config", [tiny.DENSE, tiny.MOE], ids=["dense", "moe"])
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
def test_control_fails_where_the_program_passes(config, seed):
    cell = tiny.cell(config)
    program, control = readings(cell, seed, torch.device("cpu"))
    for k, limit in cell.cell["check"]["limits"].items():
        assert program[k] <= limit < control[k], k


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["mistral-7b.chat", "mixtral-8x7b.chat",
                                      "mistral-7b.longdoc"])
def test_control_fails_at_the_cells_size(card, workload):
    cell = load_cell(workload)
    program, control = readings(cell, 20261018, card)
    for k, limit in cell.cell["check"]["limits"].items():
        assert program[k] <= limit < control[k], k
