"""Readings that set a cell's correctness limit, in one process.

    python3 bench/calibrate.py --workload <name> --seeds 11,12,... --control 3

For each seed the weights are drawn anew in place (the engine's captured
graphs keep reading them), one job is served as a run's window serves it,
the run's sample is drawn, and the sample is judged against the plain
reference: `check.numbers`, the program's readings.  For the first
`--control` seeds the float8 control is judged on the same sequences as
well (under "control").  A limit is set between the largest program
reading and the smallest control reading (see PERF.md).  Prints one JSON line a seed
and writes them all to `--out`.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", type=int, default=3, help="seeds that also judge the control")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from bench import check, harness, weights
    from bench.measure import Run
    from bench.spec import load_cell

    cell = load_cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    cfg = harness.model_config(cell.config)
    tree = weights.make(cell.spec, seeds[0], dev)
    harness.check_layout(cfg, tree)
    engine, timer = harness.build_engine(cfg, tree, dev)
    harness.warm(engine, timer, cell, seeds[0])
    print(f"calibrate {cell.name}: set-up {time.perf_counter() - t0:.1f} s, capture "
          f"{engine.capture_s:.1f} s, peak {torch.cuda.max_memory_allocated(dev)} B, "
          f"pool {engine.pool_bytes()} B", flush=True)
    rows = []
    for i, seed in enumerate(seeds):
        weights.fill(cell.spec, tree, seed)
        served, window_s = harness.serve_window(engine, timer, cell, seed, 0.0)
        run = Run(cell=cell, served=served, window_s=window_s, setup_s=0.0,
                  capture_s=engine.capture_s)
        picked = check.sample(run, cell.cell["check"]["sample_requests"], seed)
        t2 = time.perf_counter()
        found = harness.judge(cell, tree, picked, fp8_control=i < args.control)
        row = {"seed": seed, **found, "job_s": window_s, "judge_s": time.perf_counter() - t2,
               "tokens": run.out_tokens(), "served_tokens": sum(r.tau_out for _, _, r in picked),
               "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": cell.name, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
