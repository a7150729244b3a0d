"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (`src/repro_torch`),
on a machine with as many CUDA devices as the cell asks for.  The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics untraced, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1` a
`breakdown`, and last `check`, the numbers compared with their limits
(also the last lines of standard error).  Without enough CUDA devices, or
without the port, or with JAX or the reference package loaded once the
window has closed, it prints no result and exits non-zero.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches stay in fixed directories inside the checkout.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
# The script's own directory would shadow modules by the harness's file names.
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from bench.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the program under test cannot be imported: {e}", file=sys.stderr)
        return 4
    from bench import harness

    run, device, found = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                          started=STARTED)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or the reference package are loaded: {bad}",
              file=sys.stderr)
        return 5
    from bench.result import result_line

    out = result_line(cell, run, device, found, bool(args.trace))
    print(f"bench: {run.summary()}", file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
