"""Kernel B3's backward at phase 4's shape (mamba2-130m's training shape:
b=16, S=512, h=24, p=64, g=1, n=128, bf16), its time a call and how that
splits over the kernels it launches, and an alternating A/B of both
between two source trees of the port.

    python src/repro_torch/launch/scan_bwd_split.py
    python src/repro_torch/launch/scan_bwd_split.py --ab OLD/src NEW/src --pairs 2

The first form imports `repro_torch` from `--src` (default: the tree
holding this file), builds its B3 library and times one backward through
`ssd_scan._launch_bwd` with `chip_smoke.py`'s helpers: CUDA events with
the L2 flushed before each call (`time_ms`), and each kernel's device time
a call from torch.profiler over ten calls with the L2 warm
(`kernel_split`).  It prints one JSON line.

The second form runs the first in a fresh process per sample set,
alternately from the two trees (`launch/ab.py`), and prints per tree the
median of the runs' times.  Each tree builds its own kernels into its own
`build/kernels/`.  Compare only runs of one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

HERE_SRC = Path(__file__).resolve().parents[2]
ROOT = HERE_SRC.parent
SHAPE = (16, 512, 24, 64, 1, 128)           # b, s, h, p, g, n


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_bwd() -> dict:
    """B3's backward of the imported `repro_torch` at SHAPE."""
    import torch

    import repro_torch
    from repro_torch.kernels import ssd_scan as kss

    cs = _chip_smoke()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    xdt, dA, B, C, _ = cs.ssd_inputs(torch, *SHAPE, torch.bfloat16, seed=7)
    dy = torch.randn(xdt.shape, generator=torch.Generator(device="cuda").manual_seed(13),
                     device="cuda").bfloat16()
    call = lambda: kss._launch_bwd(xdt, dA, B, C, None, dy, None, False)   # noqa: E731
    return {"device": torch.cuda.get_device_name(0), "power": cs.nvidia_smi(),
            "ms": cs.time_ms(torch, call, flush, reps=10),
            "split_ms": cs.kernel_split(torch, call, r"(ssd_bwd_\w+)"),
            "package": str(Path(repro_torch.__file__).parent)}


def run_ab(src_a: str, src_b: str, pairs: int) -> dict:
    """Alternate fresh processes of the first form between two trees."""
    from repro_torch.launch.ab import alternate
    runs = alternate(Path(__file__).resolve(), src_a, src_b, pairs)
    summary = {}
    for tag, src in (("A", src_a), ("B", src_b)):
        recs = runs[tag]
        splits = [r["split_ms"] or {} for r in recs]
        summary[tag] = {"src": src, "ms": statistics.median(r["ms"] for r in recs),
                        "split_ms": {k: statistics.median(s[k] for s in splits if k in s)
                                     for k in splits[0]}}
    print(json.dumps({"summary": summary}))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", default=str(HERE_SRC),
                   help="source tree whose repro_torch is imported")
    p.add_argument("--ab", nargs=2, metavar=("SRC_A", "SRC_B"),
                   help="alternate fresh processes between two source trees")
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args(argv)
    if args.ab:
        sys.path.insert(0, str(HERE_SRC))
        run_ab(*args.ab, args.pairs)
        return 0
    sys.path.insert(0, os.path.abspath(args.src))
    print(json.dumps(time_bwd()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
