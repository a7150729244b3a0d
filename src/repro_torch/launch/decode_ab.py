"""Kernel B1's device and host times at the main path's shapes, and an
alternating A/B of them between two source trees of the port.

    python src/repro_torch/launch/decode_ab.py [--shape NAME ...] [--host-reps N]
    python src/repro_torch/launch/decode_ab.py --ab OLD/src NEW/src --pairs 2
    python src/repro_torch/launch/decode_ab.py --host-ab OLD/src NEW/src --rounds 200

The first form imports `repro_torch` from `--src` (default: the tree
holding this file) and times B1 through its wrapper at every shape of
`chip_smoke.decode_shapes`, with the helpers `chip_smoke.py` times with:
L2 flushed before each call (`time_ms`), back to back with the L2 warm
(`time_warm_ms`), and the wrapper's host microseconds a call (`host_us`);
then scaled_dot_product_attention over the same cache (cold) where it
takes the cache.  It prints one JSON line; a shape the tree's B1 does not
take (an fp8 cache before it had one) reads null.  `--shape` keeps only
the named rows; `--host-reps N` takes `host_us` as the median of N
samples (the host's own spread between samples is wider than a few
instructions in the wrapper).

The second form runs the first in a fresh process per sample set,
alternately from the two trees: pair i runs A then B for even i and B then
A for odd i.  It prints every run's line tagged with its tree, then per
tree and shape the median of the runs' times.  Each tree builds its own
kernels into its own `build/kernels/`.  Compare only runs of one call.

The third form compares the wrappers' host times alone, in one process:
it imports B1's wrapper from each tree (`load_trees`) and alternates
`host_us` samples of the two (A B, then B A, ...) at each shape, so the
spread between processes (which core, at what clock) falls on both.  It
prints per shape the medians, the median of the paired differences B - A
and its share of A's median.
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
FIELDS = ("ms", "warm_ms", "host_us", "library_ms")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_b1(names=None, host_reps: int = 1) -> dict:
    """B1 of the imported `repro_torch` at chip_smoke's decode shapes
    (those in `names`, if given)."""
    import torch

    import repro_torch
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.launch import serve

    cs = _chip_smoke()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {}
    for i, (name, shape) in enumerate(cs.decode_shapes(torch, serve).items()):
        if names and name not in names:
            continue
        q, k, v = cs.decode_inputs(torch, shape, seed=100 + i)
        pos = shape[4] - 1
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        call = lambda: kda.decode_attention(q, k, v, p)                   # noqa: E731
        try:
            call()
        except TypeError:                   # this tree's B1 does not take the cache
            rows[name] = None
            continue
        library = cs.sdpa_call(torch, q, k, v, pos)
        rows[name] = {"ms": cs.time_ms(torch, call, flush),
                      "warm_ms": cs.time_warm_ms(torch, call),
                      "host_us": statistics.median(cs.host_us(torch, call)
                                                   for _ in range(host_reps)),
                      "library_ms": cs.time_ms(torch, library, flush) if library else None,
                      "bound_ms": cs.decode_bound(shape, pos)[0]}
    return {"device": torch.cuda.get_device_name(0), "rows": rows,
            "package": str(Path(repro_torch.__file__).parent)}


def load_trees(*srcs: str) -> list:
    """(decode_attention module, serve module) of the `repro_torch` in each
    source tree, side by side in this process: the package's modules are
    dropped from `sys.modules` before each import, and the modules taken
    keep their own globals (their own kernels' builds among them)."""
    out = []
    for src in srcs:
        for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
        sys.path.insert(0, os.path.abspath(src))
        try:
            kda = importlib.import_module("repro_torch.kernels.decode_attention")
            serve = importlib.import_module("repro_torch.launch.serve")
        finally:
            sys.path.pop(0)
        out.append((kda, serve))
    return out


def host_ab(src_a: str, src_b: str, rounds: int, names=None) -> dict:
    """B1's wrapper from two trees in one process: alternating host_us
    samples (200 calls each) at chip_smoke's decode shapes."""
    import torch

    cs = _chip_smoke()
    (kda_a, _), (kda_b, serve) = load_trees(src_a, src_b)
    rows = {}
    for i, (name, shape) in enumerate(cs.decode_shapes(torch, serve).items()):
        if names and name not in names:
            continue
        q, k, v = cs.decode_inputs(torch, shape, seed=100 + i)
        p = torch.tensor(shape[4] - 1, dtype=torch.int32, device="cuda")
        calls = {"A": lambda: kda_a.decode_attention(q, k, v, p),         # noqa: E731
                 "B": lambda: kda_b.decode_attention(q, k, v, p)}         # noqa: E731
        if not torch.equal(calls["A"](), calls["B"]()):
            raise RuntimeError(f"{name}: the two trees' B1 disagree")
        us = {"A": [], "B": []}
        for r in range(rounds):
            for tag in ("AB" if r % 2 == 0 else "BA"):
                us[tag].append(cs.host_us(torch, calls[tag]))
        med = {t: statistics.median(v) for t, v in us.items()}
        diff = statistics.median(b - a for a, b in zip(us["A"], us["B"]))
        rows[name] = {"A_us": med["A"], "B_us": med["B"], "paired_diff_us": diff,
                      "paired_diff_share": diff / med["A"], "samples": rounds}
    rec = {"device": torch.cuda.get_device_name(0), "A": src_a, "B": src_b, "rows": rows}
    print(json.dumps(rec))
    return rec


def run_ab(src_a: str, src_b: str, pairs: int, child_args=()) -> dict:
    """Alternate fresh processes of the first form between two trees."""
    from repro_torch.launch.ab import alternate
    runs = alternate(Path(__file__).resolve(), src_a, src_b, pairs, child_args)
    summary = {}
    for tag, src in (("A", src_a), ("B", src_b)):
        per_shape = {}
        for name in runs[tag][0]["rows"]:
            recs = [r["rows"][name] for r in runs[tag]]
            if any(r is None for r in recs):
                per_shape[name] = None
                continue
            per_shape[name] = {f: (statistics.median(r[f] for r in recs)
                                   if recs[0][f] is not None else None) for f in FIELDS}
        summary[tag] = {"src": src, "median": per_shape}
    print(json.dumps({"summary": summary}))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", default=str(HERE_SRC),
                   help="source tree whose repro_torch is imported")
    p.add_argument("--ab", nargs=2, metavar=("SRC_A", "SRC_B"),
                   help="alternate fresh processes between two source trees")
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--host-ab", nargs=2, metavar=("SRC_A", "SRC_B"),
                   help="alternate the two trees' wrappers' host times in one process")
    p.add_argument("--rounds", type=int, default=200)
    p.add_argument("--shape", action="append", default=[],
                   help="a row of chip_smoke.decode_shapes to time (repeatable; default all)")
    p.add_argument("--host-reps", type=int, default=1,
                   help="host_us is the median of this many samples of 200 calls")
    args = p.parse_args(argv)
    if args.host_ab:
        host_ab(*args.host_ab, args.rounds, args.shape)
        return 0
    if args.ab:
        sys.path.insert(0, str(HERE_SRC))
        child = [x for n in args.shape for x in ("--shape", n)]
        run_ab(*args.ab, args.pairs, child + ["--host-reps", str(args.host_reps)])
        return 0
    sys.path.insert(0, os.path.abspath(args.src))
    print(json.dumps(time_b1(args.shape, args.host_reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
