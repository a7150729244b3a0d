"""Alternating A/B between two source trees of the port, one fresh process
per sample set, shared by the timers in this package
(`prefill_wall.py`, `decode_ab.py`)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def alternate(script: str | Path, src_a: str, src_b: str, pairs: int,
              child_args=()) -> dict[str, list[dict]]:
    """Run `script --src SRC *child_args` in a fresh process per sample
    set: pair i runs tree A then B for even i and B then A for odd i, so a
    drift in the host over the run falls on both.  Each run's last output
    line is a JSON object; it is printed tagged with its tree, source and
    pair.  Returns tree tag ("A", "B") -> its runs' records in order."""
    runs = {"A": [], "B": []}
    for i in range(pairs):
        for tag in ("AB" if i % 2 == 0 else "BA"):
            src = src_a if tag == "A" else src_b
            cmd = [sys.executable, str(script), "--src", src, *child_args]
            out = subprocess.run(cmd, check=True, capture_output=True, text=True).stdout
            rec = json.loads(out.strip().splitlines()[-1])
            rec.update(tree=tag, src=src, pair=i)
            runs[tag].append(rec)
            print(json.dumps(rec), flush=True)
    return runs
