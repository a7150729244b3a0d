"""Render the roofline table from the dry-run JSON records.

Port of `repro.analysis.report`.  The FITS note compares each record's
peak bytes per device with the pricing spec's `hbm_bytes` (`H100_SXM`).

    PYTHONPATH=src python -m repro_torch.analysis.report [--mesh pod] [--dir results/dryrun]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.energy.hardware import H100_SXM

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_: Path, mesh: str) -> list[dict]:
    recs = []
    for f in sorted(dir_.glob(f"*__{mesh}.json")):
        r = json.loads(f.read_text())
        if r.get("status") == "ok":
            recs.append(r)
    recs.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 9))
    return recs


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.0f}us"


def markdown_table(recs: list[dict], hbm_bytes: float = H100_SXM.hbm_bytes) -> str:
    cap = hbm_bytes / 1e9
    hdr = ("| arch | shape | compute | memory | collective | dominant | "
           "MODEL/traced flops | mem/dev | note |\n"
           "|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in recs:
        t = r["roofline"]
        gb = r["memory_analysis"]["peak_bytes_per_device"] / 1e9
        note = "FITS" if gb <= cap else f"OVER ({gb:.0f}GB)"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {t['useful_flops_ratio']:.2f} | "
            f"{gb:.2f}GB | {note} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="pod")
    p.add_argument("--dir", default="results/dryrun")
    args = p.parse_args(argv)
    recs = load(Path(args.dir), args.mesh)
    print(markdown_table(recs))
    doms: dict = {}
    fits = 0
    for r in recs:
        doms[r["roofline"]["dominant"]] = doms.get(r["roofline"]["dominant"], 0) + 1
        fits += r["memory_analysis"]["peak_bytes_per_device"] <= H100_SXM.hbm_bytes
    print(f"\n{len(recs)} records | dominant: {doms} | fit "
          f"{H100_SXM.hbm_bytes / 1e9:.1f}GB/chip: {fits}/{len(recs)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
