"""Where kernel B3's backward spends its device time: the backward built
from this tree's source as it is, and with one part of it cut out at a
time.

    python src/repro_torch/launch/scan_bwd_cuts.py

Each cut replaces one exact piece of `kernels/csrc/ssd_scan.cu` (a piece
that is no longer there is an error, and the CPU tests check that each
still is) and is compiled with the package's nvcc flags into
`build/scan_bwd_cuts/`.  A cut kernel's output is wrong by design and is
not checked; only its time is read.  The cuts:

  states_store      the states kernel does not store the states
  states_increment  nor adds a chunk's increment (no mma)
  chunk_load        the chunk kernel does not copy the states' planes in
  chunk_dbdc        nor accumulates dB and dC over the p-tiles
  chunk_units       nor takes its V, W, dx and dy x^T products
  chunk_head_end    nor closes a head (the decay mask, M, dcs and ddA)

Every variant is timed through `ssd_scan._launch_bwd` at phase 4's shape
(mamba2-130m's training shape, b=16, S=512, h=24, p=64, g=1, n=128, bf16)
with `chip_smoke.py`'s helpers: L2 flushed before each call (`time_ms`)
and each kernel's device time with the L2 warm (`kernel_split`), the
variants in turns, twice.  One JSON line: per variant the two readings of
each.  The difference between the whole kernel and a cut is the cut
part's share, as far as the parts do not overlap.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "ssd_scan.cu"
ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "build" / "scan_bwd_cuts"
SHAPE = (16, 512, 24, 64, 1, 128)           # b, s, h, p, g, n

NEVER = "S < 0"                             # a condition the launch never meets


def _skip(*lines: str) -> tuple[str, str]:
    """(piece, cut) for statements that the cut puts under NEVER."""
    cut = "".join(f"{ln[:len(ln) - len(ln.lstrip())]}if ({NEVER}) {ln.lstrip()}" for ln in lines)
    return "".join(lines), cut


UNIT = "    // This warp's [16 x 8] unit: rows um (16 steps), columns un (8 of the p-tile).\n"
CUTS = {
    "states_store": _skip("          store_tile16(out + off, NP, hi);\n",
                          "          store_tile16(out + off + (size_t)P * NP, NP, lo);\n"),
    "states_increment": _skip("              mma_planes<1, NPL>(st[i][m][j], ahi[m], bf);\n",
                              "              mma_bf16(st[i][m][j], alo[m], bf[0][0], bf[0][1]);\n"),
    "chunk_load": ("    for (int pl = 0; pl < 2; ++pl) {\n      load_tile(stage_si(s)",
                   f"    for (int pl = 0; pl < 2 && {NEVER}; ++pl) {{\n      load_tile(stage_si(s)"),
    "chunk_dbdc": ("        if (n0 < NP) {\n          uint32_t stb[2][4];",
                   f"        if (n0 < NP && {NEVER}) {{\n          uint32_t stb[2][4];"),
    "chunk_units": (UNIT + "    {\n", UNIT + f"    if ({NEVER}) {{\n"),
    "chunk_head_end": ("    if (pt == npt - 1) {\n", f"    if (pt == npt - 1 && {NEVER}) {{\n"),
}


def variants(source: str) -> dict[str, str]:
    """The source as it is ("whole") and with each cut applied."""
    out = {"whole": source}
    for name, (piece, cut) in CUTS.items():
        if source.count(piece) != 1:
            raise ValueError(f"cut {name!r}: its piece occurs {source.count(piece)} times "
                             f"in {SRC.name}, not once")
        out[name] = source.replace(piece, cut)
    return out


def _build_all(sources: dict[str, str]) -> dict:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        if proc.wait():
            raise RuntimeError(f"variant {name!r} did not build")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).ssd_scan_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_cuts() -> dict:
    import torch

    from repro_torch.kernels import ssd_scan as kss

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    fns = _build_all(variants(SRC.read_text()))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    xdt, dA, B, C, _ = cs.ssd_inputs(torch, *SHAPE, torch.bfloat16, seed=7)
    dy = torch.randn(xdt.shape, generator=torch.Generator(device="cuda").manual_seed(13),
                     device="cuda").bfloat16()
    call = lambda: kss._launch_bwd(xdt, dA, B, C, None, dy, None, False)   # noqa: E731
    whole = kss._bwd_kernel
    rows = {cut: {"ms": [], "split_ms": []} for cut in fns}
    try:
        for _ in range(2):
            for cut, fn in fns.items():
                kss._bwd_kernel = lambda fn=fn: fn
                rows[cut]["ms"].append(cs.time_ms(torch, call, flush, reps=10))
                rows[cut]["split_ms"].append(cs.kernel_split(torch, call, r"(ssd_bwd_\w+)"))
    finally:
        kss._bwd_kernel = whole
    return {"device": torch.cuda.get_device_name(0), "power": cs.nvidia_smi(), "rows": rows}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    print(json.dumps(time_cuts()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
