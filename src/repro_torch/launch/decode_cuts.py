"""Where kernel B1's device time goes: B1 built from this tree's source as
it is, and with one part of it cut out at a time.

    python src/repro_torch/launch/decode_cuts.py

Each cut replaces one exact piece of `kernels/csrc/decode_attention.cu`
(a piece that is no longer there is an error, and the CPU tests check
that each still is) and is compiled with the package's nvcc flags into
`build/cuts/`.  A cut kernel's output is wrong by design and is not
checked; only its time is read.  The cuts:

  merge      the last block of a (batch, KV head) returns after taking its
             ticket, so the splits' partials are never merged
  compute    no S = Q K^T, softmax or P V on the tensor-core path
  tile_loop  the ring's stages are issued and waited for, but no tile step
             runs (no widening, compute or later stages)

Every variant is timed through the wrapper at the bf16-q shapes of
`chip_smoke.decode_shapes`, at the split count the wrapper plans, with
`chip_smoke.py`'s helpers: L2 flushed before each call (`time_ms`) and
back to back with the L2 warm (`time_warm_ms`), the variants in turns,
twice.  One JSON line: per shape and variant the two readings of each.
The difference between the whole kernel and a cut is the cut part's
share, as far as the parts do not overlap.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "decode_attention.cu"
ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "build" / "cuts"

CUTS = {
    "merge": ("  if (!*last_s) return;", "  return;"),
    "compute": ("    if (j0 < g.ke) {", "    if (j0 < g.ke && pos == -12345) {"),
    "tile_loop": ("  for (int t = 0; t < n_tiles; ++t) {\n"
                  "    unsigned char* stage = ring + (t % n_stages) * L::stage_bytes;\n"
                  "    cp_async_wait(n_stages - 1);\n    __syncthreads();\n    const bf16* kt;",
                  "  for (int t = 0; t < n_tiles && pos == -12345; ++t) {\n"
                  "    unsigned char* stage = ring + (t % n_stages) * L::stage_bytes;\n"
                  "    cp_async_wait(n_stages - 1);\n    __syncthreads();\n    const bf16* kt;"),
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
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_cuts() -> dict:
    import torch

    from repro_torch.kernels import decode_attention as kda
    from repro_torch.launch import serve

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    fns = _build_all(variants(SRC.read_text()))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    whole = kda._kernel
    rows = {}
    try:
        for i, (name, shape) in enumerate(cs.decode_shapes(torch, serve).items()):
            if shape[5] != torch.bfloat16:
                continue
            q, k, v = cs.decode_inputs(torch, shape, seed=100 + i)
            p = torch.tensor(shape[4] - 1, dtype=torch.int32, device="cuda")
            rows[name] = {cut: {"ms": [], "warm_ms": []} for cut in fns}
            for _ in range(2):
                for cut, fn in fns.items():
                    kda._kernel = lambda fn=fn: fn
                    kda._workspaces.clear()       # counters left unreset by a cut
                    call = lambda: kda.decode_attention(q, k, v, p)     # noqa: E731
                    rows[name][cut]["ms"].append(cs.time_ms(torch, call, flush))
                    rows[name][cut]["warm_ms"].append(cs.time_warm_ms(torch, call))
    finally:
        kda._kernel = whole
        kda._workspaces.clear()
    return {"device": torch.cuda.get_device_name(0), "rows": rows}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    print(json.dumps(time_cuts()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
