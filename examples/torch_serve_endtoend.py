"""End-to-end serving driver on the PyTorch port: characterize a two-model
fleet by REAL execution on the card, fit the paper's workload models,
route a batched workload with the energy-aware router, and serve it through
the batched inference engines, metered by the card's NVML energy counter
(wall-clock metering on the CPU).

The port of `examples/serve_endtoend.py`: `repro_torch.launch.serve.main`
with the reference's arguments, then the caller's.  Runs on CUDA; pass
`--device cpu` to run it on the CPU.

    PYTHONPATH=src python examples/torch_serve_endtoend.py [--device cpu]
"""

import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    raise SystemExit(main(["--fleet", "llama2-7b-reduced,llama2-70b-reduced",
                           "--queries", "16", "--zeta", "0.5", *sys.argv[1:]]))
