"""End-to-end training driver on the PyTorch port.  The paper is a SERVING
paper, so the required driver is examples/torch_serve_endtoend.py; this
trains a small llama3-style model for a few hundred steps as the
training-side counterpart.  Default size (~30M params); pass
--d-model 768 --layers 12 for the ~100M variant on the card.

The port of `examples/train_small.py`: the same flags and config, plus
`--device` (default cuda); each step is `launch.steps.compile_train_step`'s
CUDA graph on the card.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 200] [--device cpu]
"""

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.train import train


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--d-model", type=int, default=384)
    p.add_argument("--layers", type=int, default=6)
    p.add_argument("--vocab", type=int, default=8192)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()

    cfg = get_config("llama3.2-3b").replace(
        name=f"llama3-small-{args.d_model}d{args.layers}L",
        n_layers=args.layers, d_model=args.d_model, n_heads=6, n_kv_heads=2,
        head_dim=64, d_ff=3 * args.d_model, vocab_size=args.vocab,
        param_dtype="float32", microbatch=0, remat=False)

    losses = train(cfg, steps=args.steps, batch=4, seq=64, device=args.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    assert losses[-1] < losses[0], "training must reduce loss"


if __name__ == "__main__":
    main()
