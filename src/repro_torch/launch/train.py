"""Training entry point: real execution on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b-reduced \
        --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 6 --batch 64 --seq 128

Port of `repro.launch.train`: `build_train_step` on synthetic LM batches
(`data.workloads.lm_train_batches`), reporting the loss curve and step
time, with checkpoints every `ckpt_every` steps and resume from the newest
`step_*` directory of `ckpt_dir`.  Where the reference jits the step with
params and optimizer state donated, the step here is
`launch.steps.compile_train_step`'s: on CUDA a graph captured at step 1
(whose time includes the capture, as the reference's includes XLA's
compile) and replayed at every later step, over the loaded checkpoint's
trees when it resumes.  Parameters are drawn on the device from
a torch.Generator seeded by `seed`.  Runs on CUDA unless `device="cpu"`
is passed.  Token-only families, as the reference's: an encdec or vlm
batch also needs frames or patches.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint as ckptlib
from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.workloads import lm_train_batches
from repro_torch.launch.steps import build_train_step, compile_train_step
from repro_torch.models import get_api


def train(arch, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
          seed: int = 0, log_every: int = 10, ckpt_dir: str | None = None,
          ckpt_every: int = 100, device: str | torch.device = "cuda") -> list[float]:
    dev = resolve_device(device)
    cfg = arch if not isinstance(arch, str) else get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={api.count_params(cfg) / 1e6:.1f}M device={dev}")

    step_fn, opt = build_train_step(cfg, lr=lr)
    opt_state = opt.init(params)
    start = 0
    if ckpt_dir is not None:
        latest = ckptlib.latest_step(ckpt_dir)
        if latest is not None:
            tree, start, _ = ckptlib.load_checkpoint(ckptlib.step_path(ckpt_dir, latest),
                                                     device=dev)
            params, opt_state = tree["params"], tree["opt_state"]
            print(f"resumed from step {start}")
    jit_step = compile_train_step(step_fn, device=dev)

    losses: list[float] = []
    t0 = time.time()
    for i, b in enumerate(lm_train_batches(steps, batch, seq, cfg.vocab_size,
                                           seed=seed + start)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        loss, params, opt_state = jit_step(params, opt_state, b)
        losses.append(float(loss))
        step_no = start + i + 1
        if i % log_every == 0 or i == steps - 1:
            dt = time.time() - t0
            print(f"step {step_no:4d} loss {losses[-1]:.4f} "
                  f"({dt / (i + 1):.3f}s/step)", flush=True)
        if ckpt_dir is not None and step_no % ckpt_every == 0:
            ckptlib.save_checkpoint(
                ckptlib.step_path(ckpt_dir, step_no),
                {"params": params, "opt_state": opt_state}, step=step_no,
                metadata={"arch": cfg.name})
    return losses


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b-reduced")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None,
                   help="save every --ckpt-every steps here; resume from its newest step")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    losses = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                   lr=args.lr, seed=args.seed, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, device=args.device)
    improved = losses[-1] < losses[0]
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} improved={improved}")
    return 0 if improved else 1


if __name__ == "__main__":
    raise SystemExit(main())
