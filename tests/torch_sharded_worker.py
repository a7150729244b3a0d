"""One rank of `tests/test_torch_sharded.py`: the port on a 2 x 2
("data", "model") mesh of gloo CPU ranks, its weights and inputs carried
by value from an npz the test wrote from the reference.

    python tests/torch_sharded_worker.py RANK WORLD PORT IN.npz OUT_DIR

Rank 0 writes OUT_DIR/out.npz with every result gathered whole."""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist


def tree_from(npz, prefix: str) -> dict:
    from repro_torch.checkpoint import unflatten_tree
    return unflatten_tree({k[len(prefix):]: npz[k] for k in npz.files if k.startswith(prefix)})


def main() -> int:
    rank, world, port, src, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                       sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import shard
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import sharding as shardrules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import get_api
    from repro_torch.weights import from_jax_params

    mesh = make_test_mesh((2, 2), device_type="cpu")
    npz = np.load(src)
    out: dict = {}

    def whole(t):
        return (t.full_tensor() if shard.is_dtensor(t) else t).detach().numpy()

    def lay_out(tree, specs):
        return shardrules.distribute_tree(tree, specs, mesh)

    # DTensor splits a dim sharded over (data, model) data-major, as JAX does
    x = shardrules.to_dtensor(torch.arange(16.0), shard.P(("data", "model")), mesh)
    d, m = mesh.get_coordinate()
    out["split_order_ok"] = np.array(
        x.to_local().tolist() == list(range((d * 2 + m) * 4, (d * 2 + m) * 4 + 4)))

    # --- qwen3-1.7b-reduced: prefill + greedy decode under the decode rules ---
    cfg = get_config("qwen3-1.7b-reduced")
    api = get_api(cfg)
    rules = shardrules.build_rules(cfg, INPUT_SHAPES["decode_32k"], multi_pod=False)
    sizes = shardrules.mesh_axis_sizes(mesh)
    params = from_jax_params(cfg, tree_from(npz, "qwen/"), "cpu")
    cache_len, steps = int(npz["cache_len"]), int(npz["steps"])
    with torch.no_grad(), implicit_replication(), shard.use_rules(rules, sizes):
        dparams = lay_out(params, api.param_specs(cfg, rules))
        tokens = torch.from_numpy(npz["prompt"])
        batch = lay_out({"tokens": tokens}, shardrules.input_pspecs({"tokens": 0}, rules))
        logits, cache = api.prefill(cfg, dparams, batch, cache_len=cache_len)
        cache = shardrules.redistribute_tree(cache, shardrules.cache_pspecs(cache, rules), mesh)
        out["k_seq_sharded"] = np.array(bool(shard.mesh_dims_of(cache.k, 2)))
        step_logits = [whole(logits)]
        for _ in range(steps):
            tok = torch.from_numpy(step_logits[-1].argmax(-1).astype(np.int32))
            tok = lay_out({"token": tok}, shardrules.input_pspecs({"token": 0}, rules))
            logits, cache = api.decode_step(cfg, dparams, cache, tok)
            step_logits.append(whole(logits))
    out["qwen_logits"] = np.stack(step_logits)

    # --- one FSDP train step's gradients under the train rules ---
    rules = shardrules.build_rules(cfg, INPUT_SHAPES["train_4k"], multi_pod=False)
    with implicit_replication(), shard.use_rules(rules, sizes):
        dparams = lay_out(params, shardrules.fsdp_specs(api.param_defs(cfg), rules, mesh))
        tb = {k: torch.from_numpy(npz[f"train_{k}"]) for k in ("tokens", "labels")}
        tb = lay_out(tb, shardrules.input_pspecs(tb, rules))
        loss, grads = value_and_grad(lambda p, b: api.train_loss(cfg, p, b)[0], dparams, tb)
        leaves = dict(flatten_tree(dparams))
        for path, g in flatten_tree(grads):
            g = shard.redistribute_like(g, leaves[path])
            out["grad/" + path] = whole(g)
            out["grad_fsdp/" + path] = np.array(
                tuple(g.placements) == tuple(leaves[path].placements))
    out["train_loss"] = whole(loss)

    # --- granite-moe-3b-a800m-reduced forward with the experts sharded ---
    gcfg = get_config("granite-moe-3b-a800m-reduced")
    gapi = get_api(gcfg)
    rules = shardrules.build_rules(gcfg, INPUT_SHAPES["prefill_32k"], multi_pod=False)
    gparams = from_jax_params(gcfg, tree_from(npz, "granite/"), "cpu")
    with torch.no_grad(), implicit_replication(), shard.use_rules(rules, sizes):
        dparams = lay_out(gparams, gapi.param_specs(gcfg, rules))
        tb = lay_out({"tokens": torch.from_numpy(npz["granite_tokens"])},
                     shardrules.input_pspecs({"tokens": 0}, rules))
        logits, _ = gapi.prefill(gcfg, dparams, tb, cache_len=int(npz["granite_cache_len"]))
    out["granite_logits"] = whole(logits)
    w = dparams["blocks"]["moe_blocks"]["moe"]["w_gate"]
    out["experts_sharded"] = np.array(bool(shard.mesh_dims_of(w, 1)))

    if rank == 0:
        np.savez(f"{out_dir}/out.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
