"""Multi-pod dry-run campaign: every assigned arch x input shape traced on
the production mesh, counted per device, and priced by a three-term
roofline.

Port of `repro.launch.dryrun`.  Where the reference lowers and compiles
each step for 512 placeholder host devices and parses its HLO, this
module traces it: on torch's "fake" process group of 256 (pod) or 512
(multi-pod) ranks (`mesh.start_fake_group`), params, optimizer state,
caches and inputs are DTensors with the reference's layouts whose local
shards are fake tensors (`FakeTensorMode`: shapes and dtypes, no storage
and no kernel), and the step runs under `analysis.trace.StepCounter`,
which counts this rank's FLOPs, collective bytes and peak live bytes.

    python -m repro_torch.launch.dryrun [--arch A ...] [--shape S ...]
        [--multi-pod] [--out results/dryrun] [--device cuda|cpu]

`--device cuda` (the default) traces fake CUDA tensors, so the kernels'
wrappers take the path they take on the card (without launching: a
wrapper handed a fake tensor runs its plain version on it, whose FLOPs
are what it counts); `--device cpu` traces fake CPU tensors.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import shard
from repro_torch.analysis.roofline import roofline_terms
from repro_torch.analysis.trace import StepCounter, Totals
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, token_specs
from repro_torch.configs.shapes import InputShape
from repro_torch.energy.costs import pass_costs
from repro_torch.energy.hardware import H100_NVLINK_LINKS, H100_SXM
from repro_torch.launch import sharding as shardrules
from repro_torch.launch.mesh import make_production_mesh, mesh_chips, start_fake_group
from repro_torch.launch.steps import build_prefill_step, build_serve_step, build_train_step
from repro_torch.models import active_params, get_api
from repro_torch.models.common import ModelConfig
from repro_torch.optim import get_optimizer

# ---------------------------------------------------------------------------
# Analytic per-step quantities for the roofline table
# ---------------------------------------------------------------------------

_OPT_BYTES_PER_PARAM = {"adamw": 26.0, "adafactor": 9.0, "sgd": 14.0}


def step_model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    n_act = active_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_act * B * S
    if shape.kind == "prefill":
        return 2.0 * n_act * B * S
    return 2.0 * n_act * B          # decode: one token per sequence


def step_hbm_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    B, S = shape.global_batch, shape.seq_len
    api = get_api(cfg)
    if shape.kind == "train":
        fwd = pass_costs(cfg, S, S, B, decode=False).hbm_bytes
        opt = api.count_params(cfg) * _OPT_BYTES_PER_PARAM[cfg.optimizer]
        # fwd + bwd (~2x fwd traffic) + remat recompute (~1x) + optimizer
        return fwd * 4.0 + opt
    if shape.kind == "prefill":
        return pass_costs(cfg, S, S, B, decode=False).hbm_bytes
    return pass_costs(cfg, 1, S, B, decode=True).hbm_bytes


# ---------------------------------------------------------------------------
# One dry-run
# ---------------------------------------------------------------------------


def fake_state(cfg: ModelConfig, shape: InputShape, mesh, rules: dict, device: str):
    """The step's arguments as DTensors on `mesh` whose local shards are
    fake tensors on `device`, laid out as the reference lays them out:
    params by `fsdp_specs` (train) or `param_specs`, the optimizer state
    by `opt_state_pspecs`, the cache by `cache_pspecs`, the inputs by
    `input_pspecs`.  Call under the FakeTensorMode that is to own them.
    Returns (step args tuple, param spec tree)."""
    api = get_api(cfg)

    def make_local(local_shape, dtype, _ref):
        return torch.zeros(local_shape, dtype=dtype, device=device)

    def lay_out(tree, specs):
        return shardrules.distribute_tree(tree, specs, mesh, make_local=make_local)

    defs = api.param_defs(cfg)
    if shape.kind == "train":
        pspecs = shardrules.fsdp_specs(defs, rules, mesh)
    else:
        pspecs = api.param_specs(cfg, rules)
    pshapes = api.param_shapes(cfg)
    params = lay_out(pshapes, pspecs)
    tspecs = token_specs(cfg, shape)
    inputs = lay_out(tspecs, shardrules.input_pspecs(tspecs, rules))
    if shape.kind == "train":
        opt = get_optimizer(cfg.optimizer)
        opt_shapes = opt.init(pshapes)
        opt_specs = shardrules.opt_state_pspecs(cfg.optimizer, defs, rules,
                                                param_spec_tree=pspecs)
        return (params, lay_out(opt_shapes, opt_specs), inputs), pspecs
    if shape.kind == "prefill":
        return (params, inputs), pspecs
    cache = api.init_cache(cfg, shape.global_batch, shape.seq_len,
                           long_context=shape.long_context, device="meta")
    return (params, lay_out(cache, shardrules.cache_pspecs(cache, rules)), inputs), pspecs


def build_step(cfg: ModelConfig, shape: InputShape, pspecs):
    if shape.kind == "train":
        return build_train_step(cfg, param_pspecs=pspecs)[0]
    if shape.kind == "prefill":
        return build_prefill_step(cfg, cache_len=shape.seq_len,
                                  long_context=shape.long_context)
    return build_serve_step(cfg)


def _trace(cfg: ModelConfig, shape: InputShape, mesh, rules: dict, device: str,
           timeline: bool = False):
    """One step traced whole: (Totals, peak bytes, argument bytes, the
    timeline of live bytes or None)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    counter = StepCounter(timeline=timeline)
    with (FakeTensorMode(), implicit_replication(),
          shard.use_rules(rules, shardrules.mesh_axis_sizes(mesh))):
        args, pspecs = fake_state(cfg, shape, mesh, rules, device)
        step = build_step(cfg, shape, pspecs)
        counter.track(args)
        state = counter.live
        with counter, (contextlib.nullcontext() if shape.kind == "train"
                       else torch.no_grad()):
            out = step(*args)
        del out, args
    return counter.totals, counter.peak, state, counter.timeline


def state_bytes(cfg: ModelConfig, shape: InputShape, mesh, rules: dict, device: str) -> int:
    """Bytes of one device's share of the step's arguments (params,
    optimizer state, cache, inputs), as StepCounter counts them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    counter = StepCounter()
    with FakeTensorMode():
        args, _ = fake_state(cfg, shape, mesh, rules, device)
        counter.track(args)
    return counter.live


def depth_variants(cfg: ModelConfig):
    """(shallow config, deeper config, repeats): two depths of the same
    model one repeated block apart, and how many blocks the full model
    has beyond the shallow one.  A block is a layer (a MoE layer past the
    dense ones; an (encoder, decoder) layer pair for encdec; a (rec, rec,
    attn) unit for the hybrid).  The shallow model has two blocks: the
    first differs from the rest (its input is the embedding, held by no
    other), so the one added is a middle one.  None when the model is
    too shallow to gain from it."""
    if cfg.family == "encdec":
        if cfg.enc_layers != cfg.dec_layers or cfg.enc_layers <= 3:
            return None
        def at(n):
            return cfg.replace(enc_layers=n, dec_layers=n, n_layers=2 * n)
        return at(2), at(3), cfg.enc_layers - 2
    if cfg.family == "hybrid":
        per = len(cfg.block_pattern)
        units, tail = cfg.n_layers // per, cfg.n_layers % per
        if units <= 3:
            return None
        return (cfg.replace(n_layers=2 * per + tail), cfg.replace(n_layers=3 * per + tail),
                units - 2)
    first = cfg.n_dense_layers + 2 if cfg.family == "moe" else 2
    if cfg.n_layers <= first + 1:
        return None
    return cfg.replace(n_layers=first), cfg.replace(n_layers=first + 1), cfg.n_layers - first


def extended_peak(shallow, deep, k: float) -> float:
    """The most bytes a forward step of k more blocks than `shallow` holds
    above its arguments, from the timelines (op, live bytes less the
    arguments' bytes) of two steps one block apart: `shallow` runs pre,
    two blocks, post; `deep` pre, three blocks, post.  Each op of the
    shallow step is paired with its counterpart in the deep one: pre and
    the first block with the same ops, the last block and post with those
    one block later.  What each holds is extended along the depth, by k
    times the difference: a prefill's cache grows with every layer passed,
    wherever the peak falls.  Where the ops leave the boundary between pre
    and the first block open (pre ends as a block ends, or post begins as
    one begins), the ops at it take the smaller of their two extensions.
    Raises ValueError when the deep step is not the shallow one with one
    more block (an encoder-decoder's two stacks)."""
    ops1, ops2 = [op for op, _ in shallow], [op for op, _ in deep]
    n1, nb = len(ops1), len(ops2) - len(ops1)
    same = 0                                        # ops alike in order
    while same < n1 and ops1[same] is ops2[same]:
        same += 1
    shifted = n1                                    # ops alike a block later
    while shifted > 0 and nb > 0 and ops1[shifted - 1] is ops2[shifted - 1 + nb]:
        shifted -= 1
    # pre's length lies in [shifted, same - 2 nb]
    lo, hi = shifted + nb, same - nb
    if nb <= 0 or lo > hi:
        raise ValueError(f"the deeper step does not repeat one block ({n1} and "
                         f"{len(ops2)} ops, {same} alike from the start, "
                         f"{n1 - shifted} from the end)")
    peak = 0.0
    for i, (_, a) in enumerate(shallow):
        same_op = a + k * (deep[i][1] - a)
        if i < lo:
            peak = max(peak, same_op)
        else:
            later = a + k * (deep[i + nb][1] - a)
            peak = max(peak, min(same_op, later) if i < hi else later)
    return peak


def _combine(a: Totals, b: Totals, k: float) -> Totals:
    """a + k (b - a), count by count."""
    out = Totals()
    out.add(a, 1.0 - k)
    out.add(b, k)
    return out


def trace_one(cfg: ModelConfig, shape: InputShape, mesh, rules: dict,
              device: str = "cuda", *, full_depth: bool = False):
    """Trace one (config x shape) step on `mesh` over fake tensors.
    Returns (Totals per device, peak live bytes per device, seconds).

    A step's counts are affine in its repeated blocks and, in training,
    in its microbatches (each is traced the same way), so by default the
    step is traced at two depths one block apart (`depth_variants`) and,
    when it accumulates more than two microbatches, at one and two
    microbatches, and the counts are extended to the full depth and
    microbatch count: the counterpart of the reference's multiplying a
    scan body by its trip count (a trace of DTensor ops on fake tensors
    runs at a few thousand ops a second).  The peak, at two microbatches
    (the accumulator live), is the full step's argument bytes plus what
    the step holds above them, extended along the depth: in training the
    two depths' peaks (the layers' saved activations), otherwise op by op
    (`extended_peak`; a step without one repeated block, an
    encoder-decoder's prefill, is traced whole for it).
    full_depth=True traces the whole step."""
    t0 = time.perf_counter()
    depths = None if full_depth else depth_variants(cfg)
    n_mb = 1
    if shape.kind == "train" and cfg.microbatch and cfg.microbatch < shape.global_batch:
        n_mb = shape.global_batch // cfg.microbatch
    mbs = (1, 2) if (not full_depth and n_mb > 2) else (n_mb,)
    cfgs = (cfg,) if depths is None else depths[:2]
    runs = {}
    for i, c in enumerate(cfgs):
        for m in mbs:
            sh = dataclasses.replace(shape, global_batch=m * cfg.microbatch) if m != n_mb \
                else shape
            runs[i, m] = _trace(c, sh, mesh, rules, device,
                                timeline=bool(depths) and shape.kind != "train")
    k = depths[2] if depths else 0.0
    m = mbs[-1]
    if len(mbs) == 1:
        totals = _combine(runs[0, m][0], runs[1, m][0], k) if depths else runs[0, m][0]
    else:
        # counts at (depth d, m microbatches): affine in d and in m, with
        # the per-layer, per-microbatch term the product of the two
        by_depth = [_combine(runs[i, 1][0], runs[i, 2][0], n_mb - 1)
                    for i in range(len(cfgs))]
        totals = _combine(by_depth[0], by_depth[1], k) if depths else by_depth[0]
    if not depths:
        peak = runs[0, m][1]
    else:
        # the peak is the full step's arguments plus what the step holds
        # above them: in training that grows with depth (each layer keeps
        # what its backward needs) and peaks in the backward; a forward
        # step's peak may fall in a layer or after them (a prefill's cache)
        if shape.kind == "train":
            extra = [runs[i, m][1] - runs[i, m][2] for i in range(2)]
            above = extra[0] + k * (extra[1] - extra[0])
        else:
            try:
                above = extended_peak(*([(op, b - runs[i, m][2]) for op, b in runs[i, m][3]]
                                        for i in range(2)), k)
            except ValueError:
                # no one repeated block: the whole step's peak
                return totals, int(_trace(cfg, shape, mesh, rules, device)[1]), \
                    time.perf_counter() - t0
        peak = state_bytes(cfg, shape, mesh, rules, device) + above
    return totals, int(peak), time.perf_counter() - t0


def run_one(arch: str, shape_name: str, *, multi_pod: bool, out_dir: Path,
            rules_extra: dict | None = None, force: bool = False,
            mesh=None, tag: str = "", cfg_overrides: dict | None = None,
            device: str = "cuda", full_depth: bool = False) -> dict:
    mesh_name = ("multipod" if multi_pod else "pod") + (f"-{tag}" if tag else "")
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = INPUT_SHAPES[shape_name]
    if mesh is None:
        start_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    chips = mesh_chips(mesh)
    rules = shardrules.build_rules(cfg, shape, multi_pod=multi_pod,
                                   extra=rules_extra)

    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "rules": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in rules.items()},
        "device": device,
        "status": "error",
    }
    try:
        totals, peak, t_trace = trace_one(cfg, shape, mesh, rules, device,
                                          full_depth=full_depth)
        terms = roofline_terms(
            arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
            hlo_totals=totals,
            hbm_bytes_global=step_hbm_bytes(cfg, shape),
            model_flops=step_model_flops(cfg, shape),
            accel=H100_SXM, ici_links=H100_NVLINK_LINKS,
        )
        record.update({
            "status": "ok",
            "t_trace_s": t_trace,
            "full_depth": full_depth,
            "memory_analysis": {"peak_bytes_per_device": int(peak)},
            "hlo": {
                "flops_per_device": totals.flops,
                "collective_bytes_per_device": dict(totals.collective_bytes),
                "collective_counts": dict(totals.collective_count),
            },
            "roofline": terms.to_dict(),
        })
    except Exception as e:  # noqa: BLE001 — campaign must survive one failure
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc(limit=8)

    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=2))
    return record


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    p = argparse.ArgumentParser(description="multi-pod dry-run campaign")
    p.add_argument("--arch", action="append", default=None,
                   help="arch id (repeatable); default: all assigned")
    p.add_argument("--shape", action="append", default=None,
                   choices=list(INPUT_SHAPES), help="input shape (repeatable)")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default="results/dryrun")
    p.add_argument("--force", action="store_true")
    p.add_argument("--tag", default="", help="suffix for perf-experiment runs")
    p.add_argument("--rule", action="append", default=[],
                   help="logical-axis override, e.g. kv_seq=model or batch=-")
    p.add_argument("--cfg", action="append", default=[],
                   help="config override, e.g. cache_dtype=float8_e4m3fn or "
                        "microbatch=16 (ints auto-parsed)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device of the fake tensors traced (no card is used)")
    p.add_argument("--full-depth", action="store_true",
                   help="trace every layer and microbatch (default: two depths, "
                        "extended; see trace_one)")
    args = p.parse_args(argv)

    cfg_overrides = {}
    for c in args.cfg:
        k, v = c.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            if v in ("true", "True", "false", "False"):
                v = v.lower() == "true"
        cfg_overrides[k] = v

    archs = args.arch or list(ASSIGNED_ARCHS)
    shapes = args.shape or list(INPUT_SHAPES)
    rules_extra = {}
    for r in args.rule:
        k, v = r.split("=", 1)
        if v in ("-", "none", "None"):
            rules_extra[k] = None
        elif "," in v:
            rules_extra[k] = tuple(v.split(","))
        else:
            rules_extra[k] = v

    out_dir = Path(args.out)
    start_fake_group(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=args.device)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            t0 = time.time()
            rec = run_one(arch, shape_name, multi_pod=args.multi_pod,
                          out_dir=out_dir, rules_extra=rules_extra or None,
                          force=args.force, mesh=mesh, tag=args.tag,
                          cfg_overrides=cfg_overrides or None, device=args.device,
                          full_depth=args.full_depth)
            dt = time.time() - t0
            if rec["status"] == "ok":
                r = rec["roofline"]
                mb = rec["memory_analysis"]["peak_bytes_per_device"] / 1e9
                print(f"OK   {arch:24s} {shape_name:12s} {rec['mesh']:9s} "
                      f"mem/dev={mb:6.2f}GB dom={r['dominant']:10s} "
                      f"step={r['step_s']*1e3:9.3f}ms  ({dt:.0f}s)", flush=True)
            else:
                failures += 1
                print(f"FAIL {arch:24s} {shape_name:12s} {rec['mesh']:9s} "
                      f"{rec['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
