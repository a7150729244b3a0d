"""The port's dry run end to end at a small size: `trace_one` on the
reduced config of every family x {train, prefill, decode} on a fake 2 x 2
("data", "model") mesh (torch's fake process group of 4 ranks, started and
destroyed by a module fixture), fake CPU tensors.  Each trace must run,
count FLOPs and bytes on this device, and see collectives where the rules
shard work.

While it traces, no strided shard may be made: some DTensor versions
refuse the views that others record as strided layouts, so the port
makes every view legal first (`shard.legal_for_view`)."""

from __future__ import annotations

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shardrules
from repro_torch.launch.mesh import make_test_mesh, start_fake_group

ARCHS = ["qwen3-1.7b", "granite-moe-3b-a800m", "deepseek-v3-671b", "mamba2-130m",
         "recurrentgemma-9b", "seamless-m4t-large-v2", "internvl2-2b"]
KINDS = [("train", 32, 8, "train"), ("prefill", 64, 4, "prefill"), ("decode", 64, 8, "decode")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    start_fake_group(4)
    try:
        yield make_test_mesh((2, 2), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture
def no_strided_shards(monkeypatch):
    from torch.distributed.tensor import placement_types

    def refuse(*args, **kwargs):
        raise AssertionError("a view made a strided shard")

    monkeypatch.setattr(placement_types._StridedShard, "__init__", refuse)


@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
@pytest.mark.parametrize("arch", ARCHS)
def test_trace_one_every_family_and_kind(mesh, no_strided_shards, arch, kind):
    name, seq, batch, k = kind
    cfg = get_config(arch + "-reduced").replace(microbatch=4)
    shape = InputShape(name, seq, batch, k)
    rules = shardrules.build_rules(cfg, shape, multi_pod=False)
    totals, peak, secs = dryrun.trace_one(cfg, shape, mesh, rules, "cpu")
    assert totals.flops > 0 and peak > 0 and secs > 0
    assert totals.total_collective_bytes > 0
    assert set(totals.collective_bytes) <= {"all-reduce", "all-gather", "reduce-scatter",
                                            "all-to-all", "collective-permute"}


@pytest.mark.parametrize("arch,fields,kind", [
    ("qwen3-1.7b-reduced", {"n_layers": 4, "microbatch": 2, "remat": True}, KINDS[0]),
    ("recurrentgemma-9b-reduced", {"n_layers": 14}, KINDS[1]),
    ("seamless-m4t-large-v2-reduced", {"enc_layers": 4, "dec_layers": 4, "n_layers": 8},
     KINDS[2]),
    # a dense prefill whose peak grows with the cache of every layer passed
    # (the larger of two shallow peaks reads 7 % low here)
    ("qwen3-1.7b-reduced", {"n_layers": 12}, ("prefill", 256, 4, "prefill")),
    # two stacks, no one repeated block: the peak of the whole step
    ("seamless-m4t-large-v2-reduced", {"enc_layers": 4, "dec_layers": 4, "n_layers": 8},
     ("prefill", 256, 4, "prefill")),
], ids=["qwen3-train", "recurrentgemma-prefill", "seamless-decode", "qwen3-prefill",
        "seamless-prefill"])
def test_two_depths_extended_match_the_whole_trace(mesh, arch, fields, kind):
    """trace_one's default (two depths one block apart, one and two
    microbatches, extended to the full step) against the whole step
    traced: FLOPs equal, collective bytes within 0.1 % (a few scalars'
    all-reduces are not per block), the peak within 1 %."""
    name, seq, batch, k = kind
    cfg = get_config(arch).replace(**fields)
    shape = InputShape(name, seq, batch, k)
    rules = shardrules.build_rules(cfg, shape, multi_pod=False)
    whole, w_peak, _ = dryrun.trace_one(cfg, shape, mesh, rules, "cpu", full_depth=True)
    ext, e_peak, _ = dryrun.trace_one(cfg, shape, mesh, rules, "cpu")
    assert dryrun.depth_variants(cfg) is not None
    assert ext.flops == whole.flops
    assert set(ext.collective_bytes) == set(whole.collective_bytes)
    for kind_, b in whole.collective_bytes.items():
        assert abs(ext.collective_bytes[kind_] - b) <= 1e-3 * b, kind_
    assert abs(e_peak / w_peak - 1) <= 0.01


def test_extended_peak_pairs_first_and_last_blocks():
    """extended_peak on made-up timelines: pre [p], blocks [a, b], post
    [q].  Each block holds 10 more bytes than the one before and the
    first holds 3 fewer besides (its input is the embedding); post holds
    what the blocks left plus 15.  Five blocks more than the shallow
    step: the last block's b, extended from the shallow step's last (from
    its first it would read 92)."""
    p, a, b, q = (torch.ops.aten.add.Tensor, torch.ops.aten.mul.Tensor,
                  torch.ops.aten.mm.default, torch.ops.aten.cat.default)

    def step(n):
        blocks = [(op, 10 * j + v - (3 if j == 0 else 0))
                  for j in range(n) for op, v in ((a, 5), (b, 30))]
        return [(p, 1)] + blocks + [(q, 10 * n + 15)]

    full = step(7)
    assert dryrun.extended_peak(step(2), step(3), 5) == max(v for _, v in full) == 90
    with pytest.raises(ValueError):
        dryrun.extended_peak(step(2), step(2) + [(a, 0), (p, 0)], 5)
