"""Kernels B1, B2, B3 and B4 of the PyTorch port on an NVIDIA card.

Needs a CUDA device and nvcc; every test here carries the `gpu` marker and
skips with a reason where there is no card (a CUDA kernel has no CPU
mode).  Imports no JAX, so it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

The kernel is held against its plain PyTorch version on the card and
against a float64 numpy oracle of the model-path semantics
(`repro.models.attention.decode_attention`, to which
tests/test_torch_kernels.py holds the plain version on the CPU), at the
shapes of tests/test_kernels.py::TestFlashDecode and with ring and
softcap, with float8_e4m3fn caches, 1 to 32 query heads a KV head, with
and without S-splits, with garbage and fp8 NaN patterns past pos, over
1,000 calls on two streams, and at the encdec cross-attention and vlm
decode shapes; reduced models of every family run on the card against
the CPU.  Tolerances by q's dtype: 1e-4 for f32
(reduction order), 2e-2 for bf16 (the kernel rounds the unnormalized
softmax weights to bf16, the plain version the normalized ones, as the
reference does).

B3 (SSD chunk scan) and B4 (RG-LRU scan) are held against their plain
versions at the shapes of mamba2-130m and recurrentgemma-9b and their
reduced variants, ragged S and an initial state included, with the input
scales and f32 tolerances of tests/test_kernels.py (TestSSDScan: atol 2e-4,
rtol 1e-3; TestRGLRU: 1e-4).  B3 in bf16 (y and final state) is held
within 2e-2 of the output's largest magnitude: kernel and plain version
round the scores, chunk states and decay-weighted inputs to bf16 as the
reference does, but the plain version's bf16 einsums also round their
outputs and chunk at 256 steps where the kernel chunks at 64.  The edge
cases follow the designs: S around B3's 64-step chunks, state sizes 16 to
256, p-tiles of 16 to 64, two groups; B4's tiles (S = 4100), its float4
edge (W = 4097) and unaligned inputs.

B1 has no backward: on CUDA inputs that need a gradient its wrapper
raises, naming the missing backward, rather than return a tensor cut from
the autograd graph; under `torch.no_grad()` the same inputs launch.  B3
and B4 carry gradients through their backward kernels: held against
autograd of the plain versions at chip_smoke.py's phase 3 shapes (each
gradient of f32 inputs within 2e-4 of its own largest, of bf16 inputs within
2e-2 of the f32 reference), bit for bit on repeat.  A dense, a MoE, the ssm and the hybrid
reduced models train one step on the card as on the CPU.

The engine's CUDA graphs (one per jit key of the reference's engine):
each family's reduced model graphed against the same steps run eagerly
on the card, logits bit-identical and greedy tokens identical in both KV
modes, replays counted as the eager steps launch; temperature sampling
inside a graph from the registered generator; B1's workspace kept by a
graph captured before a larger one replaced it; a capture that meets a
host sync, or B1 given a Python int position while capturing, raises.

The compiled training step (`launch.steps.compile_train_step`, one CUDA
graph per jit key): every family's reduced model (qwen3 microbatched,
granite-moe with capacity drops, deepseek-v3, mamba2, recurrentgemma,
seamless, internvl2), remat on, 3 graphed steps bit-identical to 3 eager
ones (losses, params, AdamW state; deterministic algorithms on) with B3's
and B4's forward and backward launches per replay equal to what the
layers need; DTensor params refused; the graph's pool released when the
step is dropped.

B2 (the analytic pass-cost surface) is held against its plain version on
the card for the eight family branches, at rtol 1e-5 in float32 (the
reference's gate for the TPU kernel) and 1e-12 in float64, and bit for bit
in each operand mode (uniform, aliased, misaligned; m = 1, 3, 5,
1,000,037); `simulate_batch` on the card within 1e-9 relative of the numpy
closed form, each of its pass-cost calls one B2 launch with no copy or fill
kernel beside it (profiler).
"""

import collections
import itertools
import os
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# cuBLAS is deterministic under torch.use_deterministic_algorithms (the
# compiled train step's bit-identity tests) only with a fixed workspace, set
# before its first call in the process, as chip_smoke.py sets it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# chip_smoke.py's phase 3 shapes, limits and gradient helpers: mamba2-130m's
# training shape, S around the forward's 64-step chunks and the backward's
# 32-step ones, state sizes 16 to 256, two groups; recurrentgemma-9b's
# training shape, many tiles, W % 4 != 0
from chip_smoke import RGLRU_BWD_CASES, SCAN_BWD_TOL, SSD_BWD_CASES  # noqa: E402
from chip_smoke import B2_MODE_CASES, B2_MODE_SIZES, b2_operands  # noqa: E402
from chip_smoke import grad_err as _grad_err  # noqa: E402
from chip_smoke import graph_drive  # noqa: E402
from chip_smoke import scan_grads as _scan_grads  # noqa: E402
from repro_torch import graphs
from repro_torch.checkpoint import flatten_tree
from repro_torch.configs import get_config
from repro_torch.energy.simulator import AnalyticLLMSimulator
from repro_torch.kernels import cost_batch as kcb
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import rglru_scan as krg
from repro_torch.kernels import ssd_scan as kss
from repro_torch.launch.steps import build_train_step, compile_train_step, value_and_grad
from repro_torch.models import get_api
from repro_torch.serving import InferenceEngine

pytestmark = pytest.mark.gpu

FLASH_SHAPES = [             # (B, Hq, Hkv, D, S)
    (2, 8, 2, 128, 512),
    (1, 16, 8, 128, 1024),
    (4, 4, 1, 64, 256),
    (2, 12, 4, 128, 384),
    (1, 71, 71, 64, 256),       # 71 heads, G = 1 (not falcon-7b: that is MQA)
    (4, 71, 1, 64, 80),         # falcon-7b MQA: G = 71, four 16-head tiles and 7
    (1, 71, 1, 64, 2048),
    (4, 24, 8, 64, 80),         # granite-moe-3b-a800m, G = 3
    (4, 32, 8, 128, 80),        # mixtral-8x7b, G = 4
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MODEL_CASES = [             # (B, Hq, Hkv, D, S, pos, ring, softcap, dtype)
    (2, 4, 2, 32, 80, 3, False, 0.0, "float32"),
    (2, 4, 2, 32, 80, 79, False, 0.0, "float32"),
    (2, 4, 2, 32, 64, 20, True, 0.0, "float32"),      # ring not yet full
    (2, 4, 2, 32, 64, 70, True, 0.0, "float32"),      # ring full
    (2, 8, 1, 64, 96, 40, False, 2.0, "float32"),     # softcap
    (1, 16, 2, 128, 130, 129, True, 5.0, "bfloat16"),
    (4, 32, 32, 128, 80, 57, False, 0.0, "bfloat16"),  # llama2-7b serve shape
    (1, 64, 8, 128, 4096, 3000, False, 0.0, "float32"),  # llama2-70b GQA
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def oracle(q, k, v, pos, ring=False, softcap=0.0):
    """float64 numpy: the model path's decode attention."""
    q, k, v = (t.double().cpu().numpy() for t in (q, k, v))
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    s = np.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, Hq // Hkv, D), k) / np.sqrt(D)
    if softcap:
        s = np.tanh(s / softcap) * softcap
    valid = np.arange(S) <= pos
    if ring:
        valid |= pos >= S - 1
    s = np.where(valid, s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhgk,bkhd->bhgd", w, v).reshape(B, Hq, D)


def inputs(B, Hq, Hkv, D, S, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def close(a, b, tol):
    np.testing.assert_allclose(a.float().cpu().numpy() if torch.is_tensor(a) else a,
                               b.float().cpu().numpy() if torch.is_tensor(b) else b,
                               atol=tol, rtol=tol)


def close_b1(a, b, tol):
    """B1's outputs: elementwise as `close`, and the largest error within
    tol times the reference's largest magnitude (a long cache averages
    randn values down to a few hundredths, where the elementwise bound
    alone is as large as the output)."""
    close(a, b, tol)
    a = a.float().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.float().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_full_cache(cuda, shape, dtype):
    q, k, v = inputs(*shape, getattr(torch, dtype))
    pos = torch.tensor(shape[-1] - 1, dtype=torch.int32, device=cuda)
    out = kda.decode_attention(q, k, v, pos)
    assert out.dtype == q.dtype and out.shape == q.shape
    close_b1(out, kda.decode_attention_plain(q, k, v, pos), TOL[dtype])
    close_b1(out, oracle(q, k, v, shape[-1] - 1), TOL[dtype])


@pytest.mark.parametrize("pos", [0, 5, 255, 400])
def test_masking_positions(cuda, pos):
    q, k, v = inputs(2, 4, 2, 64, 512, torch.float32, seed=pos)
    close_b1(kda.decode_attention(q, k, v, pos), oracle(q, k, v, pos), 1e-4)


def test_masked_tail_is_ignored(cuda):
    """The kernel never reads keys beyond pos: bit-identical output."""
    q, k, v = inputs(1, 4, 2, 64, 256, torch.float32)
    k2, v2 = k.clone(), v.clone()
    k2[:, 101:] = 1e4
    v2[:, 101:] = -1e4
    assert torch.equal(kda.decode_attention(q, k, v, 100), kda.decode_attention(q, k2, v2, 100))


@pytest.mark.parametrize("case", MODEL_CASES)
def test_model_path_cases(cuda, case):
    B, Hq, Hkv, D, S, pos, ring, softcap, dtype = case
    q, k, v = inputs(B, Hq, Hkv, D, S, getattr(torch, dtype), seed=S)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = kda.launches
    out = kda.decode_attention(q, k, v, p, ring=ring, softcap=softcap)
    assert kda.launches == before + 1
    tol = TOL[dtype]
    close_b1(out, kda.decode_attention_plain(q, k, v, p, ring=ring, softcap=softcap), tol)
    close_b1(out, oracle(q, k, v, pos, ring, softcap), tol)


def test_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(2, 4, 32, device=cuda)
    kv = torch.zeros(2, 8, 2, 32, device=cuda)
    before = kda.launches
    for cache in (torch.float8_e5m2, torch.float16):
        with pytest.raises(TypeError, match="float8_e4m3fn"):
            kda.decode_attention(q, kv.to(cache), kv.to(cache), 0)
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        kda.decode_attention(q.half(), kv.half(), kv.half(), 0)
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        kda.decode_attention(q, kv, kv.to(torch.float8_e4m3fn), 0)
    assert kda.launches == before
    with pytest.raises(ValueError, match="head dims"):
        kda.decode_attention(torch.zeros(2, 4, 48, device=cuda),
                             torch.zeros(2, 8, 2, 48, device=cuda),
                             torch.zeros(2, 8, 2, 48, device=cuda), 0)
    with pytest.raises(ValueError, match="contiguous"):
        kda.decode_attention(q, kv.transpose(1, 2).contiguous().transpose(1, 2), kv, 0)
    with pytest.raises(ValueError, match="pos"):
        kda.decode_attention(q, kv, kv, torch.tensor(0, device=cuda))


FP8_CASES = [               # (B, Hq, Hkv, D, S, pos, ring, softcap): G = 1 to 71
    (4, 32, 32, 128, 80, 57, False, 0.0),
    (2, 4, 2, 32, 80, 79, False, 0.0),
    (1, 64, 8, 128, 4096, 3000, False, 0.0),
    (4, 16, 1, 256, 2048, 2100, True, 0.0),
    (2, 32, 1, 64, 300, 200, False, 3.0),
    (4, 71, 1, 64, 80, 79, False, 0.0),         # falcon-7b MQA
    (1, 71, 1, 64, 2048, 1500, False, 0.0),
    (4, 24, 8, 64, 80, 79, False, 0.0),         # granite-moe-3b-a800m
    (4, 32, 8, 128, 80, 79, False, 0.0),        # mixtral-8x7b
]


def fp8_inputs(B, Hq, Hkv, D, S, qdtype, seed=0):
    q, k, v = inputs(B, Hq, Hkv, D, S, getattr(torch, qdtype), seed=seed)
    return q, k.float().to(torch.float8_e4m3fn), v.float().to(torch.float8_e4m3fn)


@pytest.mark.parametrize("qdtype", list(TOL))
@pytest.mark.parametrize("case", FP8_CASES)
def test_fp8_cache(cuda, case, qdtype):
    """An fp8 e4m3 cache computes in q's type, as the reference upcasts it:
    within q's tolerance of the plain version and of the oracle over the
    cache's values."""
    B, Hq, Hkv, D, S, pos, ring, softcap = case
    q, k, v = fp8_inputs(B, Hq, Hkv, D, S, qdtype, seed=S)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = kda.launches
    out = kda.decode_attention(q, k, v, p, ring=ring, softcap=softcap)
    assert kda.launches == before + 1 and out.dtype == q.dtype
    close_b1(out, kda.decode_attention_plain(q, k, v, p, ring=ring, softcap=softcap), TOL[qdtype])
    close_b1(out, oracle(q, k.float(), v.float(), pos, ring, softcap), TOL[qdtype])


@pytest.mark.parametrize("G", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("cache", ["same", "float8_e4m3fn"])
@pytest.mark.parametrize("qdtype", list(TOL))
@pytest.mark.parametrize("n_splits", [1, 7])
def test_groups_and_splits(cuda, monkeypatch, G, cache, qdtype, n_splits):
    """Query heads a KV head from 1 to 32 (two head tiles of the
    tensor-core path, four of the f32 path), S cut into 1 or up to 7
    splits (128 keys or more each) whatever the plan; the pos values give
    one split, three with a ragged last one, and six over a full cache."""
    monkeypatch.setattr(kda, "plan", lambda *a, **kw: n_splits)
    B, Hkv, D, S = 2, 2, 128, 700
    q, k, v = inputs(B, G * Hkv, Hkv, D, S, getattr(torch, qdtype), seed=G)
    if cache != "same":
        k, v = k.float().to(torch.float8_e4m3fn), v.float().to(torch.float8_e4m3fn)
    for pos in (40, 333, S - 1):
        p = torch.tensor(pos, dtype=torch.int32, device=cuda)
        out = kda.decode_attention(q, k, v, p)
        close_b1(out, kda.decode_attention_plain(q, k, v, p), TOL[qdtype])
        close_b1(out, oracle(q, k.float(), v.float(), pos), TOL[qdtype])


@pytest.mark.parametrize("cache", ["bfloat16", "float8_e4m3fn"])
def test_garbage_and_fp8_nan_past_pos_never_read(cuda, cache):
    """Keys past pos set to +-448 or to fp8 NaN bit patterns (bf16: NaN):
    the output is bit-identical, with and without splits."""
    q, k, v = inputs(4, 16, 1, 256, 2048, torch.bfloat16, seed=9)
    k, v = k.float().to(getattr(torch, cache)), v.float().to(getattr(torch, cache))
    for pos in (0, 100, 1500):
        k2, v2, k3, v3 = k.clone(), v.clone(), k.clone(), v.clone()
        k2[:, pos + 1:] = 448.0
        v2[:, pos + 1:] = -448.0
        if cache == "float8_e4m3fn":
            k3.view(torch.uint8)[:, pos + 1:] = 0x7F
            v3.view(torch.uint8)[:, pos + 1:] = 0xFF
        else:
            k3[:, pos + 1:] = float("nan")
            v3[:, pos + 1:] = float("nan")
        a = kda.decode_attention(q, k, v, pos)
        assert torch.equal(a, kda.decode_attention(q, k2, v2, pos))
        assert torch.equal(a, kda.decode_attention(q, k3, v3, pos))


def test_back_to_back_calls_on_two_streams(cuda):
    """1,000 calls that split S and merge through the per-stream counters,
    500 on each of two streams at once: every output equals the first (a
    counter left unreset, or shared by the streams, would break one)."""
    q, k, v = inputs(4, 16, 1, 256, 2048, torch.bfloat16, seed=3)
    p = torch.tensor(2047, dtype=torch.int32, device=cuda)
    assert kda.plan(4, 16, 1, 2048, 256, torch.bfloat16, torch.bfloat16) > 1
    ref = kda.decode_attention(q, k, v, p)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(500):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(kda.decode_attention(q, k, v, p))
    torch.cuda.synchronize()
    assert sum(torch.equal(o, ref) for os_ in outs for o in os_) == 1000


def test_engine_on_the_card_matches_the_cpu(cuda):
    """Reduced f32 model: greedy tokens through the kernel on the card equal
    the plain path's on the CPU, in both KV modes."""
    cfg = get_config("mistral-7b-reduced")
    cpu = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))

    def move(tree):
        return {k: move(v) if isinstance(v, dict) else v.to(cuda) for k, v in tree.items()}

    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 60)).astype(np.int32)
    ref, _ = InferenceEngine(cfg, cpu, kv_cache=True, device="cpu").generate({"tokens": toks}, 8)
    before = kda.launches
    for kv in (True, False):
        out, _ = InferenceEngine(cfg, move(cpu), kv_cache=kv, device=cuda).generate(
            {"tokens": toks}, 8)
        np.testing.assert_array_equal(out, ref)
    assert kda.launches == before + cfg.n_layers * 8


SSD_CASES = [               # (b, s, h, p, g, n): mamba2-130m and reduced
    (2, 8, 24, 64, 1, 128),
    (2, 37, 24, 64, 1, 128),
    (4, 256, 24, 64, 1, 128),
    (4, 300, 24, 64, 1, 128),
    (2, 37, 32, 16, 1, 16),      # mamba2-130m-reduced
    (2, 100, 8, 32, 2, 64),      # two groups
    # edges of the bf16 kernel's 64-step chunks, state sizes and p-tiles
    (2, 1, 24, 64, 1, 128),
    (2, 63, 24, 64, 1, 128),
    (2, 64, 24, 64, 1, 128),
    (2, 65, 24, 64, 1, 128),
    (2, 129, 24, 64, 1, 128),
    (1, 65, 4, 16, 2, 16),
    (1, 129, 4, 32, 2, 64),
    (1, 63, 4, 64, 2, 256),
    (2, 129, 8, 64, 2, 256),
]


def ssd_inputs(b, s, h, p, g, n, dtype, seed=0):
    """tests/test_kernels.py::TestSSDScan's scales."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    xdt = (rand(b, s, h, p) * 0.5).to(dtype)
    dA = -(rand(b, s, h) * 0.3).abs()
    B = (rand(b, s, g, n) * 0.5).to(dtype)
    C = (rand(b, s, g, n) * 0.5).to(dtype)
    h0 = rand(b, h, p, n) * 0.5
    return xdt, dA, B, C, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_matches_plain(cuda, case, dtype, with_h0):
    xdt, dA, B, C, h0 = ssd_inputs(*case, getattr(torch, dtype), seed=case[1])
    h0 = h0 if with_h0 else None
    before = kss.launches
    y, fin = kss.ssd_scan(xdt, dA, B, C, chunk=256, h0=h0)
    assert kss.launches == before + 1
    y_p, fin_p = kss.ssd_scan_plain(xdt, dA, B, C, chunk=256, h0=h0)
    assert y.dtype == xdt.dtype and y.shape == xdt.shape and fin.dtype == torch.float32
    for ours, plain in ((y, y_p), (fin, fin_p)):
        if dtype == "float32":
            np.testing.assert_allclose(ours.cpu().numpy(), plain.cpu().numpy(),
                                       atol=2e-4, rtol=1e-3)
        else:
            err = (ours.float() - plain.float()).abs().max().item()
            assert err <= 2e-2 * plain.float().abs().max().item(), err


def test_ssd_scan_rejects_what_the_kernel_does_not_take(cuda):
    xdt, dA, B, C, _ = ssd_inputs(1, 8, 2, 24, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="multiples"):
        kss.ssd_scan(xdt, dA, B, C, chunk=8)
    xdt, dA, B, C, _ = ssd_inputs(1, 8, 2, 16, 1, 16, torch.float32)
    with pytest.raises(TypeError):
        kss.ssd_scan(xdt, dA, B.bfloat16(), C, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        kss.ssd_scan(xdt.transpose(1, 2).contiguous().transpose(1, 2), dA, B, C, chunk=8)


def test_ssd_scan_bf16_rejects_state_sizes_off_the_mma_depth(cuda):
    """The bf16 kernel's products step through the state in 16s."""
    xdt, dA, B, C, _ = ssd_inputs(1, 8, 2, 16, 1, 24, torch.bfloat16)
    before = kss.launches
    with pytest.raises(ValueError, match="multiples of 16"):
        kss.ssd_scan(xdt, dA, B, C, chunk=8)
    assert kss.launches == before
    xdt, dA, B, C, _ = ssd_inputs(1, 8, 2, 16, 1, 24, torch.float32)
    y, _ = kss.ssd_scan(xdt, dA, B, C, chunk=8)     # the f32 kernel takes any n
    assert kss.launches == before + 1


RGLRU_CASES = [             # (B, S, W): recurrentgemma-9b, reduced, ragged
    (2, 1, 4096), (2, 8, 4096), (2, 37, 4096), (4, 300, 4096),
    (2, 37, 128), (3, 64, 100),
    (2, 128, 4096), (4, 48, 4096),        # the serve shapes: one tile
    (2, 4100, 256),                       # many tiles, state carried over
    (2, 128, 4097), (1, 300, 4097),       # W % 4 != 0: one channel a thread
]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_scan_matches_plain(cuda, case, with_h0):
    """tests/test_kernels.py::TestRGLRU's scales and tolerance."""
    Bsz, S, W = case
    gen = torch.Generator(device="cuda").manual_seed(S)
    a = 0.7 + 0.299 * torch.rand((Bsz, S, W), generator=gen, device="cuda")
    b = 0.1 * torch.randn((Bsz, S, W), generator=gen, device="cuda")
    h0 = torch.randn((Bsz, W), generator=gen, device="cuda") if with_h0 else None
    before = krg.launches
    h, last = krg.rglru_scan(a, b, h0)
    assert krg.launches == before + 1
    h_p, last_p = krg.rglru_scan_plain(a, b, h0)
    close(h, h_p, 1e-4)
    close(last, last_p, 1e-4)


def test_rglru_scan_unaligned_inputs(cuda):
    """Inputs that do not start on a 16-byte boundary take the
    one-channel-a-thread path, W % 4 == 0 notwithstanding."""
    Bsz, S, W = 2, 40, 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 0.1 * torch.randn((Bsz, S, W), generator=gen, device="cuda")
    a = torch.empty(Bsz * S * W + 1, device="cuda")[1:].view(Bsz, S, W)
    a.copy_(0.7 + 0.299 * torch.rand((Bsz, S, W), generator=gen, device="cuda"))
    assert a.data_ptr() % 16 and a.is_contiguous()
    h, last = krg.rglru_scan(a, b)
    h_p, last_p = krg.rglru_scan_plain(a, b)
    close(h, h_p, 1e-4)
    close(last, last_p, 1e-4)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("pos", [0, 1000, 2047, 2100])
def test_decode_attention_head_dim_256(cuda, dtype, pos):
    """recurrentgemma-9b's local attention: MQA, 16 query heads, a
    2048-slot ring, head dim 256; pos past the ring's end wraps it."""
    q, k, v = inputs(2, 16, 1, 256, 2048, getattr(torch, dtype), seed=pos)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    out = kda.decode_attention(q, k, v, p, ring=True)
    close_b1(out, kda.decode_attention_plain(q, k, v, p, ring=True), TOL[dtype])
    close_b1(out, oracle(q, k, v, pos, ring=True), TOL[dtype])


@pytest.mark.parametrize("arch,expect", [     # launches of (B3, B4, B1)
    ("mamba2-130m-reduced", (2, 0, 0)),          # 2 SSM layers x 1 prefill
    ("recurrentgemma-9b-reduced", (0, 4, 8)),    # 4 rec layers; 1 attn x 8 steps
])
def test_scan_models_on_the_card_match_the_cpu(cuda, arch, expect):
    """Reduced f32 ssm and hybrid models: greedy tokens through the kernels
    on the card equal the plain path's on the CPU, in both KV modes; the
    KV-on run launches B3 once per SSM layer, B4 once per recurrent layer
    and B1 once per attention layer and step."""
    cfg = get_config(arch)
    cpu = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))

    def move(tree):
        return {k: move(v) if isinstance(v, dict) else v.to(cuda) for k, v in tree.items()}

    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 37)).astype(np.int32)
    ref, _ = InferenceEngine(cfg, cpu, kv_cache=True, device="cpu").generate({"tokens": toks}, 8)
    counts = (kss.launches, krg.launches, kda.launches)
    out, _ = InferenceEngine(cfg, move(cpu), kv_cache=True, device=cuda).generate(
        {"tokens": toks}, 8)
    np.testing.assert_array_equal(out, ref)
    assert (kss.launches - counts[0], krg.launches - counts[1],
            kda.launches - counts[2]) == expect
    out, _ = InferenceEngine(cfg, move(cpu), kv_cache=False, device=cuda).generate(
        {"tokens": toks}, 8)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("arch,absorb,b1_per_step", [
    ("mixtral-8x7b-reduced", False, 2),             # 2 attention layers through B1
    ("granite-moe-3b-a800m-reduced", False, 2),
    ("deepseek-v3-671b-reduced", True, 0),          # MLA: plain PyTorch, no B1
    ("deepseek-v3-671b-reduced", False, 0),
])
def test_moe_models_on_the_card_match_the_cpu(cuda, arch, absorb, b1_per_step):
    """Reduced f32 MoE models: greedy tokens on the card equal the CPU's in
    both KV modes, and the KV-on run launches B1 once per attention layer
    and decode step (none under MLA)."""
    cfg = get_config(arch).replace(mla_absorb=absorb)
    cpu = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))

    def move(tree):
        return {k: move(v) if isinstance(v, dict) else v.to(cuda) for k, v in tree.items()}

    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 21)).astype(np.int32)
    ref, _ = InferenceEngine(cfg, cpu, kv_cache=True, device="cpu").generate({"tokens": toks}, 8)
    for kv in (True, False):
        before = kda.launches
        out, _ = InferenceEngine(cfg, move(cpu), kv_cache=kv, device=cuda).generate(
            {"tokens": toks}, 8)
        np.testing.assert_array_equal(out, ref)
        assert kda.launches - before == (b1_per_step * 8 if kv else 0)


# (B, Hq, Hkv, D, S, pos): seamless-m4t-large-v2's cross-attention over all
# 4,096 memory frames (G = 1, D = 64), and internvl2-2b's decode (G = 2,
# D = 128) over 256 patch positions + the served text, a cache of 336
ENCDEC_VLM_SHAPES = [(4, 16, 16, 64, 4096, 4095), (4, 16, 8, 128, 336, 300)]


@pytest.mark.parametrize("n_splits", [None, 1, 7])
@pytest.mark.parametrize("cache", ["same", "float8_e4m3fn"])
@pytest.mark.parametrize("qdtype", list(TOL))
@pytest.mark.parametrize("shape", ENCDEC_VLM_SHAPES)
def test_encdec_and_vlm_shapes(cuda, monkeypatch, shape, qdtype, cache, n_splits):
    """B1 at the encdec cross-attention and vlm decode shapes, with the
    cache in q's type or fp8, S cut as the plan cuts it (None) or into 1
    or 7 splits: within q's tolerance of the plain version and the oracle."""
    if n_splits is not None:
        monkeypatch.setattr(kda, "plan", lambda *a, **kw: n_splits)
    B, Hq, Hkv, D, S, pos = shape
    q, k, v = inputs(B, Hq, Hkv, D, S, getattr(torch, qdtype), seed=S + D)
    if cache != "same":
        k, v = k.float().to(torch.float8_e4m3fn), v.float().to(torch.float8_e4m3fn)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = kda.launches
    out = kda.decode_attention(q, k, v, p)
    assert kda.launches == before + 1 and out.dtype == q.dtype
    close_b1(out, kda.decode_attention_plain(q, k, v, p), TOL[qdtype])
    close_b1(out, oracle(q, k.float(), v.float(), pos), TOL[qdtype])


@pytest.mark.parametrize("arch,b1_per_step", [
    ("seamless-m4t-large-v2-reduced", 4),   # 2 decoder layers x (self + cross)
    ("internvl2-2b-reduced", 2),            # 2 layers
])
def test_encdec_vlm_models_on_the_card_match_the_cpu(cuda, arch, b1_per_step):
    """Reduced f32 encdec and vlm models with random frames/patches: prefill
    and decode logits on the card within 1e-4 of the CPU's, greedy tokens
    equal in both KV modes, and B1 launched b1_per_step times a decode step
    and never in a prefill."""
    from repro_torch.serving.engine import frontend_inputs
    cfg = get_config(arch)
    api = get_api(cfg)
    cpu = api.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))

    def move(tree):
        return {k: move(v) if isinstance(v, dict) else v.to(cuda) for k, v in tree.items()}

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (2, 21)).astype(np.int32),
             **{k: rng.normal(size=v.shape).astype(np.float32)
                for k, v in frontend_inputs(cfg, 2).items()}}
    gpu = move(cpu)
    ref, _ = InferenceEngine(cfg, cpu, kv_cache=True, device="cpu").generate(batch, 8)
    for kv in (True, False):
        before = kda.launches
        out, _ = InferenceEngine(cfg, gpu, kv_cache=kv, device=cuda).generate(batch, 8)
        np.testing.assert_array_equal(out, ref)
        assert kda.launches - before == (b1_per_step * 8 if kv else 0)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    cache_len = cfg.n_patches + 32
    with torch.no_grad():
        before = kda.launches
        lg, cg = api.prefill(cfg, gpu, {k: v.to(cuda) for k, v in tb.items()},
                             cache_len=cache_len)
        assert kda.launches == before
        lc, cc = api.prefill(cfg, cpu, tb, cache_len=cache_len)
        close(lg, lc, 1e-4)
        for t in range(4):
            tok = torch.as_tensor(ref[:, t])
            lg, cg = api.decode_step(cfg, gpu, cg, {"token": tok.to(cuda)})
            lc, cc = api.decode_step(cfg, cpu, cc, {"token": tok})
            close(lg, lc, 1e-4)
        assert kda.launches - before == 4 * b1_per_step


# ---------------------------------------------------------------------------
# B2: the analytic pass-cost surface, and simulate_batch through it
# ---------------------------------------------------------------------------

COST_ARCHS = ["llama2-7b", "mixtral-8x7b", "mistral-7b", "mamba2-130m", "recurrentgemma-9b",
              "deepseek-v3-671b", "seamless-m4t-large-v2", "internvl2-2b"]
TIN = np.array([1, 2, 8, 100, 512, 3000, 4095, 4096, 5000, 64])
TOUT = np.array([1, 3, 100, 4096, 512, 2000, 2, 1, 0, 300])


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("arch", COST_ARCHS)
def test_cost_batch_matches_plain(cuda, arch, decode, dtype, rtol):
    """B2 against its plain version on the card, m = 10,037 (not a multiple
    of a block), a scalar batch broadcast and a per-query one."""
    cfg = get_config(arch)
    td = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    nt = torch.as_tensor(rng.integers(1, 4096, 10_037), dtype=td, device=cuda)
    ctx = nt + torch.as_tensor(rng.integers(0, 4096, 10_037), dtype=td, device=cuda)
    for bt in (torch.tensor(8.0, dtype=td, device=cuda),
               torch.as_tensor(rng.integers(1, 64, 10_037), dtype=td, device=cuda)):
        for iw in (True, False):
            before = kcb.launches
            f, b = kcb.pass_surface(cfg, nt, ctx, bt, include_weights=iw, decode=decode)
            assert kcb.launches == before + 1 and f.dtype == td and f.shape == nt.shape
            pf, pb = kcb.pass_surface_plain(cfg, nt, ctx, bt, include_weights=iw, decode=decode)
            torch.testing.assert_close(f, pf, rtol=rtol, atol=0)
            torch.testing.assert_close(b, pb, rtol=rtol, atol=0)


@pytest.mark.parametrize("kv", [True, False])
@pytest.mark.parametrize("arch", COST_ARCHS)
def test_simulate_batch_on_the_card(cuda, arch, kv):
    """Within 1e-9 relative of the numpy closed form, with one B2 launch per
    pass-cost evaluation."""
    sim = AnalyticLLMSimulator(get_config(arch), batch=4, kv_cache=kv, noise_sigma=0.0)
    before = kcb.launches
    e, r = kcb.simulate_batch(sim, TIN, TOUT)
    assert kcb.launches - before == kcb.surface_calls(sim.cfg, kv)
    pbs = [sim.simulate(int(a), int(b)) for a, b in zip(TIN, TOUT)]
    np.testing.assert_allclose(e, [pb.energy_j for pb in pbs], rtol=1e-9, atol=0)
    np.testing.assert_allclose(r, [pb.runtime_s for pb in pbs], rtol=1e-9, atol=0)
    E, _ = kcb.cost_matrices([sim], TIN, TOUT, per_query=True)
    np.testing.assert_allclose(E[:, 0], e / sim.batch, rtol=1e-12, atol=0)


def test_cost_batch_rejects_what_the_kernel_does_not_take(cuda):
    cfg = get_config("llama2-7b")
    x = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        kcb.pass_surface(cfg, x.half(), x.half(), x.half())
    with pytest.raises(TypeError):
        kcb.pass_surface(cfg, x, x, x.double())
    with pytest.raises(ValueError):
        kcb.pass_surface(cfg, x, x, torch.tensor(4.0))
    f, b = kcb.pass_costs_kernel(cfg, np.arange(1.0, 38.0), np.arange(1.0, 38.0), 4.0)
    pf, pb = kcb.pass_costs_kernel(cfg, np.arange(1.0, 38.0), np.arange(1.0, 38.0), 4.0,
                                   device="cpu")
    np.testing.assert_allclose(f, pf, rtol=1e-5)
    np.testing.assert_allclose(b, pb, rtol=1e-5)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("m", B2_MODE_SIZES)
@pytest.mark.parametrize("case", B2_MODE_CASES)
def test_cost_batch_operand_modes(cuda, case, m, dtype, rtol):
    """B2 with a uniform batch or new tokens (0-d, or expanded with stride
    0), context aliasing new tokens, and bases off a 16-byte boundary, at
    m = 1, 3, 5 and 1,000,037 (chip_smoke's check): one launch a call, bit
    for bit with the plain version (as every per-query case is), for every
    family branch and both decode modes."""
    td = getattr(torch, dtype)
    for i, arch in enumerate(COST_ARCHS):
        cfg = get_config(arch)
        ops = b2_operands(torch, case, m, td, seed=200 + i)
        for decode in (False, True):
            before = kcb.launches
            f, b = kcb.pass_surface(cfg, *ops, decode=decode)
            assert kcb.launches == before + 1 and f.shape == b.shape == (m,)
            pf, pb = kcb.pass_surface_plain(cfg, *ops, decode=decode)
            torch.testing.assert_close(f, pf, rtol=rtol, atol=0)
            torch.testing.assert_close(b, pb, rtol=rtol, atol=0)
            assert torch.equal(f, pf) and torch.equal(b, pb), (arch, decode)


def _kernel_counts(fn) -> collections.Counter:
    """Kernels and device copies fn launches (torch.profiler, one call after
    a warm-up): name -> count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter({e.key: e.count for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA})


@pytest.mark.parametrize("kv", [True, False])
def test_simulate_batch_launches_b2_alone(cuda, monkeypatch, kv):
    """Each pass_surface call of simulate_batch (llama2-7b, batch 32, 10⁵
    queries) is one B2 launch and nothing else: no copy of a broadcast
    operand, no fill of a ones tensor.  The profile of simulate_batch with
    its pass_surface calls answered from memory (the same outputs, no
    launch) lacks exactly the B2 launches."""
    sim = AnalyticLLMSimulator(get_config("llama2-7b"), batch=32, kv_cache=kv, noise_sigma=0.0)
    tin, tout = np.random.default_rng(7).integers(1, 4096, (2, 100_000))
    outs = []
    real = kcb.pass_surface

    def recording(*args, **kw):
        outs.append(real(*args, **kw))
        return outs[-1]

    monkeypatch.setattr(kcb, "pass_surface", recording)
    with_b2 = _kernel_counts(lambda: kcb.simulate_batch(sim, tin, tout))
    calls = kcb.surface_calls(sim.cfg, kv)
    assert len(outs) == 2 * calls
    replies = itertools.cycle(outs[-calls:])
    monkeypatch.setattr(kcb, "pass_surface", lambda *args, **kw: next(replies))
    without = _kernel_counts(lambda: kcb.simulate_batch(sim, tin, tout))
    added = with_b2 - without
    assert not without - with_b2
    # one instance of B2 per operand modes: the prefill's and the probes'
    assert all("cost_batch_kernel" in name for name in added), added
    assert sum(added.values()) == calls


# ---------------------------------------------------------------------------
# Gradients: B1 refuses inputs that need one; B3 and B4 carry them through
# their backward kernels
# ---------------------------------------------------------------------------


def test_wrapper_raises_when_grad_is_needed(cuda):
    """B1 has no backward: it raises on a CUDA input that needs a gradient,
    and under no_grad the same input launches."""
    q, k, v = inputs(2, 4, 2, 64, 32, torch.float32)
    pos = torch.tensor(31, dtype=torch.int32, device="cuda")
    call = lambda: kda.decode_attention(q.requires_grad_(), k, v, pos)
    before = kda.launches
    with pytest.raises(RuntimeError, match="kernel B1 has no backward"):
        call()
    assert kda.launches == before
    with torch.no_grad():
        call()
    assert kda.launches == before + 1


def scan_grads(fn, inputs_, cotangents):
    return _scan_grads(torch, fn, inputs_, cotangents)


def grad_err(ours, ref):
    """Largest over the gradients of |ours - ref| over that gradient's own
    largest |ref| (chip_smoke.grad_err)."""
    return _grad_err(ours, ref)[0]


def ssd_fn(plain):
    scan = kss.ssd_scan_plain if plain else kss.ssd_scan
    return lambda x, dA, B, C, h0: scan(x, dA, B, C, chunk=256, h0=h0)


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_scan_backward_matches_autograd_of_plain(cuda, case, with_h0, with_final):
    """f32 within 2e-4 of each gradient's largest (TF32 off); bf16 inputs
    within 2e-2 of the same f32 reference (the backward differentiates the
    unrounded function in f32).  One backward launch a call."""
    b, s, h, p, g, n = case
    xdt, dA, B, C, h0 = ssd_inputs(b, s, h, p, g, n, torch.float32, seed=s)
    gen = torch.Generator(device="cuda").manual_seed(1)
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
    dfin = torch.randn((b, h, p, n), generator=gen, device="cuda") if with_final else None
    args = [xdt, dA, B, C, h0 if with_h0 else None]
    ref = scan_grads(ssd_fn(True), args, [dy, dfin])
    before = kss.bwd_launches
    assert grad_err(scan_grads(ssd_fn(False), args, [dy, dfin]), ref) <= SCAN_BWD_TOL["float32"]
    assert kss.bwd_launches == before + 1
    bf = [xdt.bfloat16(), dA, B.bfloat16(), C.bfloat16(), args[4]]
    ours = scan_grads(ssd_fn(False), bf, [dy, dfin])
    assert [t.dtype for t in ours[:4]] == [torch.bfloat16, torch.float32, torch.bfloat16,
                                           torch.bfloat16]
    assert grad_err(ours, ref) <= SCAN_BWD_TOL["bfloat16"]


@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("case", RGLRU_BWD_CASES)
def test_rglru_scan_backward_matches_autograd_of_plain(cuda, case, with_h0, with_last):
    Bsz, S, W = case
    gen = torch.Generator(device="cuda").manual_seed(S)
    a = 0.7 + 0.299 * torch.rand((Bsz, S, W), generator=gen, device="cuda")
    b = 0.1 * torch.randn((Bsz, S, W), generator=gen, device="cuda")
    h0 = torch.randn((Bsz, W), generator=gen, device="cuda") if with_h0 else None
    dh = torch.randn((Bsz, S, W), generator=gen, device="cuda")
    dlast = torch.randn((Bsz, W), generator=gen, device="cuda") if with_last else None
    ref = scan_grads(krg.rglru_scan_plain, [a, b, h0], [dh, dlast])
    before = krg.bwd_launches
    assert (grad_err(scan_grads(krg.rglru_scan, [a, b, h0], [dh, dlast]), ref)
            <= SCAN_BWD_TOL["float32"])
    assert krg.bwd_launches == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_backwards_repeat_bit_for_bit(cuda, dtype):
    """No atomics and a fixed order of every sum: two calls on the same
    inputs give the same bits (the training path's resume check runs with
    deterministic algorithms on)."""
    xdt, dA, B, C, h0 = ssd_inputs(4, 200, 24, 64, 1, 128, getattr(torch, dtype), seed=3)
    dy = torch.randn(xdt.shape, device="cuda")
    first = scan_grads(ssd_fn(False), [xdt, dA, B, C, h0], [dy, None])
    for x, y in zip(first, scan_grads(ssd_fn(False), [xdt, dA, B, C, h0], [dy, None])):
        assert torch.equal(x, y)
    a = 0.7 + 0.299 * torch.rand((4, 300, 4096), device="cuda")
    b = 0.1 * torch.randn((4, 300, 4096), device="cuda")
    dh = torch.randn_like(a)
    first = scan_grads(krg.rglru_scan, [a, b, None], [dh, None])
    for x, y in zip(first, scan_grads(krg.rglru_scan, [a, b, None], [dh, None])):
        assert torch.equal(x, y)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One AdamW step of qwen3-1.7b- and granite-moe-3b-a800m-reduced from
    the same weights: losses within 1e-3 and gradients within 1e-2 of the
    largest (f32, TF32 off)."""
    for arch in ("qwen3-1.7b-reduced", "granite-moe-3b-a800m-reduced"):
        assert_step_matches_cpu(cuda, arch)


def assert_step_matches_cpu(cuda, arch):
    cfg = get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 32), dtype=np.int32))
             for k in ("tokens", "labels")}
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = value_and_grad(lambda p, b: api.train_loss(cfg, p, b)[0],
                                  _to(params, dev), {k: v.to(dev) for k, v in batch.items()})
    assert abs(float(out["cuda"][0]) - float(out["cpu"][0])) <= 1e-3
    ref = dict(flatten_tree(out["cpu"][1]))
    for path, g in flatten_tree(out["cuda"][1]):
        top = float(ref[path].abs().max())
        assert float((g.cpu() - ref[path]).abs().max()) <= 1e-2 * max(top, 1e-12), path


@pytest.mark.parametrize("arch,mod", [("mamba2-130m-reduced", kss),
                                      ("recurrentgemma-9b-reduced", krg)])
def test_scan_families_train_on_the_card_as_on_the_cpu(cuda, arch, mod):
    """mamba2's and recurrentgemma's gradients on the card go through B3's
    and B4's backward kernels, one launch a scan layer, and match the CPU's
    at the limits of the other families; a step of the optimizer follows."""
    cfg = get_config(arch)
    layers = cfg.n_layers if cfg.family == "ssm" else 4       # 4 recurrent layers of 5
    before = mod.bwd_launches
    assert_step_matches_cpu(cuda, arch)
    assert mod.bwd_launches == before + layers
    api = get_api(cfg)
    params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), cuda)
    step, opt = build_train_step(cfg)
    batch = {k: torch.ones((2, 16), dtype=torch.int32, device="cuda")
             for k in ("tokens", "labels")}
    loss, params, _ = step(params, opt.init(params), batch)
    assert np.isfinite(float(loss))


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Attention scores: 16-bit operands into f32 where no gradient is taken
# ---------------------------------------------------------------------------


def test_attention_scores_take_bf16_operands_without_grad(cuda):
    """Without a gradient, bf16 scores on the card are `torch.bmm(...,
    out_dtype=torch.float32)` of the bf16 operands: within f32 summation
    error of the f32 cast (each within 128 x 2^-24 x sum_d |q_d k_d| of the
    exact sum, D = 128), for the GQA block; MLA's full attention and
    absorbed decode agree with their cast versions to bf16 rounding.
    Under grad the cast stays (`aten::bmm.dtype` has no derivative) and a
    backward through full attention runs."""
    from repro_torch.models import attention as att
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    q, k, v = rnd(2, 64, 4, 2, 128), rnd(2, 96, 4, 128), rnd(2, 96, 4, 128)
    with torch.no_grad():
        assert att._f32_out(q, k)
        fast = att._gqa_scores(q, k)
    assert not att._f32_out(q.requires_grad_(), k) and not att._f32_out(q.cpu(), k.cpu())
    cast = torch.einsum("bqhgd,bkhd->bhgqk", q.detach().float(), k.float())
    bound = torch.einsum("bqhgd,bkhd->bhgqk", q.detach().double().abs(), k.double().abs())
    assert fast.dtype == torch.float32
    assert ((fast.double() - cast.double()).abs() <= 2 * 128 * 2.0**-24 * bound).all()

    B, S, H, Dn, Dr = 2, 48, 4, 64, 32
    qn, qr, kn, kr, val = rnd(B, S, H, Dn), rnd(B, S, H, Dr), rnd(B, S, H, Dn), rnd(B, S, Dr), \
        rnd(B, S, H, Dn)
    with torch.no_grad():
        fast = att.mla_full_attention(qn, qr, kn, kr, val)
    cast = att.mla_full_attention(qn.requires_grad_(), qr, kn, kr, val).detach()
    assert float((fast.float() - cast.float()).abs().max()) <= 2e-2 * float(cast.abs().max())
    ql, cache, w_uv = rnd(B, H, 256), rnd(B, S, 256), rnd(H, 256, 64)
    pos = torch.tensor(S - 1, device="cuda")
    with torch.no_grad():
        fast = att.mla_decode_absorbed(ql, qr[:, 0], cache, kr, w_uv, pos, 0.1)
    cast = att.mla_decode_absorbed(ql.requires_grad_(), qr[:, 0], cache, kr, w_uv, pos,
                                   0.1).detach()
    assert float((fast.float() - cast.float()).abs().max()) <= 2e-2 * float(cast.abs().max())

    qg = q.detach().reshape(2, 64, 8, 128).requires_grad_()
    out = att.full_attention(qg, k, v)
    (out.float() ** 2).sum().backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())


# B1's optional log-sum-exp output, and sequence slices merged by it (the
# flash-decode exchange models.attention runs when the decode rules shard
# the cache along S): the llama2-7b serve shape and head dim 256's ring.
LSE_CASES = [(4, 32, 32, 128, 80, "bfloat16"), (4, 16, 1, 256, 2048, "bfloat16"),
             (2, 8, 2, 64, 512, "float32")]


@pytest.mark.parametrize("case", LSE_CASES)
@pytest.mark.parametrize("frac", [0.3, 1.0])
def test_decode_attention_lse_matches_plain(cuda, case, frac):
    *shape, dtype = case
    q, k, v = inputs(*shape, getattr(torch, dtype), seed=11)
    pos = torch.tensor(int(frac * (shape[4] - 1)), dtype=torch.int32, device=cuda)
    launches = kda.launches
    out, lse = kda.decode_attention(q, k, v, pos, lse=True)
    assert kda.launches == launches + 1
    assert lse.shape == q.shape[:2] and lse.dtype == torch.float32
    ref_out, ref_lse = kda.decode_attention_plain(q, k, v, pos, lse=True)
    assert torch.equal(out, kda.decode_attention(q, k, v, pos))    # the LSE changes no output
    close_b1(out, ref_out, TOL[dtype])
    close(lse, ref_lse, 1e-3)


@pytest.mark.parametrize("case", LSE_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_lse_merge_of_slices_matches_the_whole(cuda, case, n):
    *shape, dtype = case
    S = shape[4]
    q, k, v = inputs(*shape, getattr(torch, dtype), seed=12)
    for p in (S // 5, S - 1):
        pos = torch.tensor(p, dtype=torch.int32, device=cuda)
        whole = kda.decode_attention(q, k, v, pos).float()
        L = S // n
        outs, lses = [], []
        for i in range(n):
            rel = pos - i * L
            o, s = kda.decode_attention(q, k[:, i * L:(i + 1) * L].contiguous(),
                                        v[:, i * L:(i + 1) * L].contiguous(),
                                        rel.clamp(0, L - 1), lse=True)
            outs.append(o.float())
            lses.append(torch.where(rel >= 0, s, -torch.inf))
        lse = torch.stack(lses)
        w = torch.exp(lse - lse.max(0).values)
        merged = (torch.stack(outs) * w[..., None]).sum(0) / w.sum(0)[..., None]
        assert (merged - whole).abs().max() <= 0.01 * whole.abs().max()


@pytest.mark.parametrize("which", ["B1", "B3", "B4"])
def test_wrappers_on_fake_cuda_tensors_launch_nothing(cuda, which):
    """A dry run hands the wrappers fake CUDA tensors: they return the
    plain version's shapes and dtypes without a launch, and the trace
    counts the plain version's FLOPs (FlopCounterMode's count of it on
    the card)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.trace import StepCounter
    fn, mod, args, kw = {
        "B1": (kda.decode_attention, kda, [((4, 32, 128), torch.bfloat16),
                                          ((4, 80, 8, 128), torch.bfloat16),
                                          ((4, 80, 8, 128), torch.bfloat16)], {"lse": True}),
        "B3": (kss.ssd_scan, kss, [((2, 128, 24, 64), torch.bfloat16),
                                  ((2, 128, 24), torch.float32),
                                  ((2, 128, 1, 128), torch.bfloat16),
                                  ((2, 128, 1, 128), torch.bfloat16)], {"chunk": 64}),
        "B4": (krg.rglru_scan, krg, [((2, 128, 256), torch.float32),
                                    ((2, 128, 256), torch.float32)], {}),
    }[which]
    plain = {"B1": kda.decode_attention_plain, "B3": kss.ssd_scan_plain,
             "B4": krg.rglru_scan_plain}[which]
    extra = (41,) if which == "B1" else ()
    real = [torch.randn(s, device=cuda).to(d) for s, d in args]
    with FlopCounterMode(display=False) as fc:
        want = plain(*real, *extra, **kw)
    launches = mod.launches
    with FakeTensorMode():
        fake = [torch.empty(s, dtype=d, device="cuda") for s, d in args]
        counter = StepCounter()
        with counter:
            out = fn(*fake, *extra, **kw)
    assert mod.launches == launches
    assert counter.totals.flops == fc.get_total_flops()
    for o, w in zip(out if isinstance(out, tuple) else (out,),
                    want if isinstance(want, tuple) else (want,)):
        assert o.shape == w.shape and o.dtype == w.dtype and o.device.type == "cuda"


def test_nvml_meter_reads_the_cards_counter(cuda):
    """The port's meter over ~1 s of bf16 matmuls: positive joules, an
    average power between the card's idle power (a metered 0.5 s sleep)
    and its enforced limit, and the NVML device it opened is the torch
    device's own (by UUID)."""
    import ctypes
    import subprocess
    import time
    from repro_torch.energy.meter import NvmlMeter
    meter = NvmlMeter(cuda)
    assert meter.uuid == str(torch.cuda.get_device_properties(cuda).uuid).lower()
    buf = ctypes.create_string_buffer(96)
    assert meter.lib.nvmlDeviceGetUUID(meter.handle, buf, len(buf)) == 0
    assert buf.value.decode().lower() == "gpu-" + meter.uuid
    _, idle_s, idle_j = meter.measure(lambda: time.sleep(0.5))
    idle_w = idle_j / idle_s
    a = torch.randn(8192, 8192, device=cuda, dtype=torch.bfloat16)
    c = torch.empty_like(a)

    def busy():
        t_end = time.perf_counter() + 1.0
        while time.perf_counter() < t_end:
            for _ in range(20):
                torch.matmul(a, a, out=c)
            torch.cuda.synchronize()

    _, s, j = meter.measure(busy)
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", f"--id=GPU-{meter.uuid}"],
                           capture_output=True, text=True, timeout=60)
    limit_w = float(limit.stdout.strip())
    assert j > 0 and s > 0.9
    assert idle_w < j / s <= 1.05 * limit_w, (idle_w, j / s, limit_w)


# ---------------------------------------------------------------------------
# The engine's CUDA graphs (serving.engine: one graph per jit key)
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ["llama2-7b-reduced", "granite-moe-3b-a800m-reduced", "mamba2-130m-reduced",
               "recurrentgemma-9b-reduced", "seamless-m4t-large-v2-reduced",
               "internvl2-2b-reduced"]


def _moved(tree, device):
    return {k: _moved(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _graph_batch(cfg, B, S, seed):
    from repro_torch.serving.engine import frontend_inputs
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
            **{k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in frontend_inputs(cfg, B).items()}}


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graphed_steps_equal_eager_ones(cuda, arch):
    """Each family's reduced model: the engine's graphed steps against the
    same steps run eagerly on the card (`graphed = False`): prefill and
    decode logits bit-identical and greedy tokens identical, KV on and off;
    the graphs' replays add to B1's, B3's and B4's counts what the eager
    steps launch, and the warm-ups' launches go to `capture_launches`."""
    cfg = get_config(arch)
    params = _moved(get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                             torch.device("cpu")), cuda)
    batch = _graph_batch(cfg, 2, 13, seed=1)
    runs = {}
    for graphed in (True, False):
        eng = InferenceEngine(cfg, params, kv_cache=True, bucket=16, device=cuda)
        eng.graphed = graphed
        before = (kda.launches, kss.launches, krg.launches)
        runs[graphed] = graph_drive(torch, eng, batch, 6)[:2]
        runs[graphed] += ((kda.launches - before[0], kss.launches - before[1],
                           krg.launches - before[2]),)
        if graphed:
            assert all(s.graph is not None for s in eng.steps.values())
            assert len(eng.steps) == 2 and eng.capture_s > 0 and eng.pool_bytes() > 0
            n = [eng.capture_launches[m.__name__] for m in (kda, kss, krg)]
            assert n == [runs[True][2][0] // 6, runs[True][2][1], runs[True][2][2]]
    (lg, tg, ng), (le, te, ne) = runs[True], runs[False]
    assert ng == ne
    for a, b in zip(lg, le):
        assert torch.equal(a, b)
    for a, b in zip(tg, te):
        assert torch.equal(a, b)
    for kv in (True, False):
        outs = []
        for graphed in (True, False):
            eng = InferenceEngine(cfg, params, kv_cache=kv, bucket=16, device=cuda)
            eng.graphed = graphed
            outs.append(eng.generate(batch, 6)[0])
        np.testing.assert_array_equal(outs[0], outs[1])


def test_graphed_sampling_draws_from_the_registered_generator(cuda):
    """Sampling at temperature > 0 inside the decode graph: the engine's
    generator is registered with the graph, so two graphed engines seeded
    alike draw the same tokens, another seed draws others, and top-k 1
    equals greedy decoding."""
    from repro_torch.serving import Sampler
    cfg = get_config("llama2-7b-reduced")
    params = _moved(get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                             torch.device("cpu")), cuda)
    batch = _graph_batch(cfg, 2, 9, seed=2)

    def sample(seed, **kw):
        eng = InferenceEngine(cfg, params, kv_cache=True, bucket=16, seed=seed,
                              sampler=Sampler(**kw), device=cuda)
        out = eng.generate(batch, 12)[0]
        assert all(s.graph is not None for s in eng.steps.values())
        return out

    a = sample(42, temperature=1.0)
    np.testing.assert_array_equal(a, sample(42, temperature=1.0))
    assert not np.array_equal(a, sample(7, temperature=1.0))
    np.testing.assert_array_equal(sample(3, temperature=1.0, top_k=1), sample(3))


def test_b1_graph_replays_after_a_larger_capture(cuda):
    """Graph 1 captures B1 with a small workspace; graph 2, captured on the
    same stream at a larger shape, replaces the stream's workspace.  Graph
    1 keeps its own (`record_workspaces`): after the freed memory is
    handed to other work and scribbled over, its replay still equals the
    plain version, and so does graph 2's."""
    side = torch.cuda.Stream()
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for seed, S in ((0, 256), (1, 8192)):
        q, k, v = inputs(4, 16, 2, 128, S, torch.bfloat16, seed=seed)
        pos = torch.tensor(S - 1, dtype=torch.int32, device=cuda)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kda.decode_attention(q, k, v, pos)          # warm-up: sizes the workspace
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with kda.record_workspaces() as used, torch.cuda.graph(g, pool=pool, stream=side):
            out = kda.decode_attention(q, k, v, pos)
        graphs.append((g, out, (q, k, v, pos), used))
    (g1, o1, x1, used1), (g2, o2, x2, used2) = graphs
    assert used1[0] is not used2[0]                     # graph 2 grew the workspace
    assert kda._workspaces[(cuda.index or 0, side.cuda_stream)] is used2[0]
    junk = [torch.full((1 << 20,), -7, dtype=torch.int32, device=cuda) for _ in range(64)]
    for g, out, x in ((g1, o1, x1), (g2, o2, x2), (g1, o1, x1)):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        close_b1(out, kda.decode_attention_plain(*x), TOL["bfloat16"])
    del junk


def test_capture_that_meets_a_host_sync_raises(cuda):
    """A step whose body copies a host int to the card (the pattern the
    prefills' `torch.tensor(n, device=...)` had) fails its capture with an
    error, and so does B1 with a Python int position while capturing; no
    eager fallback runs."""
    cfg = get_config("llama2-7b-reduced")
    api = get_api(cfg)
    params = _moved(api.init_params(cfg, torch.Generator().manual_seed(0),
                                    torch.device("cpu")), cuda)
    eng = InferenceEngine(cfg, params, kv_cache=False, bucket=16, device=cuda)
    import types as _types

    def syncing_prefill(cfg_, params_, batch, **kw):
        logits, cache = api.prefill(cfg_, params_, batch, **kw)
        return logits + torch.tensor(0.0, device=logits.device), cache

    eng.api = _types.SimpleNamespace(prefill=syncing_prefill)
    with pytest.raises(RuntimeError):
        eng.generate({"tokens": np.ones((2, 5), np.int32)}, 2)
    assert not any(s.graph is not None for s in eng.steps.values())
    torch.cuda.synchronize()
    q, k, v = inputs(2, 4, 2, 64, 128, torch.float32, seed=3)
    kda.decode_attention(q, k, v, 5)           # the workspace, made eagerly
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="Python int"):
        with torch.cuda.graph(g):
            kda.decode_attention(q, k, v, 5)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The compiled training step (launch.steps.compile_train_step)
# ---------------------------------------------------------------------------

TRAIN_GRAPH_CASES = [       # (arch, config fields), remat on in each
    ("qwen3-1.7b-reduced", {"microbatch": 2}),
    ("granite-moe-3b-a800m-reduced", {"capacity_factor": 0.25}),
    ("deepseek-v3-671b-reduced", {}),
    ("mamba2-130m-reduced", {}),
    ("recurrentgemma-9b-reduced", {}),
    ("seamless-m4t-large-v2-reduced", {}),
    ("internvl2-2b-reduced", {}),
]


def _train_setup(cuda, arch, fields, n=3, B=4, S=32):
    """(cfg, train_step, optimizer, params on the card, n batches on the
    card: tokens, labels and the encdec's frames or the vlm's patches),
    the weights drawn on the CPU from seed 0."""
    from repro_torch.serving.engine import frontend_inputs
    cfg = get_config(arch).replace(remat=True, **fields)
    step_fn, opt = build_train_step(cfg, lr=1e-3)
    params = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                      torch.device("cpu"))
    rng = np.random.default_rng(0)
    batches = [{**{k: rng.integers(1, cfg.vocab_size, (B, S), dtype=np.int32)
                   for k in ("tokens", "labels")},
                **{k: rng.normal(size=v.shape).astype(np.float32)
                   for k, v in frontend_inputs(cfg, B).items()}} for _ in range(n)]
    return cfg, step_fn, opt, _moved(params, cuda), [
        {k: torch.from_numpy(v).to(cuda) for k, v in b.items()} for b in batches]


def _scan_launches_a_step(cfg, B) -> tuple:
    """(B1, B3 forward, B3 backward, B4 forward, B4 backward) launches one
    train step needs, in the order of `graphs.COUNTERS`: each scan layer's
    forward once, again in remat's recompute, and its backward once, per
    microbatch."""
    from repro_torch.models import hybrid
    mbs = B // (cfg.microbatch or B)
    if cfg.family not in ("ssm", "hybrid"):
        return (0, 0, 0, 0, 0)
    layers = cfg.n_layers if cfg.family == "ssm" else hybrid.n_rec_layers(cfg)
    fwd, bwd = (1 + cfg.remat) * layers * mbs, layers * mbs
    return (0, fwd, bwd, 0, 0) if cfg.family == "ssm" else (0, 0, 0, fwd, bwd)


@pytest.fixture
def deterministic():
    """torch.use_deterministic_algorithms(True) over the test: atomics in
    the embedding's and the MoE dispatch's backward (index_put_,
    index_add_) would otherwise sum in a different order each run, eager
    or graphed."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("arch,fields", TRAIN_GRAPH_CASES, ids=[c[0] for c in TRAIN_GRAPH_CASES])
def test_graphed_train_steps_equal_eager_ones(cuda, deterministic, arch, fields):
    """3 steps of the compiled step as CUDA graphs (a warm-up step, then
    two replays of one graph) against the same 3 steps run eagerly on the
    card (`graphed=False`) from the same weights and batches, with
    deterministic algorithms on: losses, params and AdamW state
    bit-identical; every step, replays included, adds to the launch
    counts what the layers need, and the capture recorded exactly that."""
    runs = {}
    for graphed in (True, False):
        cfg, step_fn, opt, params, batches = _train_setup(cuda, arch, fields)
        state = opt.init(params)
        compiled = compile_train_step(step_fn, device=cuda, graphed=graphed)
        losses, counts = [], []
        for b in batches:
            before = [c.launches for c in graphs.COUNTERS]
            loss, params, state = compiled(params, state, b)
            losses.append(loss)
            counts.append(tuple(c.launches - n for c, n in zip(graphs.COUNTERS, before)))
        torch.cuda.synchronize()
        runs[graphed] = (losses, params, state, counts)
        (step,) = compiled.steps.values()
        if graphed:
            assert step.graph is not None and compiled.capture_s > 0
            assert compiled.pool_bytes() > 0
            recorded = [0] * len(graphs.COUNTERS)
            for c, n in step.launches:
                recorded[graphs.COUNTERS.index(c)] = n
            assert tuple(recorded) == _scan_launches_a_step(cfg, 4)
        else:
            assert step.graph is None
    (lg, pg, sg, cg), (le, pe, se, ce) = runs[True], runs[False]
    assert [float(x) for x in lg] == [float(x) for x in le]
    for a, b in ((pg, pe), (sg, se)):
        fa, fb = dict(flatten_tree(a)), dict(flatten_tree(b))
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k
    assert cg == ce == [_scan_launches_a_step(cfg, 4)] * 3


def test_graphed_train_step_refuses_dtensor_params(cuda):
    """DTensor params on CUDA raise NotImplementedError before any work:
    sharded steps run eagerly through build_train_step."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_test_mesh, start_fake_group
    cfg, step_fn, opt, params, batches = _train_setup(cuda, "qwen3-1.7b-reduced", {}, n=1)
    state = opt.init(params)
    started = not dist.is_initialized()
    start_fake_group(1)
    try:
        mesh = make_test_mesh((1,), ("data",), "cuda")
        params["embed"] = distribute_tensor(params["embed"], mesh, [Replicate()])
        compiled = compile_train_step(step_fn, device=cuda)
        with pytest.raises(NotImplementedError, match="DTensor"):
            compiled(params, state, batches[0])
        assert not compiled.steps
    finally:
        if started:
            dist.destroy_process_group()


def test_train_graph_pool_is_released_with_the_step(cuda):
    """Dropping the compiled step frees its graph, and the caching
    allocator then returns the graph's pool to the card."""
    cfg, step_fn, opt, params, batches = _train_setup(cuda, "qwen3-1.7b-reduced", {})
    state = opt.init(params)
    compiled = compile_train_step(step_fn, device=cuda)
    for b in batches:
        loss, params, state = compiled(params, state, b)
    pool = compiled._pool
    assert graphs.pool_bytes(pool) > 0
    ref = weakref.ref(compiled)
    del compiled
    assert ref() is None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert graphs.pool_bytes(pool) == 0
    assert np.isfinite(float(loss))
