"""The arithmetic order of kernel B1's tensor-core path, emulated in numpy.

The CUDA kernel (`csrc/decode_attention.cu`, q in bf16) cannot run here,
so its order of operations is written out in float32 numpy and held to
the plain version at every shape of tests/test_torch_kernels.py and
tests/test_torch_kernels_gpu.py, with bf16 and fp8 e4m3 caches: the valid
keys cut into the kernel's splits (`key_splits`), each split's 64-key
tiles shared by four warps in 16-key slices, one online-softmax stream a
warp (scores in f32, P rounded to bf16 before P V, f32 accumulators), the
warps merged at the block's running max, then the splits' partials merged
in split order.

Tolerances: 2e-2 against the plain version, the bf16 gate of
tests/test_torch_kernels.py (the kernel rounds the unnormalized P where
the plain version rounds the normalized weights); 1e-5 against a float64
oracle with the rounding of P left out, which shows the order itself
loses nothing.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as kda

FLASH_SHAPES = [            # tests/test_kernels.py::TestFlashDecode (B, Hq, Hkv, D, S)
    (2, 8, 2, 128, 512),
    (1, 16, 8, 128, 1024),
    (4, 4, 1, 64, 256),
    (2, 12, 4, 128, 384),
    (1, 71, 71, 64, 256),
]
MODEL_CASES = [             # tests/test_torch_kernels_gpu.py (B, Hq, Hkv, D, S, pos, ring, softcap)
    (2, 4, 2, 32, 80, 3, False, 0.0),
    (2, 4, 2, 32, 80, 79, False, 0.0),
    (2, 4, 2, 32, 64, 20, True, 0.0),
    (2, 4, 2, 32, 64, 70, True, 0.0),
    (2, 8, 1, 64, 96, 40, False, 2.0),
    (1, 16, 2, 128, 130, 129, True, 5.0),
    (4, 32, 32, 128, 80, 57, False, 0.0),
    (1, 64, 8, 128, 4096, 3000, False, 0.0),
]
CASES = ([(*shape, shape[-1] - 1, False, 0.0) for shape in FLASH_SHAPES] + MODEL_CASES)
CACHES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
KEYS_PER_TILE, SLICE, WARPS = 64, 16, 4     # kMmaKeys, a warp's keys, kWarps
MIN_KEYS = 128                              # kMinKeys


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port tests do: with
    several pytest-xdist workers its default threads oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_round(x):
    """float32 -> the nearest bfloat16 (ties to even), kept in float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def key_splits(n_valid, n_splits):
    """The kernel's cut of the valid keys [0, n_valid) into splits
    (`split_plan`): at most n_splits splits of at least MIN_KEYS keys where
    there are enough, each a multiple of 16 keys but the last.  Returns
    [(first key, end key)] in split order."""
    n = max(1, min(n_splits, math.ceil(n_valid / MIN_KEYS)))
    chunk = math.ceil(math.ceil(n_valid / n) / 16) * 16
    return [(kb, min(kb + chunk, n_valid)) for kb in range(0, n_valid, chunk)]


def _merge(states):
    """Online-softmax states (m, l, o) merged at their common max, in order."""
    M = np.max([m for m, _, _ in states], axis=0)
    L = np.zeros_like(M)
    O = np.zeros_like(states[0][2])
    for m, l, o in states:
        w = np.where(m == -np.inf, np.float32(0), np.exp(m - M)).astype(np.float32)
        L = (L + l * w).astype(np.float32)
        O = (O + o * w[:, None]).astype(np.float32)
    return M, L, O


def kernel_emulated(q, k, v, pos, softcap=0.0, n_splits=1, rnd=bf16_round):
    """The bf16 kernel's arithmetic in numpy float32.  q [B,Hq,D], k and v
    [B,S,Hkv,D] hold bf16 (or fp8) values in float32.  With rnd = identity
    the rounding of P and of the output is left out."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = np.float32(1.0 / math.sqrt(D))
    uniform = pos < 0
    n_valid = S if uniform else min(pos + 1, S)
    out = np.zeros((B, Hq, D), np.float32)
    for b in range(B):
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G]
            parts = []
            for kb, ke in key_splits(n_valid, n_splits):
                warps = []
                for w in range(WARPS):
                    m = np.full(G, -np.inf, np.float32)
                    l = np.zeros(G, np.float32)
                    o = np.zeros((G, D), np.float32)
                    for j0 in range(kb + SLICE * w, ke, KEYS_PER_TILE):
                        j1 = min(j0 + SLICE, ke)
                        s = (qg @ k[b, j0:j1, h].T * scale).astype(np.float32)
                        if softcap:
                            s = (np.tanh(s / np.float32(softcap)) * np.float32(softcap)
                                 ).astype(np.float32)
                        if uniform:
                            s = np.zeros_like(s)
                        m_new = np.maximum(m, s.max(-1))
                        alpha = np.where(m == -np.inf, np.float32(0), np.exp(m - m_new))
                        p = np.exp(s - m_new[:, None]).astype(np.float32)
                        l = (l * alpha + p.sum(-1)).astype(np.float32)
                        o = (o * alpha[:, None] + rnd(p) @ v[b, j0:j1, h]).astype(np.float32)
                        m = m_new
                    warps.append((m, l, o))
                parts.append(_merge(warps))
            _, L, O = _merge(parts)
            out[b, h * G:(h + 1) * G] = O / L[:, None]
    return rnd(out)


def oracle(q, k, v, pos, softcap=0.0):
    """float64: the model path's decode attention over the valid prefix."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    s = np.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, Hq // Hkv, D), k) / np.sqrt(D)
    if softcap:
        s = np.tanh(s / softcap) * softcap
    n_valid = S if pos < 0 else min(pos + 1, S)
    s = np.where(np.arange(S) < n_valid, np.zeros_like(s) if pos < 0 else s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhgk,bkhd->bhgd", w, v).reshape(B, Hq, D)


def inputs(B, Hq, Hkv, D, S, cache, seed=0):
    """q as bf16 and k, v as the cache's type (torch), and their values in
    float32 numpy."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(B, Hq, D)).astype(np.float32)).bfloat16()
    k, v = (torch.as_tensor(rng.normal(size=(B, S, Hkv, D)).astype(np.float32)).to(cache)
            for _ in range(2))
    return (q, k, v), tuple(t.float().numpy() for t in (q, k, v))


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


class TestKernelOrder:
    @pytest.mark.parametrize("cache", list(CACHES))
    @pytest.mark.parametrize("case", CASES)
    def test_rounded_emulation_within_the_bf16_gate_of_plain(self, case, cache):
        """At the split count the wrapper plans for the card, and with 8
        splits where S allows them, so the merge is exercised."""
        B, Hq, Hkv, D, S, pos, ring, softcap = case
        tensors, arrays = inputs(B, Hq, Hkv, D, S, CACHES[cache], seed=S)
        plain = kda.decode_attention_plain(*tensors, torch.tensor(pos, dtype=torch.int32),
                                           ring=ring, softcap=softcap).float().numpy()
        planned = kda.plan(B, Hq, Hkv, S, D, torch.bfloat16, CACHES[cache])
        for n_splits in (planned, 8):
            _close(kernel_emulated(*arrays, pos, softcap, n_splits), plain, 2e-2)

    @pytest.mark.parametrize("case", CASES)
    def test_unrounded_emulation_matches_the_oracle(self, case):
        B, Hq, Hkv, D, S, pos, ring, softcap = case
        _, arrays = inputs(B, Hq, Hkv, D, S, torch.bfloat16, seed=S)
        for n_splits in (1, 8):
            ours = kernel_emulated(*arrays, pos, softcap, n_splits, rnd=lambda x: x)
            _close(ours, oracle(*arrays, pos, softcap), 1e-5)

    def test_no_valid_key_weighs_every_key_alike(self):
        """pos < 0: the reference's softmax over all-masked scores is
        uniform over all S keys; the kernel takes every key with score 0."""
        (q, k, v), arrays = inputs(1, 4, 2, 32, 300, torch.bfloat16)
        plain = kda.decode_attention_plain(q, k, v, torch.tensor(-1, dtype=torch.int32))
        _close(kernel_emulated(*arrays, -1, n_splits=2), plain.float().numpy(), 2e-2)
        _close(kernel_emulated(*arrays, -1, rnd=lambda x: x), oracle(*arrays, -1), 1e-5)

    def test_bf16_rounding_helper(self):
        x = np.array([1.0, 1.00390625, 1.01171875, -3.3, 1e-3], np.float32)
        np.testing.assert_array_equal(
            bf16_round(x), torch.as_tensor(x).bfloat16().float().numpy())


class TestSplits:
    @pytest.mark.parametrize("n_valid", [1, 15, 16, 17, 64, 80, 127, 129, 257, 2048, 3001])
    @pytest.mark.parametrize("n_splits", [1, 2, 7, 16, 32])
    def test_key_splits_cover_the_prefix(self, n_valid, n_splits):
        splits = key_splits(n_valid, n_splits)
        assert splits[0][0] == 0 and splits[-1][1] == n_valid
        assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
        assert 1 <= len(splits) <= n_splits
        assert all((ke - kb) % 16 == 0 for kb, ke in splits[:-1])
        assert all(ke > kb for kb, ke in splits)
        if len(splits) > 1:      # a split only where each gets its share of keys
            assert n_valid > MIN_KEYS

    def test_plan_at_the_main_path_shapes(self):
        bf, f8 = torch.bfloat16, torch.float8_e4m3fn
        # llama2-7b serve: B*Hkv = 128 blocks and 80 keys, no split
        assert kda.plan(4, 32, 32, 80, 128, bf, bf) == 1
        # recurrentgemma-9b ring: 4 blocks, so S splits, as far as the merge repays
        assert kda.plan(4, 16, 1, 2048, 256, bf, bf) == 16
        assert kda.plan(4, 16, 1, 2048, 256, bf, f8) == 11
        # llama2-70b GQA: 32 blocks, two a SM at D = 128
        assert kda.plan(4, 64, 8, 4096, 128, bf, bf) == 8
        # f32 holds 8 heads a block: recurrentgemma's 16 take two
        assert kda.plan(4, 16, 1, 2048, 256, torch.float32, torch.float32) == 16
        for args in ((1, 1, 1, 1, 32, bf, bf), (8, 64, 64, 100000, 64, bf, f8)):
            assert 1 <= kda.plan(*args) <= 256


class CudaStub:
    """Stands for a CUDA tensor where there is no card: the attributes the
    wrapper reads before it launches."""

    requires_grad = False

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def numel(self):
        return int(np.prod(self.shape))

    def data_ptr(self):
        return 0


class TestWrapper:
    @pytest.fixture
    def no_nvcc(self, monkeypatch):
        """The plain version fails if called; the build finds no nvcc."""
        def fell_back(*args, **kw):
            raise AssertionError("the wrapper fell back to the plain version")

        def no_nvcc(name):
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(kda, "decode_attention_plain", fell_back)
        monkeypatch.setattr(kda._build, "load", no_nvcc)
        kda._kernel.cache_clear()
        yield
        kda._kernel.cache_clear()

    @pytest.mark.parametrize("q,cache", [("bfloat16", "bfloat16"), ("bfloat16", "float8_e4m3fn"),
                                         ("float32", "float32"), ("float32", "float8_e4m3fn")])
    def test_pairs_it_takes_go_to_the_kernel(self, no_nvcc, q, cache):
        qd, cd = getattr(torch, q), getattr(torch, cache)
        with pytest.raises(RuntimeError, match="nvcc"):
            kda.decode_attention(CudaStub((2, 16, 256), qd), CudaStub((2, 64, 1, 256), cd),
                                 CudaStub((2, 64, 1, 256), cd), CudaStub((), torch.int32))

    @pytest.mark.parametrize("q,k,v", [
        ("bfloat16", "float8_e5m2", "float8_e5m2"), ("bfloat16", "float16", "float16"),
        ("float16", "float16", "float16"), ("float32", "bfloat16", "bfloat16"),
        ("bfloat16", "float32", "float32"), ("bfloat16", "bfloat16", "float8_e4m3fn")])
    def test_other_types_raise_before_any_build(self, no_nvcc, q, k, v):
        before = kda.launches
        with pytest.raises(TypeError, match="float8_e4m3fn"):
            kda.decode_attention(CudaStub((2, 16, 128), getattr(torch, q)),
                                 CudaStub((2, 64, 1, 128), getattr(torch, k)),
                                 CudaStub((2, 64, 1, 128), getattr(torch, v)), 0)
        assert kda.launches == before

    def test_cpu_fp8_caches_run_the_plain_version(self):
        (q, k, v), _ = inputs(2, 8, 2, 64, 40, torch.float8_e4m3fn)
        before = kda.launches
        p = torch.tensor(30, dtype=torch.int32)
        assert torch.equal(kda.decode_attention(q, k, v, p),
                           kda.decode_attention_plain(q, k, v, p))
        assert kda.launches == before

    def test_workspace_is_kept_per_stream_and_grown(self, monkeypatch):
        monkeypatch.setattr(kda, "_workspaces", {})
        dev = torch.device("cpu")
        part, counters = kda._workspace(dev, 7, 100, 4)
        assert part.numel() == 100 and counters.numel() == 4 and not counters.any()
        assert kda._workspace(dev, 7, 50, 2)[0] is part          # reused
        other = kda._workspace(dev, 8, 50, 2)                      # another stream
        assert other[0] is not part and other[1] is not counters
        grown = kda._workspace(dev, 7, 60, 9)
        assert grown[0].numel() == 100 and grown[1].numel() == 9 and not grown[1].any()
