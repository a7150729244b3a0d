"""Kernels B3 (SSD chunk scan) and B4 (RG-LRU scan) of the PyTorch port
against the JAX package.

On the CPU the port's plain versions are held against the Pallas kernels
`ssd_scan` and `rglru_scan_pallas` (run with interpret=True, as
tests/test_kernels.py runs them), their oracles in `repro.kernels.ref`, and
the model-side functions they stand for (`repro.models.ssm.ssd_chunked`,
`repro.models.hybrid.rglru_scan`).  The port takes what the Pallas kernels
do not: any S and W, and an initial state; those cases are held against
the oracles, which are defined for them.  tests/test_torch_kernels_gpu.py
runs the CUDA kernels on a card.

Tolerances and input scales are tests/test_kernels.py's: TestSSDScan
(atol 2e-4, rtol 1e-3) and TestRGLRU (1e-4), f32 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import hybrid as jhybrid
from repro.models import ssm as jssm
from repro_torch.kernels import rglru_scan as krg
from repro_torch.kernels import ssd_scan as kss

SSD_SHAPES = [              # tests/test_kernels.py::TestSSDScan (b, s, h, p, n, chunk)
    (2, 256, 4, 64, 32, 64),
    (1, 128, 2, 32, 16, 32),
    (2, 64, 3, 16, 128, 64),
    (1, 512, 1, 64, 128, 128),
]
RGLRU_SHAPES = [            # tests/test_kernels.py::TestRGLRU (B, S, W, block_s, block_w)
    (2, 256, 128, 64, 64),
    (1, 128, 512, 128, 256),
    (3, 64, 64, 32, 64),
    (1, 1024, 256, 256, 128),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here.  At these tiny shapes its
    intra-op threads only add overhead, and with several pytest-xdist
    workers on one machine they oversubscribe the cores: six concurrent
    CPU `serve()` runs took over 15 minutes with the default threads and
    about 10 s each with one.  One thread also avoids a fault seen in the
    first multi-threaded float32 `torch.exp` of a process (values ~1e-4
    off, relative, in about one process in twenty)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's Pallas kernels and oracles.  `repro.kernels`
    imports `jax.experimental.enable_x64`, which newer jax moved to
    `jax.enable_x64`; alias it for this module only."""
    import jax.experimental
    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.kernels import ref
    from repro.kernels.rglru_scan import rglru_scan_pallas
    from repro.kernels.ssd_scan import ssd_scan
    yield ssd_scan, rglru_scan_pallas, ref
    if added:
        del jax.experimental.enable_x64


def ssd_inputs(b, s, h, p, n, g=None, seed=0):
    """TestSSDScan's scales; B and C per group (g defaults to h)."""
    rng = np.random.default_rng(seed)
    g = h if g is None else g
    return ((rng.normal(size=(b, s, h, p)) * 0.5).astype(np.float32),
            -np.abs(rng.normal(size=(b, s, h)) * 0.3).astype(np.float32),
            (rng.normal(size=(b, s, g, n)) * 0.5).astype(np.float32),
            (rng.normal(size=(b, s, g, n)) * 0.5).astype(np.float32),
            (rng.normal(size=(b, h, p, n)) * 0.5).astype(np.float32))


def to_heads(t, h):
    """[b,s,g,n] -> [b,s,h,n]: the reference's group broadcast."""
    return np.repeat(t, h // t.shape[2], axis=2)


def port_ssd(xdt, dA, B, C, h0=None, chunk=256, fn=kss.ssd_scan):
    y, fin = fn(*(torch.as_tensor(a) for a in (xdt, dA, B, C)), chunk=chunk,
                h0=None if h0 is None else torch.as_tensor(h0))
    return y.numpy(), fin.numpy()


def close(a, b, atol=2e-4, rtol=1e-3):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=atol, rtol=rtol)


class TestSSDPlain:
    @pytest.mark.parametrize("shape", SSD_SHAPES)
    def test_matches_pallas_kernel_and_oracle(self, pallas, shape):
        ssd_scan, _, ref = pallas
        b, s, h, p, n, chunk = shape
        xdt, dA, B, C, _ = ssd_inputs(b, s, h, p, n)
        y, fin = port_ssd(xdt, dA, B, C, chunk=chunk)
        jy, jfin = ssd_scan(*map(jnp.asarray, (xdt, dA, B, C)), chunk=chunk, interpret=True)
        close(y, jy)
        close(fin, jfin)
        ry, rfin = ref.ssd_scan_ref(*map(jnp.asarray, (xdt, dA, B, C)))
        close(y, ry)
        close(fin, rfin)

    @pytest.mark.parametrize("chunk", [16, 32])
    def test_matches_model_ssd_chunked(self, chunk):
        """Where S is a multiple of the chunk the result is the reference
        model's, groups broadcast on the JAX side."""
        xdt, dA, B, C, h0 = ssd_inputs(2, 64, 4, 16, 16, g=2, seed=chunk)
        for init in (None, h0):
            y, fin = port_ssd(xdt, dA, B, C, h0=init, chunk=chunk)
            jy, jfin = jssm.ssd_chunked(
                jnp.asarray(xdt), jnp.asarray(dA), jnp.asarray(to_heads(B, 4)),
                jnp.asarray(to_heads(C, 4)), chunk,
                None if init is None else jnp.asarray(init))
            close(y, jy, 1e-5, 1e-5)
            close(fin, jfin, 1e-5, 1e-5)

    @pytest.mark.parametrize("s,chunk", [(1, 16), (7, 16), (37, 16), (100, 32), (300, 256)])
    def test_ragged_lengths_and_initial_state(self, pallas, s, chunk):
        """Any S (the last chunk short) and h0, against the sequential
        oracle, which is defined for both."""
        _, _, ref = pallas
        xdt, dA, B, C, h0 = ssd_inputs(2, s, 4, 16, 32, g=1, seed=s)
        for init in (None, h0):
            y, fin = port_ssd(xdt, dA, B, C, h0=init, chunk=chunk)
            ry, rfin = ref.ssd_scan_ref(
                jnp.asarray(xdt), jnp.asarray(dA), jnp.asarray(to_heads(B, 4)),
                jnp.asarray(to_heads(C, 4)), None if init is None else jnp.asarray(init))
            close(y, ry)
            close(fin, rfin)

    def test_chunk_length_changes_only_rounding(self):
        """The CUDA kernels walk chunks of their own (`kss.CHUNK`: 32 steps
        in f32, 64 in bf16) whatever `chunk` says."""
        xdt, dA, B, C, h0 = ssd_inputs(1, 96, 2, 16, 16, g=1, seed=5)
        b = port_ssd(xdt, dA, B, C, h0=h0, chunk=96, fn=kss.ssd_scan_plain)
        for chunk in sorted(set(kss.CHUNK.values())):
            a = port_ssd(xdt, dA, B, C, h0=h0, chunk=chunk, fn=kss.ssd_scan_plain)
            for x, y in zip(a, b):
                close(x, y, 1e-5, 1e-5)

    def test_bfloat16_keeps_the_reference_casts(self):
        xdt, dA, B, C, _ = ssd_inputs(1, 32, 2, 16, 16, g=1, seed=6)
        bf = [torch.as_tensor(a).bfloat16() for a in (xdt, B, C)]
        y, fin = kss.ssd_scan(bf[0], torch.as_tensor(dA), bf[1], bf[2], chunk=16)
        jy, jfin = jssm.ssd_chunked(
            jnp.asarray(np.asarray(bf[0].float()), jnp.bfloat16), jnp.asarray(dA),
            jnp.asarray(to_heads(np.asarray(bf[1].float()), 2), jnp.bfloat16),
            jnp.asarray(to_heads(np.asarray(bf[2].float()), 2), jnp.bfloat16), 16)
        assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
        # bf16 rounds at the same places; the order of sums inside differs
        close(y.float().numpy(), np.asarray(jy, np.float32), 2e-2, 2e-2)
        close(fin.numpy(), jfin, 2e-2, 2e-2)


def bf16_round(x):
    """float32 -> the nearest bfloat16 (ties to even), kept in float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def ssd_bf16_emulated(xdt, dA, B, C, h0=None, rnd=bf16_round):
    """The bf16 CUDA kernel's arithmetic in numpy float32: 64-step chunks,
    the ragged last chunk padded with zeros (dA = 0), the decay mask on
    C B^T, and bf16 rounding (`rnd`) of the masked scores, of the state
    entering a chunk and of the decay-weighted x of the state update.
    With rnd = identity it is the exact chunked form in f32."""
    Q = 64
    b, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    B, C = to_heads(B, h), to_heads(C, h)
    st = np.zeros((b, h, p, n), np.float32) if h0 is None else h0.astype(np.float32)
    y = np.zeros((b, s, h, p), np.float32)
    causal = np.tril(np.ones((Q, Q), bool))
    for t0 in range(0, s, Q):
        ln = min(Q, s - t0)
        x_c, b_c, c_c = (np.zeros((b, Q, h, d), np.float32) for d in (p, n, n))
        da = np.zeros((b, Q, h), np.float32)
        x_c[:, :ln], b_c[:, :ln], c_c[:, :ln] = (xdt[:, t0:t0 + ln], B[:, t0:t0 + ln],
                                                 C[:, t0:t0 + ln])
        da[:, :ln] = dA[:, t0:t0 + ln]
        cs = np.cumsum(da, axis=1, dtype=np.float32)                     # [b,Q,h]
        G = np.einsum("bthn,bjhn->bhtj", c_c, b_c)
        seg = cs.transpose(0, 2, 1)[..., :, None] - cs.transpose(0, 2, 1)[..., None, :]
        G = rnd(np.where(causal, G * np.exp(np.minimum(seg, 0)), 0).astype(np.float32))
        y_c = (np.einsum("bhtj,bjhp->bthp", G, x_c)
               + np.exp(cs)[..., None] * np.einsum("bthn,bhpn->bthp", c_c, rnd(st)))
        y[:, t0:t0 + ln] = rnd(y_c[:, :ln].astype(np.float32))
        xd = rnd((x_c * np.exp(cs[:, -1:] - cs)[..., None]).astype(np.float32))
        st = (np.exp(cs[:, -1])[..., None, None] * st
              + np.einsum("bthp,bthn->bhpn", xd, b_c)).astype(np.float32)
    return y, st


SSD_EDGE_CASES = [          # (b, s, h, p, g, n): around the 64-step chunk
    (2, 1, 4, 16, 2, 16),
    (1, 63, 4, 32, 2, 64),
    (2, 64, 2, 16, 1, 128),
    (1, 65, 4, 16, 2, 256),
    (2, 129, 4, 32, 2, 64),
]


class TestSSDKernelOrder:
    """The bf16 CUDA kernel's chunking and rounding points, emulated."""

    @pytest.mark.parametrize("case", SSD_EDGE_CASES)
    def test_rounded_emulation_within_the_bf16_gate_of_plain(self, case):
        b, s, h, p, g, n = case
        xdt, dA, B, C, h0 = (bf16_round(t) if i in (0, 2, 3) else t
                             for i, t in enumerate(ssd_inputs(b, s, h, p, n, g=g, seed=s)))
        for init in (None, h0):
            y, fin = ssd_bf16_emulated(xdt, dA, B, C, init)
            bf = [torch.as_tensor(t).bfloat16() for t in (xdt, B, C)]
            y_p, fin_p = kss.ssd_scan_plain(bf[0], torch.as_tensor(dA), bf[1], bf[2],
                                            chunk=256,
                                            h0=None if init is None else torch.as_tensor(init))
            for ours, plain in ((y, y_p.float().numpy()), (fin, fin_p.numpy())):
                assert np.abs(ours - plain).max() <= 2e-2 * np.abs(plain).max()

    @pytest.mark.parametrize("case", SSD_EDGE_CASES)
    def test_unrounded_emulation_matches_the_oracle(self, pallas, case):
        """Without the bf16 roundings the kernel's chunking is the exact
        recurrence: held to the sequential oracle at the f32 gate, which
        an off-by-one chunk edge or carry would miss."""
        _, _, ref = pallas
        b, s, h, p, g, n = case
        xdt, dA, B, C, h0 = ssd_inputs(b, s, h, p, n, g=g, seed=s)
        for init in (None, h0):
            y, fin = ssd_bf16_emulated(xdt, dA, B, C, init, rnd=lambda t: t)
            ry, rfin = ref.ssd_scan_ref(
                jnp.asarray(xdt), jnp.asarray(dA), jnp.asarray(to_heads(B, h)),
                jnp.asarray(to_heads(C, h)), None if init is None else jnp.asarray(init))
            close(y, ry)
            close(fin, rfin)

    def test_bf16_rounding_helper(self):
        x = np.array([1.0, 1.00390625, 1.005859375, -3.0e-3, 65504.0], np.float32)
        np.testing.assert_array_equal(
            bf16_round(x), torch.as_tensor(x).bfloat16().float().numpy())


def rglru_inputs(B, S, W, seed=0):
    """TestRGLRU's scales."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.7, 0.999, (B, S, W)).astype(np.float32),
            (rng.normal(size=(B, S, W)) * 0.1).astype(np.float32),
            rng.normal(size=(B, W)).astype(np.float32))


def port_rglru(a, b, h0=None, fn=krg.rglru_scan):
    h, last = fn(torch.as_tensor(a), torch.as_tensor(b),
                 None if h0 is None else torch.as_tensor(h0))
    return h.numpy(), last.numpy()


class TestRGLRUPlain:
    @pytest.mark.parametrize("shape", RGLRU_SHAPES)
    def test_matches_pallas_kernel_and_oracle(self, pallas, shape):
        _, rglru_scan_pallas, ref = pallas
        B, S, W, bs, bw = shape
        a, b, _ = rglru_inputs(B, S, W)
        h, last = port_rglru(a, b)
        jh = rglru_scan_pallas(jnp.asarray(a), jnp.asarray(b), block_s=bs, block_w=bw,
                               interpret=True)
        close(h, jh, 1e-4, 1e-4)
        close(h, ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)), 1e-4, 1e-4)
        np.testing.assert_array_equal(last, h[:, -1])

    @pytest.mark.parametrize("S,W", [(1, 4096), (37, 100), (300, 130)])
    def test_ragged_shapes_and_initial_state(self, pallas, S, W):
        _, _, ref = pallas
        a, b, h0 = rglru_inputs(2, S, W, seed=S)
        for init in (None, h0):
            h, last = port_rglru(a, b, init)
            expect = ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                        None if init is None else jnp.asarray(init))
            close(h, expect, 1e-4, 1e-4)
            close(last, np.asarray(expect)[:, -1], 1e-4, 1e-4)

    def test_matches_model_rglru_scan(self):
        """The model's scan after `_lru_coeffs`, h0 folded in as the
        reference folds it."""
        from repro_torch.models import hybrid
        rng = np.random.default_rng(1)
        W = 64
        pl = {"w_a": rng.normal(size=(W, W)) * 0.05, "b_a": np.zeros(W),
              "w_i": rng.normal(size=(W, W)) * 0.05, "b_i": np.zeros(W),
              "lam": rng.normal(size=W) + 2.0}
        pl = {k: v.astype(np.float32) for k, v in pl.items()}
        u = rng.normal(size=(2, 37, W)).astype(np.float32)
        h0 = rng.normal(size=(2, W)).astype(np.float32)
        for init in (None, h0):
            ours = hybrid.rglru_scan({k: torch.as_tensor(v) for k, v in pl.items()},
                                     torch.as_tensor(u),
                                     None if init is None else torch.as_tensor(init))
            ref = jhybrid.rglru_scan({k: jnp.asarray(v) for k, v in pl.items()},
                                     jnp.asarray(u), None if init is None else jnp.asarray(init))
            for x, y in zip(ours, ref):
                close(x.numpy(), y, 1e-5, 1e-5)


def segmented_scan_emulated(a, b, h0=None, aligned=True):
    """The B4 CUDA kernel's order in numpy float32, with the split that
    `plan` picks: tiles of nseg * seg_len steps; per tile each segment's
    affine map (A, Bc) composed step by step, an exclusive walk of the maps
    from the tile's carry-in, and the segment replayed with its carry."""
    Bsz, S, W = a.shape
    _, nseg, seg_len = krg.plan(S, W, aligned)
    carry = np.zeros((Bsz, W), np.float32) if h0 is None else h0.astype(np.float32)
    h = np.zeros_like(a)
    for t0 in range(0, S, nseg * seg_len):
        maps, starts = [], []
        for sg in range(nseg):
            ts = t0 + sg * seg_len
            A, Bc = np.ones((Bsz, W), np.float32), np.zeros((Bsz, W), np.float32)
            for t in range(ts, min(ts + seg_len, S)):
                Bc = a[:, t] * Bc + b[:, t]
                A = a[:, t] * A
            maps.append((A, Bc))
        hin = carry
        for A, Bc in maps:
            starts.append(hin)
            hin = A * hin + Bc
        carry = hin
        for sg in range(nseg):
            ts, hv = t0 + sg * seg_len, starts[sg]
            for t in range(ts, min(ts + seg_len, S)):
                hv = a[:, t] * hv + b[:, t]
                h[:, t] = hv
    return h, carry


class TestRGLRUKernelOrder:
    """The B4 CUDA kernel's segmented scan, emulated with the wrapper's split."""

    @pytest.mark.parametrize("S,W,aligned", [(1, 4096, True), (37, 64, True),
                                             (128, 256, True), (48, 128, True),
                                             (300, 36, True), (4100, 8, True),
                                             (300, 37, True), (100, 64, False)])
    def test_emulation_matches_plain(self, S, W, aligned):
        a, b, h0 = rglru_inputs(2, S, W, seed=S)
        for init in (None, h0):
            h, last = segmented_scan_emulated(a, b, init, aligned)
            h_p, last_p = port_rglru(a, b, init, fn=krg.rglru_scan_plain)
            close(h, h_p, 1e-4, 1e-4)
            close(last, last_p, 1e-4, 1e-4)

    def test_plan(self):
        """Serve prefills (S <= 256 at W = 4096) are one tile of float4
        threads, every load in flight at once; longer sequences take tiles
        of 256 steps; a width off the float4 grid or unaligned tensors take
        one channel a thread."""
        for S in (1, 8, 37, 48, 128, 256):
            vec, nseg, seg_len = krg.plan(S, 4096)
            assert vec == 4 and nseg * seg_len >= S and seg_len <= krg.SEG_LEN
            assert nseg * krg.ROW_CHANNELS // vec <= krg.MAX_THREADS
        assert krg.plan(128, 4096) == (4, 16, 8)
        assert krg.plan(48, 4096) == (4, 6, 8)
        assert krg.plan(4100, 4096) == (4, 32, 8)
        assert krg.plan(300, 4097)[0] == 1 and krg.plan(300, 4096, aligned=False)[0] == 1
        vec, nseg, seg_len = krg.plan(300, 4097)
        assert nseg * krg.ROW_CHANNELS // vec <= krg.MAX_THREADS


class CudaStub:
    """Stands for a CUDA tensor where there is no card: the attributes the
    wrappers read before they launch."""

    requires_grad = False

    def __init__(self, shape, dtype=torch.float32):
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


def _no_fallback(monkeypatch, module, plain_name):
    """Make the plain version fail if called and the build find no nvcc."""
    def fell_back(*args, **kw):
        raise AssertionError("the wrapper fell back to the plain version")

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(module, plain_name, fell_back)
    monkeypatch.setattr(module._build, "load", no_nvcc)
    module._kernel.cache_clear()


class TestWrappers:
    def test_cpu_tensors_run_the_plain_versions(self):
        xdt, dA, B, C, h0 = ssd_inputs(2, 40, 4, 16, 16, g=2)
        before = kss.launches
        a = port_ssd(xdt, dA, B, C, h0=h0, chunk=16)
        b = port_ssd(xdt, dA, B, C, h0=h0, chunk=16, fn=kss.ssd_scan_plain)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert kss.launches == before
        ra, rb, rh0 = rglru_inputs(2, 9, 32)
        before = krg.launches
        for x, y in zip(port_rglru(ra, rb, rh0), port_rglru(ra, rb, rh0, fn=krg.rglru_scan_plain)):
            np.testing.assert_array_equal(x, y)
        assert krg.launches == before

    def test_cuda_tensors_launch_or_raise(self, monkeypatch):
        """On a CUDA tensor each wrapper goes to its kernel: with no nvcc the
        error surfaces, and the plain version is never called."""
        from repro_torch.kernels import decode_attention as kda
        _no_fallback(monkeypatch, kss, "ssd_scan_plain")
        with pytest.raises(RuntimeError, match="nvcc"):
            kss.ssd_scan(CudaStub((2, 8, 4, 16)), CudaStub((2, 8, 4)), CudaStub((2, 8, 1, 16)),
                         CudaStub((2, 8, 1, 16)), chunk=8, h0=CudaStub((2, 4, 16, 16)))
        _no_fallback(monkeypatch, krg, "rglru_scan_plain")
        with pytest.raises(RuntimeError, match="nvcc"):
            krg.rglru_scan(CudaStub((2, 8, 64)), CudaStub((2, 8, 64)), CudaStub((2, 64)))
        _no_fallback(monkeypatch, kda, "decode_attention_plain")
        with pytest.raises(RuntimeError, match="nvcc"):
            kda.decode_attention(CudaStub((2, 16, 256)), CudaStub((2, 64, 1, 256)),
                                 CudaStub((2, 64, 1, 256)), CudaStub((), torch.int32), ring=True)

    def test_cuda_tensors_that_need_a_gradient_raise(self, monkeypatch):
        """B1 has no backward: on a CUDA input that needs a gradient its
        wrapper raises, naming it, before anything is built; under no_grad
        the same call goes on to the build.  B3 and B4 have backward
        kernels: such an input goes through their autograd Function on to
        the build (here: no nvcc), never to the plain version."""
        from repro_torch.kernels import decode_attention as kda

        class NeedsGrad(CudaStub):
            requires_grad = True

        calls = {
            "B3": lambda T: kss.ssd_scan(T((2, 8, 4, 16)), CudaStub((2, 8, 4)),
                                         CudaStub((2, 8, 1, 16)), CudaStub((2, 8, 1, 16)),
                                         chunk=8),
            "B4": lambda T: krg.rglru_scan(CudaStub((2, 8, 64)), T((2, 8, 64))),
            "B1": lambda T: kda.decode_attention(T((2, 16, 256)), CudaStub((2, 64, 1, 256)),
                                                 CudaStub((2, 64, 1, 256)),
                                                 CudaStub((), torch.int32)),
        }
        for mod, plain in ((kss, "ssd_scan_plain"), (krg, "rglru_scan_plain"),
                           (kda, "decode_attention_plain")):
            _no_fallback(monkeypatch, mod, plain)
        with pytest.raises(RuntimeError, match="kernel B1 has no backward"):
            calls["B1"](NeedsGrad)
        with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc"):
            calls["B1"](NeedsGrad)
        entered = []
        for kernel, fn in (("B3", kss._SSDScan), ("B4", krg._RGLRUScan)):
            def spy(ctx, *args, kernel=kernel, forward=fn.forward):
                entered.append(kernel)
                return forward(ctx, *args)
            monkeypatch.setattr(fn, "forward", staticmethod(spy))
            with pytest.raises(RuntimeError, match="nvcc"):
                calls[kernel](NeedsGrad)
            with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc"):
                calls[kernel](NeedsGrad)
        assert entered == ["B3", "B4"]

    def test_bf16_state_sizes_off_the_mma_depth_raise(self, monkeypatch):
        """The bf16 kernel steps through the state in 16s: a bf16 call with
        n % 16 != 0 (or n > 256) raises before anything is built or launched."""
        _no_fallback(monkeypatch, kss, "ssd_scan_plain")
        before = kss.launches
        bf = torch.bfloat16
        for n in (24, 8, 272):
            with pytest.raises(ValueError, match="multiples of 16|states up to"):
                kss.ssd_scan(CudaStub((2, 8, 4, 16), bf), CudaStub((2, 8, 4)),
                             CudaStub((2, 8, 1, n), bf), CudaStub((2, 8, 1, n), bf), chunk=8)
        with pytest.raises(RuntimeError, match="nvcc"):    # f32 takes n = 24
            kss.ssd_scan(CudaStub((2, 8, 4, 16)), CudaStub((2, 8, 4)),
                         CudaStub((2, 8, 1, 24)), CudaStub((2, 8, 1, 24)), chunk=8)
        assert kss.launches == before

    def test_bf16_unaligned_inputs_raise(self, monkeypatch):
        """The bf16 kernel copies 16-byte pieces; dA, read a float at a
        time, and the f32 kernel take any alignment."""
        _no_fallback(monkeypatch, kss, "ssd_scan_plain")

        class Unaligned(CudaStub):
            def data_ptr(self):
                return 8

        bf = torch.bfloat16
        args = [CudaStub((2, 8, 4, 16), bf), CudaStub((2, 8, 4)),
                CudaStub((2, 8, 1, 16), bf), CudaStub((2, 8, 1, 16), bf)]
        for i in (0, 2, 3):
            bad = list(args)
            bad[i] = Unaligned(args[i].shape, bf)
            with pytest.raises(ValueError, match="16-byte boundary"):
                kss.ssd_scan(*bad, chunk=8)
        with pytest.raises(RuntimeError, match="nvcc"):
            kss.ssd_scan(args[0], Unaligned((2, 8, 4)), args[2], args[3], chunk=8)
        with pytest.raises(RuntimeError, match="nvcc"):
            kss.ssd_scan(Unaligned((2, 8, 4, 16)), CudaStub((2, 8, 4)),
                         Unaligned((2, 8, 1, 16)), Unaligned((2, 8, 1, 16)), chunk=8)

    def test_rejects_mixed_and_other_devices(self):
        cpu = torch.zeros(2, 8, 4, 16)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            kss.ssd_scan(cpu, torch.zeros(2, 8, 4), torch.zeros(2, 8, 1, 16),
                         torch.zeros(2, 8, 1, 16), chunk=8, h0=CudaStub((2, 4, 16, 16)))
        meta = [torch.zeros(s, device="meta") for s in ((2, 8, 4, 16), (2, 8, 4),
                                                        (2, 8, 1, 16), (2, 8, 1, 16))]
        with pytest.raises(ValueError, match="CPU or CUDA"):
            kss.ssd_scan(*meta, chunk=8)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            krg.rglru_scan(torch.zeros(2, 8, 64), CudaStub((2, 8, 64)))
        with pytest.raises(ValueError, match="CPU or CUDA"):
            krg.rglru_scan(torch.zeros(2, 8, 64, device="meta"),
                           torch.zeros(2, 8, 64, device="meta"))

    def test_rejects_mismatched_shapes(self):
        with pytest.raises(ValueError):
            kss.ssd_scan(torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 4),
                         torch.zeros(2, 8, 3, 16), torch.zeros(2, 8, 3, 16), chunk=8)
        with pytest.raises(ValueError):
            kss.ssd_scan(torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 4),
                         torch.zeros(2, 8, 1, 16), torch.zeros(2, 8, 1, 16), chunk=8,
                         h0=torch.zeros(2, 4, 16, 8))
        with pytest.raises(ValueError):
            krg.rglru_scan(torch.zeros(2, 8, 64), torch.zeros(2, 8, 32))
        with pytest.raises(ValueError):
            krg.rglru_scan(torch.zeros(2, 8, 64), torch.zeros(2, 8, 64), torch.zeros(3, 64))
