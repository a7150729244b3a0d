"""Kernel B2 and the batch cost surfaces of the PyTorch port against the JAX
package.

On the CPU the port's `pass_surface_plain` is held against the Pallas
kernel `pass_costs_pallas` (run with interpret=True, as
tests/test_cost_kernels.py runs it) and against numpy `pass_costs_batch`:
in float32 at rtol 1e-5 (the TPU kernel's numerics; the reference's own
gate), in float64 at rtol 1e-12.  A numpy emulation of csrc/cost_batch.cu's
arithmetic, fed the host-resolved constants the kernel receives, must give
the plain version's values bit for bit.  `simulate_batch(device="cpu")`
and `cost_matrices` are held within 1e-9 relative of the numpy closed form
`AnalyticLLMSimulator.simulate` and of the reference's jit
`simulate_batch`, on all of tests/test_cost_kernels.py's cases.
tests/test_torch_kernels_gpu.py runs the CUDA kernel on a card.
"""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.energy import costs as jcosts
from repro.energy.simulator import AnalyticLLMSimulator as JSim
from repro_torch.configs import get_config
from repro_torch.energy import costs
from repro_torch.energy.simulator import AnalyticLLMSimulator
from repro_torch.kernels import cost_batch as kcb

FAMILY_ARCHS = {   # tests/test_cost_kernels.py's six families, plus encdec and vlm
    "dense": "llama2-7b", "moe": "mixtral-8x7b", "windowed": "mistral-7b",
    "ssm": "mamba2-130m", "hybrid": "recurrentgemma-9b", "mla": "deepseek-v3-671b",
    "encdec": "seamless-m4t-large-v2", "vlm": "internvl2-2b",
}
TIN = np.array([1, 2, 8, 100, 512, 3000, 4095, 4096, 5000, 64])
TOUT = np.array([1, 3, 100, 4096, 512, 2000, 2, 1, 0, 300])
CU_SOURCE = Path(kcb.__file__).resolve().parent / "csrc" / "cost_batch.cu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as every port test file does: with
    several pytest-xdist workers torch's default threads oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jcb():
    """The JAX package's `repro.kernels.cost_batch`.  It imports
    `jax.experimental.enable_x64`, which newer jax moved to
    `jax.enable_x64`; alias it for this module only."""
    import jax.experimental
    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.kernels import cost_batch
    yield cost_batch
    if added:
        del jax.experimental.enable_x64


def _queries(seed=3, m=200):
    """tests/test_cost_kernels.py::TestPassCostsPallas's inputs."""
    rng = np.random.default_rng(seed)
    nt = rng.integers(1, 4096, m).astype(float)
    return nt, nt + rng.integers(0, 4096, m)


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


class TestPassSurface:
    @pytest.mark.parametrize("decode", [False, True])
    @pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
    def test_f32_matches_pallas_kernel_and_numpy(self, jcb, family, decode):
        arch = FAMILY_ARCHS[family]
        nt, ctx = _queries()
        f, b = kcb.pass_costs_kernel(get_config(arch), nt, ctx, 8.0, decode=decode,
                                     device="cpu")
        assert f.dtype == b.dtype == np.float32
        jf, jb = jcb.pass_costs_pallas(jget_config(arch), nt, ctx, 8.0, decode=decode,
                                       interpret=True)
        ref = jcosts.pass_costs_batch(jget_config(arch), nt, ctx, 8.0, decode=decode)
        for ours, theirs in ((f, jf), (b, jb), (f, ref.flops), (b, ref.hbm_bytes)):
            np.testing.assert_allclose(ours, theirs, rtol=1e-5)

    def test_unpadded_sizes(self, jcb):
        """m not a multiple of the Pallas kernel's (8, 128) tile."""
        nt = np.arange(1.0, 38.0)
        f, b = kcb.pass_costs_kernel(get_config("llama2-7b"), nt, nt, 4.0, device="cpu")
        assert f.shape == b.shape == (37,)
        jf, jb = jcb.pass_costs_pallas(jget_config("llama2-7b"), nt, nt, 4.0, interpret=True)
        np.testing.assert_allclose(f, jf, rtol=1e-5)
        np.testing.assert_allclose(b, jb, rtol=1e-5)

    @pytest.mark.parametrize("include_weights", [True, False])
    @pytest.mark.parametrize("decode", [False, True])
    @pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
    def test_f64_matches_numpy(self, family, decode, include_weights):
        cfg = get_config(FAMILY_ARCHS[family])
        nt, ctx = _queries(seed=4)
        bt = np.array([1.0, 4.0, 32.0])[:, None]
        f, b = kcb.pass_surface(cfg, *(torch.as_tensor(x, dtype=torch.float64)
                                       for x in (nt, ctx, bt)),
                                include_weights=include_weights, decode=decode)
        assert f.dtype == torch.float64 and f.shape == (3, 200)
        ref = costs.pass_costs_batch(cfg, nt, ctx, bt, include_weights=include_weights,
                                     decode=decode)
        np.testing.assert_allclose(f.numpy(), ref.flops, rtol=1e-12)
        np.testing.assert_allclose(b.numpy(), ref.hbm_bytes, rtol=1e-12)


def emulate_kernel(p, nt, ctx, bt, dtype):
    """csrc/cost_batch.cu's `query`, operation for operation, in numpy
    `dtype` (which rounds every product and sum, as the kernel's _rn
    intrinsics do), from the constants the kernel receives.  The batch's
    products with the constants come first (`BatchTerms`: once a thread for
    a uniform batch, here a 0-d array), then each query's."""
    c = {name: dtype(getattr(p, name)) for name, ty in p._fields_ if ty is ctypes.c_double}
    nt, ctx, bt = (np.asarray(x, dtype) for x in (nt, ctx, bt))
    # BatchTerms
    ssm_b = c["ssm_layers"] * bt
    attn_b = c["attn_layers"] * bt * dtype(4) * c["heads"] * c["head_dim"]
    xattn_b = c["xattn_layers"] * bt * dtype(4) * c["heads"] * c["head_dim"]
    router_b = c["router_layers"] * bt
    state_b = bt * c["ssm_state_bytes"]
    # query
    tokens = bt * nt
    cc = np.minimum(ctx, c["clamp"]) if p.has_clamp else ctx
    flops = c["k_dense"] * tokens
    if p.ssm:
        flops = flops + ssm_b * nt * c["ssm_flops"]
    else:
        flops = flops + attn_b * nt * cc
        if p.has_xattn:
            flops = flops + xattn_b * nt * c["n_frames"]
    if p.moe:
        flops = flops + router_b * nt * c["router_flops"]
    bytes_ = np.zeros_like(tokens)
    if p.include_weights:
        if p.moe:
            hit = np.minimum(c["n_experts"], tokens * c["top_k"])
            bytes_ = bytes_ + (c["weight_bytes"] + hit * c["expert_bytes"]) * c["elem_bytes"]
        else:
            bytes_ = bytes_ + c["weight_bytes"]
    bytes_ = bytes_ + tokens * c["act_bytes"]
    bytes_ = bytes_ + tokens * c["kv_bytes"]
    if p.decode:
        extra = bt * cc * c["kv_bytes"]
        if p.ssm:
            extra = extra + state_b
        bytes_ = bytes_ + extra
    return flops, bytes_


def emulate_coverage(m, itemsize, threads=256, vecs=2):
    """How often csrc/cost_batch.cu's launch writes each query (`launch`
    and the kernel's indexing in numpy): 16-byte vectors (thread t of block
    b: vectors b threads vecs + j threads + t), then single queries after
    the last whole vector (the tail, by block 0's first threads).  Returns
    (blocks, writes per query)."""
    n = 16 // itemsize
    nvec = m // n
    per_block = threads * vecs
    blocks = -(-nvec // per_block) if nvec > 0 else 1
    writes = np.zeros(m, np.int64)
    t = np.arange(threads)
    tail = nvec * n + t
    writes[tail[tail < m]] += 1
    v = (np.arange(blocks)[:, None, None] * per_block + np.arange(vecs)[None, :, None] * threads
         + t[None, None, :]).ravel()
    v = v[v < nvec]
    for k in range(n):
        np.add.at(writes, v * n + k, 1)
    return blocks, writes


class TestKernelArithmetic:
    def test_params_struct_mirrors_the_cuda_source(self):
        body = re.search(r"struct CostBatchParams \{(.*?)\};", CU_SOURCE.read_text(), re.S)
        fields = re.findall(r"^\s*(double|int32_t)\s+(\w+);", body.group(1), re.M)
        assert fields == [("double" if ty is ctypes.c_double else "int32_t", name)
                          for name, ty in kcb.CostBatchParams._fields_]
        assert ctypes.sizeof(kcb.CostBatchParams) == 19 * 8 + 6 * 4

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    @pytest.mark.parametrize("family", sorted(FAMILY_ARCHS) + ["granite-moe-3b-a800m",
                                                              "deepseek-67b"])
    def test_emulated_kernel_equals_plain(self, family, dtype):
        """The constants the host resolves, run through the kernel's order of
        operations, give pass_surface_plain's values bit for bit."""
        cfg = get_config(FAMILY_ARCHS.get(family, family))
        nt, ctx = _queries(seed=5, m=300)
        bt = np.repeat([1.0, 3.0, 32.0], 100)
        td = getattr(torch, dtype)
        for iw in (True, False):
            for decode in (True, False):
                p = kcb.surface_params(cfg, iw, decode, td)
                ef, eb = emulate_kernel(p, nt, ctx, bt, getattr(np, dtype))
                pf, pb = kcb.pass_surface_plain(cfg, *(torch.as_tensor(x, dtype=td)
                                                       for x in (nt, ctx, bt)),
                                                include_weights=iw, decode=decode)
                np.testing.assert_array_equal(ef, pf.numpy())
                np.testing.assert_array_equal(eb, pb.numpy())

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    @pytest.mark.parametrize("call", ["prefill", "decode probe", "uniform context"])
    @pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
    def test_emulated_kernel_equals_plain_with_uniform_operands(self, family, call, dtype):
        """simulate_batch's own operands: the prefill's (τin, τin, a 0-d
        batch) and the KV-on decode probes' (a 0-d 1, L, a 0-d batch), and
        a uniform context.  The batch's products taken once, as the kernel
        takes them for a uniform batch, give the plain version's values bit
        for bit."""
        cfg = get_config(FAMILY_ARCHS[family])
        nt, ctx = _queries(seed=6, m=300)
        td, nd = getattr(torch, dtype), getattr(np, dtype)
        ops = {"prefill": (ctx, ctx, 32.0), "decode probe": (1.0, ctx + 0.5, 32.0),
               "uniform context": (nt, 4096.0, 3.0)}[call]
        for iw in (True, False):
            for decode in (True, False):
                p = kcb.surface_params(cfg, iw, decode, td)
                ef, eb = emulate_kernel(p, *ops, nd)
                pf, pb = kcb.pass_surface_plain(cfg, *(torch.as_tensor(x, dtype=td)
                                                       for x in ops),
                                                include_weights=iw, decode=decode)
                np.testing.assert_array_equal(np.broadcast_to(ef, pf.shape), pf.numpy())
                np.testing.assert_array_equal(np.broadcast_to(eb, pb.shape), pb.numpy())

    @pytest.mark.parametrize("vecs", [2, 4])
    @pytest.mark.parametrize("itemsize", [4, 8])
    @pytest.mark.parametrize("m", [1, 3, 5, 37, 1_000_000, 1_000_037])
    def test_every_query_is_written_once(self, m, itemsize, vecs):
        """The kernel's vectors and tail write each query exactly once, for
        both numbers of vectors a thread (two or three arrays: 2; one or
        none: 4), in one wave of blocks with no grid-stride loop."""
        blocks, writes = emulate_coverage(m, itemsize, vecs=vecs)
        assert (writes == 1).all()
        assert blocks == max(1, -(-(m // (16 // itemsize)) // (256 * vecs)))

    def test_large_weight_bytes_stay_double(self):
        """deepseek-v3-671b's weight bytes (~1.3e12 once every expert is hit)
        pass as doubles: exact in the float64 instance, rounded once to
        float32 in the float32 one."""
        from repro_torch.models import get_api
        cfg = get_config("deepseek-v3-671b")
        total_bytes = float(get_api(cfg).count_params(cfg) * 2)
        assert total_bytes > 1e12
        nt = np.array([1.0, 64.0])
        for dtype, rtol in ((np.float64, 0.0), (np.float32, 2.0 ** -23)):
            p = kcb.surface_params(cfg, True, False, getattr(torch, dtype.__name__))
            _, b = emulate_kernel(p, nt, nt, 1.0, dtype)
            act_kv = nt[1] * (p.act_bytes + p.kv_bytes)
            np.testing.assert_allclose(float(b[1]) - act_kv, total_bytes, rtol=rtol)
            assert float(b[0]) < float(b[1]) / 10      # one token hits 8 of 256 experts


def _sim(family, kv, batch=4):
    cfg = get_config(FAMILY_ARCHS[family])
    return (AnalyticLLMSimulator(cfg, batch=batch, kv_cache=kv, noise_sigma=0.0),
            JSim(jget_config(FAMILY_ARCHS[family]), batch=batch, kv_cache=kv,
                 noise_sigma=0.0))


class TestSimulateBatch:
    @pytest.mark.parametrize("kv", [True, False])
    @pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
    def test_matches_numpy_closed_form_and_reference(self, jcb, family, kv):
        sim, jsim = _sim(family, kv)
        e, r = kcb.simulate_batch(sim, TIN, TOUT, device="cpu")
        assert e.dtype == r.dtype == np.float64 and e.shape == r.shape == TIN.shape
        pbs = [sim.simulate(int(a), int(b)) for a, b in zip(TIN, TOUT)]
        assert _rel(e, np.array([pb.energy_j for pb in pbs])) <= 1e-9
        assert _rel(r, np.array([pb.runtime_s for pb in pbs])) <= 1e-9
        je, jr = jcb.simulate_batch(jsim, TIN, TOUT)
        assert _rel(e, je) <= 1e-9 and _rel(r, jr) <= 1e-9

    def test_million_step_decode_finite(self, jcb):
        """The float64 power sums must survive count³ ≈ 1e18."""
        sim, jsim = _sim("dense", True, batch=1)
        e, r = kcb.simulate_batch(sim, [1], [1_000_000], device="cpu")
        pb = sim.simulate(1, 1_000_000)
        assert np.isfinite(e[0]) and np.isfinite(r[0])
        assert _rel(e, np.array([pb.energy_j])) <= 1e-9
        assert _rel(r, np.array([pb.runtime_s])) <= 1e-9
        assert _rel(e, jcb.simulate_batch(jsim, [1], [1_000_000])[0]) <= 1e-9

    def test_batch_override(self):
        sim, _ = _sim("dense", True, batch=8)
        e8, _ = kcb.simulate_batch(sim, [64], [64], device="cpu")
        e1, r1 = kcb.simulate_batch(sim, [64], [64], batch=1, device="cpu")
        assert e1[0] < e8[0]
        pre_t, pre_e = sim.prefill_cost(64, 1)
        dec_t, dec_e = sim.decode_cost(64, 64, 1)
        t = pre_t + dec_t
        assert _rel(r1, np.array([t])) <= 1e-9
        assert _rel(e1, np.array([pre_e + dec_e + sim.host_power_w * t])) <= 1e-9

    def test_cost_matrices_shape_and_values(self, jcb):
        sims = [AnalyticLLMSimulator(get_config(FAMILY_ARCHS[f]), batch=2, kv_cache=True,
                                     noise_sigma=0.0) for f in ("dense", "moe")]
        tin, tout = np.array([8, 64, 512]), np.array([8, 32, 128])
        E, R = kcb.cost_matrices(sims, tin, tout, per_query=True, device="cpu")
        assert E.shape == R.shape == (3, 2)
        for j, sim in enumerate(sims):
            for i in range(3):
                pb = sim.simulate(int(tin[i]), int(tout[i]))
                assert _rel(E[i, j], pb.energy_j / sim.batch) <= 1e-9
                assert _rel(R[i, j], pb.runtime_s / sim.batch) <= 1e-9
        jsims = [JSim(jget_config(FAMILY_ARCHS[f]), batch=2, kv_cache=True, noise_sigma=0.0)
                 for f in ("dense", "moe")]
        JE, JR = jcb.cost_matrices(jsims, tin, tout, per_query=True)
        assert _rel(E, JE) <= 1e-9 and _rel(R, JR) <= 1e-9
        E2, _ = kcb.cost_matrices(sims, tin, tout, device="cpu")
        np.testing.assert_array_equal(E2 / 2, E)

    @pytest.mark.parametrize("arch, kv, calls", [
        ("llama2-7b", True, 4), ("llama2-7b", False, 4), ("mistral-7b", True, 7),
        ("recurrentgemma-9b", False, 7), ("mixtral-8x7b", False, 7), ("mixtral-8x7b", True, 4),
        ("deepseek-v3-671b", False, 7), ("mamba2-130m", False, 4)])
    def test_surface_calls_per_evaluation(self, monkeypatch, arch, kv, calls):
        """One prefill call and three probes per decode segment: the count
        of B2 launches one simulate_batch makes on a card."""
        seen = []
        plain = kcb.pass_surface

        def counting(*args, **kw):
            seen.append(kw.get("decode"))
            return plain(*args, **kw)

        monkeypatch.setattr(kcb, "pass_surface", counting)
        sim = AnalyticLLMSimulator(get_config(arch), kv_cache=kv, noise_sigma=0.0)
        kcb.simulate_batch(sim, TIN, TOUT, device="cpu")
        assert len(seen) == kcb.surface_calls(sim.cfg, kv) == calls
        assert seen == [False] + [kv] * (calls - 1)


class CudaStub:
    """Stands for a CUDA tensor where there is no card: the attributes the
    wrapper reads before it launches."""

    def __init__(self, shape, dtype=torch.float32):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)


class TestWrappers:
    def test_cpu_tensors_run_the_plain_version(self):
        cfg = get_config("mixtral-8x7b")
        x = torch.arange(1.0, 65.0)
        before = kcb.launches
        for a, b in zip(kcb.pass_surface(cfg, x, 2 * x, torch.tensor(4.0), decode=True),
                        kcb.pass_surface_plain(cfg, x, 2 * x, torch.tensor(4.0), decode=True)):
            assert torch.equal(a, b)
        assert kcb.launches == before

    def test_cuda_tensors_launch_or_raise(self, monkeypatch):
        """On CUDA tensors the wrapper goes to the kernel: with no nvcc the
        error surfaces, and the plain version is never called."""
        def fell_back(*args, **kw):
            raise AssertionError("the wrapper fell back to the plain version")

        def no_nvcc(name):
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(kcb, "pass_surface_plain", fell_back)
        monkeypatch.setattr(kcb._build, "load", no_nvcc)
        kcb._kernel.cache_clear()
        for dtype in (torch.float32, torch.float64):
            with pytest.raises(RuntimeError, match="nvcc"):
                kcb.pass_surface(get_config("llama2-7b"), CudaStub((64,), dtype),
                                 CudaStub((64,), dtype), CudaStub((), dtype))
        kcb._kernel.cache_clear()

    def test_rejects_mixed_devices_and_other_dtypes(self):
        cfg = get_config("llama2-7b")
        with pytest.raises(ValueError, match="CPU or CUDA"):
            kcb.pass_surface(cfg, CudaStub((8,)), CudaStub((8,)), torch.tensor(4.0))
        meta = torch.zeros(8, device="meta")
        with pytest.raises(ValueError, match="CPU or CUDA"):
            kcb.pass_surface(cfg, meta, meta, meta)
        for dtype in (torch.float16, torch.bfloat16, torch.int64):
            with pytest.raises(TypeError, match="float32 or float64"):
                kcb.pass_surface(cfg, CudaStub((8,), dtype), CudaStub((8,), dtype),
                                 CudaStub((), dtype))
        with pytest.raises(TypeError, match="float32 or float64"):
            kcb.pass_surface(cfg, CudaStub((8,)), CudaStub((8,)),
                             CudaStub((), torch.float64))

    def test_entry_points_default_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        sim = AnalyticLLMSimulator(get_config("llama2-7b"))
        for call in (lambda: kcb.simulate_batch(sim, [8], [8]),
                     lambda: kcb.cost_matrices([sim], [8], [8]),
                     lambda: kcb.pass_costs_kernel(sim.cfg, [8.0], [8.0], 1.0)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


class TestOperandModes:
    """What the wrapper hands kernel B2: each operand an array or a uniform
    value, context aliasing new_tokens, inputs at any offset, outputs on a
    16-byte boundary.  The launch is a stand-in that records its
    arguments, fed CPU tensors, since the wrapper's choices are made on the
    host."""

    def test_operand_mode(self):
        shape = torch.Size([10])
        for t in (torch.tensor(3.0), torch.tensor([3.0]), torch.tensor(3.0).expand(10),
                  torch.tensor([[3.0]])):
            u, mode = kcb.operand_mode(t, shape)
            assert mode == kcb.UNIFORM and u.data_ptr() == t.data_ptr()
        x = torch.arange(10.0)
        a, mode = kcb.operand_mode(x, shape)
        assert mode == kcb.ARRAY and a.data_ptr() == x.data_ptr()      # no copy
        a, mode = kcb.operand_mode(torch.arange(20.0)[::2], shape)
        assert mode == kcb.ARRAY and a.is_contiguous() and torch.equal(a, 2 * x)
        a, mode = kcb.operand_mode(torch.arange(3.0)[:, None], torch.Size([3, 5]))
        assert mode == kcb.ARRAY and a.shape == (3, 5) and a.is_contiguous()

    @pytest.fixture
    def recorded(self, monkeypatch):
        calls = []

        def launch(dtype, nt, ctx, bt, flops, bytes_, m, params, *rest):
            calls.append(dict(ptrs=(nt, ctx, bt, flops, bytes_), m=m, modes=rest[:3]))
            return 0

        monkeypatch.setattr(kcb, "_kernel", lambda: launch)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: types.SimpleNamespace(cuda_stream=0))
        return calls

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_simulate_batch_operands_go_in_without_copies(self, recorded, dtype):
        cfg = get_config("llama2-7b")
        L = torch.arange(1.0, 1002.0, dtype=dtype)
        B = torch.tensor(32.0, dtype=dtype)
        cases = [((L, L, B), (kcb.ARRAY, kcb.ALIAS, kcb.UNIFORM)),          # prefill
                 ((L.new_ones(()), L, B), (kcb.UNIFORM, kcb.ARRAY, kcb.UNIFORM)),  # probe
                 ((L, 2 * L, L), (kcb.ARRAY,) * 3),
                 ((B.expand(1001), L, B.expand(1001)), (kcb.UNIFORM, kcb.ARRAY, kcb.UNIFORM))]
        for (nt, ctx, bt), modes in cases:
            before = kcb.launches
            f, b = kcb._launch(cfg, nt, ctx, bt, include_weights=True, decode=True)
            call = recorded[-1]
            assert kcb.launches == before + 1
            assert call["modes"] == modes and call["m"] == 1001
            assert call["ptrs"][:3] == (nt.data_ptr(), ctx.data_ptr(), bt.data_ptr())
            assert f.shape == b.shape == (1001,) and f.dtype == b.dtype == dtype
            assert f.data_ptr() % 16 == b.data_ptr() % 16 == 0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_outputs_are_16_byte_aligned_whatever_the_inputs(self, recorded, dtype):
        """Inputs off a 16-byte boundary (slices t[k:]) go in as they are,
        read element by element by the kernel; the outputs are fresh
        allocations on a 16-byte boundary, which the kernel requires."""
        cfg = get_config("llama2-7b")
        base = torch.arange(1.0, 40.0, dtype=dtype)
        for k in range(4):
            t = base[k:k + 30]
            for ops in ((t, t, torch.tensor(2.0, dtype=dtype)),
                        (torch.tensor(1.0, dtype=dtype), t, base[:30])):
                f, b = kcb._launch(cfg, *ops, include_weights=False, decode=False)
                assert recorded[-1]["ptrs"][:3] == tuple(x.data_ptr() for x in ops)
                assert f.data_ptr() % 16 == b.data_ptr() % 16 == 0
                assert f.shape == (30,) and f.is_contiguous()

    def test_all_uniform_and_empty(self, recorded):
        cfg = get_config("llama2-7b")
        one = torch.tensor(1.0)
        f, _ = kcb._launch(cfg, one, one, one, include_weights=True, decode=False)
        assert f.shape == () and recorded[-1]["modes"] == (kcb.UNIFORM,) * 3
        n = len(recorded)
        f, _ = kcb._launch(cfg, torch.zeros(0), torch.zeros(0), one,
                           include_weights=True, decode=False)
        assert f.shape == (0,) and len(recorded) == n       # nothing to launch

    @pytest.mark.parametrize("kv", [True, False])
    def test_simulate_batch_passes_uniform_operands(self, jcb, monkeypatch, kv):
        """simulate_batch passes its batch as a 0-d tensor, the prefill's
        τin as both new tokens and context, and (KV on) each decode probe's
        new tokens as a 0-d 1: on a card, one array read and no copy.  On
        the CPU its values still equal the reference's jit simulate_batch."""
        seen = []
        plain = kcb.pass_surface

        def recording(cfg, nt, ctx, bt, **kw):
            shape = torch.broadcast_shapes(nt.shape, ctx.shape, bt.shape)
            modes = [kcb.operand_mode(t, shape)[1] for t in (nt, ctx, bt)]
            if kcb.same_tensor(ctx, nt):
                modes[1] = kcb.ALIAS
            seen.append((tuple(modes), kw["decode"]))
            return plain(cfg, nt, ctx, bt, **kw)

        monkeypatch.setattr(kcb, "pass_surface", recording)
        sim, jsim = _sim("dense", kv, batch=32)
        e, r = kcb.simulate_batch(sim, TIN, TOUT, device="cpu")
        probe = ((kcb.UNIFORM, kcb.ARRAY, kcb.UNIFORM), True) if kv else \
            ((kcb.ARRAY, kcb.ALIAS, kcb.UNIFORM), False)
        assert seen == [((kcb.ARRAY, kcb.ALIAS, kcb.UNIFORM), False)] + [probe] * 3
        je, jr = jcb.simulate_batch(jsim, TIN, TOUT)
        assert _rel(e, je) <= 1e-9 and _rel(r, jr) <= 1e-9
