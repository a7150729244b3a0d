"""Kernel B1 of the PyTorch port (flash-decode GQA attention) against the
JAX package.

On the CPU the port's `decode_attention_plain` is held against the Pallas
kernel `flash_decode_gqa` (run with interpret=True, as tests/test_kernels.py
runs it), its oracle `decode_attention_ref` and the model-side
`repro.models.attention.decode_attention`.  tests/test_torch_kernels_gpu.py
runs the same cases through the CUDA kernel on a card.

Tolerances follow tests/test_kernels.py::_tol: 1e-4 for f32 (reduction
order only), 2e-2 for bf16 (the reference rounds the softmax weights to
bf16 before the value product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as kda

FLASH_SHAPES = [            # tests/test_kernels.py::TestFlashDecode
    (2, 8, 2, 128, 512),
    (1, 16, 8, 128, 1024),
    (4, 4, 1, 64, 256),
    (2, 12, 4, 128, 384),    # non-pow2 S
    (1, 71, 71, 64, 256),    # falcon-7b-like MHA head count
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MODEL_CASES = [             # (B, Hq, Hkv, D, S, pos, ring, softcap)
    (2, 4, 2, 32, 80, 3, False, 0.0),
    (2, 4, 2, 32, 80, 79, False, 0.0),
    (2, 4, 2, 32, 64, 20, True, 0.0),     # ring not yet full
    (2, 4, 2, 32, 64, 70, True, 0.0),     # ring full: every slot valid
    (2, 8, 1, 64, 96, 40, False, 2.0),    # softcap
    (1, 16, 2, 128, 130, 129, True, 5.0),  # ragged S, ring full, softcap
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
    """The JAX package's Pallas kernel and oracle.  `repro.kernels` imports
    `jax.experimental.enable_x64`, which newer jax moved to `jax.enable_x64`;
    alias it for this module only."""
    import jax.experimental
    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.kernels import ref
    from repro.kernels.decode_attention import flash_decode_gqa
    yield flash_decode_gqa, ref.decode_attention_ref
    if added:
        del jax.experimental.enable_x64


def _inputs(B, Hq, Hkv, D, S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def _port(fn, arrays, dtype, pos, device="cpu", **kw):
    q, k, v = (torch.as_tensor(a).to(device=device, dtype=dtype) for a in arrays)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=device)
    return fn(q, k, v, pos_t, **kw).float().cpu().numpy()


def _jax(fn, arrays, dtype, pos, **kw):
    q, k, v = (jnp.asarray(a, dtype) for a in arrays)
    return np.asarray(fn(q, k, v, jnp.asarray(pos, jnp.int32), **kw), np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("shape", FLASH_SHAPES)
    def test_full_cache(self, pallas, shape, dtype):
        flash, oracle = pallas
        jdt, tdt, tol = DTYPES[dtype]
        arrays = _inputs(*shape)
        pos = shape[-1] - 1
        ours = _port(kda.decode_attention_plain, arrays, tdt, pos)
        _close(ours, _jax(flash, arrays, jdt, pos, block_s=128, interpret=True), tol)
        _close(ours, _jax(oracle, arrays, jdt, pos), tol)

    @pytest.mark.parametrize("pos", [0, 5, 255, 400])
    def test_masking_positions(self, pallas, pos):
        flash, oracle = pallas
        arrays = _inputs(2, 4, 2, 64, 512, seed=pos)
        ours = _port(kda.decode_attention_plain, arrays, torch.float32, pos)
        _close(ours, _jax(flash, arrays, jnp.float32, pos, block_s=128, interpret=True), 1e-4)
        _close(ours, _jax(oracle, arrays, jnp.float32, pos), 1e-4)

    def test_masked_tail_is_ignored(self):
        """Garbage beyond pos must not influence the output."""
        q, k, v = _inputs(1, 4, 2, 64, 256)
        pos = 100
        k2, v2 = k.copy(), v.copy()
        k2[:, pos + 1:] = 1e4
        v2[:, pos + 1:] = -1e4
        a = _port(kda.decode_attention_plain, (q, k, v), torch.float32, pos)
        b = _port(kda.decode_attention_plain, (q, k2, v2), torch.float32, pos)
        np.testing.assert_allclose(a, b, atol=1e-5)


class TestPlainAgainstModelPath:
    """The model path needs ring and softcap, which the Pallas kernel lacks."""

    @pytest.mark.parametrize("case", MODEL_CASES)
    def test_matches_model_decode_attention(self, case):
        B, Hq, Hkv, D, S, pos, ring, softcap = case
        arrays = _inputs(B, Hq, Hkv, D, S, seed=S)
        ours = _port(kda.decode_attention_plain, arrays, torch.float32, pos,
                     ring=ring, softcap=softcap)
        _close(ours, _jax(jattn.decode_attention, arrays, jnp.float32, pos,
                          ring=ring, softcap=softcap), 1e-4)

    def test_wrapper_runs_plain_on_cpu(self):
        arrays = _inputs(2, 4, 2, 32, 80)
        before = kda.launches
        a = _port(kda.decode_attention, arrays, torch.float32, 40, ring=True, softcap=3.0)
        b = _port(kda.decode_attention_plain, arrays, torch.float32, 40, ring=True, softcap=3.0)
        np.testing.assert_array_equal(a, b)
        assert kda.launches == before, "the CPU path launches no kernel"


class TestWrapperChecks:
    def test_rejects_mismatched_shapes(self):
        q = torch.zeros(2, 4, 32)
        with pytest.raises(ValueError):
            kda.decode_attention(q, torch.zeros(2, 8, 3, 32), torch.zeros(2, 8, 3, 32), 0)
        with pytest.raises(ValueError):
            kda.decode_attention(q, torch.zeros(2, 8, 2, 32), torch.zeros(2, 9, 2, 32), 0)

    def test_rejects_other_devices(self):
        q = torch.zeros(2, 4, 32, device="meta")
        kv = torch.zeros(2, 8, 2, 32, device="meta")
        with pytest.raises(ValueError, match="CPU or CUDA"):
            kda.decode_attention(q, kv, kv, 0)


class TestBuild:
    def test_library_key_follows_sources_and_flags(self, monkeypatch):
        path = _build.library_path("decode_attention")
        assert path.parent == _build.BUILD_DIR and path.name.startswith("libdecode_attention-")
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
        assert _build.library_path("decode_attention") != path

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc()
