"""The backward kernels of B3 (SSD chunk scan) and B4 (RG-LRU scan), the
port's sequential oracles (`kernels/ref.py`) and its public kernel names
(`kernels/ops.py`), against the JAX package.

The CUDA kernels cannot run here, so their algorithms are emulated in
PyTorch below, step for step as the sources order them
(`ssd_bwd_emulated`: csrc/ssd_scan.cu's two backward kernels, with
or without their bf16 hi/lo rounding of the tensor cores' operands;
`rglru_bwd_emulated`: csrc/rglru_scan.cu's reverse segmented scan with
`plan`'s split), and held against autograd of the plain versions and of
the sequential oracles: within 1e-10 in float64 (the plain versions and the
oracles keep float64 as it is) and 1e-5 relative in float32.  The
`torch.autograd.Function`s that launch the kernels on the card run here
with their launchers replaced by the plain forward and these emulations,
which changes nothing in the package; tests/test_torch_kernels_gpu.py and
chip_smoke.py run the kernels themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rglru_scan as krg
from repro_torch.kernels import ssd_scan as kss

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run torch on one CPU thread here, as the other port tests do: with
    several pytest-xdist workers its default threads oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's oracles and public kernel names.  `repro.kernels`
    imports `jax.experimental.enable_x64`, which newer jax moved to
    `jax.enable_x64`; alias it for this module only."""
    import jax.experimental
    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.kernels import ops, ref
    yield ref, ops
    if added:
        del jax.experimental.enable_x64


# ---------------------------------------------------------------------------
# Inputs (tests/test_kernels.py's scales), drawn with numpy
# ---------------------------------------------------------------------------


def ssd_np(b, s, h, p, n, g, seed=0):
    """xdt, dA, B, C (per group), h0, dy, d_final."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(b, s, h, p)) * 0.5), -np.abs(rng.normal(size=(b, s, h)) * 0.3),
            (rng.normal(size=(b, s, g, n)) * 0.5), (rng.normal(size=(b, s, g, n)) * 0.5),
            (rng.normal(size=(b, h, p, n)) * 0.5), rng.normal(size=(b, s, h, p)),
            rng.normal(size=(b, h, p, n)))


def rglru_np(B, S, W, seed=0):
    """a, b, h0, dh, dh_last."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.7, 0.999, (B, S, W)), rng.normal(size=(B, S, W)) * 0.1,
            rng.normal(size=(B, W)), rng.normal(size=(B, S, W)), rng.normal(size=(B, W)))


def tensors(arrays, dtype):
    return [torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays]


def heads(t, h):
    """[b,s,g,n] -> [b,s,h,n]: the reference's group broadcast."""
    return t.repeat_interleave(h // t.shape[2], dim=2)


# ---------------------------------------------------------------------------
# Emulations of the backward kernels
# ---------------------------------------------------------------------------


def planes(t, split):
    """t as the kernel holds it on the tensor cores, (hi, lo): hi =
    bf16(t), lo = bf16(t - hi), in t's dtype, when `split`; (t, 0)
    otherwise (the algorithm without the rounding)."""
    if not split:
        return t, torch.zeros_like(t)
    hi = t.to(torch.bfloat16).to(t.dtype)
    return hi, (t - hi).to(torch.bfloat16).to(t.dtype)


def rounded(t, split):
    """hi + lo of `planes`: the value a split operand carries."""
    hi, lo = planes(t, split)
    return hi + lo


def prod(eq, a, b, split):
    """einsum(eq, a, b) as an mma over the operands' planes: every pair of
    planes but lo x lo (exact when not `split`)."""
    ah, al = planes(a, split)
    bh, bl = planes(b, split)
    return torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)


def ssd_bwd_emulated(xdt, dA, B, C, h0, dy, d_final, want_h0, Q=kss.BWD_CHUNK, split=False):
    """csrc/ssd_scan.cu's backward in PyTorch, in the inputs' precision (at
    least f32): chunks of Q steps, zero-padded past S (dA = 0).  The states
    kernel's chunk increments, (x o e^{cs_last-cs_t})^T B and (dy o
    e^{cs_t})^T C, and the passes from chunk to chunk that carry each
    entering state S_in forward and each outgoing adjoint dS_out back to
    dh0.  Then per chunk, the chunk kernel's products: C B^T per group and
    per head dy x^T, the decay-masked Gm and M, V = B dS_out^T and W = C
    S_in^T, dx = Gm^T dy + e^{cs_last-cs_j} V, and dcs (pair terms' row
    sums less column sums, e^{cs_t} dy.W, less e^{cs_last-cs_j} x.V moved
    to the chunk's end, e^{cs_last} <dS_out, S_in> there), summed from the
    end into ddA; dB = (sum_h M)^T C + sum_h (e^{cs_last-cs_j} x) dS_out and
    dC = (sum_h M) B + sum_h (e^{cs_t} dy) S_in, the heads of a group summed
    in head order.  `split` takes every product's operands as the kernel
    does (`planes`: f32 inputs, decay-weighted operands, states, Gm and sum
    M in bf16 hi and lo); without it the arithmetic is exact in the inputs'
    precision.  Returns (dxdt, ddA, dB, dC, dh0 or None) as
    `kss._launch_bwd` does."""
    b, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    w = torch.promote_types(xdt.dtype, torch.float32)
    nc = -(-s // Q)
    pad = nc * Q - s

    def chunks(t):
        t = t.to(w)
        t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t.reshape((b, nc, Q) + t.shape[2:])

    # inputs as loaded: f32 ones in two planes
    x, g_y = rounded(chunks(xdt), split), rounded(chunks(dy), split)   # [b,nc,Q,h,p]
    Bg, Cg = rounded(chunks(B), split), rounded(chunks(C), split)     # [b,nc,Q,g,n]
    Bh, Ch = Bg.repeat_interleave(rep, dim=3), Cg.repeat_interleave(rep, dim=3)
    a = chunks(dA)
    cs = torch.cumsum(a, dim=2)
    din, dout = torch.exp(cs), torch.exp(cs[:, :, -1:] - cs)        # [b,nc,Q,h]
    last = din[:, :, -1]                                            # [b,nc,h]

    # the states kernel: increments on the tensor cores, the pass elementwise
    inc = prod("bcqhp,bcqhn->bchpn", dout[..., None] * x, Bh, split)
    dinc = prod("bcqhp,bcqhn->bchpn", din[..., None] * g_y, Ch, split)
    st = torch.zeros((b, h, p, n), dtype=w) if h0 is None else h0.to(w)
    s_in = []
    for c in range(nc):
        s_in.append(st)
        st = last[:, c, :, None, None] * st + inc[:, c]
    ds = torch.zeros((b, h, p, n), dtype=w) if d_final is None else d_final.to(w)
    s_out = [None] * nc
    for c in reversed(range(nc)):
        s_out[c] = ds
        ds = last[:, c, :, None, None] * ds + dinc[:, c]
    s_in, s_out = torch.stack(s_in, 1), torch.stack(s_out, 1)      # [b,nc,h,p,n]

    # the chunk kernel
    ct = cs.permute(0, 1, 3, 2)                                     # [b,nc,h,Q]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(causal, torch.exp(ct[..., :, None] - ct[..., None, :]), 0.0)
    cb = prod("bctgn,bcjgn->bcgtj", Cg, Bg, split)                  # [b,nc,g,Q,Q]
    gm = L * cb.repeat_interleave(rep, dim=2)
    dyx = prod("bcthp,bcjhp->bchtj", g_y, x, split)
    m = L * dyx
    V = prod("bcjhn,bchpn->bcjhp", Bh, s_out, split)
    W = prod("bcthn,bchpn->bcthp", Ch, s_in, split)
    dx = prod("bchtj,bcthp->bcjhp", gm, g_y, split) + dout[..., None] * V
    pair = gm * dyx
    dcs = (pair.sum(-1) - pair.sum(-2)).permute(0, 1, 3, 2)         # [b,nc,Q,h]
    v = dout * (x * V).sum(-1)
    dcs = dcs + din * (g_y * W).sum(-1) - v
    dot = (rounded(s_out, split) * rounded(s_in, split)).sum((-1, -2))
    dcs[:, :, -1] += v.sum(2) + last * dot
    ddA = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2])

    def head_sum(t):        # [b,nc,Q,h,n] -> [b,nc,Q,g,n], heads in order
        t = t.reshape(t.shape[:3] + (g, rep, n))
        out = t[..., 0, :]
        for k in range(1, rep):
            out = out + t[..., k, :]
        return out

    summ = m.reshape((b, nc, g, rep, Q, Q))
    summ = sum((summ[:, :, :, k] for k in range(1, rep)), summ[:, :, :, 0])
    dBg = (prod("bcgtj,bctgn->bcjgn", summ, Cg, split)
           + head_sum(prod("bcjhp,bchpn->bcjhn", dout[..., None] * x, s_out, split)))
    dCg = (prod("bcgtj,bcjgn->bctgn", summ, Bg, split)
           + head_sum(prod("bcthp,bchpn->bcthn", din[..., None] * g_y, s_in, split)))

    def cut(t):
        return t.reshape((b, nc * Q) + t.shape[3:])[:, :s]

    return (cut(dx).to(xdt.dtype), cut(ddA), cut(dBg).to(B.dtype), cut(dCg).to(C.dtype),
            ds if want_h0 else None)


def rglru_bwd_emulated(a, h, h0, dh, dh_last, want_h0, aligned=True):
    """csrc/rglru_scan.cu's backward in PyTorch: reversed step r is
    t = S-1-r, with coefficient a_{t+1} (1 at r = 0, dh_last the carry-in);
    tiles of nseg * seg_len reversed steps (`plan`'s split), each
    segment's affine map composed, an exclusive walk of the maps from the
    tile's carry, the segment replayed: db_t = g_t, da_t = g_t h_{t-1}
    (h0 or 0 at t = 0), dh0 = a_0 g_0.  Returns (da, db, dh0 or None)."""
    Bsz, S, W = a.shape
    _, nseg, seg_len = krg.plan(S, W, aligned)
    zero = torch.zeros((Bsz, W), dtype=a.dtype)
    coef = lambda t: a[:, t + 1] if t + 1 < S else torch.ones_like(zero)
    hprev = lambda t: h[:, t - 1] if t >= 1 else (zero if h0 is None else h0)
    carry = zero if dh_last is None else dh_last
    da, db = torch.empty_like(a), torch.empty_like(a)
    for r0 in range(0, S, nseg * seg_len):
        segs = [range(r, min(r + seg_len, S)) for r in range(r0, r0 + nseg * seg_len, seg_len)]
        starts, gin = [], carry
        for seg in segs:
            A, Bc = torch.ones_like(zero), zero
            for r in seg:
                Bc = coef(S - 1 - r) * Bc + dh[:, S - 1 - r]
                A = coef(S - 1 - r) * A
            starts.append(gin)
            gin = A * gin + Bc
        carry = gin
        for seg, gv in zip(segs, starts):
            for r in seg:
                t = S - 1 - r
                gv = coef(t) * gv + dh[:, t]
                db[:, t] = gv
                da[:, t] = gv * hprev(t)
    return da, db, (a[:, 0] * carry if want_h0 else None)


def autograd_grads(fn, inputs, cotangents):
    """Gradients of sum(out . cotangent) over fn's outputs (a None
    cotangent: the output is not used) with respect to `inputs`."""
    inputs = [t.detach().clone().requires_grad_() if t is not None else None for t in inputs]
    outs = fn(*inputs)
    loss = sum((o * c).sum() for o, c in zip(outs, cotangents) if c is not None)
    live = [t for t in inputs if t is not None]
    grads = iter(torch.autograd.grad(loss, live, allow_unused=True))
    out = []
    for t in inputs:
        if t is not None:
            gr = next(grads)
            t = torch.zeros_like(t) if gr is None else gr     # an input out of reach
        out.append(t)
    return out


def assert_close(ours, ref, rel):
    """Within rel x the largest magnitude of the reference."""
    ours, ref = ours.detach().to(F64), ref.detach().to(F64)
    top = float(ref.abs().max())
    assert float((ours - ref).abs().max()) <= rel * max(top, 1e-30)


def ssd_plain(xdt, dA, B, C, h0):
    return kss.ssd_scan_plain(xdt, dA, B, C, chunk=16, h0=h0)


def ssd_ref(xdt, dA, B, C, h0):
    h = xdt.shape[2]
    return kref.ssd_scan_ref(xdt, dA, heads(B, h), heads(C, h), h0)


def rglru_ref(a, b, h0):
    hs = kref.rglru_scan_ref(a, b, h0)
    return hs, hs[:, -1]


# ---------------------------------------------------------------------------
# (a) kernels/ref.py against repro.kernels.ref
# ---------------------------------------------------------------------------


class TestRefPort:
    @pytest.mark.parametrize("B,Hq,Hkv,D,S,pos", [(2, 8, 2, 64, 48, 47), (1, 6, 6, 32, 20, 7),
                                                  (2, 4, 1, 16, 9, 0)])
    def test_decode_attention_ref(self, jref, B, Hq, Hkv, D, S, pos):
        ref, _ = jref
        rng = np.random.default_rng(S)
        q, k, v = (rng.normal(size=sh).astype(np.float32)
                   for sh in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        ours = kref.decode_attention_ref(*tensors((q, k, v), torch.float32), pos)
        np.testing.assert_allclose(ours.numpy(), ref.decode_attention_ref(q, k, v, pos),
                                   atol=1e-5, rtol=1e-5)
        co = rng.normal(size=(B, Hq, D)).astype(np.float32)
        grads = autograd_grads(lambda *t: (kref.decode_attention_ref(*t, pos),),
                               tensors((q, k, v), torch.float32), [torch.as_tensor(co)])
        jgrads = jax.grad(lambda *t: jnp.sum(ref.decode_attention_ref(*t, pos) * co),
                          argnums=(0, 1, 2))(q, k, v)
        for ours_g, jg in zip(grads, jgrads):
            assert_close(ours_g, torch.as_tensor(np.array(jg)), 1e-5)

    @pytest.mark.parametrize("b,s,h,p,n,init", [(2, 13, 3, 4, 5, False), (1, 9, 2, 8, 4, True)])
    def test_ssd_scan_ref(self, jref, b, s, h, p, n, init):
        ref, _ = jref
        xdt, dA, B, C, h0, dy, dfin = (a.astype(np.float32) for a in ssd_np(b, s, h, p, n, h))
        h0 = h0 if init else None
        args = (xdt, dA, B, C, h0)
        y, fin = kref.ssd_scan_ref(*tensors(args[:4], torch.float32),
                                   None if h0 is None else torch.as_tensor(h0))
        jy, jfin = ref.ssd_scan_ref(*args)
        np.testing.assert_allclose(y.numpy(), jy, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(fin.numpy(), jfin, atol=1e-5, rtol=1e-5)
        live = [a for a in args if a is not None]
        grads = autograd_grads(lambda *t: kref.ssd_scan_ref(*t), tensors(live, torch.float32),
                               tensors((dy, dfin), torch.float32))

        def jloss(*t):
            y, f = ref.ssd_scan_ref(*t)
            return jnp.sum(y * dy) + jnp.sum(f * dfin)

        jgrads = jax.grad(jloss, argnums=tuple(range(len(live))))(*live)
        for ours_g, jg in zip(grads, jgrads):
            assert_close(ours_g, torch.as_tensor(np.array(jg)), 1e-5)

    @pytest.mark.parametrize("S,W,init", [(1, 8, True), (23, 16, False), (40, 5, True)])
    def test_rglru_scan_ref(self, jref, S, W, init):
        ref, _ = jref
        a, b, h0, dh, _ = (t.astype(np.float32) for t in rglru_np(2, S, W, seed=S))
        h0 = h0 if init else None
        live = [t for t in (a, b, h0) if t is not None]
        ours = kref.rglru_scan_ref(*tensors(live, torch.float32))
        np.testing.assert_allclose(ours.numpy(), ref.rglru_scan_ref(*live), atol=1e-5,
                                   rtol=1e-5)
        grads = autograd_grads(lambda *t: (kref.rglru_scan_ref(*t),),
                               tensors(live, torch.float32), [torch.as_tensor(dh)])
        jgrads = jax.grad(lambda *t: jnp.sum(ref.rglru_scan_ref(*t) * dh),
                          argnums=tuple(range(len(live))))(*live)
        for ours_g, jg in zip(grads, jgrads):
            assert_close(ours_g, torch.as_tensor(np.array(jg)), 1e-5)

    def test_no_model_path_imports_it(self):
        import pathlib
        root = pathlib.Path(kref.__file__).resolve().parents[1]
        users = [p for p in root.rglob("*.py") if p.name != "ref.py"
                 and ("kernels.ref" in p.read_text() or "import ref" in p.read_text())]
        assert not users, users


# ---------------------------------------------------------------------------
# (b) the emulated backward algorithms against autograd
# ---------------------------------------------------------------------------

# (b, s, h, p, n, g): ragged and whole chunks of 32 steps, one or two groups
SSD_CASES = [(2, 1, 2, 4, 3, 1), (1, 31, 4, 3, 5, 2), (2, 32, 2, 4, 4, 1),
             (1, 45, 4, 2, 6, 2), (1, 70, 2, 3, 4, 1)]
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


class TestSSDBackwardEmulation:
    @pytest.mark.parametrize("case", SSD_CASES)
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_matches_autograd_of_plain_and_oracle(self, case, dtype):
        b, s, h, p, n, g = case
        xdt, dA, B, C, h0, dy, dfin = tensors(ssd_np(b, s, h, p, n, g, seed=s), dtype)
        for init in (None, h0):
            for d_final in (None, dfin):
                ours = ssd_bwd_emulated(xdt, dA, B, C, init, dy, d_final, init is not None)
                for fn in (ssd_plain, ssd_ref):
                    expect = autograd_grads(fn, [xdt, dA, B, C, init], [dy, d_final])
                    for o, e in zip(ours, expect):
                        assert (o is None) == (e is None)
                        if o is not None:
                            assert_close(o, e, TOL[dtype])


    @pytest.mark.parametrize("case", SSD_CASES)
    @pytest.mark.parametrize("inputs", ["float32", "bf16-exact"])
    def test_bf16_planes_hold_the_f32_gate(self, case, inputs):
        """With the kernel's rounding (`split`: f32 inputs, decay-weighted
        operands, states, Gm and sum M as bf16 hi and lo planes, lo x lo
        dropped) every gradient of f32 inputs, or of f32 inputs that bf16
        holds exactly (the bf16 kernel's one plane), stays within 1e-4 of
        its own largest in autograd of the plain version and of the oracle
        in float64: half the card's 2e-4 gate (at most 3e-5 seen here)."""
        b, s, h, p, n, g = case
        arrays = list(ssd_np(b, s, h, p, n, g, seed=s))
        if inputs == "bf16-exact":
            for k in (0, 2, 3, 5):            # xdt, B, C, dy
                arrays[k] = torch.as_tensor(arrays[k]).bfloat16().double().numpy()
        x32, x64 = tensors(arrays, torch.float32), tensors(arrays, F64)
        for init in (None, 4):
            for fin in (None, 6):
                ours = ssd_bwd_emulated(*x32[:4], init and x32[init], x32[5], fin and x32[fin],
                                        init is not None, split=True)
                for fn in (ssd_plain, ssd_ref):
                    expect = autograd_grads(fn, [*x64[:4], init and x64[init]],
                                            [x64[5], fin and x64[fin]])
                    for o, e in zip(ours, expect):
                        assert (o is None) == (e is None)
                        if o is not None:
                            assert_close(o, e, 1e-4)


RGLRU_CASES = [(1, 8), (37, 64), (128, 16), (300, 36), (300, 37), (600, 8)]


class TestRGLRUBackwardEmulation:
    @pytest.mark.parametrize("S,W", RGLRU_CASES)
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_matches_autograd_of_plain_and_oracle(self, S, W, dtype):
        a, b, h0, dh, dlast = tensors(rglru_np(2, S, W, seed=S), dtype)
        for init in (None, h0):
            h = kref.rglru_scan_ref(a, b, init)
            for d_last in (None, dlast):
                ours = rglru_bwd_emulated(a, h, init, dh, d_last, init is not None)
                for fn in (krg.rglru_scan_plain, rglru_ref):
                    expect = autograd_grads(fn, [a, b, init], [dh, d_last])
                    for o, e in zip(ours, expect):
                        assert (o is None) == (e is None)
                        if o is not None:
                            assert_close(o, e, TOL[dtype])

    def test_unaligned_split_gives_the_same_gradients(self):
        a, b, h0, dh, dlast = tensors(rglru_np(2, 100, 64, seed=3), F64)
        h = kref.rglru_scan_ref(a, b, h0)
        for x, y in zip(rglru_bwd_emulated(a, h, h0, dh, dlast, True, aligned=True),
                        rglru_bwd_emulated(a, h, h0, dh, dlast, True, aligned=False)):
            assert_close(x, y, 1e-12)


# ---------------------------------------------------------------------------
# (c) the autograd Functions, launchers replaced by the emulations
# ---------------------------------------------------------------------------


@pytest.fixture
def emulated(monkeypatch):
    """Route CPU tensors through `_SSDScan` and `_RGLRUScan`: the forward
    launchers run the plain versions, the backward launchers the
    emulations, and the wrappers send CPU inputs that need a gradient to
    the Functions as they send CUDA ones (while `calls["on"]`).  Counts
    the calls."""
    calls = {"on": True, "ssd": 0, "ssd_bwd": 0, "rglru": 0, "rglru_bwd": 0}

    def ssd_fwd(xdt, dA, B, C, h0):
        calls["ssd"] += 1
        with torch.no_grad():
            return kss.ssd_scan_plain(xdt, dA, B, C, chunk=64, h0=h0)

    def ssd_bwd(*args):
        calls["ssd_bwd"] += 1
        return ssd_bwd_emulated(*args)

    def rglru_fwd(a, b, h0):
        calls["rglru"] += 1
        with torch.no_grad():
            return krg.rglru_scan_plain(a, b, h0)

    def rglru_bwd(*args):
        calls["rglru_bwd"] += 1
        return rglru_bwd_emulated(*args)

    plain_ssd, plain_rglru = kss.ssd_scan, krg.rglru_scan

    def ssd_scan(xdt, dA, B, C, *, chunk, h0=None):
        tensors_ = [xdt, dA, B, C] + ([] if h0 is None else [h0])
        if calls["on"] and torch.is_grad_enabled() and any(t.requires_grad for t in tensors_):
            return kss._SSDScan.apply(xdt, dA, B, C, h0)
        return plain_ssd(xdt, dA, B, C, chunk=chunk, h0=h0)

    def rglru_scan(a, b, h0=None):
        tensors_ = [a, b] + ([] if h0 is None else [h0])
        if calls["on"] and torch.is_grad_enabled() and any(t.requires_grad for t in tensors_):
            return krg._RGLRUScan.apply(a, b, h0)
        return plain_rglru(a, b, h0)

    monkeypatch.setattr(kss, "_launch", ssd_fwd)
    monkeypatch.setattr(kss, "_launch_bwd", ssd_bwd)
    monkeypatch.setattr(kss, "ssd_scan", ssd_scan)
    monkeypatch.setattr(krg, "_launch", rglru_fwd)
    monkeypatch.setattr(krg, "_launch_bwd", rglru_bwd)
    monkeypatch.setattr(krg, "rglru_scan", rglru_scan)
    return calls


class TestFunctions:
    def test_gradcheck_f64(self, emulated):
        xdt, dA, B, C, h0, _, _ = tensors(ssd_np(1, 37, 4, 2, 3, 2, seed=1), F64)
        args = tuple(t.requires_grad_() for t in (xdt, dA, B, C, h0))
        assert torch.autograd.gradcheck(lambda *t: kss._SSDScan.apply(*t), args)
        a, b, h0, _, _ = tensors(rglru_np(2, 19, 5, seed=1), F64)
        args = tuple(t.requires_grad_() for t in (a, b, h0))
        assert torch.autograd.gradcheck(lambda *t: krg._RGLRUScan.apply(*t), args)
        assert emulated["ssd_bwd"] > 0 and emulated["rglru_bwd"] > 0

    def test_unused_outputs_count_as_zeros(self, emulated):
        """Only y (or h) reaches the loss, as in training: the final state's
        gradient is None and the backward treats it as zeros; a loss on
        the final state alone gets the same as its autograd."""
        xdt, dA, B, C, h0, dy, dfin = tensors(ssd_np(2, 40, 4, 4, 3, 2, seed=2), F64)
        y, fin = kss.ssd_scan(*(t.requires_grad_() for t in (xdt, dA, B, C)), chunk=16)
        got = torch.autograd.grad((y * dy).sum(), (xdt, dA, B, C))
        expect = autograd_grads(ssd_plain, [xdt, dA, B, C, None], [dy, None])
        for o, e in zip(got, expect):
            assert_close(o, e, 1e-10)
        y, fin = kss.ssd_scan(xdt, dA, B, C, chunk=16)
        got = torch.autograd.grad((fin * dfin).sum(), (xdt, dA, B, C))
        expect = autograd_grads(ssd_plain, [xdt, dA, B, C, None], [None, dfin])
        for o, e in zip(got, expect):
            assert_close(o, e, 1e-10)
        a, b, _, dh, _ = tensors(rglru_np(2, 20, 8, seed=2), F64)
        h, last = krg.rglru_scan(a.requires_grad_(), b.requires_grad_())
        got = torch.autograd.grad((h * dh).sum(), (a, b))
        expect = autograd_grads(krg.rglru_scan_plain, [a, b, None], [dh, None])
        for o, e in zip(got, expect):
            assert_close(o, e, 1e-10)
        assert emulated["ssd_bwd"] == 2 and emulated["rglru_bwd"] == 1

    def test_no_gradient_reaching_the_outputs_launches_no_backward(self, emulated):
        xdt, dA, B, C, _, _, _ = tensors(ssd_np(1, 8, 2, 2, 2, 1), F64)
        assert kss._SSDScan.backward(type("Ctx", (), {"saved_tensors": (xdt, dA, B, C, None)}),
                                     None, None) == (None,) * 5
        assert emulated["ssd_bwd"] == 0

    def test_groups_reduce_to_per_group_gradients(self, emulated):
        """Two groups of two heads: dB and dC come back per group, the sum of
        their heads' gradients, equal to autograd of the group broadcast."""
        xdt, dA, B, C, _, dy, _ = tensors(ssd_np(1, 33, 4, 2, 3, 2, seed=4), F64)
        y, _ = kss.ssd_scan(xdt, dA, B.requires_grad_(), C.requires_grad_(), chunk=16)
        dB, dC = torch.autograd.grad((y * dy).sum(), (B, C))
        assert dB.shape == B.shape and dC.shape == C.shape
        Bh, Ch = heads(B, 4).detach().requires_grad_(), heads(C, 4).detach().requires_grad_()
        yh, _ = kss.ssd_scan_plain(xdt, dA, Bh, Ch, chunk=16)
        dBh, dCh = torch.autograd.grad((yh * dy).sum(), (Bh, Ch))
        assert_close(dB, dBh.reshape(1, 33, 2, 2, 3).sum(3), 1e-10)
        assert_close(dC, dCh.reshape(1, 33, 2, 2, 3).sum(3), 1e-10)

    def test_gradient_types(self, emulated):
        """bf16 xdt, B, C: dxdt, dB and dC in bf16, ddA and dh0 in f32; B4
        takes and returns f32."""
        xdt, dA, B, C, h0, dy, _ = tensors(ssd_np(1, 20, 2, 4, 4, 1, seed=5), torch.float32)
        xdt, B, C = (t.bfloat16().requires_grad_() for t in (xdt, B, C))
        dA.requires_grad_()
        h0.requires_grad_()
        y, fin = kss.ssd_scan(xdt, dA, B, C, chunk=16, h0=h0)
        assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
        grads = torch.autograd.grad((y.float() * dy).sum(), (xdt, dA, B, C, h0))
        assert [t.dtype for t in grads] == [torch.bfloat16, torch.float32, torch.bfloat16,
                                            torch.bfloat16, torch.float32]
        a, b, h0, dh, _ = tensors(rglru_np(1, 9, 4), torch.float32)
        h, _ = krg.rglru_scan(a.requires_grad_(), b, h0.requires_grad_())
        assert all(t.dtype == torch.float32
                   for t in torch.autograd.grad((h * dh).sum(), (a, h0)))
        assert emulated["ssd_bwd"] == 1 and emulated["rglru_bwd"] == 1

    def test_backward_under_remat_recomputes_the_forward(self, emulated):
        """Inside non-reentrant checkpoint (`maybe_remat`) the backward
        re-runs the Function's forward once for its saved tensors."""
        from repro_torch.models.common import maybe_remat
        a, b, _, dh, _ = tensors(rglru_np(1, 12, 4), F64)
        fn = maybe_remat(lambda a_, b_: krg.rglru_scan(a_, b_)[0], True)
        h = fn(a.requires_grad_(), b)
        (got,) = torch.autograd.grad((h * dh).sum(), (a,))
        (expect,) = autograd_grads(krg.rglru_scan_plain, [a, b, None], [dh, None])[:1]
        assert_close(got, expect, 1e-10)
        assert emulated["rglru"] == 2 and emulated["rglru_bwd"] == 1


# ---------------------------------------------------------------------------
# (d) train_loss of the scan families through the Functions
# ---------------------------------------------------------------------------


class TestTrainLossThroughFunctions:
    @pytest.mark.parametrize("arch", ["mamba2-130m-reduced", "recurrentgemma-9b-reduced"])
    def test_grads_equal_plain_and_reference(self, emulated, arch):
        from test_torch_train import (assert_grads_close, carried, np_batch,
                                      port_value_and_grad, ref_value_and_grad)
        jcfg, jparams, cfg, params = carried(arch)
        batch = np_batch(cfg)
        emulated["on"] = False
        plain_loss, plain = port_value_and_grad(cfg, params, batch)
        emulated["on"] = True
        loss, grads = port_value_and_grad(cfg, params, batch)
        calls = emulated
        key = "ssd" if arch.startswith("mamba2") else "rglru"
        assert calls[key] > 0 and calls[f"{key}_bwd"] == calls[key]
        assert abs(loss - plain_loss) <= 1e-5 * abs(plain_loss)
        for path, g in plain.items():
            top = float(np.abs(g).max())
            np.testing.assert_allclose(grads[path], g, rtol=0, atol=1e-5 * max(top, 1e-30),
                                       err_msg=path)
        ref_loss, ref = ref_value_and_grad(jcfg, jparams, batch)
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
        assert_grads_close(grads, ref)


# ---------------------------------------------------------------------------
# (e) kernels/ops.py against repro.kernels.ops
# ---------------------------------------------------------------------------


class TestOps:
    def test_decode_attention(self, jref):
        _, ops = jref
        rng = np.random.default_rng(0)
        q, k, v = (rng.normal(size=sh).astype(np.float32)
                   for sh in ((1, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64)))
        for pos in (127, 40):
            ours = kops.decode_attention(*tensors((q, k, v), torch.float32), pos, block_s=64)
            expect = ops.decode_attention(q, k, v, jnp.asarray(pos), block_s=64, interpret=True)
            np.testing.assert_allclose(ours.numpy(), expect, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 3, 16, 32, 32), (1, 128, 2, 32, 16, 64)])
    def test_ssd(self, jref, b, s, h, p, n, chunk):
        _, ops = jref
        xdt, dA, B, C, _, _, _ = (a.astype(np.float32) for a in ssd_np(b, s, h, p, n, h))
        y, fin = kops.ssd(*tensors((xdt, dA, B, C), torch.float32), chunk=chunk)
        jy, jfin = ops.ssd(xdt, dA, B, C, chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.numpy(), jy, atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(fin.numpy(), jfin, atol=2e-4, rtol=1e-3)

    def test_rglru(self, jref):
        _, ops = jref
        a, b, _, _, _ = (t.astype(np.float32) for t in rglru_np(1, 64, 64))
        h = kops.rglru(*tensors((a, b), torch.float32), block_s=32, block_w=64)
        np.testing.assert_allclose(h.numpy(), ops.rglru(a, b, block_s=32, block_w=64,
                                                        interpret=True), atol=1e-4, rtol=1e-4)

    def test_interpret_names_the_cpu_route(self):
        z = torch.zeros
        for call in (lambda: kops.decode_attention(z(1, 2, 32), z(1, 8, 1, 32), z(1, 8, 1, 32), 3,
                                                   interpret=True),
                     lambda: kops.ssd(z(1, 8, 2, 16), z(1, 8, 2), z(1, 8, 2, 16), z(1, 8, 2, 16),
                                      interpret=True),
                     lambda: kops.rglru(z(1, 8, 4), z(1, 8, 4), interpret=True)):
            with pytest.raises(ValueError, match='device="cpu"'):
                call()
