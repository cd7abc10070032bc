"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  A CUDA kernel has no CPU mode, so every test here
needs an NVIDIA GPU with nvcc (Hopper, sm_90a) and skips elsewhere; run
them there with ``python -m pytest tests/test_torch_kernels_cuda.py -m
cuda``.  ``chip_smoke.py`` runs the same comparisons at BERT-base widths.

Tolerance: both sides accumulate in f32 and round to bf16 at the same
points, so they differ only where summation order flips a rounding --
at most two bf16 ulps of the tensor's largest value, and rarely.  The int8
kernels are held bit for bit (see below)."""

import pytest
import torch

from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want):
    d = (got.float() - want.float()).abs()
    assert d.max().item() <= 2.0 ** -6 * want.float().abs().max().item()
    assert d.mean().item() <= 1e-3


def _rand(dev, *shape, std=1.0, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * std).to(dev, dtype)


def _rand_dev(dev, *shape, std=1.0, dtype=torch.bfloat16, seed=0):
    """As ``_rand``, drawn on the card (the GEMM cases' large operands)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)


# The wgmma + TMA GEMMs' cases (gemm_bias_residual, gemm_dgrad): rows from
# one to 8192, some not a multiple of the 192-row tile; every width N % 128
# == 0 the encoder configurations reach; depths with K % 64 == 32 (96)
# beside the encoder's.
GEMM_M = [1, 60, 7688, 8192]
GEMM_NK = [(n, k) for n in (384, 768, 1024, 3072, 4096)
           for k in (96, 768, 2304, 3072)]


# gemm_bias_act's (act, dropout rate) cases: dropout follows the GELU only
ACT_RATES = [("none", 0.0), ("gelu", 0.0), ("gelu", 0.1)]


@pytest.mark.parametrize("save_h", [False, True])
@pytest.mark.parametrize("act,rate", ACT_RATES)
@pytest.mark.parametrize("n,k", GEMM_NK)
@pytest.mark.parametrize("m", GEMM_M)
def test_gemm_bias_act(dev, m, n, k, act, rate, save_h):
    """The bias and GELU epilogues against the plain version (out and h by
    ``_close``: the plain f32 product sums in another order, so a bf16
    rounding may flip).  The saved h is the bias epilogue's output bit for
    bit (one mainloop, one rounding), and the GELU output is the plain
    GELU of the kernel's own h within one bf16 ulp (erff against
    torch.erf), 0 exactly where the stream-1 keep bits drop."""
    from nbest_asr_tpu_torch.ops.layers import gelu
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    a = _rand_dev(dev, m, k, seed=1)
    w = _rand_dev(dev, k, n, std=0.05, seed=2)
    b = _rand_dev(dev, n, std=0.1, dtype=torch.float32, seed=3)
    d1 = _drop(rate, 1)
    got = K.gemm_bias_act(a, w, b, act, drop=d1, save_h=save_h)
    h = K.gemm_bias_act(a, w, b)
    torch.cuda.synchronize()
    want = K.gemm_bias_act_reference(a, w, b, act, d1, save_h)
    got, want = (got, want) if save_h else ((got,), (want,))
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16 and x.shape == (m, n)
        _close(x, y)
    if save_h:
        assert torch.equal(got[0], h)
    if act == "gelu":
        g = gelu(h.float())
        if d1 is not None:
            g = d1.apply(g)
            assert (got[-1][~keep_mask(1234, 1, 0, m, n, rate, dev)]
                    == 0).all()
        assert _ulps(got[-1], g.to(torch.bfloat16)) <= 1.0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,k", GEMM_NK)
@pytest.mark.parametrize("m", GEMM_M)
def test_gemm_bias_residual_and_layer_norm(dev, m, n, k, rate):
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    a = _rand_dev(dev, m, k, seed=4)
    w = _rand_dev(dev, k, n, std=0.05, seed=5)
    b = _rand_dev(dev, n, std=0.1, dtype=torch.float32, seed=6)
    r = _rand_dev(dev, m, n, seed=7)
    d2 = _drop(rate, 2)
    s, y2d = K.gemm_bias_residual(a, w, b, r, drop=d2, save_y2d=True)
    torch.cuda.synchronize()
    rs, ry2d = K.gemm_bias_residual_reference(a, w, b, r, d2, True)
    _close(s, rs)
    _close(y2d, ry2d)
    if rate > 0:
        keep = keep_mask(1234, 2, 0, m, n, rate, dev)
        assert (y2d[~keep] == 0).all()
        assert torch.equal(s[~keep], r.float()[~keep])
    if n > 1024:        # layer_norm takes rows of N <= 1024
        return
    g = 1 + _rand(dev, n, std=0.1, dtype=torch.float32, seed=8)
    bb = _rand(dev, n, std=0.1, dtype=torch.float32, seed=9)
    y = K.layer_norm_rows(s, g, bb, 1e-12)
    torch.cuda.synchronize()
    _close(y, K.layer_norm_reference(s, g, bb, 1e-12, torch.bfloat16))


# seg_attention's (seq, head dim) cases: at d = 64 (the wgmma kernel)
# ragged lengths, the four DSTC2 buckets and past 256 (two score windows);
# at d = 32 and 128 the mma.sync kernel
ATTN_SD = ([(s, 64) for s in (20, 64, 96, 130, 160, 256, 300, 512)]
           + [(s, d) for d in (32, 128) for s in (20, 160, 512)])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("s,d", ATTN_SD)
def test_seg_attention(dev, s, d, packed):
    b, nh = (3, 4) if s < 256 else (2, 4)
    qkv = _rand(dev, b * s, 3 * nh * d, seed=s + d)
    if packed:
        mask = torch.zeros(b, s)
        mask[:, : s // 3], mask[:, s // 3: 2 * s // 3] = 1.0, 2.0
    else:
        mask = torch.ones(b, s)
        mask[:, s - s // 4:] = 0.0
    mask = mask.to(dev)
    got = K.seg_attention(qkv, mask, nh)
    torch.cuda.synchronize()
    _close(got, K.seg_attention_reference(qkv, mask, nh))


def test_wrappers_refuse_and_count(dev):
    a = _rand(dev, 64, 256)
    w = _rand(dev, 256, 128)
    b = torch.zeros(128, device=dev)
    with pytest.raises(TypeError):
        K.gemm_bias_act(a.float(), w, b)
    with pytest.raises(ValueError, match="N % 128"):
        K.gemm_bias_act(a, w[:, :96].contiguous(), b[:96])
    with pytest.raises(ValueError, match="K % 8"):
        K.gemm_bias_act(a[:, :250].contiguous(), w[:250].contiguous(), b)
    with pytest.raises(ValueError, match="head dims"):
        K.seg_attention(_rand(dev, 64, 3 * 144), torch.ones(4, 16,
                                                            device=dev), 3)
    # the TMA kernel refuses an operand off a 16-byte boundary
    r = _rand(dev, 64, 128)
    off = _rand(dev, 64 * 256 + 1)[1:].view(64, 256)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_bias_residual(off, w, b, r)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_bias_residual(a, w, b, _rand(dev, 64 * 128 + 1)[1:].view(
            64, 128))
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_bias_act(off, w, b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_bias_act(a, w, torch.zeros(129, device=dev)[1:], "gelu")
    _cuda.reset_launch_counts()
    K.gemm_bias_act(a, w, b)
    K.gemm_bias_act(a, w, b, "gelu")
    assert _cuda.launch_counts["gemm_bias_act"] == 2
    assert sum(_cuda.launch_counts.values()) == 2


# --------------------------------------------------------------------- #
# int8 serving kernels: bit-equal to their plain versions (the integer
# dot is exact and the epilogues round at the same points), except the
# GELU epilogue, where erff and torch.erf may differ in the last f32 bit:
# there at most one bf16 ulp.
# --------------------------------------------------------------------- #

def _ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want``."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return ((got.float() - w).abs() / ulp).max().item()


def _i8_weight(dev, k, n, seed):
    from nbest_asr_tpu_torch.ops.quant import kernel_layout, quantize_weight

    q, s = quantize_weight(_rand(dev, k, n, std=0.05, dtype=torch.float32,
                                 seed=seed))
    return kernel_layout(q), s.reshape(-1)


# Rows built to stress the row pass's division (csrc/quant_rows.cu,
# div_scale): per row an abs-max (its scale not a power of two; 381 2^-8
# makes 127 s exact, so the f32 rows hold exact ties), and in it, for each
# k, the value nearest (k + 1/2) s in the row's dtype and its neighbours
# one ulp either side, below the abs-max; the 1e-12 floor (abs-max below
# and at it), tiny and huge rows, and values under 2^-90 (the division's
# scaled branch) and subnormal ones.
STRESS_AMAX = [381 * 2.0 ** -8, 1.5, 0.37e-12, 1e-12, 2.9e-12, 1.3e30,
               3.0e38]


def _stress_row(k, dtype, amax):
    a = torch.tensor([amax], dtype=dtype)
    s = (torch.clamp(a.float(), min=1e-12) / torch.full_like(
        a.float(), 127.0)).double().item()
    t = torch.tensor([(j + 0.5) * s for j in range(-127, 127)],
                     dtype=torch.float64).to(dtype)
    bits = t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    near = torch.cat([t, (bits + 1).view(dtype), (bits - 1).view(dtype)])
    near = near[near.float().abs() < a.float()]
    tiny = torch.tensor([1e-30, -3e-35, 1e-40, -2.0 ** -100], dtype=dtype)
    row = torch.cat([a, near, tiny, -near])[:k]
    return torch.cat([row, torch.zeros(k - row.numel(), dtype=dtype)])


# the row pass's widths (K = 256 n) and one it does not take
QUANT_K = [768, 1024, 3072, 4096, 776]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", QUANT_K)
@pytest.mark.parametrize("m", [1, 60, 300, 8192])
def test_quantize_rows(dev, m, k, dtype):
    x = _rand(dev, m, k, dtype=dtype, seed=m + k)
    if m > 1:
        x[1] = 0.0                        # all-zero row: the 1e-12 floor
        # amax 127 gives scale 1: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0 (half to
        # even), the +-0.5 boundary after scaling
        x[0, :4] = torch.tensor([127.0, 2.5, 3.5, -0.5], dtype=dtype)
        for i, amax in enumerate(STRESS_AMAX):
            x[2 + i] = _stress_row(k, dtype, amax).to(dev)
    n0 = K.quantize_rows_pass_launches()
    q, s = _twice(lambda: K.quantize_rows(x))
    n1 = K.quantize_rows_pass_launches()
    assert {w: n1[w] - n0[w] for w in n1 if n1[w] != n0[w]} == (
        {k: 2} if k % 256 == 0 else {})
    rq, rs = K.quantize_rows_reference(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, rq) and torch.equal(s, rs)
    if m > 1:
        assert q[0, :4].tolist() == [127, 2, 4, 0]
        assert (q[1] == 0).all()


# The int8 GEMMs' rows: one to 8192, around the s8 wgmma kernel's 192-row
# tile (193) and off it; depths beside the encoder's: K = 192 half-fills
# the 128-deep s8 stage.
I8_M = [1, 60, 193, 300, 8192]


def _twice(fn):
    """The launch's outputs, held bit-equal to a second launch's."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (first, second))):
        assert torch.equal(a, b)
    return first


@pytest.mark.parametrize("k192", [False, True], ids=["k", "k192"])
@pytest.mark.parametrize("epi", ["none", "gelu", "residual"])
@pytest.mark.parametrize("m", I8_M)
def test_gemm_i8_epilogues(dev, m, epi, k192):
    k, n = (3072, 768) if epi == "residual" else (768, 2304)
    k = 192 if k192 else k
    xq, xs = K.quantize_rows(_rand(dev, m, k, seed=m + 1))
    wq, ws = _i8_weight(dev, k, n, seed=m + 2)
    b = _rand(dev, n, std=0.1, dtype=torch.float32, seed=m + 3)
    if epi == "residual":
        r = _rand(dev, m, n, seed=m + 4)
        got = _twice(lambda: K.gemm_i8_bias_residual(xq, xs, wq, ws, b, r))
        want = K.gemm_i8_bias_residual_reference(xq, xs, wq, ws, b, r)
    else:
        got = _twice(lambda: K.gemm_i8_bias_act(xq, xs, wq, ws, b, epi))
        want = K.gemm_i8_bias_act_reference(xq, xs, wq, ws, b, epi)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if epi == "gelu":
        assert _ulps(got, want) <= 1.0
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_int8_blocks(dev, packed):
    from nbest_asr_tpu_torch.ops.int8_serving import (
        int8_attention_block, int8_attention_block_reference,
        int8_ffn_block, int8_ffn_block_reference)

    b, s, h = 3, 40, 256
    x = _rand(dev, b, s, h, seed=11)
    mask = torch.ones(b, s)
    if packed:
        mask[:, 13:27], mask[:, 27:35], mask[:, 35:] = 2.0, 3.0, 0.0
    else:
        mask[0, 30:] = 0.0
    mask = mask.to(dev)
    ln = (1 + _rand(dev, h, std=0.1, dtype=torch.float32, seed=12),
          _rand(dev, h, std=0.1, dtype=torch.float32, seed=13))
    attn = (x, *_i8_weight(dev, h, 3 * h, 14),
            _rand(dev, 3 * h, std=0.02, dtype=torch.float32, seed=15),
            *_i8_weight(dev, h, h, 16),
            _rand(dev, h, std=0.02, dtype=torch.float32, seed=17), *ln)
    got = int8_attention_block(*attn, mask, n_heads=4)
    torch.cuda.synchronize()
    _close(got, int8_attention_block_reference(*attn, mask, n_heads=4))
    ffn = (x, *_i8_weight(dev, h, 512, 18),
           _rand(dev, 512, std=0.02, dtype=torch.float32, seed=19),
           *_i8_weight(dev, 512, h, 20),
           _rand(dev, h, std=0.02, dtype=torch.float32, seed=21), *ln)
    got = int8_ffn_block(*ffn)
    torch.cuda.synchronize()
    _close(got, int8_ffn_block_reference(*ffn))


def _misaligned(t):
    """A contiguous copy of ``t`` whose address is one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def test_i8_wrappers_refuse_and_count(dev):
    """Dtypes, shapes and layouts the kernels do not take raise on CUDA
    tensors; nothing falls back to the plain version."""
    x = _rand(dev, 64, 256)
    xq, xs = K.quantize_rows(x)
    wq, ws = _i8_weight(dev, 256, 128, 30)
    b = torch.zeros(128, device=dev)
    r = _rand(dev, 64, 128)
    with pytest.raises(TypeError):
        K.quantize_rows(x.half())
    with pytest.raises(ValueError, match="K % 8"):
        K.quantize_rows(x[:, :250].contiguous())
    with pytest.raises(TypeError):
        K.gemm_i8_bias_act(xq.float(), xs, wq, ws, b)
    with pytest.raises(ValueError, match="column-major"):
        K.gemm_i8_bias_act(xq, xs, wq.contiguous(), ws, b)
    with pytest.raises(ValueError, match="N % 128"):
        K.gemm_i8_bias_act(xq, xs, wq[:, :64], ws[:64], b[:64])
    with pytest.raises(ValueError, match="K % 64"):
        K.gemm_i8_bias_act(xq[:, :96].contiguous(), xs, wq[:96], ws, b)
    with pytest.raises(TypeError, match="bf16"):
        K.gemm_i8_bias_act(xq, xs, wq, ws, b, out_dtype=torch.float32)
    with pytest.raises(TypeError):
        K.gemm_i8_bias_residual(xq, xs, wq, ws, b, r.float())
    # TMA and the 16-byte epilogue loads: operands off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_i8_bias_act(_misaligned(xq), xs, wq, ws, b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_i8_bias_act(xq, xs, wq, _misaligned(ws), b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_i8_bias_residual(_misaligned(xq), xs, wq, ws, b, r)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_i8_bias_residual(xq, xs, wq, ws, b, _misaligned(r))
    # without the GELU, the saved h is the output itself
    h, y = K.gemm_i8_bias_act(xq, xs, wq, ws, b, save_h=True)
    assert h is y
    _cuda.reset_launch_counts()
    K.quantize_rows(x)
    K.gemm_i8_bias_act(xq, xs, wq, ws, b, "gelu")
    K.gemm_i8_bias_residual(xq, xs, wq, ws, b, r)
    assert {k: v for k, v in _cuda.launch_counts.items() if v} == {
        "quantize_rows": 1, "gemm_i8_bias_act": 1,
        "gemm_i8_bias_residual": 1}


# --------------------------------------------------------------------- #
# FFN training kernels: Philox dropout epilogues, LN statistics, the
# backward row pass and the two dgrad epilogues.  Where the outputs are
# pure elementwise functions of the same inputs they are held bit for bit
# (or to one bf16 ulp where erff / expf meet torch.erf / torch.exp);
# GEMM and row-reduction outputs to the tolerance above.
# --------------------------------------------------------------------- #

def _drop(rate, stream, seed=1234):
    from nbest_asr_tpu_torch.ops.philox import site

    return site(seed, rate, stream)


def _keep_rate_ok(mask, rate):
    n = mask.numel()
    keep = mask.float().mean().item()
    assert abs(keep - (1 - rate)) <= 4 * ((rate * (1 - rate) / n) ** 0.5)


@pytest.mark.parametrize("m,hid,inter", [(300, 256, 512), (1, 384, 768),
                                          (60, 1024, 3072),
                                          (7688, 768, 3072),
                                          (8192, 4096, 2304)])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_dropout_epilogues(dev, rate, m, hid, inter):
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    x = _rand_dev(dev, m, hid, seed=40)
    w1 = _rand_dev(dev, hid, inter, std=0.05, seed=41)
    b1 = _rand_dev(dev, inter, std=0.1, dtype=torch.float32, seed=42)
    w2 = _rand_dev(dev, inter, hid, std=0.05, seed=43)
    b2 = _rand_dev(dev, hid, std=0.1, dtype=torch.float32, seed=44)
    d1, d2 = _drop(rate, 1), _drop(rate, 2)
    h, gd = K.gemm_bias_act(x, w1, b1, "gelu", drop=d1, save_h=True)
    s, y2d = K.gemm_bias_residual(gd, w2, b2, x, drop=d2, save_y2d=True)
    torch.cuda.synchronize()
    rh, rgd = K.gemm_bias_act_reference(x, w1, b1, "gelu", d1, True)
    rs, ry2d = K.gemm_bias_residual_reference(gd, w2, b2, x, d2, True)
    _close(h, rh)
    _close(gd, rgd)
    _close(s, rs)
    _close(y2d, ry2d)
    if rate > 0:
        k1 = keep_mask(1234, 1, 0, m, inter, rate, dev)
        k2 = keep_mask(1234, 2, 0, m, hid, rate, dev)
        assert (gd[~k1] == 0).all() and (y2d[~k2] == 0).all()
        _keep_rate_ok(k1, rate)
        _keep_rate_ok(k2, rate)
        # the dropped sum is the residual alone
        assert torch.equal(s[~k2], x.float()[~k2])


def test_layer_norm_stats(dev):
    s = _rand(dev, 300, 768, dtype=torch.float32, seed=45)
    g = 1 + _rand(dev, 768, std=0.1, dtype=torch.float32, seed=46)
    b = _rand(dev, 768, std=0.1, dtype=torch.float32, seed=47)
    y, mean, rstd = K.layer_norm_rows(s, g, b, 1e-12, stats=True)
    torch.cuda.synchronize()
    ry, rmean, rrstd = K.layer_norm_reference(s, g, b, 1e-12,
                                              torch.bfloat16, stats=True)
    assert mean.shape == rstd.shape == (300,)
    torch.testing.assert_close(mean, rmean, rtol=0, atol=1e-6)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=0)
    _close(y, ry)
    assert torch.equal(K.layer_norm_rows(s, g, b, 1e-12), y)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", [1, 60, 300])
def test_ffn_bwd_rows(dev, m, rate):
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    x = _rand(dev, m, 768, seed=50)
    y2d = _rand(dev, m, 768, seed=51)
    dy = _rand(dev, m, 768, seed=52)
    ls = 1 + _rand(dev, 768, std=0.1, dtype=torch.float32, seed=53)
    s = x.float() + y2d.float()
    mean = s.mean(1)
    rstd = torch.rsqrt(((s - mean[:, None]) ** 2).mean(1) + 1e-12)
    d2 = _drop(rate, 2)
    dy2, xhat, ds = K.ffn_bwd_rows(x, y2d, dy, ls, mean, rstd, drop=d2)
    torch.cuda.synchronize()
    rdy2, rxhat, rds = K.ffn_bwd_rows_reference(x, y2d, dy, ls, mean, rstd,
                                                d2)
    assert ds.dtype == torch.float32 and dy2.dtype == torch.bfloat16
    torch.testing.assert_close(ds, rds, rtol=0,
                               atol=1e-5 * rds.abs().max().item())
    assert _ulps(xhat, rxhat) <= 1.0
    _close(dy2, rdy2)
    if rate > 0:
        keep = keep_mask(1234, 2, 0, m, 768, rate, dev)
        assert (dy2[~keep] == 0).all()


@pytest.mark.parametrize("epilogue,rate", [("dgelu", 0.0), ("dgelu", 0.1),
                                          ("residual", 0.0)])
@pytest.mark.parametrize("n,k", GEMM_NK)
@pytest.mark.parametrize("m", GEMM_M)
def test_gemm_dgrad(dev, m, n, k, epilogue, rate):
    """a (m, k) @ w.T for w (n, k); the dgelu case's h comes from the
    forward GEMM (gemm_bias_act with GELU and the same stream-1 dropout),
    whose gd the backward regenerates bit for bit."""
    a = _rand_dev(dev, m, k, seed=60)                      # dy2 / dh
    w = _rand_dev(dev, n, k, std=0.05, seed=61)            # w2 / w1
    if epilogue == "dgelu":
        d1 = _drop(rate, 1)
        h, gd_fwd = K.gemm_bias_act(
            _rand_dev(dev, m, 256, seed=62),
            _rand_dev(dev, 256, n, std=0.1, seed=63),
            _rand_dev(dev, n, std=0.1, dtype=torch.float32, seed=64),
            "gelu", drop=d1, save_h=True)
        dh, gd = K.gemm_dgrad(a, w, "dgelu", h=h, drop=d1)
        torch.cuda.synchronize()
        rdh, rgd = K.gemm_dgrad_reference(a, w, "dgelu", h=h, drop=d1)
        _close(dh, rdh)
        assert torch.equal(gd, gd_fwd)
        assert torch.equal(gd == 0, rgd == 0)
        nz = rgd != 0
        assert _ulps(gd[nz], rgd[nz]) <= 1.0
    else:
        ds = _rand_dev(dev, m, n, dtype=torch.float32, seed=65)
        dx = K.gemm_dgrad(a, w, "residual", ds=ds)
        torch.cuda.synchronize()
        _close(dx, K.gemm_dgrad_reference(a, w, "residual", ds=ds))


def test_backward_regenerates_forward_masks(dev):
    """The dgelu epilogue's gd (regenerated from h and the stream-1 mask)
    equals the forward GEMM's gd bit for bit."""
    x = _rand(dev, 200, 768, seed=70)
    w1 = _rand(dev, 768, 3072, std=0.05, seed=71)
    b1 = _rand(dev, 3072, std=0.1, dtype=torch.float32, seed=72)
    w2 = _rand(dev, 3072, 768, std=0.05, seed=73)
    d1 = _drop(0.1, 1, seed=99)
    h, gd = K.gemm_bias_act(x, w1, b1, "gelu", drop=d1, save_h=True)
    _, gd2 = K.gemm_dgrad(_rand(dev, 200, 768, seed=74), w2, "dgelu", h=h,
                          drop=d1)
    torch.cuda.synchronize()
    assert torch.equal(gd, gd2)


def test_ffn_block_training_matches_autograd(dev):
    """The FFN autograd Function (five kernels, bf16) against torch
    autograd through the plain block on f32 copies of the same inputs,
    same Philox masks.  bf16 rounding of the activations moves outputs
    and gradients by < 0.5% of their largest (mean < 0.4% of their mean
    magnitude); a wrong mask or epilogue moves them by > 10%."""
    from nbest_asr_tpu_torch.ops.fused_ffn import (fused_ffn_block,
                                                   fused_ffn_block_reference)

    x = _rand(dev, 4, 50, 768, seed=80)
    ps = [_rand(dev, 768, 3072, std=0.02, seed=81),
          _rand(dev, 3072, std=0.02, dtype=torch.float32, seed=82),
          _rand(dev, 3072, 768, std=0.02, seed=83),
          _rand(dev, 768, std=0.02, dtype=torch.float32, seed=84),
          1 + _rand(dev, 768, std=0.1, dtype=torch.float32, seed=85),
          _rand(dev, 768, std=0.1, dtype=torch.float32, seed=86)]
    dy = _rand(dev, 4, 50, 768, seed=87)
    outs = []
    for fn, f32 in ((fused_ffn_block, False),
                    (fused_ffn_block_reference, True)):
        args = [(t.float() if f32 else t).clone().requires_grad_(True)
                for t in [x] + ps]
        y = fn(*args, dropout_rate=0.1, seed=5)
        y.backward(dy.float() if f32 else dy)
        outs.append([y.detach()] + [a.grad for a in args])
    for got, want in zip(*outs):
        assert got.dtype == (torch.float32 if want.dim() == 1
                             else torch.bfloat16)
        d = (got.float() - want).abs()
        assert d.max().item() <= 2e-2 * want.abs().max().item()
        assert d.mean().item() <= 1e-2 * want.abs().mean().item()


def test_train_wrappers_refuse_and_count(dev):
    a = _rand(dev, 64, 768)
    w2 = _rand(dev, 3072, 768)
    h = _rand(dev, 64, 3072)
    with pytest.raises(TypeError):
        K.gemm_dgrad(a.float(), w2, "dgelu", h=h)
    with pytest.raises(ValueError, match="needs h"):
        K.gemm_dgrad(a, w2, "dgelu")
    with pytest.raises(ValueError, match="shape"):
        K.gemm_dgrad(a, w2, "dgelu", h=h[:, :1024].contiguous())
    with pytest.raises(ValueError, match="epilogue"):
        K.gemm_dgrad(a, w2, "gelu", h=h)
    with pytest.raises(TypeError):
        K.gemm_dgrad(h, _rand(dev, 768, 3072), "residual",
                     ds=a.contiguous())
    with pytest.raises(ValueError, match="N % 128"):
        K.ffn_bwd_rows(*(a[:, :96].contiguous(),) * 3,
                       torch.ones(96, device=dev),
                       torch.zeros(64, device=dev),
                       torch.ones(64, device=dev))
    with pytest.raises(TypeError):
        K.ffn_bwd_rows(a, a, a.float(), torch.ones(768, device=dev),
                       torch.zeros(64, device=dev),
                       torch.ones(64, device=dev))
    with pytest.raises(ValueError, match="GELU"):
        K.gemm_bias_act(a, w2.t().contiguous(), torch.zeros(3072,
                                                            device=dev),
                        drop=_drop(0.1, 1))
    # the TMA kernel refuses an operand off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_dgrad(_rand(dev, 64 * 768 + 1)[1:].view(64, 768), w2,
                     "dgelu", h=h)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_dgrad(a, w2, "dgelu",
                     h=_rand(dev, 64 * 3072 + 1)[1:].view(64, 3072))
    _cuda.reset_launch_counts()
    K.gemm_dgrad(a, w2, "dgelu", h=h)
    K.ffn_bwd_rows(a, a, a, torch.ones(768, device=dev),
                   torch.zeros(64, device=dev), torch.ones(64, device=dev))
    assert {k: v for k, v in _cuda.launch_counts.items() if v} == {
        "gemm_dgrad": 1, "ffn_bwd_rows": 1}


# --------------------------------------------------------------------- #
# attention training kernels: seg_attention's prob dropout and row
# statistics, seg_attention_bwd, the "none" dgrad epilogue.  The
# backward's outputs are sums of bf16-rounded products of probs that the
# kernel and the plain version compute in other orders, so they are held
# to two bf16 ulps of the largest value and, on average, to 1/64 of the
# mean magnitude.
# --------------------------------------------------------------------- #

def _close_rel(got, want):
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    assert d.max().item() <= 2.0 ** -6 * w.max().item()
    assert d.mean().item() <= 2.0 ** -6 * w.mean().item()


def _attn_mask(dev, b, s, packed):
    mask = torch.ones(b, s)
    if packed:
        mask[:, s // 3: 2 * s // 3], mask[:, 2 * s // 3:] = 2.0, 0.0
    else:
        mask[0, s - s // 4:] = 0.0
    return mask.to(dev)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("s,d", ATTN_SD)
def test_seg_attention_dropout_and_stats(dev, s, d, packed, rate):
    """ctx held to the plain version's; the statistics to its row max and
    sum of exp."""
    b, nh = (3, 4) if s < 256 else (2, 12 if d == 64 else 4)
    h = nh * d
    qkv = _rand(dev, b * s, 3 * h, std=0.5, seed=s + d)
    mask = _attn_mask(dev, b, s, packed)
    drop = _drop(rate, 3)
    ctx, st = K.seg_attention(qkv, mask, nh, drop=drop, stats=True)
    torch.cuda.synchronize()
    rctx, rst = K.seg_attention_reference(qkv, mask, nh, drop, stats=True)
    _close(ctx, rctx)
    assert st.shape == (2, b, nh, s)
    torch.testing.assert_close(st, rst, rtol=1e-5, atol=1e-6)
    assert torch.equal(K.seg_attention(qkv, mask, nh, drop=drop), ctx)


@pytest.mark.parametrize("layout", ["qkv", "bshd"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [20, 64, 96, 160, 256, 512])
def test_seg_attention_bwd(dev, s, d, packed, rate, layout):
    """dq, dk, dv against the plain backward, on the (n, 3h) QKV buffer's
    column blocks or on route A's standalone (b, s, heads, d) tensors;
    two runs give bit-equal gradients (ordered sums, no atomics); d = 64
    at s <= 256 runs the wgmma pair, every other shape the mma.sync
    pair."""
    b, nh = 2, 4
    h = nh * d
    mask = _attn_mask(dev, b, s, packed)
    drop = _drop(rate, 3)
    if layout == "qkv":
        qkv = _rand(dev, b * s, 3 * h, std=0.5, seed=s + d)
        dctx = _rand(dev, b * s, h, std=0.1, seed=s + d + 1)
        _, st = K.seg_attention(qkv, mask, nh, drop=drop, stats=True)

        def run():
            return K.seg_attention_bwd(qkv, dctx, mask, st, nh, drop=drop)

        def want():
            w = K.seg_attention_bwd_reference(qkv, dctx, mask, st, nh, drop)
            return [w[:, i * h:(i + 1) * h] for i in range(3)]
    else:
        q, k, v, do = _bshd_operands(dev, b, s, nh, d, False, seed=s + d)
        sc = 1.0 / d ** 0.5
        _, st = K.sb_attention(q, k, v, mask, sc, drop, stats=True)

        def run():
            return torch.cat([g.reshape(b * s, h) for g in K.sb_attention_bwd(
                q, k, v, do, mask, st, sc, drop)], dim=1)

        def want():
            return K.sb_attention_bwd_reference(q, k, v, do, mask, st, sc,
                                                drop)
    n0 = K.seg_attention_bwd_wgmma_launches()
    got = run()
    torch.cuda.synchronize()
    assert K.seg_attention_bwd_wgmma_launches() - n0 == int(
        d == 64 and s <= 256)
    for part, w in enumerate(want()):              # dq, dk, dv
        _close_rel(got[:, part * h:(part + 1) * h], w.reshape(b * s, h))
    assert torch.equal(run(), got)


@pytest.mark.parametrize("onehot_k", [True, False])
def test_attention_backward_regenerates_the_forward_prob_mask(dev, onehot_k):
    """With one-hot V (row k = e_k, s = d = 64) the forward's ctx is the
    dropped probs rounded to bf16, and the dK/dV kernel's dV for one-hot
    dO their transpose as the backward rebuilds them: both are 0 exactly
    where the stream-3 keep bits drop.  With one-hot K too, the dQ
    kernel's dq (for dO = 1) is negative exactly where a prob was dropped.
    With random K too, the backward (the wgmma pair at d = 64) rebuilds
    the forward's scores on the forward's own products: its bf16 probs
    equal the forward's, with no element that differs."""
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    b, s, nh, d = 2, 64, 2, 64
    h = nh * d
    qkv = _rand(dev, b * s, 3 * h, std=0.5, seed=90)
    eye = torch.eye(s, device=dev, dtype=torch.bfloat16)
    for hd in range(nh):
        for part in (1, 2) if onehot_k else (2,):
            c0 = part * h + hd * d
            qkv[:, c0:c0 + d] = eye.repeat(b, 1)
    mask = torch.ones(b, s, device=dev)
    drop = _drop(0.1, 3, seed=4321)
    keep = keep_mask(4321, 3, 0, b * nh * s, s, 0.1, dev).reshape(b, nh, s,
                                                                    s)
    ctx, st = K.seg_attention(qkv, mask, nh, drop=drop, stats=True)
    d_v = K.seg_attention_bwd(qkv, eye.repeat(b, nh).contiguous(), mask, st,
                              nh, drop=drop)
    d_q = K.seg_attention_bwd(qkv, torch.ones_like(ctx), mask, st, nh,
                              drop=drop)
    torch.cuda.synchronize()
    p_fwd = ctx.reshape(b, s, nh, d).permute(0, 2, 1, 3)
    p_bwd = d_v[:, 2 * h:].reshape(b, s, nh, d).permute(0, 2, 3, 1)
    assert torch.equal(p_fwd != 0, keep)
    assert torch.equal(p_bwd != 0, keep)
    n_diff = int((p_fwd != p_bwd).sum())
    print(f"rebuilt probs (one-hot K: {onehot_k}): {n_diff} of "
          f"{keep.numel()} differ in bf16, max "
          f"{_ulps(p_bwd[keep], p_fwd[keep]):.0f} ulp")
    assert n_diff == 0
    if onehot_k:
        # a kept prob's ds is p * inv_keep * (1 - kept mass) >= 0 (~1e-10
        # where the whole row is kept), a dropped one's -p * inv_keep *
        # kept mass
        dq = d_q[:, :h].reshape(b, s, nh, d).permute(0, 2, 1, 3) > -1e-6
        assert torch.equal(dq, keep)


@pytest.mark.parametrize("n,k", GEMM_NK)
@pytest.mark.parametrize("m", GEMM_M)
def test_gemm_dgrad_none(dev, m, n, k):
    a = _rand_dev(dev, m, k, seed=95)
    w = _rand_dev(dev, n, k, std=0.05, seed=96)
    out = K.gemm_dgrad(a, w, "none")
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    _close(out, K.gemm_dgrad_reference(a, w, "none"))


@pytest.mark.parametrize("packed", [False, True])
def test_attention_block_training_matches_autograd(dev, packed):
    """The attention autograd Function (kernels, bf16) against torch
    autograd through the plain block on f32 copies of the same inputs,
    same Philox masks: the output and all seven gradients within 2% of
    their largest value, mean within 1% of their mean magnitude."""
    from nbest_asr_tpu_torch.ops.fused_attention import (
        fused_attention_block, fused_attention_block_reference)

    b, s = 4, 50
    x = _rand(dev, b, s, 768, seed=100)
    ps = [_rand(dev, 768, 3 * 768, std=0.02, seed=101),
          _rand(dev, 3 * 768, std=0.02, dtype=torch.float32, seed=102),
          _rand(dev, 768, 768, std=0.02, seed=103),
          _rand(dev, 768, std=0.02, dtype=torch.float32, seed=104),
          1 + _rand(dev, 768, std=0.1, dtype=torch.float32, seed=105),
          _rand(dev, 768, std=0.1, dtype=torch.float32, seed=106)]
    mask = _attn_mask(dev, b, s, packed)
    dy = _rand(dev, b, s, 768, seed=107)
    outs = []
    for fn, f32 in ((fused_attention_block, False),
                    (fused_attention_block_reference, True)):
        args = [(t.float() if f32 else t).clone().requires_grad_(True)
                for t in [x] + ps]
        y = fn(*args, mask, n_heads=12, attn_dropout=0.1,
               hidden_dropout=0.1, seed=5)
        y.backward(dy.float() if f32 else dy)
        outs.append([y.detach()] + [a.grad for a in args])
    for got, want in zip(*outs):
        assert got.dtype == (torch.float32 if want.dim() == 1
                             else torch.bfloat16)
        d = (got.float() - want).abs()
        assert d.max().item() <= 2e-2 * want.abs().max().item()
        assert d.mean().item() <= 1e-2 * want.abs().mean().item()


def test_attention_train_wrappers_refuse_and_count(dev):
    from nbest_asr_tpu_torch.ops.fused_attention import fused_attention_block

    qkv = _rand(dev, 64, 3 * 256)
    mask = torch.ones(2, 32, device=dev)
    _, st = K.seg_attention(qkv, mask, 4, stats=True)
    with pytest.raises(TypeError):
        K.seg_attention_bwd(qkv, qkv[:, :256].float().contiguous(), mask,
                            st, 4)
    with pytest.raises(ValueError, match="shape"):
        K.seg_attention_bwd(qkv, qkv[:, :256].contiguous(), mask, st[:, :1],
                            4)
    with pytest.raises(ValueError, match="head dims"):
        K.seg_attention_bwd(qkv, qkv[:, :256].contiguous(), mask, st, 16)
    with pytest.raises(ValueError, match="no dropout"):
        K.gemm_dgrad(qkv[:, :256].contiguous(), _rand(dev, 256, 256), "none",
                     drop=_drop(0.1, 4))
    x = _rand(dev, 2, 32, 256).requires_grad_(True)
    w = [_rand(dev, 256, 768), torch.zeros(768, device=dev),
         _rand(dev, 256, 256), torch.zeros(256, device=dev),
         torch.ones(256, device=dev), torch.zeros(256, device=dev)]
    _cuda.reset_launch_counts()
    y = fused_attention_block(x, *w, mask, n_heads=4, attn_dropout=0.1,
                              hidden_dropout=0.1, seed=3)
    y.backward(torch.ones_like(y))
    assert {k: v for k, v in _cuda.launch_counts.items() if v} == {
        "gemm_bias_act": 1, "seg_attention": 1, "gemm_bias_residual": 1,
        "layer_norm": 1, "ffn_bwd_rows": 1, "gemm_dgrad": 2,
        "seg_attention_bwd": 1}


# --------------------------------------------------------------------- #
# int8 training kernels: the dropout / saved-residual epilogues of the two
# int8 forward GEMMs, the gradient quant and the three int8 dgrad
# epilogues -- bit for bit where the integer dot and the same f32
# operations decide (one bf16 ulp, or 1e-6 relative in f32, where erff /
# expf meet torch.erf / torch.exp) -- and both int8 blocks, both
# backwards, against the same Function on the kernels' plain versions.
# The attention kernels' d = 192 and 256 instances against their plain
# versions.
# --------------------------------------------------------------------- #

def _i8_train_weight(dev, k, n, seed):
    """(q column-major, q row-major, scale) of a bf16 weight, as the int8
    training blocks quantize it."""
    from nbest_asr_tpu_torch.ops.quant import quantize_train_weight

    return quantize_train_weight(_rand(dev, k, n, std=0.05, seed=seed))


@pytest.mark.parametrize("k", [768, 192])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", I8_M)
def test_gemm_i8_train_epilogues(dev, m, rate, k):
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    xq, xs = K.quantize_rows(_rand(dev, m, k, seed=m + 110))
    w1q, _, w1s = _i8_train_weight(dev, k, 3072, m + 111)
    b1 = _rand(dev, 3072, std=0.1, dtype=torch.float32, seed=m + 112)
    d1, d2 = _drop(rate, 1), _drop(rate, 2)
    h, gd = _twice(lambda: K.gemm_i8_bias_act(xq, xs, w1q, w1s, b1, "gelu",
                                              drop=d1, save_h=True))
    torch.cuda.synchronize()
    rh, rgd = K.gemm_i8_bias_act_reference(xq, xs, w1q, w1s, b1, "gelu",
                                           torch.bfloat16, d1, True)
    assert torch.equal(h, rh)
    assert torch.equal(gd == 0, rgd == 0)
    assert _ulps(gd[rgd != 0], rgd[rgd != 0]) <= 1.0
    gq, gs = K.quantize_rows(gd)
    w2q, _, w2s = _i8_train_weight(dev, 3072, 768, m + 113)
    b2 = _rand(dev, 768, std=0.1, dtype=torch.float32, seed=m + 114)
    x = _rand(dev, m, 768, seed=m + 115)
    s, y2d = _twice(lambda: K.gemm_i8_bias_residual(
        gq, gs, w2q, w2s, b2, x, drop=d2, save_y2d=True))
    torch.cuda.synchronize()
    rs, ry2d = K.gemm_i8_bias_residual_reference(gq, gs, w2q, w2s, b2, x,
                                                 d2, True)
    assert torch.equal(s, rs) and torch.equal(y2d, ry2d)
    if rate > 0:
        assert (gd[~keep_mask(1234, 1, 0, m, 3072, rate, dev)] == 0).all()
        assert (y2d[~keep_mask(1234, 2, 0, m, 768, rate, dev)] == 0).all()


# gemm_i8_bias_residual's (N, K): the out-proj, W2, and a wider N with K =
# 192, which half-fills the 128-deep s8 stage
I8_RESIDUAL_NK = [(768, 768), (768, 3072), (1024, 192)]


@pytest.mark.parametrize("save_y2d", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,k", I8_RESIDUAL_NK)
@pytest.mark.parametrize("m", I8_M)
def test_gemm_i8_bias_residual(dev, m, n, k, rate, save_y2d):
    """The s8 wgmma residual launch bit for bit against its plain version:
    serving's instance (no dropout, no y2d) and the training one (dropout,
    y2d or both)."""
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    xq, xs = K.quantize_rows(_rand_dev(dev, m, k, seed=m + k))
    wq, ws = _i8_weight(dev, k, n, seed=n + k)
    b = _rand(dev, n, std=0.1, dtype=torch.float32, seed=n)
    r = _rand_dev(dev, m, n, seed=m + n + 1)
    drop = _drop(rate, 2) if rate else None
    got = _twice(lambda: K.gemm_i8_bias_residual(xq, xs, wq, ws, b, r,
                                                 drop=drop,
                                                 save_y2d=save_y2d))
    want = K.gemm_i8_bias_residual_reference(xq, xs, wq, ws, b, r, drop,
                                             save_y2d)
    got, want = ((o if save_y2d else (o,)) for o in (got, want))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    if rate and save_y2d:
        assert (got[1][~keep_mask(1234, 2, 0, m, n, rate, dev)] == 0).all()


# the widths of a layer's four gradient quantizations (768, 3072, 768,
# 2304: the row pass) and one the row pass does not take
@pytest.mark.parametrize("stress", [False, True], ids=["rand", "stress"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,k", [(1, 768), (60, 3072), (300, 2304),
                                 (8192, 768), (8192, 3072), (300, 776)])
def test_quantize_grad_rows(dev, m, k, rate, dtype, stress):
    """q and scale bit-equal to the plain version, with and without the
    stream-4 dropout; K = 256 n on the gradient row pass (its counter), 776
    on the two-pass kernel.  ``stress``: ws all ones, so that the folded
    rows are the stress rows of ``test_quantize_rows`` (quotients on and
    beside the ties, |x| < 2^-90) and one all-zero row."""
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    g = _rand(dev, m, k, std=1e-3, dtype=dtype, seed=m + 120)
    ws = _rand(dev, k, std=1e-3, dtype=torch.float32, seed=m + 121).abs()
    if stress:
        ws = torch.ones_like(ws)
        if m > 1:
            g[1] = 0.0
            for i, amax in enumerate(STRESS_AMAX[:m - 2]):
                g[2 + i] = _stress_row(k, dtype, amax).to(dev)
    drop = _drop(rate, 4)
    n0 = K.quantize_grad_rows_pass_launches()
    q, s = _twice(lambda: K.quantize_grad_rows(g, ws, drop))
    n1 = K.quantize_grad_rows_pass_launches()
    assert {w: n1[w] - n0[w] for w in n1 if n1[w] != n0[w]} == (
        {k: 2} if k % 256 == 0 else {})
    rq, rs = K.quantize_grad_rows_reference(g, ws, drop)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, rq) and torch.equal(s, rs)
    if stress and m > 1:
        assert (q[1] == 0).all()
    if rate > 0:
        assert (q[~keep_mask(1234, 4, 0, m, k, rate, dev)] == 0).all()


@pytest.mark.parametrize("k192", [False, True], ids=["k", "k192"])
@pytest.mark.parametrize("epilogue,rate", [("dgelu", 0.1), ("dgelu", 0.0),
                                           ("residual", 0.0),
                                           ("none", 0.0)])
@pytest.mark.parametrize("m", I8_M)
def test_gemm_i8_dgrad(dev, m, epilogue, rate, k192):
    n_in, n_out = {"dgelu": (3072, 768), "residual": (768, 3072),
                   "none": (768, 768)}[epilogue]
    n_out = 192 if k192 else n_out       # the dgrad's depth K
    _, wr, ws = _i8_train_weight(dev, n_in, n_out, m + 130)
    gq, gs = K.quantize_grad_rows(_rand(dev, m, n_out, std=1e-3,
                                        dtype=torch.float32, seed=m + 131),
                                  ws)
    if epilogue == "dgelu":
        h = _rand(dev, m, n_in, seed=m + 132)
        d1 = _drop(rate, 1)
        dh, dh32, gd = _twice(lambda: K.gemm_i8_dgrad(gq, gs, wr, "dgelu",
                                                      h=h, drop=d1))
        torch.cuda.synchronize()
        rdh, rdh32, rgd = K.gemm_i8_dgrad_reference(gq, gs, wr, "dgelu", h=h,
                                                    drop=d1)
        assert torch.equal(dh32 == 0, rdh32 == 0)
        # gelu'(h) cancels near h = -0.75, so the f32 dh is held to the
        # scale of the tensor: erff / expf against torch.erf / torch.exp
        torch.testing.assert_close(dh32, rdh32, rtol=0,
                                   atol=1e-6 * rdh32.abs().max().item())
        assert _ulps(dh[rdh != 0], rdh[rdh != 0]) <= 1.0
        assert torch.equal(gd == 0, rgd == 0)
        assert _ulps(gd[rgd != 0], rgd[rgd != 0]) <= 1.0
    elif epilogue == "residual":
        ds = _rand(dev, m, n_in, dtype=torch.float32, seed=m + 133)
        dx = _twice(lambda: K.gemm_i8_dgrad(gq, gs, wr, "residual", ds=ds))
        torch.cuda.synchronize()
        assert torch.equal(dx, K.gemm_i8_dgrad_reference(gq, gs, wr,
                                                         "residual", ds=ds))
    else:
        out = _twice(lambda: K.gemm_i8_dgrad(gq, gs, wr, "none"))
        torch.cuda.synchronize()
        assert torch.equal(out, K.gemm_i8_dgrad_reference(gq, gs, wr,
                                                          "none"))


def _hold_blocks(outs):
    """Kernel chain's output and gradients against the plain chain's on
    the same bf16 inputs: an int8 rounding that a one-ulp GELU difference
    flips moves a few values, so 2% of the largest value and 1% of the
    mean magnitude, as the bf16 blocks are held."""
    for got, want in zip(*outs):
        assert got.dtype == want.dtype
        d = (got.float() - want.float()).abs()
        assert d.max().item() <= 2e-2 * want.float().abs().max().item()
        assert d.mean().item() <= 1e-2 * want.float().abs().mean().item()


def _block_outs(fn, tensors, dy, *extra, **kw):
    args = [t.clone().requires_grad_(True) for t in tensors]
    y = fn(*args, *extra, **kw)
    y.backward(dy)
    return [y.detach()] + [a.grad for a in args]


@pytest.mark.parametrize("int8_bwd", [False, True])
def test_int8_train_blocks_match_their_plain_chains(dev, int8_bwd):
    from nbest_asr_tpu_torch.ops.fused_attention import (
        fused_attention_block_int8_train,
        fused_attention_block_int8_train_reference)
    from nbest_asr_tpu_torch.ops.fused_ffn import (
        fused_ffn_block_int8_train, fused_ffn_block_int8_train_reference)

    b, s = 4, 50
    x = _rand(dev, b, s, 768, seed=140)
    dy = _rand(dev, b, s, 768, seed=141)
    ln = [1 + _rand(dev, 768, std=0.1, dtype=torch.float32, seed=142),
          _rand(dev, 768, std=0.1, dtype=torch.float32, seed=143)]
    ffn = [x, _rand(dev, 768, 3072, std=0.02, seed=144),
           _rand(dev, 3072, std=0.02, dtype=torch.float32, seed=145),
           _rand(dev, 3072, 768, std=0.02, seed=146),
           _rand(dev, 768, std=0.02, dtype=torch.float32, seed=147), *ln]
    kw = dict(dropout_rate=0.1, seed=5, int8_bwd=int8_bwd)
    _hold_blocks([_block_outs(fn, ffn, dy, **kw) for fn in (
        fused_ffn_block_int8_train, fused_ffn_block_int8_train_reference)])
    attn = [x, _rand(dev, 768, 3 * 768, std=0.02, seed=148),
            _rand(dev, 3 * 768, std=0.02, dtype=torch.float32, seed=149),
            _rand(dev, 768, 768, std=0.02, seed=150),
            _rand(dev, 768, std=0.02, dtype=torch.float32, seed=151), *ln]
    mask = _attn_mask(dev, b, s, packed=True)
    kw = dict(n_heads=12, attn_dropout=0.1, hidden_dropout=0.1, seed=5,
              int8_bwd=int8_bwd)
    _hold_blocks([_block_outs(fn, attn, dy, mask, **kw) for fn in (
        fused_attention_block_int8_train,
        fused_attention_block_int8_train_reference)])


def test_int8_train_wrappers_refuse_and_count(dev):
    from nbest_asr_tpu_torch.ops.fused_ffn import fused_ffn_block_int8_train

    g = _rand(dev, 64, 768, dtype=torch.float32)
    _, wr, ws = _i8_train_weight(dev, 3072, 768, 160)
    gq, gs = K.quantize_grad_rows(g, ws)
    with pytest.raises(TypeError):
        K.quantize_grad_rows(g.half(), ws)
    with pytest.raises(ValueError, match="shape"):
        K.quantize_grad_rows(g, ws[:512])
    with pytest.raises(ValueError, match="needs h"):
        K.gemm_i8_dgrad(gq, gs, wr, "dgelu")
    with pytest.raises(ValueError, match="no dropout"):
        K.gemm_i8_dgrad(gq, gs, wr, "none", drop=_drop(0.1, 1))
    with pytest.raises(ValueError, match="shape"):
        K.gemm_i8_dgrad(gq, gs, wr.t().contiguous(), "none")
    with pytest.raises(TypeError, match="bf16"):
        K.gemm_i8_dgrad(gq, gs, wr, "none", out_dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_i8_dgrad(_misaligned(gq), gs, wr, "none")
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_i8_dgrad(gq, gs, wr, "dgelu",
                        h=_misaligned(_rand(dev, 64, 3072)))
    x = _rand(dev, 2, 32, 768).requires_grad_(True)
    w = [_rand(dev, 768, 3072, std=0.02), torch.zeros(3072, device=dev),
         _rand(dev, 3072, 768, std=0.02), torch.zeros(768, device=dev),
         torch.ones(768, device=dev), torch.zeros(768, device=dev)]
    for int8_bwd, want in (
            (True, {"quantize_rows": 2, "gemm_i8_bias_act": 1,
                    "gemm_i8_bias_residual": 1, "layer_norm": 1,
                    "ffn_bwd_rows": 1, "quantize_grad_rows": 2,
                    "gemm_i8_dgrad": 2}),
            (False, {"quantize_rows": 2, "gemm_i8_bias_act": 1,
                     "gemm_i8_bias_residual": 1, "layer_norm": 1,
                     "ffn_bwd_rows": 1, "gemm_bias_act": 1,
                     "gemm_dgrad": 2})):
        _cuda.reset_launch_counts()
        y = fused_ffn_block_int8_train(x, *w, dropout_rate=0.1, seed=3,
                                       int8_bwd=int8_bwd)
        y.backward(torch.ones_like(y))
        assert {k: v for k, v in _cuda.launch_counts.items() if v} == want


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("s", [20, 130])
def test_seg_attention_wide_heads(dev, s, d):
    """The d = 192 and 256 instances (head dims JAX sends to its
    megakernels, e.g. hidden 384 with 2 heads) against their plain
    versions, forward with dropout and statistics, and backward."""
    b, nh = 2, 2
    h = nh * d
    qkv = _rand(dev, b * s, 3 * h, std=0.5, seed=s + d + 170)
    dctx = _rand(dev, b * s, h, std=0.1, seed=s + d + 171)
    mask = _attn_mask(dev, b, s, packed=True)
    drop = _drop(0.1, 3)
    ctx, st = K.seg_attention(qkv, mask, nh, drop=drop, stats=True)
    got = K.seg_attention_bwd(qkv, dctx, mask, st, nh, drop=drop)
    torch.cuda.synchronize()
    rctx, rst = K.seg_attention_reference(qkv, mask, nh, drop, stats=True)
    _close(ctx, rctx)
    torch.testing.assert_close(st, rst, rtol=1e-5, atol=1e-6)
    want = K.seg_attention_bwd_reference(qkv, dctx, mask, st, nh, drop)
    for part in range(3):
        cols = slice(part * h, (part + 1) * h)
        _close_rel(got[:, cols], want[:, cols])
    _close(K.seg_attention(qkv, mask, nh), K.seg_attention_reference(
        qkv, mask, nh))


# --------------------------------------------------------------------- #
# the flash route: the widened single-block kernels on (b, s, heads, d)
# operands (views of one QKV buffer and standalone tensors, d = 32 too)
# and the tiled kernels, at any s, against their plain versions; the
# tiled kernels forced at s = 256 draw the single-block kernels' mask.
# --------------------------------------------------------------------- #

def _bshd_operands(dev, b, s, nh, d, views, seed):
    if views:                      # split views of one (b*s, 3h) buffer
        qkv = _rand(dev, b * s, 3 * nh * d, std=0.5, seed=seed)
        q, k, v = qkv.view(b, s, 3, nh, d).unbind(2)
    else:
        q, k, v = (_rand(dev, b, s, nh, d, std=0.5, seed=seed + i)
                   for i in range(3))
    return q, k, v, _rand(dev, b, s, nh, d, std=0.1, seed=seed + 3)


@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_sb_attention_strided(dev, d, views, rate):
    b, s, nh = 3, 150, 4
    q, k, v, do = _bshd_operands(dev, b, s, nh, d, views, seed=d + 200)
    mask = _attn_mask(dev, b, s, packed=True)
    drop, sc = _drop(rate, 3), 0.3
    o, st = K.sb_attention(q, k, v, mask, sc, drop, stats=True)
    grads = K.sb_attention_bwd(q, k, v, do, mask, st, sc, drop)
    torch.cuda.synchronize()
    ro, rst = K.sb_attention_reference(q, k, v, mask, sc, drop, stats=True)
    _close(o, ro)
    torch.testing.assert_close(st, rst, rtol=1e-5, atol=1e-6)
    for got, want in zip(grads, K.sb_attention_bwd_reference(
            q, k, v, do, mask, st, sc, drop)):
        _close_rel(got, want)


# the tiled kernels' cases (s, d, q / k / v as QKV views, dropout rate):
# d = 64 (the wgmma + TMA backward pair) at four lengths, both layouts,
# with and without dropout; d = 32 and 128 (the mma.sync pair)
FLASH_TILED_CASES = [(s, 64, views, rate) for s in (100, 700, 1024, 2048)
                     for views in (False, True) for rate in (0.0, 0.1)] + [
    (s, d, s == 700, 0.1) for d in (32, 128) for s in (100, 700)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("s,d,views,rate", FLASH_TILED_CASES)
def test_flash_tiled_kernels(dev, s, d, views, rate, packed):
    """The tiled kernels against their plain versions; the backward pair
    twice, bit for bit (ordered sums, no atomics); all three on their
    wgmma + TMA kernels exactly at d = 64."""
    b, nh = 2, 4
    q, k, v, do = _bshd_operands(dev, b, s, nh, d, views, seed=s + d)
    mask = _attn_mask(dev, b, s, packed)
    drop, sc = _drop(rate, 3), 1.0 / d ** 0.5
    n0 = K.flash_wgmma_launches()
    o, lse = K.flash_fwd(q, k, v, mask, sc, drop)

    def bwd():
        dq, di = K.flash_bwd_dq(q, k, v, mask, o, lse, do, sc, drop)
        return (dq, di, *K.flash_bwd_dkv(q, k, v, mask, lse, di, do, sc,
                                         drop))

    dq, di, dk, dv = bwd()
    torch.cuda.synchronize()
    n1 = K.flash_wgmma_launches()
    assert {n: n1[n] - n0[n] for n in n1} == {
        "flash_fwd": int(d == 64), "flash_bwd_dq": int(d == 64),
        "flash_bwd_dkv": int(d == 64)}
    ro, rlse = K.flash_fwd_reference(q, k, v, mask, sc, drop)
    _close(o, ro)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    rdq, rdi = K.flash_bwd_dq_reference(q, k, v, mask, o, lse, do, sc, drop)
    torch.testing.assert_close(di, rdi, rtol=1e-4,
                               atol=1e-5 * rdi.abs().max().item())
    _close_rel(dq, rdq)
    for got, want in zip((dk, dv), K.flash_bwd_dkv_reference(
            q, k, v, mask, lse, di, do, sc, drop)):
        _close_rel(got, want)
    for got, again in zip((dq, di, dk, dv), bwd()):
        assert torch.equal(got, again)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_tiled_draws_the_single_block_mask(dev, d):
    """At s = 256 the forced tiled route and the single-block route drop
    the same probs: with four packed segments of 64 and v one-hot within
    a segment (d = 64), o != 0 is the stream-3 keep mask on the diagonal
    blocks for both; at every d both routes' outputs and gradients agree
    within the kernels' tolerance."""
    from nbest_asr_tpu_torch.ops.flash_attention import flash_attention
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    b, s, nh, rate, seed = 2, 256, 2, 0.1, 4321
    mask = (torch.arange(s, device=dev) // 64 + 1).float()[None].repeat(b, 1)
    q, k, v, do = _bshd_operands(dev, b, s, nh, d, False, seed=d + 300)
    if d == 64:
        eye = torch.eye(64, device=dev, dtype=torch.bfloat16)
        v = eye.repeat(4, 1)[None, :, None, :].expand(b, s, nh, d)
    outs = []
    for kw in ({}, dict(block_q=128, block_k=128)):
        qq, kk, vv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        o = flash_attention(qq, kk, vv, mask, dropout_rate=rate, seed=seed,
                            **kw)
        o.backward(do)
        outs.append([o.detach(), qq.grad, kk.grad, vv.grad])
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        _close_rel(got, want)
    if d == 64:
        keep = keep_mask(seed, 3, 0, b * nh * s, s, rate, dev).reshape(
            b, nh, s, s)
        seg = torch.arange(s, device=dev) // 64
        cols = seg[:, None] * 64 + torch.arange(64, device=dev)[None]
        want = torch.gather(keep, 3, cols[None, None].expand(b, nh, s, 64))
        for o in (outs[0][0], outs[1][0]):
            assert torch.equal(o.permute(0, 2, 1, 3) != 0, want)


def test_flash_wrappers_refuse_and_count(dev):
    from nbest_asr_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, do = _bshd_operands(dev, 2, 80, 4, 64, True, seed=400)
    mask = torch.ones(2, 80, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        K.flash_fwd(*(t[..., :48].contiguous() for t in (q, k, v)), mask,
                    0.1)
    with pytest.raises(ValueError, match="strides"):
        K.flash_fwd(q, k.contiguous(), v, mask, 0.1)
    with pytest.raises(TypeError):
        K.flash_fwd(q.float(), k, v, mask, 0.1)
    # TMA reads rows 16 bytes aligned: a row stride of 772 values (a QKV
    # buffer 4 columns wider), and a q or a dout off a 16-byte boundary,
    # are refused
    o, lse = K.flash_fwd(q, k, v, mask, 0.1)
    wide = torch.zeros(2 * 80, 3 * 256 + 4, device=dev, dtype=torch.bfloat16)
    qx, kx, vx = wide[:, :3 * 256].unflatten(1, (3, 4, 64)).unflatten(
        0, (2, 80)).unbind(2)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        K.flash_fwd(qx, kx, vx, mask, 0.1)
    q_off = torch.empty(q.numel() + 1, device=dev,
                        dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        K.flash_fwd(q_off, k.contiguous(), v.contiguous(), mask, 0.1)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        K.flash_bwd_dq(qx, kx, vx, mask, o, lse, do, 0.1)
    do_off = torch.empty(do.numel() + 1, device=dev,
                         dtype=torch.bfloat16)[1:].view(do.shape)
    with pytest.raises(ValueError, match="dout must be 16-byte aligned"):
        K.flash_bwd_dkv(q, k, v, mask, lse, lse, do_off, 0.1)
    with pytest.raises(ValueError, match="seq"):
        K.sb_attention(*(torch.cat([t] * 7, 1) for t in (q, k, v)),
                       torch.ones(2, 560, device=dev), 0.1)
    for kw, want in (({}, {"seg_attention": 1, "seg_attention_bwd": 1}),
                     (dict(block_k=64), {"flash_fwd": 1, "flash_bwd_dq": 1,
                                         "flash_bwd_dkv": 1})):
        qq, kk, vv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        _cuda.reset_launch_counts()
        n0 = K.flash_wgmma_launches()
        flash_attention(qq, kk, vv, mask, dropout_rate=0.1, seed=1,
                        **kw).backward(do)
        assert {n: c for n, c in _cuda.launch_counts.items() if c} == want
        n1 = K.flash_wgmma_launches()
        assert {n: n1[n] - n0[n] for n in n1} == {
            n: want.get(n, 0) for n in n1}


# --------------------------------------------------------------------- #
# the plain-block route's row kernels: residual LayerNorm forward and
# backward, bias-GELU forward and backward, the embedding lookup.  Outputs
# in bf16 within one bf16 ulp of the plain version per element, plus
# 2**-16 of the tensor's largest value (both sides round an f32 value
# once; a different summation order of the row statistics moves it by a
# few f32 ulps of the row's magnitude, which shows in bf16 ulps where
# cancellation leaves an element near 0); f32 outputs and statistics
# within 1e-5 of the largest value; dscale and dbias within 1e-4 of their
# largest value (column sums of 8192 rows in another order).
# --------------------------------------------------------------------- #

ROW_SHAPES = [(8192, 768), (7688, 1024), (60, 256), (1, 128)]


def _hold_rows(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.bfloat16:
        w = want.float()
        ulp = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(2.0 ** -126))) - 7)
        lim = ulp + 2.0 ** -16 * w.abs().max()
        assert bool(((got.float() - w).abs() <= lim).all())
    else:
        d = (got - want).abs().max().item()
        assert d <= 1e-5 * want.abs().max().item()


def _hold_sum(got, want, tol=1e-4):
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def _ln_operands(dev, m, n, dtype, seed):
    x = _rand(dev, m, n, dtype=dtype, seed=seed)
    r = _rand(dev, m, n, dtype=dtype, seed=seed + 1)
    dy = _rand(dev, m, n, dtype=dtype, seed=seed + 2)
    g = 1 + _rand(dev, n, std=0.1, dtype=torch.float32, seed=seed + 3)
    b = _rand(dev, n, std=0.1, dtype=torch.float32, seed=seed + 4)
    return x, r, dy, g, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n", ROW_SHAPES)
def test_residual_layer_norm(dev, m, n, dtype):
    x, r, dy, g, b = _ln_operands(dev, m, n, dtype, seed=m + n)
    y, mean, rstd = K.residual_layer_norm(x, r, g, b, 1e-12)
    dx, dg, db = K.residual_layer_norm_bwd(x, r, dy, g, mean, rstd)
    torch.cuda.synchronize()
    ry, rmean, rrstd = K.residual_layer_norm_reference(x, r, g, b, 1e-12)
    _hold_rows(y, ry)
    _hold_rows(mean, rmean)
    _hold_rows(rstd, rrstd)
    rdx, rdg, rdb = K.residual_layer_norm_bwd_reference(x, r, dy, g, mean,
                                                        rstd)
    _hold_rows(dx, rdx)
    _hold_sum(dg, rdg)
    _hold_sum(db, rdb)


# (193, 3076) and (60, 36): N % 8 == 4, the 4-wide instance
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n", [(8192, 3072), (7688, 4096), (193, 3076),
                                 (60, 36)])
def test_bias_gelu(dev, m, n, dtype):
    x = _rand(dev, m, n, std=2.0, dtype=dtype, seed=m)
    b = _rand(dev, n, dtype=torch.float32, seed=n)
    dy = _rand(dev, m, n, dtype=dtype, seed=m + 1)
    y = _twice(lambda: K.bias_gelu(x, b))
    dx = _twice(lambda: K.bias_gelu_bwd(x, b, dy))
    torch.cuda.synchronize()
    _hold_rows(y, K.bias_gelu_reference(x, b))
    _hold_rows(dx, K.bias_gelu_bwd_reference(x, b, dy))


def test_bias_gelu_instances_agree(dev):
    """A bf16 operand 8 bytes off a 16-byte boundary takes the 4-wide
    instance; it equals the 8-wide instance bit for bit."""
    x = _rand(dev, 300, 3072, std=2.0, seed=40)
    b = _rand(dev, 3072, dtype=torch.float32, seed=41)
    dy = _rand(dev, 300, 3072, seed=42)

    def off8(t):
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        out = buf[4:4 + t.numel()].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 == 8
        return out

    xo, dyo = off8(x), off8(dy)
    assert torch.equal(K.bias_gelu(xo, b), K.bias_gelu(x, b))
    assert torch.equal(K.bias_gelu_bwd(xo, b, dyo), K.bias_gelu_bwd(x, b, dy))
    assert torch.equal(K.bias_gelu_bwd(x, b, dyo), K.bias_gelu_bwd(x, b, dy))


def _embed_operands(dev, n, h, dtype, seed, vocab=30522, types=2, s=256):
    g = torch.Generator().manual_seed(seed)
    word = _rand(dev, vocab, h, std=0.05, dtype=dtype, seed=seed)
    pos = _rand(dev, 514, h, std=0.05, dtype=dtype, seed=seed + 1)
    type_ = _rand(dev, types, h, std=0.05, dtype=dtype, seed=seed + 2)
    sc = 1 + _rand(dev, h, std=0.1, dtype=torch.float32, seed=seed + 3)
    bi = _rand(dev, h, std=0.1, dtype=torch.float32, seed=seed + 4)
    ids = torch.randint(0, vocab, (n,), generator=g).to(dev, torch.int32)
    tids = torch.randint(0, types, (n,), generator=g).to(dev, torch.int32)
    return word, pos, type_, sc, bi, ids, tids


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,s,off", [(8192, 768, 256, 0),
                                       (7688, 1024, 248, 2), (8, 128, 8, 0)])
def test_embed_lookup(dev, n, h, s, off, dtype, typed):
    word, pos, type_, sc, bi, ids, tids = _embed_operands(dev, n, h, dtype,
                                                          seed=n + h)
    tids = tids if typed else None
    p = pos[off:off + s]
    got = K.embed_lookup(word, p, type_, sc, bi, ids, tids, s, 1e-12)
    torch.cuda.synchronize()
    _hold_rows(got, K.embed_lookup_reference(word, p, type_, sc, bi, ids,
                                             tids, s, 1e-12))


def test_embed_lookup_out_of_range_id_gives_nan_row(dev):
    """Out-of-range ids read what JAX's kernel reads: a type id outside
    the table and a word id in the table's padding to a multiple of 8
    (30522 % 8 = 2) a zero row, as the plain version does; a word id past
    the padding, where JAX's kernel fails, a NaN row."""
    word, pos, type_, sc, bi, ids, tids = _embed_operands(
        dev, 16, 768, torch.float32, seed=5)
    ids[3] = 30522
    tids[5] = 2
    ids[9] = 30528
    got = K.embed_lookup(word, pos[:8], type_, sc, bi, ids, tids, 8, 1e-12)
    torch.cuda.synchronize()
    bad = torch.isnan(got).any(dim=1)
    assert bad.tolist() == [i == 9 for i in range(16)]
    ids[9] = 0
    want = K.embed_lookup_reference(word, pos[:8], type_, sc, bi, ids, tids,
                                    8, 1e-12)
    _hold_rows(got[~bad], want[~bad])


def test_row_functions_match_plain_autograd(dev):
    """The three Functions' gradients against torch autograd through the
    kernels' plain versions, at the smoke's widths."""
    from nbest_asr_tpu_torch.ops.fused_embed import fused_embed_lookup
    from nbest_asr_tpu_torch.ops.fused_gelu import fused_bias_gelu
    from nbest_asr_tpu_torch.ops.fused_ln import fused_residual_layer_norm

    def run(fn, tensors, dy):
        ts = [t.detach().clone().requires_grad_(True) for t in tensors]
        out = fn(*ts)
        out.backward(dy)
        return [out.detach()] + [t.grad for t in ts]

    x, r, dy, g, b = _ln_operands(dev, 4096, 768, torch.bfloat16, seed=9)
    got = run(lambda *a: fused_residual_layer_norm(*a), (x, r, g, b), dy)
    want = run(lambda x_, r_, g_, b_: K.residual_layer_norm_reference(
        x_, r_, g_, b_, 1e-12)[0], (x, r, g, b), dy)
    _hold_rows(got[0], want[0])
    for a, w in zip(got[1:], want[1:]):
        _close(a, w) if a.dtype == torch.bfloat16 else _hold_sum(a, w, 1e-3)

    h = _rand(dev, 4096, 3072, dtype=torch.bfloat16, seed=10)
    b1 = _rand(dev, 3072, dtype=torch.float32, seed=11)
    dh = _rand(dev, 4096, 3072, dtype=torch.bfloat16, seed=12)
    got = run(fused_bias_gelu, (h, b1), dh)
    want = run(K.bias_gelu_reference, (h, b1), dh)
    _hold_rows(got[0], want[0])
    _close(got[1], want[1])
    # dbias sums the bf16 dx, as JAX sums it (fused_gelu.py:85); the two
    # dx differ by a bf16 ulp here and there, so 1e-3 of the largest value
    _hold_sum(got[2], want[1].float().sum(dim=0), 1e-3)

    word, pos, type_, sc, bi, ids, tids = _embed_operands(
        dev, 4096, 768, torch.float32, seed=13)
    s = 256
    dy = _rand(dev, 16, s, 768, dtype=torch.float32, seed=14)

    def fused(w, p, t, c, e):
        return fused_embed_lookup(w, p[:s], t, c, e, ids.reshape(16, s),
                                  tids.reshape(16, s), s)

    def plain(w, p, t, c, e):
        return K.embed_lookup_reference(w, p[:s], t, c, e, ids, tids, s,
                                        1e-12).reshape(16, s, 768)

    for a, w in zip(run(fused, (word, pos, type_, sc, bi), dy),
                    run(plain, (word, pos, type_, sc, bi), dy)):
        _hold_sum(a, w, 1e-4)


def test_row_wrappers_refuse_and_count(dev):
    x, r, dy, g, b = _ln_operands(dev, 64, 768, torch.bfloat16, seed=20)
    with pytest.raises(ValueError, match="N in"):
        K.residual_layer_norm(x[:, :64].contiguous(), r[:, :64].contiguous(),
                              g[:64], b[:64], 1e-12)
    with pytest.raises(TypeError):
        K.residual_layer_norm(x, r.float(), g, b, 1e-12)
    with pytest.raises(TypeError):
        K.bias_gelu(x.half(), b)
    with pytest.raises(ValueError, match="N % 4"):
        K.bias_gelu(x[:, :766].contiguous(), b[:766])
    word, pos, type_, sc, bi, ids, tids = _embed_operands(
        dev, 64, 768, torch.float32, seed=21)
    with pytest.raises(TypeError):
        K.embed_lookup(word, pos, type_, sc, bi, ids.long(), tids, 8, 1e-12)
    _cuda.reset_launch_counts()
    _, mean, rstd = K.residual_layer_norm(x, r, g, b, 1e-12)
    K.residual_layer_norm_bwd(x, r, dy, g, mean, rstd)
    K.bias_gelu(x, b)
    K.bias_gelu_bwd(x, b, dy)
    K.embed_lookup(word, pos, type_, sc, bi, ids, None, 8, 1e-12)
    assert {n: c for n, c in _cuda.launch_counts.items() if c} == {
        "residual_layer_norm": 1, "residual_layer_norm_bwd": 1,
        "bias_gelu": 1, "bias_gelu_bwd": 1, "embed_lookup": 1}


def test_fused_rows_encoder_forward_counts(dev):
    """Route C's encoder forward (both megakernels off, the three row
    flags on) launches the row kernels exactly: per layer two residual
    LayerNorms and one bias-GELU, one embedding lookup per forward; a
    training step adds their backwards."""
    from nbest_asr_tpu_torch.models.encoder import (EncoderConfig,
                                                    encoder_forward,
                                                    init_encoder_params)

    cfg = EncoderConfig.bert_base(num_layers=2, compute_dtype="bfloat16",
                                  use_fused_ln=True, use_fused_gelu=True,
                                  use_fused_embedding=True)
    params = init_encoder_params(torch.Generator(dev).manual_seed(0), cfg)
    ids = torch.randint(0, 30522, (8, 64), device=dev)
    mask = torch.ones(8, 64, device=dev)
    _cuda.reset_launch_counts()
    with torch.no_grad():
        y = encoder_forward(params, ids, mask, None, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all()
    assert {n: c for n, c in _cuda.launch_counts.items() if c} == {
        "residual_layer_norm": 4, "bias_gelu": 2, "embed_lookup": 1}
    train = {k: v.requires_grad_(True) for k, v in params["layers"].items()}
    _cuda.reset_launch_counts()
    encoder_forward(dict(params, layers=train), ids, mask, None, cfg,
                    deterministic=False, seed=3).float().sum().backward()
    torch.cuda.synchronize()
    assert {n: c for n, c in _cuda.launch_counts.items() if c} == {
        "residual_layer_norm": 4, "residual_layer_norm_bwd": 4,
        "bias_gelu": 2, "bias_gelu_bwd": 2, "embed_lookup": 1}


# --remat on both megakernels: a 2-layer bf16 training step at hidden 256
# (four heads of 64), dropout on, with and without remat from the same
# parameters and seed
REMAT_ENC = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                 intermediate_size=1024, compute_dtype="bfloat16",
                 hidden_dropout=0.1, attn_dropout=0.1, use_fused_attn=True,
                 use_fused_ffn=True, use_flash_attention=True)
# a training layer's forward launches (both blocks), which the recompute
# repeats, and its backward's, which it leaves alone
REMAT_FWD = {"gemm_bias_act": 2, "gemm_bias_residual": 2, "layer_norm": 2,
             "seg_attention": 1}
REMAT_BWD = {"ffn_bwd_rows": 2, "gemm_dgrad": 4, "seg_attention_bwd": 1}


def _remat_step(dev, remat):
    """Loss and every gradient of a 2-layer bf16 encoder's training
    forward (sum of squares of its output), and the kernels' launches."""
    from nbest_asr_tpu_torch.models.encoder import (EncoderConfig,
                                                    encoder_forward,
                                                    init_encoder_params)
    from nbest_asr_tpu_torch.train.optimizer import tree_leaves, tree_map

    cfg = EncoderConfig(**REMAT_ENC, remat=remat)
    params = tree_map(lambda t: t.to(dev), init_encoder_params(
        torch.Generator().manual_seed(0), cfg))
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 512, (8, 64), generator=g).to(dev)
    mask = torch.ones(8, 64, device=dev)
    mask[3, 40:] = 0
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    _cuda.reset_launch_counts()
    y = encoder_forward(live, ids, mask, None, cfg, deterministic=False,
                        seed=123)
    loss = (y.float() ** 2).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    return loss.detach(), grads, dict(_cuda.launch_counts)


def test_remat_step_is_bit_equal_and_doubles_forward_launches(dev):
    """Bit-equal loss and gradients (the kernels use no atomics, and the
    recompute redraws the same Philox keep bits); each forward kernel
    launched twice as often, each backward kernel as often."""
    loss0, g0, c0 = _remat_step(dev, False)
    loss1, g1, c1 = _remat_step(dev, True)
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)
    layers = REMAT_ENC["num_layers"]
    for k, n in REMAT_FWD.items():
        assert c0[k] == layers * n and c1[k] == 2 * layers * n, k
    for k, n in REMAT_BWD.items():
        assert c0[k] == c1[k] == layers * n, k
