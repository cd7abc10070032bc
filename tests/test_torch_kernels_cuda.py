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


@pytest.mark.parametrize("act", ["none", "gelu"])
@pytest.mark.parametrize("m", [1, 60, 300])
def test_gemm_bias_act(dev, m, act):
    a = _rand(dev, m, 256, seed=1)
    w = _rand(dev, 256, 384, std=0.05, seed=2)
    b = _rand(dev, 384, std=0.1, dtype=torch.float32, seed=3)
    got = K.gemm_bias_act(a, w, b, act)
    torch.cuda.synchronize()
    _close(got, K.gemm_bias_act_reference(a, w, b, act))


def test_gemm_bias_residual_and_layer_norm(dev):
    a = _rand(dev, 200, 512, seed=4)
    w = _rand(dev, 512, 256, std=0.05, seed=5)
    b = _rand(dev, 256, std=0.1, dtype=torch.float32, seed=6)
    r = _rand(dev, 200, 256, seed=7)
    s = K.gemm_bias_residual(a, w, b, r)
    torch.cuda.synchronize()
    _close(s, K.gemm_bias_residual_reference(a, w, b, r))
    g = 1 + _rand(dev, 256, std=0.1, dtype=torch.float32, seed=8)
    bb = _rand(dev, 256, std=0.1, dtype=torch.float32, seed=9)
    y = K.layer_norm_rows(s, g, bb, 1e-12)
    torch.cuda.synchronize()
    _close(y, K.layer_norm_reference(s, g, bb, 1e-12, torch.bfloat16))


@pytest.mark.parametrize("b,s,h,nh", [(3, 20, 256, 4), (2, 130, 256, 2),
                                      (2, 512, 128, 2)])
@pytest.mark.parametrize("packed", [False, True])
def test_seg_attention(dev, b, s, h, nh, packed):
    qkv = _rand(dev, b * s, 3 * h, seed=s)
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
    with pytest.raises(ValueError, match="head dims"):
        K.seg_attention(_rand(dev, 64, 3 * 96), torch.ones(4, 16,
                                                           device=dev), 3)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 60, 300])
def test_quantize_rows(dev, m, dtype):
    x = _rand(dev, m, 768, dtype=dtype, seed=m)
    if m > 1:
        x[1] = 0.0                        # all-zero row: the 1e-12 floor
        # amax 127 gives scale 1: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0 (half to
        # even), the +-0.5 boundary after scaling
        x[0, :4] = torch.tensor([127.0, 2.5, 3.5, -0.5], dtype=dtype)
    q, s = K.quantize_rows(x)
    torch.cuda.synchronize()
    rq, rs = K.quantize_rows_reference(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, rq) and torch.equal(s, rs)
    if m > 1:
        assert q[0, :4].tolist() == [127, 2, 4, 0]
        assert (q[1] == 0).all()


@pytest.mark.parametrize("epi", ["none", "gelu", "residual"])
@pytest.mark.parametrize("m", [1, 60, 300])
def test_gemm_i8_epilogues(dev, m, epi):
    k, n = (3072, 768) if epi == "residual" else (768, 2304)
    xq, xs = K.quantize_rows(_rand(dev, m, k, seed=m + 1))
    wq, ws = _i8_weight(dev, k, n, seed=m + 2)
    b = _rand(dev, n, std=0.1, dtype=torch.float32, seed=m + 3)
    if epi == "residual":
        r = _rand(dev, m, n, seed=m + 4)
        got = K.gemm_i8_bias_residual(xq, xs, wq, ws, b, r)
        want = K.gemm_i8_bias_residual_reference(xq, xs, wq, ws, b, r)
    else:
        got = K.gemm_i8_bias_act(xq, xs, wq, ws, b, epi)
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
    _cuda.reset_launch_counts()
    K.quantize_rows(x)
    K.gemm_i8_bias_act(xq, xs, wq, ws, b, "gelu")
    K.gemm_i8_bias_residual(xq, xs, wq, ws, b, r)
    assert {k: v for k, v in _cuda.launch_counts.items() if v} == {
        "quantize_rows": 1, "gemm_i8_bias_act": 1,
        "gemm_i8_bias_residual": 1}
