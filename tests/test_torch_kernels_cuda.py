"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  A CUDA kernel has no CPU mode, so every test here
needs an NVIDIA GPU with nvcc (Hopper, sm_90a) and skips elsewhere; run
them there with ``python -m pytest tests/test_torch_kernels_cuda.py -m
cuda``.  ``chip_smoke.py`` runs the same comparisons at BERT-base widths.

Tolerance: both sides accumulate in f32 and round to bf16 at the same
points, so they differ only where summation order flips a rounding --
at most two bf16 ulps of the tensor's largest value, and rarely."""

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
