"""Int8 quantization -- the port of ``nbest_asr_tpu/ops/quant.py`` (the
plain-torch oracles of the int8 serving and int8 training kernels).

- **Weights**: per-output-channel symmetric int8, quantized once at
  ``Predictor`` construction (``quantize_encoder_params``), or at every
  int8 training step from the live bf16 weights (``quantize_train_weight``,
  as ``nbest_asr_tpu/ops/fused_ffn.py:_fwd_call_i8`` does in XLA outside
  the Pallas body).  Scales are f32 ``max(amax, 1e-12) / 127`` over the
  input axis.
- **Activations**: dynamic per-token symmetric int8 with the same
  formula over each row, inside the forward (``dense_int8``).
- **Gradients** (``dgrad_int8``): the input-gradient product of the int8
  training backward contracts over the weight's output axis, so the
  per-output scales fold into the gradient before its per-token quant.

Rounding is ``torch.round`` (half to even, as ``jnp.round``), the clip is
[-127, 127] and both divisions are IEEE f32 divisions, so ``q`` and
``scale`` equal the JAX package's bit for bit, on the CPU and on CUDA.

Memory layout: the quantized kernels keep the JAX shape ``(..., in,
out)`` but are stored column-major -- the transpose view of a contiguous
``(..., out, in)`` tensor (``kernel_layout``) -- because the CUDA int8
GEMMs (``csrc/gemm_wgmma.cu``) read each output column's weights
K-contiguous (8-bit ``wgmma`` transposes no operand).  Values and shapes are those of the JAX tree; only the
strides differ.  The int8 dgrads read the same values row-major
(``quantize_train_weight`` returns both layouts).
"""

from __future__ import annotations

import torch

LAYER_GEMM_KERNELS = ("qkv_kernel", "attn_out_kernel", "ffn_in_kernel",
                      "ffn_out_kernel")


def symmetric_int8(x: torch.Tensor, dim: int):
    amax = x.abs().amax(dim=dim, keepdim=True)
    # divide by a tensor on x's device: torch on CUDA turns division by a
    # Python scalar into a multiplication by its reciprocal, which is not
    # the IEEE division of jnp and of the CUDA kernel.  full_like fills it
    # on the device; a tensor copied from the host would make every call
    # wait for the card (the int8 training blocks quantize their weights
    # at every call)
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor, axis_in: int = -2):
    """Per-output-channel symmetric int8 over the input axis.

    w: (..., in, out) f32 -> (q int8 same shape, scale f32 with the input
    axis reduced to 1)."""
    return symmetric_int8(w.float(), axis_in)


def quantize_train_weight(w: torch.Tensor):
    """A training step's quantization of the (in, out) weight ``w`` -- the
    compute-dtype (bf16) cast the encoder hands the block, not the f32
    master, as JAX quantizes ``w.astype(f32)`` of that cast
    (``fused_ffn.py:450-451``, ``fused_attention.py:498-499``) -> (q in
    ``kernel_layout`` for the forward GEMMs, q row-major for the dgrads,
    scale (out,) f32)."""
    q, scale = quantize_weight(w.float())
    return kernel_layout(q), q.contiguous(), scale.reshape(-1)


def dgrad_int8(g: torch.Tensor, wq: torch.Tensor,
               w_scale: torch.Tensor) -> torch.Tensor:
    """dx = g @ dequant(wq)^T through an exact int8 dot
    (``nbest_asr_tpu/ops/quant.py:dgrad_int8``): the per-output scales
    fold into g before its per-token quant,
    ``sum_o q(g*ws)[o] * wq[i,o] * g_scale == sum_o g[o] * w[i,o]`` up to
    that quant's rounding.

    g: (..., out) bf16/f32; wq: (in, out) int8; w_scale: (1, out) or
    (out,) f32.  Returns f32 (..., in)."""
    gq, g_scale = symmetric_int8(g.float() * w_scale.reshape(-1), -1)
    return int_dot(gq, wq.transpose(-1, -2)).to(torch.float32) * g_scale


def quantize_rows_reference(x: torch.Tensor):
    """Per-token (row) quant of (n, K) bf16/f32 -> (q (n, K) int8,
    scale (n,) f32): ``int8_serving.py:_quant_rows`` on the f32 upcast."""
    q, scale = symmetric_int8(x.float(), -1)
    return q, scale.squeeze(-1)


def int_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product on any device: an f64 matmul of
    the int8 values (every partial sum is an integer below 2**53), then
    int32.  (torch has no int32 matmul on CUDA, and f32 is exact only
    below 2**24.)"""
    return torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(
        torch.int32)


def dequant(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """``(f32(acc) * x_scale) * w_scale + bias`` in f32, one rounding per
    operation in the JAX order (``quant.py:92-93``)."""
    return acc.to(torch.float32) * x_scale * w_scale + bias.to(torch.float32)


def dense_int8(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(wq) + bias via an exact int8 dot.

    x: (..., in) bf16/f32; wq: (in, out) int8; w_scale: (1, out) f32.
    Activations are dynamically quantized per token (row abs-max); the
    result is rounded once to x's dtype."""
    xq, x_scale = symmetric_int8(x.float(), -1)
    out = dequant(int_dot(xq, wq), x_scale, w_scale.reshape(-1), bias)
    return out.to(x.dtype)


def kernel_layout(q: torch.Tensor) -> torch.Tensor:
    """The same (..., in, out) values stored column-major (the transpose
    view of a contiguous (..., out, in) tensor), as the CUDA int8 GEMM
    reads them.  A no-op copy for a tensor already in that layout."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_encoder_params(params: dict) -> dict:
    """Return a copy of the model param tree with the encoder's stacked
    GEMM kernels replaced by ``{"q": int8 (L, in, out), "scale": f32
    (L, 1, out)}`` dicts, ``q`` in ``kernel_layout``.  ``encoder_forward``
    dispatches on the dict leaves; everything else is shared, not
    copied."""
    layers = dict(params["encoder"]["layers"])
    for name in LAYER_GEMM_KERNELS:
        q, scale = quantize_weight(layers[name], axis_in=-2)
        layers[name] = {"q": kernel_layout(q), "scale": scale}
    enc = dict(params["encoder"], layers=layers)
    return dict(params, encoder=enc)


def is_quantized(kernel) -> bool:
    return isinstance(kernel, dict)
