"""Wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

The two bf16 TPU megakernels of the serving path become a chain of four
kernels (sources in ``csrc/``):

- ``gemm_bias_act``      -- ``act(bf16(a @ w + bias))``; QKV and FFN-in
- ``gemm_bias_residual`` -- ``f32(bf16(a @ w + bias)) + f32(resid)``;
                            out-proj and FFN-out (both, and ``gemm_dgrad``
                            below, on the wgmma + TMA GEMM of
                            ``csrc/gemm_wgmma.cu``)
- ``layer_norm``         -- row LayerNorm of that f32 sum, bf16 out
- ``seg_attention``      -- segment-masked softmax attention from the
                            (n, 3h) QKV buffer to ctx (n, h)

The two int8 serving megakernels reuse ``seg_attention`` and
``layer_norm`` and add three:

- ``quantize_rows``         -- per-token symmetric int8 of (n, K) rows (a
                               one-read row pass at K = 256 n, n <= 16,
                               counted also by
                               ``quantize_rows_pass_launches``)
- ``gemm_i8_bias_act``      -- ``act(bf16(dequant(xq . wq) + bias))``
- ``gemm_i8_bias_residual`` -- ``f32(bf16(dequant(xq . wq) + bias)) +
                               f32(resid)``

where ``dequant(acc) = (f32(acc) * x_scale) * w_scale``, the int8 weight
``wq`` (K, N) is stored column-major (``quant.kernel_layout``) and its
per-output-channel scale ``ws`` is (N,) f32.  Both int8 GEMMs run the
``wgmma`` + TMA GEMM of ``csrc/gemm_wgmma.cu`` in s8.

The FFN block's training chain (``ops/fused_ffn.py``) gives
``gemm_bias_act`` and ``gemm_bias_residual`` a Philox dropout site
(``drop``, an ``ops.philox.Dropout``) and saved residuals (the pre-GELU
``h``, the dropped second-GEMM output ``y2d``), ``layer_norm`` its row
statistics, and adds two kernels for the backward:

- ``ffn_bwd_rows`` -- the LayerNorm-backward row pass: dy2, xhat, ds
- ``gemm_dgrad``   -- ``a @ w.T`` (w the forward's (N, K) weight) with
                      the "dgelu" epilogue (dh and the regenerated gd)
                      or the "residual" one (dx = bf16(ds + a @ w.T))

The attention block's training chain (``ops/fused_attention.py``) gives
``seg_attention`` a Philox prob-dropout site and its row statistics,
``gemm_dgrad`` a plain "none" epilogue (dctx = bf16(dout @ wo.T)), reuses
``ffn_bwd_rows`` for its LayerNorm-backward rows, and adds one kernel:

- ``seg_attention_bwd`` -- dqkv (n, 3h) from QKV, dctx, the mask and the
                           forward's row statistics (a dQ kernel, then a
                           dK/dV kernel)

The flash-attention route (``ops/flash_attention.py``) runs the same two
attention kernels on (b, s, heads, d) operands read by row stride --
``sb_attention`` and ``sb_attention_bwd``, counted as ``seg_attention``
and ``seg_attention_bwd`` (the single-block route, s <= 512) -- and adds
three tiled kernels for any sequence length:

- ``flash_fwd``     -- online-softmax forward: o and the row lse
- ``flash_bwd_dq``  -- dq, and di = rowsum(dO * O) for the next kernel
- ``flash_bwd_dkv`` -- dk and dv

(all three on ``wgmma`` + TMA at d = 64 and 96, as ``FLASH_WGMMA``
lists, counted also by ``flash_wgmma_launches``; on ``mma.sync`` at
every other head dim).

Every attention kernel wrapper takes every head dim d >= 1.  At d <= 256
with d % 8 == 0 each runs on the narrowest ``mma.sync`` instance of width
32, 64, 96, 128, 192 or 256 at least d wide, its columns past d
zero-filled on load and never stored (``csrc/attention.cuh``,
``instance_width``), or on a ``wgmma`` kernel: the tiled trio at d = 64
and 96, ``seg_attention`` and ``seg_attention_bwd`` at d = 64 and 192
(s <= 512; at d = 192 past 256 keys K and V streamed) and 96 (s <= 256),
counted also by ``seg_attention_wgmma_launches``
and ``seg_attention_bwd_wgmma_launches``.  Every other head dim -- d >
256, and d % 8 != 0, whose heads leave the 16-byte boundaries those
instances copy on -- runs the chunked family (``csrc/attention_chunked.cu``:
``chunked_fwd``, which keeps a slab of up to 384 output columns in
``wgmma`` accumulators and builds each score once per key tile for all
of them, its instance by ``chunked_fwd_instance``; ``chunked_bwd_dq``,
``chunked_bwd_dkv``, the head dim in 64-column chunks; any alignment),
for both the single-block pair and the tiled trio, counted also by
``attn_chunked_launches`` (and the forward by
``chunked_fwd_instance_launches``).
``attn_instance`` is the one rule that picks the single-block pair's
instance: the wrappers pass its choice to the library, which runs that
instance or refuses.

The int8 training blocks (``ops/fused_ffn.py``, ``ops/fused_attention.py``,
``*_int8_train``) give ``gemm_i8_bias_act`` and ``gemm_i8_bias_residual``
the same Philox dropout sites and saved residuals, and add two kernels for
their int8 backwards:

- ``quantize_grad_rows`` -- per-token int8 of ``drop(g) * ws``, a gradient
                            with the weight's per-output scales folded in
                            (the same one-read row pass at K = 256 n,
                            counted by ``quantize_grad_rows_pass_launches``)
- ``gemm_i8_dgrad``      -- ``f32(gq . wq^T) * g_scale`` for the quantized
                            (in, out) weight row-major, with the "dgelu"
                            (dh in bf16 and f32, the regenerated gd),
                            "residual" and "none" epilogues (the s8
                            ``wgmma`` + TMA GEMM)

The encoder's plain-block route (``use_fused_ln``, ``use_fused_gelu``,
``use_fused_embedding``; ``ops/fused_ln.py``, ``ops/fused_gelu.py``,
``ops/fused_embed.py``) adds five row and elementwise kernels, on bf16 or
f32 activations:

- ``residual_layer_norm``     -- ``LN(x + r)`` with the sum in f32, its row
                                 mean and rstd (``csrc/layer_norm.cu``)
- ``residual_layer_norm_bwd`` -- dx, and dscale / dbias as per-block
                                 partials summed in a fixed order
- ``bias_gelu``               -- ``gelu(x + b)`` with the A&S 7.1.26 erf
                                 (``csrc/fused_gelu.cu``)
- ``bias_gelu_bwd``           -- ``dy * gelu'(x + b)``
- ``embed_lookup``            -- word + position + type rows, LayerNorm
                                 (``csrc/fused_embed.cu``)

A wrapper given CPU tensors runs the plain version (``*_reference``).
Given CUDA tensors it checks dtype, shape and contiguity, raises on what
the kernel does not take, allocates the output with ``torch.empty``,
launches on the current stream, raises on a launch error and counts the
launch in ``_cuda.launch_counts``.  There is no fallback from the kernel
to the plain version.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import _cuda
from .layers import (INV_SQRT2, INV_SQRT2PI, acc_dtype, gelu,
                     gelu_grad, layer_norm_stats)
from .philox import Dropout, keep_mask, threshold
from .quant import dequant, int_dot, quantize_rows_reference, symmetric_int8

# fill for masked-out scores, as the TPU kernels use
# (nbest_asr_tpu/ops/flash_attention.py:MASK_VALUE)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_SEQ = 512                 # one-block ceiling, fused_attention.FAB_MAX_SEQ
# score elements per chunk of the plain tiled versions (batch elements
# are taken a chunk at a time, so s = 1024 .. 2048 fit on the card)
_REF_CHUNK = 2 ** 26


def chunked_head_dim(d: int) -> bool:
    """The head dims the chunked attention family runs, for the
    single-block pair and the tiled trio alike: d > 256 (past the widest
    fixed-width instance) or d % 8 != 0 (a head's columns off the 16-byte
    boundaries the other instances copy on)."""
    return d > 256 or d % 8 != 0


def attn_instance(d: int, s: int, backward: bool = False):
    """The instance ``seg_attention`` (``backward``: ``seg_attention_bwd``)
    runs at head dim d and sequence length s: ``"chunked"`` where
    ``chunked_head_dim`` holds, ``"wgmma"`` at d = 64 and d = 192 (both
    to s = 512) and d = 96 (s <= 256), else the width of its ``mma.sync``
    instance, the narrowest of 32, 64, 96, 128, 192 and 256 at least d
    wide; None where the wrappers refuse (d < 1, s outside 1 .. 512).  The
    wrappers pass this choice to the library (``csrc/seg_attention.cu``,
    ``csrc/seg_attention_bwd.cu``, ``csrc/attention_chunked.cu``), whose
    launch counters show that it ran."""
    if d < 1 or not 0 < s <= MAX_SEQ:
        return None
    if chunked_head_dim(d):
        return "chunked"
    if d in (64, 192) or d == 96 and s <= 256:
        return "wgmma"
    return next(w for w in (32, 64, 96, 128, 192, 256) if w >= d)


def _instance_arg(d: int, s: int, backward: bool) -> int:
    """``attn_instance`` as the C interface takes it: 0 for the wgmma
    kernels, else the mma.sync instance's width."""
    inst = attn_instance(d, s, backward)
    return 0 if inst == "wgmma" else inst


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or
    on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"{name}: tensors on {sorted(kinds)}; expected all on "
                     "the CPU (plain version) or all on one CUDA device")


def _expect(name: str, arg: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {arg} is {t.dtype}, the kernel takes "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _drop_args(drop: "Dropout | None"):
    """The C interface's five dropout scalars (csrc/philox.cuh)."""
    if drop is None:
        return 0, 0, 0, 0.0, 0
    return drop.seed, drop.stream, threshold(drop.rate), drop.inv_keep, 1


def _ptr(t) -> "int | None":
    return None if t is None else t.data_ptr()


def _gemm_dims(name: str, a: torch.Tensor, w: torch.Tensor,
               k_mult: int = 32):
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    (M, K), N = a.shape, w.shape[1]
    if N % 128 or K % k_mult:
        raise ValueError(f"{name}: the kernel needs N % 128 == 0 and "
                         f"K % {k_mult} == 0, got N={N}, K={K}")
    return M, N, K


def _aligned16(name: str, **tensors) -> None:
    """The TMA kernels (csrc/gemm_wgmma.cu, bf16 and int8; the tiled
    flash kernels at d = 64 and 96) and the row kernels load and store 16 bytes
    at a time from each operand's base (the bias and scales too)."""
    for arg, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned, its "
                             f"address is {t.data_ptr():#x}")


def _i8_operands(name: str, xq, xs, wq, ws, bias):
    """Check the int8 GEMM operands; returns (M, N, K)."""
    M, N, K = _gemm_dims(name, xq, wq, k_mult=64)
    _expect(name, "xq", xq, torch.int8, (M, K))
    _expect(name, "x_scale", xs, torch.float32, (M,))
    # the kernel reads each output column's weights K-contiguous
    _expect(name, "wq.t() (wq must be column-major, see "
            "quant.kernel_layout)", wq.t(), torch.int8, (N, K))
    _expect(name, "w_scale", ws, torch.float32, (N,))
    _expect(name, "bias", bias, torch.float32, (N,))
    return M, N, K


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #

def gemm_bias_act_reference(a, w, bias, act: str = "none", drop=None,
                            save_h: bool = False):
    acc = acc_dtype(a.dtype)
    h = (a.to(acc) @ w.to(acc) + bias.to(acc)).to(a.dtype)
    y = h
    if act == "gelu":
        g = gelu(h.to(acc))
        if drop is not None:
            g = drop.apply(g)
        y = g.to(a.dtype)
    return (h, y) if save_h else y


def gemm_bias_residual_reference(a, w, bias, resid, drop=None,
                                 save_y2d: bool = False):
    acc = acc_dtype(a.dtype)
    y2 = (a.to(acc) @ w.to(acc) + bias.to(acc)).to(a.dtype).to(acc)
    if drop is not None:
        y2 = drop.apply(y2)
    s = y2 + resid.to(acc)
    return (s, y2.to(a.dtype)) if save_y2d else s


def gemm_dgrad_reference(a, w, epilogue: str, h=None, ds=None, drop=None):
    acc = acc_dtype(a.dtype)
    d = a.to(acc) @ w.to(acc).t()
    if epilogue == "none":
        return d.to(a.dtype)
    if epilogue == "residual":
        return (ds.to(acc) + d).to(a.dtype)
    if drop is not None:
        d = drop.apply(d)
    h32 = h.to(acc)
    g = gelu(h32)
    if drop is not None:
        g = drop.apply(g)
    return (d * gelu_grad(h32)).to(a.dtype), g.to(a.dtype)


def ffn_bwd_rows_reference(x, y2d, dy, ls, mean, rstd, drop=None):
    acc = acc_dtype(x.dtype)
    s = y2d.to(acc) + x.to(acc)
    xhat = (s - mean[:, None]) * rstd[:, None]
    gl = dy.to(acc) * ls.to(acc)
    m1 = gl.mean(dim=1, keepdim=True)
    m2 = (gl * xhat).mean(dim=1, keepdim=True)
    ds = (gl - m1 - xhat * m2) * rstd[:, None]
    dy2 = ds if drop is None else drop.apply(ds)
    return dy2.to(x.dtype), xhat.to(x.dtype), ds


def gemm_i8_bias_act_reference(xq, xs, wq, ws, bias, act: str = "none",
                               out_dtype=torch.bfloat16, drop=None,
                               save_h: bool = False):
    h = dequant(int_dot(xq, wq), xs[:, None], ws, bias).to(out_dtype)
    y = h
    if act == "gelu":
        g = gelu(h.to(acc_dtype(out_dtype)))
        if drop is not None:
            g = drop.apply(g)
        y = g.to(out_dtype)
    return (h, y) if save_h else y


def gemm_i8_bias_residual_reference(xq, xs, wq, ws, bias, resid, drop=None,
                                    save_y2d: bool = False):
    acc = acc_dtype(resid.dtype)
    y2 = dequant(int_dot(xq, wq), xs[:, None], ws, bias).to(
        resid.dtype).to(acc)
    if drop is not None:
        y2 = drop.apply(y2)
    s = y2 + resid.to(acc)
    return (s, y2.to(resid.dtype)) if save_y2d else s


def quantize_grad_rows_reference(g, ws, drop=None):
    """``quant_rows.cu``'s gradient variant: per-row int8 of ``drop(g) *
    ws`` in f32 (``nbest_asr_tpu/ops/fused_ffn.py:_dgrad_rows_i8``)."""
    g32 = g.to(torch.float32)
    if drop is not None:
        g32 = drop.apply(g32)
    q, scale = symmetric_int8(g32 * ws.to(torch.float32), -1)
    return q, scale.squeeze(-1)


def gemm_i8_dgrad_reference(gq, gs, wq, epilogue: str, h=None, ds=None,
                            drop=None, out_dtype=torch.bfloat16):
    """d = f32(gq . wq^T) * gs for wq (N, K), then the epilogue (see
    ``gemm_i8_dgrad``)."""
    d = int_dot(gq, wq.t()).to(torch.float32) * gs[:, None]
    if epilogue == "none":
        return d.to(out_dtype)
    if epilogue == "residual":
        return (ds.to(torch.float32) + d).to(out_dtype)
    if drop is not None:
        d = drop.apply(d)
    h32 = h.to(acc_dtype(h.dtype))
    dh = d * gelu_grad(h32)
    g = gelu(h32)
    if drop is not None:
        g = drop.apply(g)
    return dh.to(h.dtype), dh, g.to(h.dtype)


def layer_norm_reference(s, scale, bias, eps: float, out_dtype,
                         stats: bool = False):
    y, mean, rstd = layer_norm_stats(s, scale, bias, eps)
    y = y.to(s.dtype).to(out_dtype)
    return (y, mean[:, 0], rstd[:, 0]) if stats else y


def _erf_as(x):
    """erf by Abramowitz & Stegun 7.1.26, in the order of
    ``nbest_asr_tpu/ops/fused_gelu.py:_erf`` -- the function the fused
    GELU kernels compute, not ``torch.erf``."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_cdf(s):
    return 0.5 * (1.0 + _erf_as(s * INV_SQRT2))


def residual_layer_norm_reference(x, r, scale, bias, eps: float):
    """(y in x's dtype, mean (M,), rstd (M,)) of LN(x + r), the sum and
    statistics in (at least) f32."""
    acc = acc_dtype(x.dtype)
    y, mean, rstd = layer_norm_stats(x.to(acc) + r.to(acc), scale, bias, eps)
    return y.to(x.dtype), mean[:, 0], rstd[:, 0]


def residual_layer_norm_bwd_reference(x, r, dy, scale, mean, rstd):
    """(dx in x's dtype, dscale, dbias) of LN(x + r) from the forward's
    statistics, in the order of ``nbest_asr_tpu/ops/fused_ln.py:79``."""
    acc = acc_dtype(x.dtype)
    xhat = (x.to(acc) + r.to(acc) - mean[:, None]) * rstd[:, None]
    d = dy.to(acc)
    g = d * scale.to(acc)
    m1 = g.mean(dim=1, keepdim=True)
    m2 = (g * xhat).mean(dim=1, keepdim=True)
    dx = (g - m1 - xhat * m2) * rstd[:, None]
    return dx.to(x.dtype), (d * xhat).sum(dim=0), d.sum(dim=0)


def bias_gelu_reference(x, b):
    """gelu(x + b) with the A&S erf, in (at least) f32, out in x's
    dtype."""
    s = x.to(acc_dtype(x.dtype)) + b
    return (s * _gelu_cdf(s)).to(x.dtype)


def bias_gelu_bwd_reference(x, b, dy):
    """dy * (cdf + s * pdf) at s = x + b, out in x's dtype."""
    acc = acc_dtype(x.dtype)
    s = x.to(acc) + b
    pdf = torch.exp(-0.5 * s * s) * INV_SQRT2PI
    return (dy.to(acc) * (_gelu_cdf(s) + s * pdf)).to(x.dtype)


def embed_lookup_reference(word, pos, type_, scale, bias, ids, type_ids,
                           seq_len: int, eps: float):
    """(n, h) in the tables' dtype: LN(word[ids] + pos[t % seq_len] +
    type[type_ids]) for flat token rows t, the sum and statistics in (at
    least) f32; ``type_ids`` None reads type row 0.  Out-of-range ids
    read what JAX's lookup reads (``fused_embed.py:48``, interpret mode):
    a type id outside its table a zero row (its one-hot select), a word
    id in the table's padding to a multiple of 8 a zero row; a word id
    below 0 or past that padding raises ``IndexError``, as JAX's DMA of
    the row group does."""
    acc = acc_dtype(word.dtype)
    V, ids = word.shape[0], ids.long()
    if bool(((ids < 0) | (ids >= -(-V // 8) * 8)).any()):
        raise IndexError(f"embed_lookup: a word id outside [0, {V}) and "
                         "its padding to a multiple of 8")
    rows = torch.arange(ids.shape[0], device=ids.device) % seq_len
    zero = torch.zeros((), dtype=acc, device=word.device)
    w = torch.where((ids < V)[:, None], word[ids.clamp(max=V - 1)].to(acc),
                    zero)
    if type_ids is None:
        t = type_[0].to(acc)
    else:
        T, tids = type_.shape[0], type_ids.long()
        t = torch.where(((tids >= 0) & (tids < T))[:, None],
                        type_[tids.clamp(0, T - 1)].to(acc), zero)
    x = w + pos[rows].to(acc) + t
    return layer_norm_stats(x, scale, bias, eps)[0].to(word.dtype)


def _seg_scores(q, k, mask, sm_scale: float):
    """Scaled, segment-masked scores (b, n_heads, s, s) of (b, s,
    n_heads, d) q and k, in the accumulation dtype: MASK_VALUE where the
    segment ids differ."""
    acc = acc_dtype(q.dtype)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    m = mask.to(acc)
    same = m[:, None, :, None] == m[:, None, None, :]
    return torch.where(same, sc, torch.tensor(MASK_VALUE, dtype=acc,
                                              device=sc.device))


def _qkv_views(qkv, mask, n_heads: int):
    """q, k, v of the (b*s, 3h) QKV buffer as (b, s, n_heads, d) views
    (row stride 3h), and 1 / sqrt(d)."""
    b, s = mask.shape
    d = qkv.shape[1] // 3 // n_heads
    q, k, v = qkv.reshape(b, s, 3, n_heads, d).unbind(2)
    return q, k, v, 1.0 / float(d) ** 0.5


def _scores(qkv, mask, n_heads: int):
    """-> (q, k, v as (b, s, n_heads, d) in the accumulation dtype, the
    scaled segment-masked scores (b, n_heads, s, s), sm_scale) of the
    (b*s, 3h) QKV buffer."""
    q, k, v, sm_scale = _qkv_views(qkv, mask, n_heads)
    acc = acc_dtype(qkv.dtype)
    return (q.to(acc), k.to(acc), v.to(acc),
            _seg_scores(q, k, mask, sm_scale), sm_scale)


def _drop_probs(drop, p, elem0: int = 0):
    """The stream-3 prob dropout of (b, n_heads, s, s) probs of batch
    elements elem0 .. elem0 + b - 1: Philox row (elem * n_heads + head) *
    s + q, column k."""
    b, nh, s, sk = p.shape
    keep = keep_mask(drop.seed, drop.stream, elem0 * nh * s, b * nh * s, sk,
                     drop.rate, p.device).reshape(p.shape)
    scale = torch.tensor(drop.inv_keep, dtype=p.dtype, device=p.device)
    return torch.where(keep, p * scale, torch.zeros_like(p))


def sb_attention_reference(q, k, v, mask, sm_scale: float, drop=None,
                           stats: bool = False):
    """o = drop(softmax(scores)) rounded to q's dtype @ v, rounded: (b, s,
    n_heads, d) q, k, v -> (b, s, n_heads, d); with ``stats`` also the
    row max and sum of exp, (2, b, n_heads, s)."""
    sc = _seg_scores(q, k, mask, sm_scale)
    mx = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - mx)
    sm = e.sum(dim=-1, keepdim=True)
    p = e / sm
    if drop is not None:
        p = _drop_probs(drop, p)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(p.dtype),
                     v.to(p.dtype)).to(q.dtype)
    if stats:
        return o, torch.stack([mx[..., 0], sm[..., 0]])
    return o


def sb_attention_bwd_reference(q, k, v, dout, mask, stats, sm_scale: float,
                               drop=None):
    """(dq, dk, dv), (b, s, n_heads, d) each, line by line as
    ``nbest_asr_tpu/ops/flash_attention.py:_sb_bwd_kernel`` (:380-409)
    and ``fused_attention.py:_fab_bwd_kernel`` (:240-266), with the probs
    rebuilt from the forward's row statistics."""
    sc = _seg_scores(q, k, mask, sm_scale)
    acc = sc.dtype
    p = torch.exp(sc - stats[0][..., None].to(acc)) \
        / stats[1][..., None].to(acc)
    do = dout.to(acc)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.to(acc))
    p_v = p
    if drop is not None:
        p_v, dp = _drop_probs(drop, p), _drop_probs(drop, dp)
    p_vc = p_v.to(q.dtype).to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_vc, do)
    di = torch.sum(dp * p, dim=-1, keepdim=True)
    ds_a = (p * (dp - di) * sm_scale).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_a, k.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_a, q.to(acc))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def seg_attention_reference(qkv, mask, n_heads: int, drop=None,
                            stats: bool = False):
    """ctx (n, h) = ``sb_attention_reference`` of the QKV buffer's
    heads at sm_scale 1 / sqrt(d); with ``stats`` also the row max and sum
    of exp, (2, b, n_heads, s)."""
    n, h3 = qkv.shape
    q, k, v, sm_scale = _qkv_views(qkv, mask, n_heads)
    out = sb_attention_reference(q, k, v, mask, sm_scale, drop, stats)
    if stats:
        return out[0].reshape(n, h3 // 3), out[1]
    return out.reshape(n, h3 // 3)


def seg_attention_bwd_reference(qkv, dctx, mask, stats, n_heads: int,
                                drop=None):
    """dqkv (n, 3h), q | k | v columns: ``sb_attention_bwd_reference``
    of the QKV buffer's heads."""
    q, k, v, sm_scale = _qkv_views(qkv, mask, n_heads)
    grads = sb_attention_bwd_reference(q, k, v, dctx.reshape(q.shape), mask,
                                       stats, sm_scale, drop)
    return torch.stack(grads, dim=2).reshape(qkv.shape)


def _batch_chunks(b: int, n_heads: int, s: int):
    """Batch-element ranges whose (n_heads, s, s) scores stay below
    _REF_CHUNK elements together."""
    step = max(1, _REF_CHUNK // (n_heads * s * s))
    return [(e, min(b, e + step)) for e in range(0, b, step)]


def flash_fwd_reference(q, k, v, mask, sm_scale: float, drop=None):
    """The tiled forward's function: (b, s, n_heads, d) q, k, v -> (o in
    q's dtype, lse (b, n_heads, s) in the accumulation dtype), o =
    (round(drop(exp(s - m))) @ v) * (1 / l) for the row max m and sum l
    of exp, lse = m + log(max(l, 1e-30)) -- the kernel's arithmetic with
    the final max in place of the running one (the unnormalised probs
    are rounded to q's dtype before P.V, as on the card)."""
    b, s, nh, _ = q.shape
    o, lse = [], []
    for e0, e1 in _batch_chunks(b, nh, s):
        sc = _seg_scores(q[e0:e1], k[e0:e1], mask[e0:e1], sm_scale)
        mx = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - mx)
        l = p.sum(dim=-1, keepdim=True)
        lse.append((mx + torch.log(l.clamp_min(1e-30)))[..., 0])
        if drop is not None:
            p = _drop_probs(drop, p, e0)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(p.dtype),
                          v[e0:e1].to(p.dtype))
        o.append((pv * (1.0 / l).permute(0, 2, 1, 3)).to(q.dtype))
    return torch.cat(o), torch.cat(lse)


def _flash_bwd_parts(q, k, v, mask, lse, di, dout, sm_scale: float, drop,
                     want_dq: bool):
    """(dq, None, None) or (None, dk, dv) of the tiled backward from lse
    and di = rowsum(dout * o) (b, n_heads, s): p = exp(s - lse), dp =
    drop(dout v^T), ds = round(p * (dp - di) * sm_scale)."""
    b, s, nh, _ = q.shape
    acc = acc_dtype(q.dtype)
    dq, dk, dv = [], [], []
    for e0, e1 in _batch_chunks(b, nh, s):
        qc, kc, vc = q[e0:e1], k[e0:e1], v[e0:e1]
        do = dout[e0:e1].to(acc)
        p = torch.exp(_seg_scores(qc, kc, mask[e0:e1], sm_scale)
                      - lse[e0:e1, ..., None].to(acc))
        dp = torch.einsum("bqhd,bkhd->bhqk", do, vc.to(acc))
        p_v = p
        if drop is not None:
            p_v, dp = _drop_probs(drop, p, e0), _drop_probs(drop, dp, e0)
        ds = (p * (dp - di[e0:e1, ..., None].to(acc)) * sm_scale).to(
            q.dtype).to(acc)
        if want_dq:
            dq.append(torch.einsum("bhqk,bkhd->bqhd", ds, kc.to(acc)).to(
                q.dtype))
        else:
            dk.append(torch.einsum("bhqk,bqhd->bkhd", ds, qc.to(acc)).to(
                q.dtype))
            dv.append(torch.einsum("bhqk,bqhd->bkhd",
                                   p_v.to(q.dtype).to(acc), do).to(q.dtype))
    if want_dq:
        return torch.cat(dq), None, None
    return None, torch.cat(dk), torch.cat(dv)


def flash_bwd_dq_reference(q, k, v, mask, o, lse, dout, sm_scale: float,
                           drop=None):
    """(dq, di): di = rowsum(f32(dout) * f32(o)) (b, n_heads, s), then dq
    (``nbest_asr_tpu/ops/flash_attention.py:_bwd_dq_kernel`` :276)."""
    acc = acc_dtype(q.dtype)
    di = torch.einsum("bqhd,bqhd->bhq", o.to(acc), dout.to(acc))
    return _flash_bwd_parts(q, k, v, mask, lse, di, dout, sm_scale, drop,
                            True)[0], di


def flash_bwd_dkv_reference(q, k, v, mask, lse, di, dout, sm_scale: float,
                            drop=None):
    """(dk, dv) (``flash_attention.py:_bwd_dkv_kernel`` :226)."""
    return _flash_bwd_parts(q, k, v, mask, lse, di, dout, sm_scale, drop,
                            False)[1:]


def flash_bwd_reference(q, k, v, mask, o, lse, dout, sm_scale: float,
                        drop=None):
    """(dq, dk, dv) of the tiled backward."""
    dq, di = flash_bwd_dq_reference(q, k, v, mask, o, lse, dout, sm_scale,
                                    drop)
    return (dq, *flash_bwd_dkv_reference(q, k, v, mask, lse, di, dout,
                                         sm_scale, drop))


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #

def gemm_bias_act(a, w, bias, act: str = "none", drop=None,
                  save_h: bool = False):
    """(M, K) @ (K, N) + bias, rounded to bf16 (``h``), then ``act``
    ("none" or exact-erf "gelu") in f32, the Philox dropout ``drop``
    (gelu only) and a second rounding.  Output (M, N) bf16, or ``(h,
    out)`` with ``save_h``."""
    if act not in ("none", "gelu"):
        raise ValueError(f"gemm_bias_act: act must be 'none' or 'gelu', "
                         f"got {act!r}")
    if drop is not None and act != "gelu":
        raise ValueError("gemm_bias_act: dropout follows the GELU only")
    if not _on_cuda("gemm_bias_act", a, w, bias):
        return gemm_bias_act_reference(a, w, bias, act, drop, save_h)
    # TMA zero-fills the depth past K; it needs rows of a 16-byte pitch
    M, N, K = _gemm_dims("gemm_bias_act", a, w, k_mult=8)
    _expect("gemm_bias_act", "a", a, torch.bfloat16, (M, K))
    _expect("gemm_bias_act", "w", w, torch.bfloat16, (K, N))
    _expect("gemm_bias_act", "bias", bias, torch.float32, (N,))
    _aligned16("gemm_bias_act", a=a, w=w, bias=bias)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    gelu_h = save_h and act == "gelu"     # without the GELU, h is out
    h = torch.empty_like(out) if gelu_h else None
    rc = _cuda.lib().nbk_gemm_bias_act(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        _ptr(h), M, N, K, 1 if act == "gelu" else 0, *_drop_args(drop),
        _stream(a))
    _cuda.check(rc, "gemm_bias_act")
    _cuda.launch_counts["gemm_bias_act"] += 1
    if save_h:
        return (h if gelu_h else out), out
    return out


def gemm_bias_residual(a, w, bias, resid, drop=None,
                       save_y2d: bool = False):
    """y2 = drop(f32(bf16(a @ w + bias))); y2 + f32(resid): the residual
    sum, in f32, that ``layer_norm`` normalises.  Output (M, N) f32, or
    ``(sum, y2d)`` with ``save_y2d`` (y2d = bf16(y2))."""
    if not _on_cuda("gemm_bias_residual", a, w, bias, resid):
        return gemm_bias_residual_reference(a, w, bias, resid, drop,
                                            save_y2d)
    M, N, K = _gemm_dims("gemm_bias_residual", a, w)
    _expect("gemm_bias_residual", "a", a, torch.bfloat16, (M, K))
    _expect("gemm_bias_residual", "w", w, torch.bfloat16, (K, N))
    _expect("gemm_bias_residual", "bias", bias, torch.float32, (N,))
    _expect("gemm_bias_residual", "resid", resid, torch.bfloat16, (M, N))
    _aligned16("gemm_bias_residual", a=a, w=w, bias=bias, resid=resid)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    y2d = torch.empty((M, N), dtype=torch.bfloat16, device=a.device) \
        if save_y2d else None
    rc = _cuda.lib().nbk_gemm_bias_residual(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), resid.data_ptr(),
        out.data_ptr(), _ptr(y2d), M, N, K, *_drop_args(drop), _stream(a))
    _cuda.check(rc, "gemm_bias_residual")
    _cuda.launch_counts["gemm_bias_residual"] += 1
    return (out, y2d) if save_y2d else out


DGRAD_EPILOGUES = {"dgelu": 0, "residual": 1, "none": 2}   # nbk_gemm_dgrad


def gemm_dgrad(a, w, epilogue: str, h=None, ds=None, drop=None):
    """``a (M, K) @ w.T`` for the forward's weight ``w`` (N, K), with the
    backward's epilogues:

    - "dgelu": ``(dh, gd)``, dh = bf16(drop(a @ w.T) * gelu'(f32 h)) and
      gd = bf16(drop(gelu(f32 h))), for h (M, N) bf16;
    - "residual": dx = bf16(ds + a @ w.T), for ds (M, N) f32;
    - "none": bf16(a @ w.T) (the attention block's dctx)."""
    if epilogue not in DGRAD_EPILOGUES:
        raise ValueError(f"gemm_dgrad: epilogue must be one of "
                         f"{sorted(DGRAD_EPILOGUES)}, got {epilogue!r}")
    operand = {"dgelu": h, "residual": ds, "none": a}[epilogue]
    if operand is None:
        raise ValueError(f"gemm_dgrad: the {epilogue!r} epilogue needs "
                         f"{'h' if epilogue == 'dgelu' else 'ds'}")
    if epilogue != "dgelu" and drop is not None:
        raise ValueError(f"gemm_dgrad: the {epilogue} epilogue has no "
                         "dropout")
    if not _on_cuda("gemm_dgrad", a, w, operand):
        return gemm_dgrad_reference(a, w, epilogue, h, ds, drop)
    M, N, K = _gemm_dims("gemm_dgrad", a, w.t())
    _expect("gemm_dgrad", "a", a, torch.bfloat16, (M, K))
    _expect("gemm_dgrad", "w", w, torch.bfloat16, (N, K))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    gd = None
    if epilogue == "dgelu":
        _expect("gemm_dgrad", "h", h, torch.bfloat16, (M, N))
        gd = torch.empty_like(out)
    elif epilogue == "residual":
        _expect("gemm_dgrad", "ds", ds, torch.float32, (M, N))
    _aligned16("gemm_dgrad", a=a, w=w, h=h, ds=ds)
    rc = _cuda.lib().nbk_gemm_dgrad(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), _ptr(h), _ptr(gd),
        _ptr(ds), M, N, K, DGRAD_EPILOGUES[epilogue],
        *_drop_args(drop), _stream(a))
    _cuda.check(rc, "gemm_dgrad")
    _cuda.launch_counts["gemm_dgrad"] += 1
    return (out, gd) if epilogue == "dgelu" else out


def ffn_bwd_rows(x, y2d, dy, ls, mean, rstd, drop=None):
    """The LayerNorm-backward row pass over (M, N) rows: ``(dy2, xhat,
    ds)`` with dy2 = bf16(drop(ds)), xhat bf16, ds f32 (see
    csrc/ffn_bwd.cu).  The FFN block runs it on its y2d; the attention
    block on its od (dy2 is then dout, the out-proj output's gradient)."""
    if not _on_cuda("ffn_bwd_rows", x, y2d, dy, ls, mean, rstd):
        return ffn_bwd_rows_reference(x, y2d, dy, ls, mean, rstd, drop)
    if x.dim() != 2:
        raise ValueError(f"ffn_bwd_rows: expected (M, N), got "
                         f"{tuple(x.shape)}")
    M, N = x.shape
    if N % 128 or N > 1024:
        raise ValueError(f"ffn_bwd_rows: the kernel needs N % 128 == 0 and "
                         f"N <= 1024, got N={N}")
    for name, t in (("x", x), ("y2d", y2d), ("dy", dy)):
        _expect("ffn_bwd_rows", name, t, torch.bfloat16, (M, N))
    _expect("ffn_bwd_rows", "ls", ls, torch.float32, (N,))
    _expect("ffn_bwd_rows", "mean", mean, torch.float32, (M,))
    _expect("ffn_bwd_rows", "rstd", rstd, torch.float32, (M,))
    dy2 = torch.empty_like(x)
    xhat = torch.empty_like(x)
    ds = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = _cuda.lib().nbk_ffn_bwd_rows(
        x.data_ptr(), y2d.data_ptr(), dy.data_ptr(), ls.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dy2.data_ptr(), xhat.data_ptr(),
        ds.data_ptr(), M, N, *_drop_args(drop), _stream(x))
    _cuda.check(rc, "ffn_bwd_rows")
    _cuda.launch_counts["ffn_bwd_rows"] += 1
    return dy2, xhat, ds


def layer_norm_rows(s, scale, bias, eps: float, out_dtype=torch.bfloat16,
                    stats: bool = False):
    """Row LayerNorm of the (M, N) f32 residual sum; f32 statistics,
    output ``out_dtype`` (bf16 on the kernel); with ``stats`` also the
    row mean and rstd, (M,) f32 each."""
    if not _on_cuda("layer_norm", s, scale, bias):
        return layer_norm_reference(s, scale, bias, eps, out_dtype, stats)
    if s.dim() != 2:
        raise ValueError(f"layer_norm: expected (M, N), got "
                         f"{tuple(s.shape)}")
    M, N = s.shape
    if N % 128 or N > 1024:
        raise ValueError(f"layer_norm: the kernel needs N % 128 == 0 and "
                         f"N <= 1024, got N={N}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"layer_norm: the kernel writes bf16, not "
                        f"{out_dtype}")
    _expect("layer_norm", "s", s, torch.float32, (M, N))
    _expect("layer_norm", "scale", scale, torch.float32, (N,))
    _expect("layer_norm", "bias", bias, torch.float32, (N,))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=s.device)
    mean = rstd = None
    if stats:
        mean = torch.empty((M,), dtype=torch.float32, device=s.device)
        rstd = torch.empty_like(mean)
    rc = _cuda.lib().nbk_layer_norm(
        s.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        _ptr(mean), _ptr(rstd), M, N, float(eps), _stream(s))
    _cuda.check(rc, "layer_norm")
    _cuda.launch_counts["layer_norm"] += 1
    return (out, mean, rstd) if stats else out


def _attn_dims(name: str, qkv, mask, n_heads: int):
    """Check the attention kernels' QKV and mask; returns (b, s, h)."""
    if qkv.dim() != 2 or mask.dim() != 2 or qkv.shape[1] % 3:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)}, mask "
                         f"{tuple(mask.shape)}")
    b, s = mask.shape
    h = qkv.shape[1] // 3
    if n_heads < 1 or h < n_heads or h % n_heads:
        raise ValueError(f"{name}: {h} columns do not split into {n_heads} "
                         "heads")
    if s > MAX_SEQ:
        raise ValueError(f"{name}: seq {s} > {MAX_SEQ}")
    _expect(name, "qkv", qkv, torch.bfloat16, (b * s, 3 * h))
    _expect(name, "mask", mask, torch.float32, (b, s))
    return b, s, h


def _row_stride(name: str, arg: str, t, ld=None) -> int:
    """The row stride of a (b, s, n_heads, d) operand whose rows are
    (n_heads * d) contiguous values, ld apart (``ld`` if given); raises on
    any other layout."""
    b, s, nh, d = t.shape
    if ld is None:
        ld = t.stride(1) if s > 1 else t.stride(0)
    want = (s * ld, ld, d, 1)
    if not all(st == w or n == 1 for st, w, n in zip(t.stride(), want,
                                                     t.shape)):
        raise ValueError(f"{name}: {arg} has strides {t.stride()}; the "
                         f"kernel reads rows of {nh} x {d} contiguous values "
                         f"{ld} apart")
    return ld


def _bshd(name: str, q, k, v, mask, max_seq=None):
    """Check (b, s, n_heads, d) bf16 q, k, v sharing one row stride ld
    and the (b, s) f32 mask; returns (b, s, n_heads, d, ld).  The
    fixed-width instances copy 16 bytes at a time, so they need ld % 8 ==
    0 and 16-byte aligned operands; the chunked family (``chunked_head_dim``)
    copies at whatever width the operands allow."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, nh, d = q.shape
    if d < 1:
        raise ValueError(f"{name}: head dim {d}")
    if max_seq is not None and s > max_seq:
        raise ValueError(f"{name}: seq {s} > {max_seq}")
    ld = _row_stride(name, "q", q)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {arg} is {t.dtype}, the kernel takes "
                            "torch.bfloat16")
        _row_stride(name, arg, t, ld)
        if not chunked_head_dim(d) and (t.data_ptr() % 16 or ld % 8):
            raise ValueError(f"{name}: {arg} must be 16-byte aligned with a "
                             f"row stride % 8 == 0 (got {ld})")
    _expect(name, "mask", mask, torch.float32, (b, s))
    return b, s, nh, d, ld


def _stat_rows(st, b: int, nh: int, s: int):
    """Pointers of the row max and sum planes of (2, b, nh, s) f32
    statistics (None, None without them)."""
    if st is None:
        return None, None
    return st.data_ptr(), st.data_ptr() + 4 * b * nh * s


def _launch_seg_attention(qkv_ptrs, ld, mask, out, st, b, s, nh, d,
                          sm_scale, drop, stream):
    if attn_instance(d, s) == "chunked":
        rc = _cuda.lib().nbk_chunked_fwd(
            *qkv_ptrs, ld, mask.data_ptr(), out.data_ptr(),
            *_stat_rows(st, b, nh, s), 0, b, s, nh, d, float(sm_scale),
            *_drop_args(drop), stream)
        _cuda.check(rc, "seg_attention")
        _cuda.launch_counts["seg_attention"] += 1
        return
    rc = _cuda.lib().nbk_seg_attention(
        *qkv_ptrs, ld, mask.data_ptr(), out.data_ptr(), _ptr(st), b, s, nh,
        d, _instance_arg(d, s, False), float(sm_scale), *_drop_args(drop),
        stream)
    _cuda.check(rc, "seg_attention")
    _cuda.launch_counts["seg_attention"] += 1


def _launch_seg_attention_bwd(qkv_ptrs, ld, dout, mask, stats, grad_ptrs,
                              ld_g, b, s, nh, d, sm_scale, drop, stream):
    di = torch.empty((b, nh, s), dtype=torch.float32, device=mask.device)
    if attn_instance(d, s, True) == "chunked":
        # the dQ kernel's first sweep writes di = rowsum(dp * p), which
        # the dK/dV kernel reads
        lib, st = _cuda.lib(), _stat_rows(stats, b, nh, s)
        rc = lib.nbk_chunked_bwd_dq(
            *qkv_ptrs, ld, None, dout.data_ptr(), mask.data_ptr(), *st,
            di.data_ptr(), grad_ptrs[0], ld_g, b, s, nh, d, float(sm_scale),
            *_drop_args(drop), stream)
        _cuda.check(rc, "seg_attention_bwd")
        rc = lib.nbk_chunked_bwd_dkv(
            *qkv_ptrs, ld, dout.data_ptr(), mask.data_ptr(), *st,
            di.data_ptr(), *grad_ptrs[1:], ld_g, b, s, nh, d,
            float(sm_scale), *_drop_args(drop), stream)
        _cuda.check(rc, "seg_attention_bwd")
        _cuda.launch_counts["seg_attention_bwd"] += 1
        return
    rc = _cuda.lib().nbk_seg_attention_bwd(
        *qkv_ptrs, ld, dout.data_ptr(), mask.data_ptr(), stats.data_ptr(),
        di.data_ptr(), *grad_ptrs, ld_g, b, s, nh, d,
        _instance_arg(d, s, True), float(sm_scale), *_drop_args(drop),
        stream)
    _cuda.check(rc, "seg_attention_bwd")
    _cuda.launch_counts["seg_attention_bwd"] += 1


def _wgmma_head_dim(d: int) -> None:
    if d and attn_instance(d, 1) != "wgmma":
        raise ValueError(f"the single-block pair has no wgmma instance at "
                         f"head dim {d}")


def seg_attention_wgmma_launches(d: int = 0) -> int:
    """Launches of ``seg_attention``'s wgmma kernels since the kernels were
    loaded, at head dim ``d`` (64, 96 or 192; 0: all three; any other d
    raises):
    which instance ran (``attn_instance``)."""
    _wgmma_head_dim(d)
    return int(_cuda.lib().nbk_seg_attention_wgmma_launches(d))


def seg_attention_bwd_wgmma_launches(d: int = 0) -> int:
    """Launches of ``seg_attention_bwd``'s wgmma pairs since the kernels
    were loaded, at head dim ``d`` (64, 96 or 192; 0: all three; any other
    d raises): which instance ran (``attn_instance``)."""
    _wgmma_head_dim(d)
    return int(_cuda.lib().nbk_seg_attention_bwd_wgmma_launches(d))


# the chunked family's kernels, in the order of nbk_chunked_launches
CHUNKED = ("chunked_fwd", "chunked_bwd_dq", "chunked_bwd_dkv")


def attn_chunked_launches() -> dict:
    """Launches of the chunked family's kernels since the kernels were
    loaded, per kernel: the routing behind the ``seg_attention``,
    ``seg_attention_bwd`` and tiled counters at the head dims
    ``chunked_head_dim`` names (a single-block backward launches
    ``chunked_bwd_dq`` and ``chunked_bwd_dkv`` once each)."""
    lib = _cuda.lib()
    return {name: int(lib.nbk_chunked_launches(i))
            for i, name in enumerate(CHUNKED)}


# chunked_fwd's instances (csrc/attention_chunked.cu, fwd_instance), in the
# order of nbk_chunked_fwd_instance_launches: the columns of the output
# slab a block keeps in registers, Q resident in shared memory but in the
# last, which streams Q's panels beside K's and takes its slabs in turn
CHUNKED_FWD_INSTANCES = ("slab32", "slab64", "slab128", "slab192",
                         "slab384", "slab384_streamed_q")


def chunked_fwd_instance(d: int) -> str:
    """The ``chunked_fwd`` instance that head dim d (>= 1) runs: the
    narrowest slab of 32, 64, 128, 192 or 384 columns at least
    ceil16(d) wide (one warpgroup to 192, two at 384), Q resident; wider
    heads on the 384-column slab with Q streamed.  The library's own rule
    (``fwd_instance``), mirrored so that ``chunked_fwd_instance_launches``
    can be read per head dim."""
    if d < 1:
        raise ValueError(f"chunked_fwd: head dim {d}")
    d16 = -(-d // 16) * 16
    return next((f"slab{w}" for w in (32, 64, 128, 192, 384) if d16 <= w),
                "slab384_streamed_q")


def chunked_fwd_instance_launches() -> dict:
    """Launches of ``chunked_fwd`` since the kernels were loaded, per
    instance of ``CHUNKED_FWD_INSTANCES``: which one ran."""
    lib = _cuda.lib()
    return {name: int(lib.nbk_chunked_fwd_instance_launches(i))
            for i, name in enumerate(CHUNKED_FWD_INSTANCES)}


def _column_blocks(t, h: int):
    """Pointers of the q | k | v column blocks of a (n, 3h) bf16 buffer."""
    p = t.data_ptr()
    return p, p + 2 * h, p + 4 * h


def sb_attention(q, k, v, mask, sm_scale: float, drop=None,
                 stats: bool = False):
    """Single-block segment attention of (b, s, n_heads, d) q, k, v (s <=
    512; on the card bf16 sharing one row stride: views of the QKV buffer
    or standalone tensors) and the (b, s) segment mask -> o (b, s,
    n_heads, d), with the Philox prob dropout ``drop`` (stream 3) applied
    to the normalised f32 probs before their bf16 rounding; with
    ``stats`` also ``(o, stats)``, stats (2, b, n_heads, s) f32 = each
    row's max and sum of exp.  Launches ``seg_attention``."""
    if not _on_cuda("seg_attention", q, k, v, mask):
        return sb_attention_reference(q, k, v, mask, sm_scale, drop, stats)
    b, s, nh, d, ld = _bshd("seg_attention", q, k, v, mask, MAX_SEQ)
    out = torch.empty((b, s, nh, d), dtype=torch.bfloat16, device=q.device)
    st = torch.empty((2, b, nh, s), dtype=torch.float32,
                     device=q.device) if stats else None
    _launch_seg_attention((q.data_ptr(), k.data_ptr(), v.data_ptr()), ld,
                          mask, out, st, b, s, nh, d, sm_scale, drop,
                          _stream(q))
    return (out, st) if stats else out


def sb_attention_bwd(q, k, v, dout, mask, stats, sm_scale: float,
                     drop=None):
    """The single-block backward: (dq, dk, dv), (b, s, n_heads, d) each,
    from q, k, v as ``sb_attention`` took them, the bf16 output gradient
    ``dout`` (b, s, n_heads, d), the mask and ``sb_attention``'s row
    statistics, regenerating the forward's stream-3 mask (see
    csrc/seg_attention_bwd.cu).  Launches ``seg_attention_bwd``."""
    name = "seg_attention_bwd"
    if not _on_cuda(name, q, k, v, dout, mask, stats):
        return sb_attention_bwd_reference(q, k, v, dout, mask, stats,
                                          sm_scale, drop)
    b, s, nh, d, ld = _bshd(name, q, k, v, mask, MAX_SEQ)
    _expect(name, "dout", dout, torch.bfloat16, (b, s, nh, d))
    _expect(name, "stats", stats, torch.float32, (2, b, nh, s))
    grads = tuple(torch.empty(q.shape, dtype=torch.bfloat16,
                              device=q.device) for _ in range(3))
    _launch_seg_attention_bwd(
        (q.data_ptr(), k.data_ptr(), v.data_ptr()), ld, dout, mask, stats,
        tuple(g.data_ptr() for g in grads), nh * d, b, s, nh, d, sm_scale,
        drop, _stream(q))
    return grads


def seg_attention(qkv, mask, n_heads: int, drop=None, stats: bool = False):
    """(b*s, 3h) QKV + (b, s) segment mask -> ctx (b*s, h): the
    ``sb_attention`` kernel on the buffer's q | k | v column blocks (row
    stride 3h) at sm_scale 1 / sqrt(d); with ``stats`` also ``(ctx,
    stats)``, stats (2, b, n_heads, s) f32, from which
    ``seg_attention_bwd`` rebuilds the probs."""
    if not _on_cuda("seg_attention", qkv, mask):
        return seg_attention_reference(qkv, mask, n_heads, drop, stats)
    b, s, h = _attn_dims("seg_attention", qkv, mask, n_heads)
    out = torch.empty((b * s, h), dtype=torch.bfloat16, device=qkv.device)
    st = torch.empty((2, b, n_heads, s), dtype=torch.float32,
                     device=qkv.device) if stats else None
    d = h // n_heads
    _launch_seg_attention(_column_blocks(qkv, h), 3 * h, mask, out, st, b,
                          s, n_heads, d, 1.0 / float(d) ** 0.5, drop,
                          _stream(qkv))
    return (out, st) if stats else out


def seg_attention_bwd(qkv, dctx, mask, stats, n_heads: int, drop=None):
    """The attention backward from the (b*s, 3h) QKV, the (b*s, h) bf16
    ctx gradient, the mask and ``seg_attention``'s row statistics ->
    dqkv (b*s, 3h) bf16, written by the kernel straight into its q | k |
    v column blocks."""
    if not _on_cuda("seg_attention_bwd", qkv, dctx, mask, stats):
        return seg_attention_bwd_reference(qkv, dctx, mask, stats, n_heads,
                                           drop)
    b, s, h = _attn_dims("seg_attention_bwd", qkv, mask, n_heads)
    _expect("seg_attention_bwd", "dctx", dctx, torch.bfloat16, (b * s, h))
    _expect("seg_attention_bwd", "stats", stats, torch.float32,
            (2, b, n_heads, s))
    dqkv = torch.empty_like(qkv)
    d = h // n_heads
    _launch_seg_attention_bwd(_column_blocks(qkv, h), 3 * h, dctx, mask,
                              stats, _column_blocks(dqkv, h), 3 * h, b, s,
                              n_heads, d, 1.0 / float(d) ** 0.5, drop,
                              _stream(qkv))
    return dqkv


def flash_fwd(q, k, v, mask, sm_scale: float, drop=None):
    """The tiled flash forward of (b, s, n_heads, d) q, k, v (any s; on
    the card bf16 sharing one row stride) and the (b, s) segment mask ->
    (o (b, s, n_heads, d), lse (b, n_heads, s) f32), with the Philox prob
    dropout ``drop`` (stream 3).  The library picks the kernel by d: the
    chunked family's ``chunked_fwd`` where ``chunked_head_dim(d)`` holds."""
    if not _on_cuda("flash_fwd", q, k, v, mask):
        return flash_fwd_reference(q, k, v, mask, sm_scale, drop)
    b, s, nh, d, ld = _bshd("flash_fwd", q, k, v, mask)
    o = torch.empty((b, s, nh, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    rc = _cuda.lib().nbk_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, mask.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, s, nh, d, float(sm_scale),
        *_drop_args(drop), _stream(q))
    _cuda.check(rc, "flash_fwd")
    _cuda.launch_counts["flash_fwd"] += 1
    return o, lse


def _flash_bwd_checks(name, q, k, v, mask, lse, dout, stat2, stat2_name):
    b, s, nh, d, ld = _bshd(name, q, k, v, mask)
    _expect(name, "dout", dout, torch.bfloat16, (b, s, nh, d))
    _expect(name, "lse", lse, torch.float32, (b, nh, s))
    if stat2_name == "o":
        _expect(name, "o", stat2, torch.bfloat16, (b, s, nh, d))
    else:
        _expect(name, "di", stat2, torch.float32, (b, nh, s))
    if not chunked_head_dim(d):
        _aligned16(name, dout=dout, **({"o": stat2} if stat2_name == "o"
                                       else {}))
    return b, s, nh, d, ld


# the head dims at which each tiled kernel runs its wgmma + TMA instance
# (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu); the mma.sync
# kernels take every other head dim but those ``chunked_head_dim`` names,
# which the same entry points hand to the chunked family
FLASH_WGMMA = {"flash_fwd": (64, 96), "flash_bwd_dq": (64, 96),
               "flash_bwd_dkv": (64, 96)}


def flash_wgmma_launches(d: int = 0) -> dict:
    """Launches of the tiled kernels' wgmma + TMA instances since the
    kernels were loaded, per kernel, at head dim ``d`` (64 or 96, where
    ``FLASH_WGMMA`` names an instance; 0: all; any other d raises, as a
    count there would read 0 whatever ran): the routing behind the
    ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` counters.
    The padded head dims 72 .. 88 run on the mma.sync 96 instance and
    count nowhere here."""
    if d and not any(d in dims for dims in FLASH_WGMMA.values()):
        raise ValueError(f"the tiled kernels have no wgmma instance at head "
                         f"dim {d}")
    lib = _cuda.lib()
    return {"flash_fwd": int(lib.nbk_flash_fwd_wgmma_launches(d)),
            "flash_bwd_dq": int(lib.nbk_flash_bwd_wgmma_launches(0, d)),
            "flash_bwd_dkv": int(lib.nbk_flash_bwd_wgmma_launches(1, d))}


def flash_bwd_dq(q, k, v, mask, o, lse, dout, sm_scale: float, drop=None):
    """The tiled backward's dQ kernel -> (dq (b, s, n_heads, d), di (b,
    n_heads, s) f32 = rowsum(dout * o)), from ``flash_fwd``'s inputs, o
    and lse and the bf16 output gradient ``dout``."""
    if not _on_cuda("flash_bwd_dq", q, k, v, mask, o, lse, dout):
        return flash_bwd_dq_reference(q, k, v, mask, o, lse, dout, sm_scale,
                                      drop)
    b, s, nh, d, ld = _flash_bwd_checks("flash_bwd_dq", q, k, v, mask, lse,
                                        dout, o, "o")
    dq = torch.empty((b, s, nh, d), dtype=torch.bfloat16, device=q.device)
    di = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    rc = _cuda.lib().nbk_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, o.data_ptr(),
        dout.data_ptr(), mask.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), nh * d, b, s, nh, d, float(sm_scale),
        *_drop_args(drop), _stream(q))
    _cuda.check(rc, "flash_bwd_dq")
    _cuda.launch_counts["flash_bwd_dq"] += 1
    return dq, di


def flash_bwd_dkv(q, k, v, mask, lse, di, dout, sm_scale: float,
                  drop=None):
    """The tiled backward's dK/dV kernel -> (dk, dv), (b, s, n_heads, d)
    each, from ``flash_fwd``'s inputs, lse, ``flash_bwd_dq``'s di and the
    bf16 output gradient ``dout``."""
    if not _on_cuda("flash_bwd_dkv", q, k, v, mask, lse, di, dout):
        return flash_bwd_dkv_reference(q, k, v, mask, lse, di, dout,
                                       sm_scale, drop)
    b, s, nh, d, ld = _flash_bwd_checks("flash_bwd_dkv", q, k, v, mask, lse,
                                        dout, di, "di")
    dk = torch.empty((b, s, nh, d), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    rc = _cuda.lib().nbk_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, dout.data_ptr(),
        mask.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), nh * d, b, s, nh, d, float(sm_scale),
        *_drop_args(drop), _stream(q))
    _cuda.check(rc, "flash_bwd_dkv")
    _cuda.launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


def quantize_rows_pass_launches() -> dict:
    """Launches of ``quantize_rows``' row pass since the kernels were
    loaded, by row width K = 256 n, n = 1 .. 16 (csrc/quant_rows.cu; any
    other K runs its two-pass kernel): the routing behind the
    ``quantize_rows`` counter."""
    lib = _cuda.lib()
    return {256 * n: int(lib.nbk_quantize_rows_pass_launches(n))
            for n in range(1, 17)}


def quantize_grad_rows_pass_launches() -> dict:
    """Launches of ``quantize_grad_rows``' row pass since the kernels were
    loaded, by row width K = 256 n, n = 1 .. 16 (as
    ``quantize_rows_pass_launches``)."""
    lib = _cuda.lib()
    return {256 * n: int(lib.nbk_quantize_grad_rows_pass_launches(n))
            for n in range(1, 17)}


def quantize_rows(x):
    """Per-token symmetric int8 of (M, K) bf16/f32 rows -> (q (M, K)
    int8, scale (M,) f32)."""
    if not _on_cuda("quantize_rows", x):
        return quantize_rows_reference(x)
    if x.dim() != 2 or x.shape[1] % 8:
        raise ValueError(f"quantize_rows: the kernel takes (M, K) with "
                         f"K % 8 == 0, got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_rows: x is {x.dtype}, the kernel takes "
                        "bf16 or f32")
    M, K = x.shape
    _expect("quantize_rows", "x", x, x.dtype, (M, K))
    _aligned16("quantize_rows", x=x)
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    rc = _cuda.lib().nbk_quantize_rows(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K,
        int(x.dtype == torch.float32), _stream(x))
    _cuda.check(rc, "quantize_rows")
    _cuda.launch_counts["quantize_rows"] += 1
    return q, scale


def gemm_i8_bias_act(xq, xs, wq, ws, bias, act: str = "none",
                     out_dtype=torch.bfloat16, drop=None,
                     save_h: bool = False):
    """dequant(xq (M, K) int8 . wq (K, N) int8) + bias, rounded to
    ``out_dtype`` (``h``), then ``act`` ("none" or exact-erf "gelu") in
    f32, the Philox dropout ``drop`` (gelu only) and a second rounding.
    The kernel writes bf16; ``(h, out)`` with ``save_h``."""
    if act not in ("none", "gelu"):
        raise ValueError(f"gemm_i8_bias_act: act must be 'none' or 'gelu', "
                         f"got {act!r}")
    if drop is not None and act != "gelu":
        raise ValueError("gemm_i8_bias_act: dropout follows the GELU only")
    if not _on_cuda("gemm_i8_bias_act", xq, xs, wq, ws, bias):
        return gemm_i8_bias_act_reference(xq, xs, wq, ws, bias, act,
                                          out_dtype, drop, save_h)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"gemm_i8_bias_act: the kernel writes bf16, not "
                        f"{out_dtype}")
    M, N, K = _i8_operands("gemm_i8_bias_act", xq, xs, wq, ws, bias)
    _aligned16("gemm_i8_bias_act", xq=xq, x_scale=xs, wq=wq, w_scale=ws,
               bias=bias)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    gelu_h = save_h and act == "gelu"     # without the GELU, h is out
    h = torch.empty_like(out) if gelu_h else None
    rc = _cuda.lib().nbk_gemm_i8_bias_act(
        xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
        bias.data_ptr(), out.data_ptr(), _ptr(h), M, N, K,
        1 if act == "gelu" else 0, *_drop_args(drop), _stream(xq))
    _cuda.check(rc, "gemm_i8_bias_act")
    _cuda.launch_counts["gemm_i8_bias_act"] += 1
    if save_h:
        return (h if gelu_h else out), out
    return out


def gemm_i8_bias_residual(xq, xs, wq, ws, bias, resid, drop=None,
                          save_y2d: bool = False):
    """y2 = drop(f32(round(dequant(xq . wq) + bias))), rounded to resid's
    dtype first; y2 + f32(resid): the residual sum, in f32, that
    ``layer_norm`` normalises; ``(sum, y2d)`` with ``save_y2d`` (y2d =
    y2 in resid's dtype).  The kernel takes a bf16 residual."""
    if not _on_cuda("gemm_i8_bias_residual", xq, xs, wq, ws, bias, resid):
        return gemm_i8_bias_residual_reference(xq, xs, wq, ws, bias, resid,
                                               drop, save_y2d)
    M, N, K = _i8_operands("gemm_i8_bias_residual", xq, xs, wq, ws, bias)
    _expect("gemm_i8_bias_residual", "resid", resid, torch.bfloat16, (M, N))
    _aligned16("gemm_i8_bias_residual", xq=xq, x_scale=xs, wq=wq,
               w_scale=ws, bias=bias, resid=resid)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    y2d = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device) \
        if save_y2d else None
    rc = _cuda.lib().nbk_gemm_i8_bias_residual(
        xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
        bias.data_ptr(), resid.data_ptr(), out.data_ptr(), _ptr(y2d), M, N,
        K, *_drop_args(drop), _stream(xq))
    _cuda.check(rc, "gemm_i8_bias_residual")
    _cuda.launch_counts["gemm_i8_bias_residual"] += 1
    return (out, y2d) if save_y2d else out


def quantize_grad_rows(g, ws, drop=None):
    """Per-token symmetric int8 of ``drop(g) * ws`` for a gradient g (M, K)
    bf16/f32 and the (K,) f32 per-output-channel scales of the weight the
    next dgrad contracts over -> (q (M, K) int8, scale (M,) f32)."""
    if not _on_cuda("quantize_grad_rows", g, ws):
        return quantize_grad_rows_reference(g, ws, drop)
    if g.dim() != 2 or g.shape[1] % 8:
        raise ValueError(f"quantize_grad_rows: the kernel takes (M, K) with "
                         f"K % 8 == 0, got {tuple(g.shape)}")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_grad_rows: g is {g.dtype}, the kernel "
                        "takes bf16 or f32")
    M, K = g.shape
    _expect("quantize_grad_rows", "g", g, g.dtype, (M, K))
    _expect("quantize_grad_rows", "ws", ws, torch.float32, (K,))
    _aligned16("quantize_grad_rows", g=g, ws=ws)
    q = torch.empty((M, K), dtype=torch.int8, device=g.device)
    scale = torch.empty((M,), dtype=torch.float32, device=g.device)
    rc = _cuda.lib().nbk_quantize_grad_rows(
        g.data_ptr(), ws.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K,
        int(g.dtype == torch.float32), *_drop_args(drop), _stream(g))
    _cuda.check(rc, "quantize_grad_rows")
    _cuda.launch_counts["quantize_grad_rows"] += 1
    return q, scale


def gemm_i8_dgrad(gq, gs, wq, epilogue: str, h=None, ds=None, drop=None,
                  out_dtype=torch.bfloat16):
    """The int8 dgrad ``d = f32(gq (M, K) . wq^T) * gs`` of a gradient
    quantized by ``quantize_grad_rows``, for ``wq`` (N, K) the forward's
    quantized (in, out) weight in its row-major layout, with the
    backwards' epilogues:

    - "dgelu": ``(dh, dh32, gd)``, dh32 = drop(d) * gelu'(f32 h) in f32,
      dh its bf16 rounding and gd = bf16(drop(gelu(f32 h))), for h (M, N)
      bf16;
    - "residual": dx = bf16(ds + d), for ds (M, N) f32;
    - "none": bf16(d) (the attention block's dctx)."""
    if epilogue not in DGRAD_EPILOGUES:
        raise ValueError(f"gemm_i8_dgrad: epilogue must be one of "
                         f"{sorted(DGRAD_EPILOGUES)}, got {epilogue!r}")
    operand = {"dgelu": h, "residual": ds, "none": gs}[epilogue]
    if operand is None:
        raise ValueError(f"gemm_i8_dgrad: the {epilogue!r} epilogue needs "
                         f"{'h' if epilogue == 'dgelu' else 'ds'}")
    if epilogue != "dgelu" and drop is not None:
        raise ValueError(f"gemm_i8_dgrad: the {epilogue} epilogue has no "
                         "dropout")
    if not _on_cuda("gemm_i8_dgrad", gq, gs, wq, operand):
        return gemm_i8_dgrad_reference(gq, gs, wq, epilogue, h, ds, drop,
                                       out_dtype)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"gemm_i8_dgrad: the kernel writes bf16, not "
                        f"{out_dtype}")
    M, N, K = _gemm_dims("gemm_i8_dgrad", gq, wq.t(), k_mult=64)
    _expect("gemm_i8_dgrad", "gq", gq, torch.int8, (M, K))
    _expect("gemm_i8_dgrad", "g_scale", gs, torch.float32, (M,))
    _expect("gemm_i8_dgrad", "wq", wq, torch.int8, (N, K))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=gq.device)
    dh32 = gd = None
    if epilogue == "dgelu":
        _expect("gemm_i8_dgrad", "h", h, torch.bfloat16, (M, N))
        dh32 = torch.empty((M, N), dtype=torch.float32, device=gq.device)
        gd = torch.empty_like(out)
    elif epilogue == "residual":
        _expect("gemm_i8_dgrad", "ds", ds, torch.float32, (M, N))
    _aligned16("gemm_i8_dgrad", gq=gq, g_scale=gs, wq=wq, h=h, ds=ds)
    rc = _cuda.lib().nbk_gemm_i8_dgrad(
        gq.data_ptr(), gs.data_ptr(), wq.data_ptr(), out.data_ptr(),
        _ptr(dh32), _ptr(h), _ptr(gd), _ptr(ds), M, N, K,
        DGRAD_EPILOGUES[epilogue], *_drop_args(drop), _stream(gq))
    _cuda.check(rc, "gemm_i8_dgrad")
    _cuda.launch_counts["gemm_i8_dgrad"] += 1
    return (out, dh32, gd) if epilogue == "dgelu" else out


# hidden sizes the row kernels take (one warp per row, four columns a lane
# per 128: csrc/common.cuh:NBK_ROW_WIDTHS)
ROW_WIDTHS = tuple(range(128, 1025, 128))
_ACTS = (torch.bfloat16, torch.float32)
# the row pass of residual_layer_norm_bwd runs at most this many blocks of
# 8 warps (2 per SM), each writing one partial row of dscale and dbias
_LN_BWD_BLOCKS = 264


def _rows(name: str, t, widths=ROW_WIDTHS):
    """(M, N) of a 2-D bf16 / f32 activation the row kernels take."""
    if t.dim() != 2 or t.shape[1] not in widths:
        raise ValueError(f"{name}: the kernel takes (M, N) rows with N in "
                         f"{widths}, got {tuple(t.shape)}")
    if t.dtype not in _ACTS:
        raise TypeError(f"{name}: {t.dtype}; the kernel takes bf16 or f32")
    return t.shape


def _params(name: str, n: int, *vecs) -> None:
    for arg, t in vecs:
        _expect(name, arg, t, torch.float32, (n,))


def _aligned(name: str, *tensors) -> None:
    """The row and GELU kernels read four values at a time."""
    for t in tensors:
        if t is not None and t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name}: an operand is not aligned to four "
                             "elements (a view at an odd offset?)")


def residual_layer_norm(x, r, scale, bias, eps: float):
    """LN(x + r) over (M, N) rows: (y in x's dtype, mean (M,) f32, rstd
    (M,) f32); x and r bf16 or f32 alike, scale and bias (N,) f32."""
    if not _on_cuda("residual_layer_norm", x, r, scale, bias):
        return residual_layer_norm_reference(x, r, scale, bias, eps)
    M, N = _rows("residual_layer_norm", x)
    _expect("residual_layer_norm", "x", x, x.dtype, (M, N))
    _expect("residual_layer_norm", "r", r, x.dtype, (M, N))
    _params("residual_layer_norm", N, ("scale", scale), ("bias", bias))
    _aligned("residual_layer_norm", x, r, scale, bias)
    y = torch.empty_like(x)
    mean = torch.empty((M,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rc = _cuda.lib().nbk_residual_layer_norm(
        x.data_ptr(), r.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), M, N, float(eps),
        int(x.dtype == torch.float32), _stream(x))
    _cuda.check(rc, "residual_layer_norm")
    _cuda.launch_counts["residual_layer_norm"] += 1
    return y, mean, rstd


def residual_layer_norm_bwd(x, r, dy, scale, mean, rstd):
    """(dx in x's dtype, dscale (N,) f32, dbias (N,) f32) of
    ``residual_layer_norm`` from its statistics; dx is the gradient of
    both x and r."""
    if not _on_cuda("residual_layer_norm_bwd", x, r, dy, scale, mean, rstd):
        return residual_layer_norm_bwd_reference(x, r, dy, scale, mean,
                                                 rstd)
    M, N = _rows("residual_layer_norm_bwd", x)
    for arg, t in (("x", x), ("r", r), ("dy", dy)):
        _expect("residual_layer_norm_bwd", arg, t, x.dtype, (M, N))
    _params("residual_layer_norm_bwd", N, ("scale", scale))
    _params("residual_layer_norm_bwd", M, ("mean", mean), ("rstd", rstd))
    _aligned("residual_layer_norm_bwd", x, r, dy, scale)
    dx = torch.empty_like(x)
    blocks = min(-(-M // 8), _LN_BWD_BLOCKS)
    part = torch.empty((blocks, 2, N), dtype=torch.float32, device=x.device)
    dsb = torch.empty((2, N), dtype=torch.float32, device=x.device)
    rc = _cuda.lib().nbk_residual_layer_norm_bwd(
        x.data_ptr(), r.data_ptr(), dy.data_ptr(), scale.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
        dsb[0].data_ptr(), dsb[1].data_ptr(), M, N, blocks,
        int(x.dtype == torch.float32), _stream(x))
    _cuda.check(rc, "residual_layer_norm_bwd")
    _cuda.launch_counts["residual_layer_norm_bwd"] += 1
    return dx, dsb[0], dsb[1]


def _gelu_operands(name: str, x, b, dy=None):
    """(M, N) of the GELU kernels' bf16 / f32 (M, N) operands, N % 4 ==
    0 (groups of four never cross a row)."""
    if x.dim() != 2 or x.shape[1] % 4:
        raise ValueError(f"{name}: the kernel takes (M, N) with N % 4 == 0, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _ACTS:
        raise TypeError(f"{name}: {x.dtype}; the kernel takes bf16 or f32")
    M, N = x.shape
    _expect(name, "x", x, x.dtype, (M, N))
    _params(name, N, ("b", b))
    if dy is not None:
        _expect(name, "dy", dy, x.dtype, (M, N))
    _aligned(name, x, b, dy)
    return M, N


def bias_gelu(x, b):
    """gelu(x + b) over (M, N), the A&S erf in f32, out in x's dtype (bf16
    or f32); b (N,) f32."""
    if not _on_cuda("bias_gelu", x, b):
        return bias_gelu_reference(x, b)
    M, N = _gelu_operands("bias_gelu", x, b)
    y = torch.empty_like(x)
    rc = _cuda.lib().nbk_bias_gelu(x.data_ptr(), b.data_ptr(), y.data_ptr(),
                                   M, N, int(x.dtype == torch.float32),
                                   _stream(x))
    _cuda.check(rc, "bias_gelu")
    _cuda.launch_counts["bias_gelu"] += 1
    return y


def bias_gelu_bwd(x, b, dy):
    """dx = dy * gelu'(x + b) over (M, N), in x's dtype."""
    if not _on_cuda("bias_gelu_bwd", x, b, dy):
        return bias_gelu_bwd_reference(x, b, dy)
    M, N = _gelu_operands("bias_gelu_bwd", x, b, dy)
    dx = torch.empty_like(x)
    rc = _cuda.lib().nbk_bias_gelu_bwd(x.data_ptr(), b.data_ptr(),
                                       dy.data_ptr(), dx.data_ptr(), M, N,
                                       int(x.dtype == torch.float32),
                                       _stream(x))
    _cuda.check(rc, "bias_gelu_bwd")
    _cuda.launch_counts["bias_gelu_bwd"] += 1
    return dx


def embed_lookup(word, pos, type_, scale, bias, ids, type_ids,
                 seq_len: int, eps: float):
    """(n, h) in the tables' dtype: LN(word[ids] + pos[t % seq_len] +
    type[type_ids]) for the flat (n,) int32 ``ids`` and ``type_ids`` (None:
    type row 0).  Tables f32 or bf16 alike, scale and bias (h,) f32.  A
    type id outside its table and a word id in the table's padding to a
    multiple of 8 read a zero row, as JAX's kernel; a word id where JAX
    raises (below 0, past the padding) gives a NaN row on the card (the
    ids are not read on the host)."""
    tensors = [word, pos, type_, scale, bias, ids] + (
        [] if type_ids is None else [type_ids])
    if not _on_cuda("embed_lookup", *tensors):
        return embed_lookup_reference(word, pos, type_, scale, bias, ids,
                                      type_ids, seq_len, eps)
    V, N = _rows("embed_lookup", word)
    if pos.shape[0] < seq_len or seq_len < 1:
        raise ValueError(f"embed_lookup: {pos.shape[0]} position rows, "
                         f"seq_len {seq_len}")
    _expect("embed_lookup", "pos", pos, word.dtype, (pos.shape[0], N))
    _expect("embed_lookup", "type_", type_, word.dtype, (type_.shape[0], N))
    _params("embed_lookup", N, ("scale", scale), ("bias", bias))
    n = ids.shape[0]
    _expect("embed_lookup", "ids", ids, torch.int32, (n,))
    if type_ids is not None:
        _expect("embed_lookup", "type_ids", type_ids, torch.int32, (n,))
    _aligned("embed_lookup", word, pos, type_, scale, bias)
    out = torch.empty((n, N), dtype=word.dtype, device=word.device)
    rc = _cuda.lib().nbk_embed_lookup(
        ids.data_ptr(), _ptr(type_ids), word.data_ptr(), pos.data_ptr(),
        type_.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, N, int(seq_len), V, type_.shape[0], float(eps),
        int(word.dtype == torch.float32), _stream(word))
    _cuda.check(rc, "embed_lookup")
    _cuda.launch_counts["embed_lookup"] += 1
    return out


def chain_ops(plain: bool) -> SimpleNamespace:
    """The block chains' operations by the wrappers' names: the wrappers
    (kernels on CUDA tensors), or with ``plain`` their plain versions on
    any device -- so one autograd Function runs either chain, and the
    card can hold a whole block to its plain version."""
    names = ("quantize_rows", "quantize_grad_rows", "gemm_bias_act",
             "gemm_bias_residual", "gemm_dgrad", "gemm_i8_bias_act",
             "gemm_i8_bias_residual", "gemm_i8_dgrad", "ffn_bwd_rows",
             "seg_attention", "seg_attention_bwd", "sb_attention",
             "sb_attention_bwd", "flash_fwd", "flash_bwd_dq",
             "flash_bwd_dkv")
    g = globals()
    ops = {n: g[f"{n}_reference" if plain else n] for n in names}
    ops["layer_norm_rows"] = layer_norm_reference if plain else \
        layer_norm_rows
    return SimpleNamespace(**ops)
