"""Batch inference API in PyTorch -- the port of
``nbest_asr_tpu/serve.py``'s ``Predictor``, in bf16 (``quantize="none"``)
or with int8 encoder GEMMs (``quantize="int8"``).

A fixed-shape, single-stream forward (no transcript pass, no loss) from
raw serialized utterances (``[CLS] [SYS] <sys words> [USR] <hyp1> [SEP]
<hyp2> ...``, as a string or a word list) to semantic-tuple label
strings.  Each call packs once to the smallest length bucket that fits
its longest utterance, then runs fixed ``batch_size`` batches; pad rows
get ``mask[row, 0] = 1`` so they stay harmless.  Every batch is enqueued
before any result is read: its (b, n_bottom) output is copied
device->host into a pinned buffer with a non-blocking copy on the current
stream, and an event marks when the bytes have landed, so
``predict_async(...).result()`` overlaps the device with host work.

``quantize="int8"`` quantizes the f32 masters' four encoder GEMM kernels
once at construction (``ops/quant.py``: per-output-channel int8, stored
in the layout the CUDA int8 GEMM reads) and routes every layer through
the int8 kernel chains (``ops/int8_serving.py``) where the config takes
them.  ``quantize=None`` resolves as ``resolve_quantize`` says.

The Predictor runs on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), where the kernels' plain versions run.
``load_predictor`` restores the best checkpoint a Trainer wrote
(``train/loop.py``, ``<exp_dir>/model.ckpt``) and wraps it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Union

import numpy as np
import torch

from .data.dataset import RawSplit
from .data.input_builder import pack_split
from .data.native_loader import (NativePacker, native_available,
                                 native_supported)
from .data.tokenizer import BaseTokenizer
from .data.vocab import Memory
from .models.encoder import (GEMM_KERNELS, attn_lanes_ok,
                             ffn_kernel_routes)
from .models.heads import hierarchy_device_arrays
from .models.model import ModelConfig, model_forward
from .ops import _cuda
from .ops.quant import is_quantized, kernel_layout, quantize_encoder_params
from .train.decode import decode_multihot
from .train.metrics import multihot_to_labels

Utterances = Sequence[Union[str, Sequence[str]]]


class _PendingPrediction:
    """Handle for an in-flight prediction (all device work enqueued).
    ``result()`` waits for the copies and decodes; idempotent."""

    def __init__(self, predictor: "Predictor", n: int, futures):
        self._p = predictor
        self._n = n
        self._futures = futures
        self._out = None

    def result(self) -> List[List[str]]:
        if self._out is None:
            out = _gather(self._futures, self._n, self._p.memory.n_bottom,
                          bool)
            self._futures = None
            self._out = multihot_to_labels(out, self._p.memory.idx2label)
        return self._out


def _gather(futures, n: int, width: int, dtype) -> np.ndarray:
    out = np.zeros((n, width), dtype=dtype)
    for start, end, host, done in futures:
        if done is not None:
            done.synchronize()
        out[start:end] = host.numpy()[: end - start]
    return out


# Whether int8 serving beat bf16 on the card in every length bucket:
# ``predict`` utt/s of Predictor(quantize="int8") against
# quantize="none", BERT-base, batch 64, requests of 256 utterances,
# alternated A B B A (chip_smoke.py).  It did not (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md): int8 served 9905 / 9991 / 5430 / 4445 utt/s against
# bf16's 11473 / 11292 / 7206 / 4971 at seq 64 / 96 / 160 / 256, and the
# int8 encoder forward at 64 x 256 takes 9.64 ms of device time against
# bf16's 8.07 (chip_time_attention.py).  The int8 residual GEMM, the
# per-token quant passes and, at seq 64, the host time of the int8
# chain's four extra launches per layer outweigh the int8 products' gain.
INT8_FASTER_ON_CUDA = False


def resolve_quantize(quantize, cfg: ModelConfig, device: torch.device) -> str:
    """The serving mode for ``quantize``.  An explicit "int8" or "none"
    wins.  None resolves to "int8" only on CUDA, where the int8 kernel
    chains take every layer (``use_fused_attn`` and ``use_fused_ffn`` set,
    the lane rules hold) and int8 measured faster than bf16
    (``INT8_FASTER_ON_CUDA``); to "none" otherwise, always on the CPU."""
    if quantize not in (None, "none", "int8"):
        raise ValueError(f"quantize: expected None, 'none' or 'int8', "
                         f"got {quantize!r}")
    if quantize is not None:
        return quantize
    enc = cfg.encoder
    kernels_take_it = (enc.use_fused_attn and attn_lanes_ok(enc)
                       and ffn_kernel_routes(enc))
    return "int8" if (device.type == "cuda" and kernels_take_it
                      and INT8_FASTER_ON_CUDA) else "none"


class Predictor:
    def __init__(self, params: dict, cfg: ModelConfig, memory: Memory,
                 tokenizer: BaseTokenizer, *, device="cuda",
                 layout: str = "default", use_segments: bool = False,
                 batch_size: int = 16, max_len: int = 256,
                 bucket_lens: tuple = (64, 96, 160, 256),
                 quantize: "str | None" = None,
                 fused_attn_eval: "bool | None" = None):
        self.device = torch.device(device)
        quantize = resolve_quantize(quantize, cfg, self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Predictor(device={device!r}): CUDA is not "
                               "available")
        # the serving default routes the deterministic forward through
        # the attention kernel when the config uses the kernels and the
        # device runs them (CUDA); explicit True/False always wins
        if fused_attn_eval is None:
            fused_attn_eval = (cfg.encoder.use_fused_attn
                               and self.device.type == "cuda")
        if fused_attn_eval and not cfg.encoder.use_fused_attn_eval:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, use_fused_attn_eval=True))
        self.quantize = quantize            # resolved serving mode
        self.cfg = cfg
        self.memory = memory
        self.tokenizer = tokenizer
        self.layout = layout
        self.use_segments = use_segments
        self.batch_size = batch_size
        self.max_len = max_len
        self.bucket_lens = sorted(
            {min(b, max_len) for b in bucket_lens} | {max_len})
        self.hier = hierarchy_device_arrays(memory.arrays(), self.device)
        # f32 masters on the device, plus forward copies of the four GEMM
        # kernels made once here (not per call): int8 in the kernels'
        # layout, or the compute dtype.  A tree that arrives quantized
        # (e.g. the JAX package's, bridged) keeps its int8 values.
        self.params = _tree_to(params, self.device)
        fwd = self.params
        if quantize == "int8" and not is_quantized(
                fwd["encoder"]["layers"]["qkv_kernel"]):
            fwd = quantize_encoder_params(fwd)
        self._fwd_params = dict(fwd, encoder=dict(fwd["encoder"], layers={
            k: _forward_copy(v, cfg.encoder.cdtype) if k in GEMM_KERNELS
            else v for k, v in fwd["encoder"]["layers"].items()}))
        e = cfg.encoder
        if self.device.type == "cuda" and (
                e.use_fused_attn or e.use_fused_ffn or e.use_fused_ln
                or e.use_fused_gelu or e.use_fused_embedding):
            _cuda.lib()         # build now: raises if nvcc or a build fails
        # native (C++) packer when the tokenizer is covered and g++ built
        # it; the Python packer otherwise
        self._native = None
        if native_supported(tokenizer) and native_available():
            self._native = NativePacker(memory, tokenizer, layout)

    # ------------------------------------------------------------------ #
    def _pack(self, seqs):
        """Pack once at the natural width, then pad up to the smallest
        bucket that fits (identical to re-packing at the bucket width);
        only a natural width past ``max_len`` re-packs, truncating."""
        def do_pack(max_len):
            if self._native is not None:
                return self._native.pack_lines(seqs, max_len=max_len)
            split = RawSplit(asr_seqs=seqs, trans_seqs=seqs,
                             labels=[[] for _ in seqs])
            return pack_split(split, self.tokenizer, self.memory,
                              layout=self.layout, max_len=max_len)

        packed = do_pack(None)
        target = self.max_len
        for b in self.bucket_lens:
            if packed.max_len <= b:
                target = b
                break
        if packed.max_len > target:
            return do_pack(target)
        if packed.max_len < target:
            d = target - packed.input_ids.shape[1]
            packed = dataclasses.replace(
                packed,
                input_ids=np.pad(packed.input_ids, ((0, 0), (0, d)),
                                 constant_values=self.tokenizer.pad_token_id),
                segment_ids=np.pad(packed.segment_ids, ((0, 0), (0, d))),
                attn_mask=np.pad(packed.attn_mask, ((0, 0), (0, d))),
                max_len=target)
        return packed

    @torch.inference_mode()
    def _forward(self, ids: torch.Tensor, mask: torch.Tensor,
                 segs: torch.Tensor):
        top, probs, final, _, _ = model_forward(self._fwd_params, self.cfg,
                                             self.hier, ids, mask, segs)
        return decode_multihot(top, probs, self.hier), final

    def _dispatch(self, utterances: Utterances, want: str = "pred"):
        """Pack, then enqueue every batch without waiting.  Returns
        ``(futures, n)``; a future is ``(start, end, host_tensor,
        event)``, where ``host_tensor`` receives the batch's decoded
        multi-hot ("pred") or final scores ("final")."""
        seqs = [u.split() if isinstance(u, str) else list(u)
                for u in utterances]
        n = len(seqs)
        packed = self._pack(seqs)
        segs = packed.segment_ids if self.use_segments else \
            np.zeros_like(packed.segment_ids)
        cuda = self.device.type == "cuda"

        futures = []
        bs = self.batch_size
        for start in range(0, n, bs):
            end = min(start + bs, n)
            pad = bs - (end - start)
            ids = np.pad(packed.input_ids[start:end], ((0, pad), (0, 0)))
            mask = np.pad(packed.attn_mask[start:end], ((0, pad), (0, 0)))
            sg = np.pad(segs[start:end], ((0, pad), (0, 0)))
            mask[end - start:, 0] = 1.0
            pred, final = self._forward(
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device),
                torch.from_numpy(sg).to(self.device))
            out = pred if want == "pred" else final
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=cuda)
            host.copy_(out, non_blocking=cuda)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            futures.append((start, end, host, done))
        return futures, n

    def predict(self, utterances: Utterances) -> List[List[str]]:
        """Raw serialized utterances -> per-utterance label lists."""
        futures, n = self._dispatch(utterances)
        return _PendingPrediction(self, n, futures).result()

    def predict_async(self, utterances: Utterances) -> _PendingPrediction:
        """Non-blocking predict: every batch is enqueued now, and the
        handle's ``.result()`` yields the label lists."""
        futures, n = self._dispatch(utterances)
        return _PendingPrediction(self, n, futures)

    def scores(self, utterances: Utterances) -> np.ndarray:
        """Raw utterances -> (n, n_bottom) final scores, through the same
        fixed-shape batch loop as ``predict``."""
        futures, n = self._dispatch(utterances, want="final")
        return _gather(futures, n, self.memory.n_bottom, np.float32)


def _forward_copy(kernel, cdt: torch.dtype):
    """A GEMM leaf as the forward reads it: an int8 leaf in the CUDA int8
    GEMM's layout (a no-op for ``quantize_encoder_params``' own output), a
    tensor in the compute dtype."""
    if is_quantized(kernel):
        return {"q": kernel_layout(kernel["q"]), "scale": kernel["scale"]}
    return kernel.to(cdt)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def load_predictor(exp_dir: str, memory: Memory, cfg: ModelConfig,
                   tokenizer: BaseTokenizer, **kw) -> Predictor:
    """Restore the best checkpoint written by the Trainer and wrap it (the
    port of ``nbest_asr_tpu/serve.py:load_predictor`` :282); ``kw`` goes
    to ``Predictor``, which runs on the card unless ``device="cpu"``."""
    ckpt = torch.load(os.path.join(exp_dir, "model.ckpt"),
                      map_location="cpu", weights_only=True)
    return Predictor(ckpt["params"], cfg, memory, tokenizer, **kw)
