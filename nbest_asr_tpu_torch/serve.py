"""Batch inference API in PyTorch -- the port of
``nbest_asr_tpu/serve.py``'s ``Predictor`` in bf16 (``quantize="none"``).

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

``load_predictor`` (restoring a Trainer checkpoint) waits for the
trainer's checkpoint format.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch

from nbest_asr_tpu.data.dataset import RawSplit
from nbest_asr_tpu.data.input_builder import pack_split
from nbest_asr_tpu.data.native_loader import (NativePacker, native_available,
                                              native_supported)
from nbest_asr_tpu.data.tokenizer import BaseTokenizer
from nbest_asr_tpu.data.vocab import Memory

from .models.encoder import GEMM_KERNELS
from .models.heads import hierarchy_device_arrays
from .models.model import ModelConfig, model_forward
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


class Predictor:
    def __init__(self, params: dict, cfg: ModelConfig, memory: Memory,
                 tokenizer: BaseTokenizer, *, device="cpu",
                 layout: str = "default", use_segments: bool = False,
                 batch_size: int = 16, max_len: int = 256,
                 bucket_lens: tuple = (64, 96, 160, 256),
                 quantize: "str | None" = None,
                 fused_attn_eval: "bool | None" = None):
        if quantize == "int8":
            raise NotImplementedError(
                "quantize='int8': the int8 serving kernels are still to "
                "port (ROADMAP queue 2); use quantize='none'")
        if quantize not in (None, "none"):
            raise ValueError(f"quantize: expected None, 'none' or 'int8', "
                             f"got {quantize!r}")
        self.device = torch.device(device)
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
        self.quantize = "none"
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
        # f32 masters on the device, plus compute-dtype copies of the
        # four GEMM kernels made once here (not cast per call)
        self.params = _tree_to(params, self.device)
        cdt = cfg.encoder.cdtype
        enc = self.params["encoder"]
        self._fwd_params = {
            "encoder": {
                "embeddings": enc["embeddings"],
                "layers": {k: (v.to(cdt) if k in GEMM_KERNELS else v)
                           for k, v in enc["layers"].items()},
            },
            "head": self.params["head"],
        }
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
        top, probs, final, _ = model_forward(self._fwd_params, self.cfg,
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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
