#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``nbest_asr_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, each fatal on failure:

1. Device: refuse to run without CUDA; print the card, its power limit,
   the torch and CUDA versions; build the hand-written kernels from
   ``nbest_asr_tpu_torch/csrc`` (nvcc, first use) and print the seconds.
2. Kernels against their plain PyTorch versions, on the card, at
   BERT-base widths in bf16: batch 64 x seq {64, 96, 160, 256} plus a
   ragged 3 x 20 case, with padded 1/0 and packed multi-segment masks;
   each kernel and the four block functions (bf16 and int8).  The int8
   kernels must equal their plain versions bit for bit (the GELU
   epilogue within one bf16 ulp).  Prints per-bucket times.
3. The slice: ``Predictor(device="cuda", quantize="none")`` on a
   12-layer BERT-base encoder (random weights from
   ``torch.Generator().manual_seed(0)``) over a synthetic DSTC2-like
   label hierarchy serves four requests of 256 utterances, one per length
   bucket, through ``predict``, ``predict_async`` and ``scores``.  The
   kernels' launch counters must rise by exactly layers x batches x
   launches-per-layer.  The same weights through the plain path (the
   three kernel flags off) must agree on >= 98% of utterances over the
   label decisions an f32 plain run resolves beyond bf16 noise (raw
   label agreement is printed too), and the kernel path's scores are
   held to that f32 run.
3b. The int8 slice: ``Predictor(device="cuda", quantize="int8")`` on the
   same weights serves the same requests.  The int8 kernels' counters
   rise by exactly layers x batches x launches-per-layer (every
   ``quantize_rows`` on its row pass, at K = 768 and 3072) while the bf16
   GEMM counters stay at 0; agreement with the int8 plain path on the
   decisions the f32 run resolves must be >= 98%, and the int8 scores
   within 5e-2 of the f32 run (``nbest_asr_tpu/ops/quant.py:31``).
4. Times: ms per batch of 64 for the kernel and the plain forward per
   bucket (CUDA events, after warm-up) and ``predict`` utt/s, bf16 and
   int8 side by side (int8 and bf16 ``predict`` alternate, ABBA).
5. Training kernels against their plain versions with the same Philox
   bits, at BERT-base widths for n in {60 (3 x 20), 7680 (80 x 96), 8192
   (32 x 256)} rows, padded and packed masks: the FFN block's chain (the
   dropout epilogues of ``gemm_bias_act`` and ``gemm_bias_residual`` with
   h and y2d saved, ``layer_norm``'s statistics, ``ffn_bwd_rows``, the
   "dgelu" and "residual" ``gemm_dgrad``) and the attention block's
   (``seg_attention`` with prob dropout and row statistics, the out-proj
   epilogue with hidden dropout and od saved, ``ffn_bwd_rows`` on od,
   the "none" and "residual" ``gemm_dgrad``, ``seg_attention_bwd``) --
   elementwise results within one bf16 ulp of the plain version on the
   kernel's own inputs, dropped elements exactly 0, the backward's
   regenerated gd equal to the forward's bit for bit, GEMM and attention
   outputs within two bf16 ulps of the tensor's largest value; a one-hot
   probe shows the forward, the dQ kernel and the dK/dV kernel dropping
   exactly the stream-3 probs, and with random K that the backward's
   rebuilt bf16 probs equal the forward's -- and each whole block,
   forward and all seven gradients, against torch autograd through the
   plain block.  ``seg_attention_bwd`` at every bucket's micro (padded and
   packed masks, dropout 0 and 0.1, the QKV buffer and standalone (b, s,
   heads, d) tensors), each launch on its wgmma pair, two runs bit-equal;
   its device ms per bucket beside SDPA's backward alone.
   Per training layer: kernel, plain, library and bound ms; each block's
   forward + backward per bucket.  The int8 training chains likewise, on
   the same Philox bits and weights quantized as a training step
   quantizes them: ``quantize_rows``, the dropout / saved-residual
   epilogues of ``gemm_i8_bias_act`` and ``gemm_i8_bias_residual``,
   ``quantize_grad_rows`` and the three ``gemm_i8_dgrad`` epilogues bit for
   bit (the GELU / gelu' epilogues within one bf16 ulp, the f32 dh within
   1e-6 of its largest value), the backward's regenerated gd equal to the
   forward's; each int8 block on both backwards, forward and seven
   gradients, against the same Function on the kernels' plain versions;
   the d = 192 and 256 attention instances against their plain versions.
6. The training slice: ``make_train_step`` on seed-0 BERT-base weights
   (bf16 compute, f32 masters, dropout 0.1, ``use_fused_ffn=True``,
   ``use_fused_attn=True``) over the synthetic hierarchy, n_accum 2,
   three steps per bucket at the token-budget micro sizes (128, 80, 48,
   32 rows at seq 64, 96, 160, 256).  The kernels' counters must rise by
   exactly layers x micros x ``PER_LAYER_TRAIN``, and one step of the
   FFN-only route (``use_fused_attn=False``) at seq 64 by layers x micros
   x ``PER_LAYER_TRAIN_FFN``; every loss part must be finite; at dropout
   0 one kernel step and one plain step (all kernel flags off) from the
   same weights must agree (loss parts within 1e-2 relative, parameter
   deltas within 5e-2 of each leaf's largest delta); 30 steps on one
   fixed micro at seq 64, lr 1e-4 (warmup-linear), dropout on, must
   halve the micro's dropout-free total loss, read on the plain path
   before the first step and after each (the median of the last ten);
   the per-step loss under dropout and the plain path's own run are
   printed beside.
   Prints step ms per bucket (CUDA events), train utt/s, both blocks'
   fwd + bwd ms and their share of the step, the plain attention path's
   ms, and the peak memory.
7. The int8 training slice: the same, on JAX's shipped int8 training
   configuration (``NBEST_BENCH_INT8=2``: ``use_int8_train``,
   ``use_int8_train_attn``, ``use_int8_train_bwd`` as well), counters by
   ``PER_LAYER_TRAIN_I8`` (every ``quantize_rows`` on its row pass, at K
   = 768 and 3072, and every ``quantize_grad_rows`` on its gradient row
   pass, at all four of a layer's widths: 768, 3072, 768, 2304), and one
   counted step without
   ``use_int8_train_bwd`` (``NBEST_BENCH_INT8=1``) by
   ``PER_LAYER_TRAIN_I8_FWD``; at dropout 0 one kernel step against the
   same step with both int8 blocks on their kernels' plain versions; the
   30-step loss halving; step ms, utt/s, int8 block ms and peak memory
   beside the bf16 step's, and the per-step weight quantization's ms.
8. The flash route's kernels against their plain versions with the same
   Philox bits: the widened single-block pair (``seg_attention`` /
   ``seg_attention_bwd`` on (b, s, heads, d) operands, QKV views at d =
   64 and standalone tensors at d = 32 and 128, 32 x 256 and 48 x 160)
   and the tiled ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv`` (32 x
   1024 and 8 x 2048, d = 64 and 128), padded and packed masks, dropout 0
   and 0.1, checking o, the statistics (row sum, lse, di), dq, dk, dv,
   and that the three run on their wgmma + TMA kernels exactly at d = 64
   (``flash_wgmma_launches``); the tiled route forced at s =
   256 drops exactly the single-block route's probs (a one-hot probe
   against the stream-3 keep bits) and agrees with it in value.  Kernel
   (device) / plain / library (device) / bound ms of the tiled kernels at
   route B's layer, the backward pair beside SDPA's backward alone (and
   without dropout), and flash attention forward + backward against the
   plain attention path at every training shape.
9. Route A, JAX's ``--no_fused_attn``: ``make_train_step`` with
   ``use_flash_attention, use_fused_ffn`` (``use_fused_attn=False``), 3
   steps per bucket: counters by ``PER_LAYER_TRAIN_FLASH_SB`` at 160 and
   256 and ``PER_LAYER_TRAIN_FFN`` at 64 and 96 (flash_min_seq 160); step
   ms, utt/s and peak memory per bucket; at dropout 0 one kernel step at
   seq 256 against the plain encoder path; 30 steps on a fixed micro at
   seq 160 halve the loss.
10. Route B, the JAX trainer's TPU defaults at seq 1024: BERT-base with
   ``max_position=1024``, ``use_flash_attention, use_fused_attn,
   use_fused_ffn``, one micro of 32 rows; a padded step (lengths
   768-1024) and a packed step (position_ids), counters by
   ``PER_LAYER_TRAIN_TILED`` (the tiled kernels 12 x per micro, every
   launch on their wgmma + TMA kernels); at dropout 0 one
   kernel step against the same step with flash and the FFN block on
   their plain versions.
11. Route C's row kernels against their plain versions
   (``phase_rows_kernels``): ``residual_layer_norm`` and
   ``residual_layer_norm_bwd`` at 8192 x 768 and 7688 x 1024, bf16 and
   f32; ``bias_gelu`` and ``bias_gelu_bwd`` at 8192 x 3072 and 7688 x
   4096, bf16, and 193 x 3076 (their 4-wide instance), bf16 and f32;
   ``embed_lookup`` at 8192 and 7688 tokens, f32 and bf16 tables,
   offsets 0 and 2, with and without type ids; kernel / plain / library
   / bound ms per training layer at 8192 rows.
12. Route C's training: ``make_train_step`` on the plain blocks with
   ``use_fused_ln, use_fused_gelu, use_fused_embedding`` (both
   megakernels and flash off, JAX's EncoderConfig defaults), 3 steps per
   bucket on unpacked rows, counters by ``PER_LAYER_TRAIN_ROWS`` per layer
   and ``embed_lookup`` once per micro; the dropout-0 gate against the
   plain encoder path; 30 steps on a fixed micro halve the loss.  Its
   serving runs in phase 3 (``Predictor`` with the three flags, counted
   by ``PER_LAYER_ROWS`` and held by the bf16 gate) and its forward ms in
   phase 4.
13. The CLI (``phase_cli``): a synthetic dataroot (``memory.json`` from
   ``dstc2_like_memory``; train / valid / test shards of 1024 / 256 / 256
   DSTC2-like utterances, seed 0) in a temporary directory, then
   ``cli.main`` in this process at BERT-base width, 2 layers deep (12
   heads, bf16, dropout 0.1, buckets 64 / 96 / 160 / 256, token budget
   8192, batch 32, 2 epochs; phase 14 (b) runs these flags 12 layers
   deep): the kernels' counters rise by exactly layers x
   (training micros x ``PER_LAYER_TRAIN`` + eval batches x the FFN
   block's forward); ``Trainer.train(stop_after_epoch=0)`` and then
   ``main(... --resume auto)`` end with params, optimizer state, step and
   ``best.json`` bit-equal to the uninterrupted run's; ``--testing``
   reproduces the best epoch's valid F1 / Acc; ``load_predictor`` restores
   ``model.ckpt`` onto the card and serves the valid split.  Prints the
   epoch and eval seconds and rows / s (three steps an epoch: printed, no
   benchmark).
14. The pretrained path (``phase_pretrained``), bf16 on the blocks'
   kernels.  (a) MLM at BERT-base width (12 layers, dropout 0.1): a
   ``vocab.txt`` of the memory's words padded with ``[unusedN]`` to 30522
   rows and BERT's tokenizer files with ``[SYS]`` / ``[USR]`` added past
   it, read by ``WordPieceTokenizer``; phase 13's synthetic train shard
   packed at buckets 64 and 96 (both text sides, default layout, rows
   over 96 dropped); 20 steps of ``make_mlm_train_step`` (8192-token
   batches, BertAdam lr 1e-3, warmup 0.1) whose loss must start within 1
   of ln 30522 and fall by more than 1; launches = 20 x layers x
   ``PER_LAYER_TRAIN``; the tied f32 decoder timed alone; one step at
   dropout 0 against the plain route (phase 6's gate).  (b) The export
   (``export_hf_checkpoint`` with the MLM head) read back by
   ``load_pretrained_encoder`` exactly; ``cli.main`` with phase 13's
   flags (the checkpoint's 12 layers) and ``--tod_pre_trained_model
   <dir> --require_pretrained`` (TOD layout, the added tokens clamped
   into the word table): the Trainer's encoder at init equal to the
   checkpoint's, launches held to the plan, ``--testing`` reproducing
   the best epoch, ``load_predictor``.  (c) RoBERTa-base
   (``pytorch_model.bin``, vocab 50265) and XLM-R-base
   (``model.safetensors`` written byte by byte here, vocab 250002)
   checkpoints from a seed under ``roberta.``: 514 positions, one type
   row, eps 1e-5, offset 2; each read back as written, served through
   ``Predictor`` at 64 x 256 (RoBERTa with segment ids 0 and 1) and held
   to the plain and f32 Predictors (phase 3's gate), ``embed_lookup`` at
   its vocab held to its plain version with out-of-range type and word
   ids; at XLM-R-base two ``Trainer`` steps (``family="xlm-roberta"``,
   double separator, 4 micros of 32 x 256) with the step time, peak memory
   and BertAdam's share printed.
15. Multi-process training (``phase_multiprocess``).  (a) A one-rank NCCL
   process group in this process: three ``make_train_step`` steps over
   its mesh (``parallel/mesh.make_mesh``) beside three without one,
   BERT-base 12 layers, bf16, both blocks' kernels, dropout 0, n_accum 2
   at 2 x 128 x 64, in turns A B B A: bit-equal parameters (a one-rank
   sum is the identity), each run's launches layers x micros x
   ``PER_LAYER_TRAIN``, the gradient all-reduce's ms a step.  (b) Two
   ranks sharing the card over gloo, started as ``python3 chip_smoke.py
   --mp-rank R 2 DIR``
   (``mp_worker``; each joins its group first, then runs ``cli.main(argv,
   device="cuda:0")``): phase 13's dataroot at BERT-base width, 2 layers,
   bf16, both blocks, dropout 0, one epoch, ``--data_mode direct`` (dp =
   2) at a batch of 512, which holds each length bucket whole, so that
   each step trains on one process's rows: every epoch metric within 1e-4
   of the same flags in one process, here; the ranks' parameters
   bit-equal; each rank's launches by the plan; rank 1 (its own
   experiment directory) writes nothing, rank 0 the one-process run's
   files.  (c) The same two ranks at ``--n_model_parallel 2`` (tp = 2, the
   plain route, f32, batch 32, token budget 8192): no kernel launched,
   every loss within 2e-5 relative of tp = 1 on the plain route
   (``--no_fused_attn --no_fused_ffn --no_flash_attention``), the ranks'
   gathered parameters bit-equal.  (d) With two cards or more, (b) over
   NCCL, one rank a card; otherwise one line says why not.  Prints each
   part's wall seconds, the gradient all-reduce's ms a step and one tp
   all-reduce's, with the card's name and power limit; (b) and (c)'s times
   are two ranks sharing one card, not a scaling figure.
16. The offline path (``phase_offline``).  (a) ``write_dstc2_sessions``
   writes 200 synthetic DSTC2 sessions (compound acts, request and value
   slots, empty hypotheses, dropped turns) and the port's ``run_etl``
   turns them into a dataroot: each split holds exactly the turns the
   drop rule keeps.  (b) ``pretrain_mlm`` on its train shard at BERT-base
   width (hidden 768, 12 heads, intermediate 3072), 4 layers (JAX's
   default), bf16, 30 steps at lr 1e-3 with the vocab of the port's
   WordPiece trainer: the loss from near ln V down by more than 0.3, the
   launches 30 x 4 x ``PER_LAYER_TRAIN``; step ms (CUDA events, after the
   first) and peak memory printed.  (c) ``cli.main`` from its export with
   ``--tod_pre_trained_model --require_pretrained --remat --profile_dir``,
   2 epochs, every split on the native packer: the launches equal the
   plan with one more training forward a layer and micro (the
   recompute), and the profiler's Chrome trace of the traced epoch's
   training holds, for each set of device kernels (csrc/'s ``__global__``
   names; the three bf16 GEMM wrappers share ``gemm_tma_kernel``, which the
   trace cannot tell apart), at least as many events as the wrappers that
   launch them launched in that epoch.  (d) One 12-layer BERT-base bf16 step at
   ``N_ACCUM`` x 128 x 64 (dropout 0.1, both blocks) without and with
   ``remat``, A B B A after a reference step: the loss and every gradient
   bit-equal, the forward launches doubled and the backward's unchanged,
   the peak memory over the forwards and backwards lower with remat (the
   whole step's peak is BertAdam's update, printed beside); step ms and
   peaks printed, and for one more step each way under ``torch.profiler``
   the step's span beside its device kernels' summed time.

The last lines are the kernels' JSON record (with each kernel's bound:
the larger of its bytes over HBM's 3.35 TB/s and its operations over the
H100's dense peak for their type; and the time of a PyTorch call that
computes the same function, where there is one), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BUCKETS = (64, 96, 160, 256)
BATCH = 64
H, NH, INTER, LAYERS, VOCAB = 768, 12, 3072, 12, 30522
REQUEST = 256                       # utterances per request
KERNEL_SOURCES = {
    "gemm_bias_act": "nbest_asr_tpu_torch/csrc/gemm_wgmma.cu",
    "gemm_bias_residual": "nbest_asr_tpu_torch/csrc/gemm_wgmma.cu",
    "layer_norm": "nbest_asr_tpu_torch/csrc/layer_norm.cu",
    "seg_attention": "nbest_asr_tpu_torch/csrc/seg_attention.cu",
    "quantize_rows": "nbest_asr_tpu_torch/csrc/quant_rows.cu",
    "gemm_i8_bias_act": "nbest_asr_tpu_torch/csrc/gemm_wgmma.cu",
    "gemm_i8_bias_residual": "nbest_asr_tpu_torch/csrc/gemm_wgmma.cu",
    "ffn_bwd_rows": "nbest_asr_tpu_torch/csrc/ffn_bwd.cu",
    "gemm_dgrad": "nbest_asr_tpu_torch/csrc/gemm_wgmma.cu",
    "seg_attention_bwd": "nbest_asr_tpu_torch/csrc/seg_attention_bwd.cu",
    "quantize_grad_rows": "nbest_asr_tpu_torch/csrc/quant_rows.cu",
    "gemm_i8_dgrad": "nbest_asr_tpu_torch/csrc/gemm_wgmma.cu",
    "flash_fwd": "nbest_asr_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd_dq": "nbest_asr_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_bwd_dkv": "nbest_asr_tpu_torch/csrc/flash_attention_bwd.cu",
    "residual_layer_norm": "nbest_asr_tpu_torch/csrc/layer_norm.cu",
    "residual_layer_norm_bwd": "nbest_asr_tpu_torch/csrc/layer_norm.cu",
    "bias_gelu": "nbest_asr_tpu_torch/csrc/fused_gelu.cu",
    "bias_gelu_bwd": "nbest_asr_tpu_torch/csrc/fused_gelu.cu",
    "embed_lookup": "nbest_asr_tpu_torch/csrc/fused_embed.cu",
}
FAB = "nbest_asr_tpu/ops/fused_attention.py:152"
FFN = "nbest_asr_tpu/ops/fused_ffn.py:166"
I8A = "nbest_asr_tpu/ops/int8_serving.py:157"
I8F = "nbest_asr_tpu/ops/int8_serving.py:90"
FFB = "nbest_asr_tpu/ops/fused_ffn.py:224"
FAB_B = "nbest_asr_tpu/ops/fused_attention.py:204"
FFI8 = "nbest_asr_tpu/ops/fused_ffn.py:404"
FFI8_B = "nbest_asr_tpu/ops/fused_ffn.py:533"
FAI8 = "nbest_asr_tpu/ops/fused_attention.py:436"
FAI8_B = "nbest_asr_tpu/ops/fused_attention.py:565"
FLASH = "nbest_asr_tpu/ops/flash_attention.py"
KERNEL_REPLACES = {
    "gemm_bias_act": f"{FAB} (QKV GEMM) + {FFN} (W1 GEMM + GELU + "
                     "dropout, _gelu_slice :153)",
    "gemm_bias_residual": f"{FAB} (out-proj) + {FFN} (W2 GEMM + dropout, "
                          ":181-191), + residual",
    "layer_norm": f"{FAB} + {FFN} + {I8A} + {I8F} (LayerNorm tails, "
                  "statistics)",
    "seg_attention": f"{FAB} (head loop, _head_probs :103, prob dropout "
                     f":175-178) + {I8A} (head loop :169-189)",
    "quantize_rows": f"{I8A} + {I8F} (_quant_rows :57)",
    "gemm_i8_bias_act": f"{I8A} (QKV _dense_i8) + {I8F} (W1 _dense_i8 + "
                        "GELU)",
    "gemm_i8_bias_residual": f"{I8A} (out-proj _dense_i8) + {I8F} (W2 "
                             "_dense_i8), + residual",
    "ffn_bwd_rows": f"{FFB} (_row_grads :203-221, dy2 / xhat :259-260) "
                    f"+ {FAB_B} (LN backward, hidden drop :216-231)",
    "gemm_dgrad": f"{FFB} (dy2 @ w2^T, drop, gelu' :245-253; ds + dh @ "
                  f"w1^T :239, :251, :258) + {FAB_B} (dout @ wo^T :232; "
                  "ds + dqkv @ wqkv^T :268-269)",
    "seg_attention_bwd": f"{FAB_B} (head loop: probs, dp, dv, di, ds, dq, "
                         f"dk :235-266) + {FAI8_B} (head loop :601-631)",
    "quantize_grad_rows": f"{FFI8_B} (_dgrad_rows_i8 :523-527 on drop2(ds) "
                          f"and dh) + {FAI8_B} (on drop_h(ds) :597, dqkv "
                          ":633)",
    "gemm_i8_dgrad": f"{FFI8_B} (dy2 @ W2^T, drop, gelu' :562-566; ds + dh "
                     f"@ W1^T :568) + {FAI8_B} (dout @ Wo^T :597; ds + dqkv "
                     "@ Wqkv^T :633-635)",
}
KERNEL_REPLACES["seg_attention"] += f" + {FLASH}:364 (_sb_fwd_kernel)"
KERNEL_REPLACES["seg_attention_bwd"] += f" + {FLASH}:380 (_sb_bwd_kernel)"
KERNEL_REPLACES.update({
    "flash_fwd": f"{FLASH}:99 (_fwd_kernel: online softmax, prob dropout; "
                 "the wrapper's transposes and padding :644-672)",
    "flash_bwd_dq": f"{FLASH}:276 (_bwd_dq_kernel) + di = sum(do * o) "
                    f"(_flash_core_bwd :499)",
    "flash_bwd_dkv": f"{FLASH}:226 (_bwd_dkv_kernel)",
    "residual_layer_norm": "nbest_asr_tpu/ops/fused_ln.py:33 (_fwd_kernel)",
    "residual_layer_norm_bwd": "nbest_asr_tpu/ops/fused_ln.py:79 "
                               "(_bwd_kernel)",
    "bias_gelu": "nbest_asr_tpu/ops/fused_gelu.py:41 (_fwd_kernel)",
    "bias_gelu_bwd": "nbest_asr_tpu/ops/fused_gelu.py:47 (_bwd_kernel)",
    "embed_lookup": "nbest_asr_tpu/ops/fused_embed.py:48 (_embed_kernel)"})
KERNEL_REPLACES["quantize_rows"] += (f" + {FFI8} (_quant_rows_f32 on x, gd "
                                     f":417, :424) + {FAI8} (on x, ctx :454, "
                                     ":471)")
KERNEL_REPLACES["gemm_i8_bias_act"] += (f" + {FFI8} (W1, GELU, drop1 "
                                        f":417-422) + {FAI8} (QKV :454)")
KERNEL_REPLACES["gemm_i8_bias_residual"] += (f" + {FFI8} (W2, drop2, y2d "
                                             f":424-431) + {FAI8} (out-proj, "
                                             "hidden drop, od :471-478)")
# launches of each kernel per encoder layer on the routed bf16 and int8
# paths (ops/fused_*.py, ops/int8_serving.py); every other kernel 0
PER_LAYER = {"gemm_bias_act": 2, "gemm_bias_residual": 2, "layer_norm": 2,
             "seg_attention": 1}
PER_LAYER_I8 = {"quantize_rows": 4, "gemm_i8_bias_act": 2,
                "gemm_i8_bias_residual": 2, "layer_norm": 2,
                "seg_attention": 1}
# launches per encoder layer per micro of the training step: both blocks'
# forward and backward chains (ops/fused_attention.py, ops/fused_ffn.py);
# with use_fused_attn=False the FFN block's alone
PER_LAYER_TRAIN = {"gemm_bias_act": 2, "gemm_bias_residual": 2,
                   "layer_norm": 2, "ffn_bwd_rows": 2, "gemm_dgrad": 4,
                   "seg_attention": 1, "seg_attention_bwd": 1}
PER_LAYER_TRAIN_FFN = {"gemm_bias_act": 1, "gemm_bias_residual": 1,
                       "layer_norm": 1, "ffn_bwd_rows": 1, "gemm_dgrad": 2}
# ... on the int8 training routes: with the int8 backwards (JAX's shipped
# NBEST_BENCH_INT8=2) and with the bf16 backwards (NBEST_BENCH_INT8=1,
# which recompute h, qkv and the attention in bf16)
PER_LAYER_TRAIN_I8 = {"quantize_rows": 4, "gemm_i8_bias_act": 2,
                      "gemm_i8_bias_residual": 2, "layer_norm": 2,
                      "seg_attention": 1, "ffn_bwd_rows": 2,
                      "quantize_grad_rows": 4, "gemm_i8_dgrad": 4,
                      "seg_attention_bwd": 1}
PER_LAYER_TRAIN_I8_FWD = {"quantize_rows": 4, "gemm_i8_bias_act": 2,
                          "gemm_i8_bias_residual": 2, "layer_norm": 2,
                          "seg_attention": 2, "ffn_bwd_rows": 2,
                          "gemm_bias_act": 2, "gemm_dgrad": 4,
                          "seg_attention_bwd": 1}
# ... on the flash route (JAX's --no_fused_attn: use_flash_attention, the
# FFN block fused): the single-block kernels at seq >= flash_min_seq 160,
# plain attention below; and the long-sequence route (seq 1024 > 512) on
# the tiled kernels
PER_LAYER_TRAIN_FLASH_SB = dict(PER_LAYER_TRAIN_FFN, seg_attention=1,
                                seg_attention_bwd=1)
PER_LAYER_TRAIN_TILED = dict(PER_LAYER_TRAIN_FFN, flash_fwd=1,
                             flash_bwd_dq=1, flash_bwd_dkv=1)
LONG_BATCH, LONG_SEQ = 32, 1024
# ... on route C, the encoder's plain blocks with JAX's three row-kernel
# flags: per layer, serving and per training micro; the embedding lookup
# runs once per forward
ROWS_FLAGS = dict(use_fused_ln=True, use_fused_gelu=True,
                  use_fused_embedding=True)
PER_LAYER_ROWS = {"residual_layer_norm": 2, "bias_gelu": 1}
PER_LAYER_TRAIN_ROWS = dict(PER_LAYER_ROWS, residual_layer_norm_bwd=2,
                            bias_gelu_bwd=1)
PER_FORWARD_ROWS = {"embed_lookup": 1}
# the flash kernels' checks: single-block (b, s, heads, d, QKV views) and
# tiled (b, s, heads, d) shapes
FLASH_SB_SHAPES = ((32, 256, NH, 64, True), (48, 160, NH, 64, True),
                   (48, 160, NH, 32, False), (48, 160, NH // 2, 128, False))
FLASH_TILED_SHAPES = ((LONG_BATCH, LONG_SEQ, NH, 64), (8, 2048, NH, 64),
                      (LONG_BATCH, LONG_SEQ, NH // 2, 128),
                      (8, 2048, NH // 2, 128))
# training micro rows per bucket under the 8192-token budget
# (nbest_asr_tpu/train/loop.py:430)
TRAIN_MICRO = {64: 128, 96: 80, 160: 48, 256: 32}
N_ACCUM, TRAIN_STEPS, DROPOUT = 2, 3, 0.1
# the H100 SXM's published dense peaks (NVIDIA H100 datasheet)
PEAK = {"bf16": 989e12, "s8": 1979e12, "f32": 67e12}
HBM = 3.35e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound(ops: float, nbytes: float, kind: str):
    """(ms, "bytes" | "operations"): the least time the H100 could take
    to move ``nbytes`` through HBM and do ``ops`` at its ``kind`` peak."""
    t_ops, t_bytes = ops / PEAK[kind] * 1e3, nbytes / HBM * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_sum(parts):
    """The bound of several launches: their sum, labelled by the kind
    that bounds most of it."""
    ms = sum(b[0] for b in parts)
    by = max(("bytes", "operations"),
             key=lambda k: sum(b[0] for b in parts if b[1] == k))
    return ms, by


def gemm_bound(M, N, K, extra_bytes: float, kind: str = "bf16"):
    """A GEMM's bound: A (M, K), W (K, N) read once, plus ``extra_bytes``
    (bias, residual, outputs) -- 2 bytes a value in bf16, 1 in s8."""
    w = 2 if kind == "bf16" else 1
    return bound(2.0 * M * N * K, w * (M * K + K * N) + extra_bytes, kind)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Device time of ``fn`` per call: the calls queue behind a ~0.1 s
    ``torch.cuda._sleep`` so that the card runs them back to back however
    slowly the host enqueues them (``cuda_ms`` measures the enqueue where
    the host is the slower).  Fails if the host did not enqueue them all
    within the sleep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    es = torch.cuda.Event(enable_timing=True)
    es.record()
    torch.cuda._sleep(200_000_000)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    e1.record()
    e1.synchronize()
    if host_ms >= es.elapsed_time(e0):
        raise AssertionError(f"device_ms: the host took {host_ms:.1f} ms to "
                             "enqueue, longer than the sleep")
    return e0.elapsed_time(e1) / iters


# the main path's kernels timed back to back (cuda_ms, the host's issue
# included) and on the device alone (device_ms); the record takes device
# time for them, and the log prints the rate each GEMM reaches
DEVICE_TIMED = ("gemm_bias_act", "gemm_bias_residual", "gemm_dgrad",
                "seg_attention", "seg_attention_bwd", "layer_norm",
                "ffn_bwd_rows", "quantize_rows", "gemm_i8_bias_act",
                "gemm_i8_bias_residual", "quantize_rows [train]",
                "gemm_i8_bias_act [train]", "gemm_i8_bias_residual [train]",
                "quantize_grad_rows", "gemm_i8_dgrad")


def time_device(name, tag, fk, fl, flops, b_ms, card):
    """(kernel ms, library ms), device time, of a device-timed kernel's
    launches (library None where PyTorch has no such call); logs both
    timings, the GEMMs' rates (TOP/s for the int8 ones) and the bound."""
    k_bb, k_dev = cuda_ms(fk), device_ms(fk)
    unit = "TOP/s" if "i8" in name else "TFLOP/s"

    def rate(ms):
        return f" ({flops / ms / 1e9:.1f} {unit})" if flops else ""

    lib_s, l_dev = "none", None
    if fl is not None:
        l_bb, l_dev = cuda_ms(fl), device_ms(fl)
        lib_s = f"{l_bb:.4f} / {l_dev:.4f} ms{rate(l_dev)}"
    log(f"  time {name} {tag}: kernel {k_bb:.4f} ms back to back, "
        f"{k_dev:.4f} ms device{rate(k_dev)}; library {lib_s}; bound "
        f"{b_ms:.4f} ms{rate(b_ms)} [{card}]")
    return k_dev, l_dev


class Checker:
    """Holds a kernel's output to its plain version's; any breach is
    fatal.  Tolerances (bf16 outputs, both sides f32-accumulated with the
    same rounding points, so they differ only where a different
    summation order flips a bf16 rounding):
      - GEMM and attention outputs: max |d| <= 2**-6 * max|want| (two
        bf16 ulps at the tensor's largest magnitude), mean |d| <= 1e-3;
      - LayerNorm outputs: max |d| <= 5e-2, mean |d| <= 5e-3 (|y| < 8
        here, so 5e-2 is under two bf16 ulps)."""

    def __init__(self):
        self.max_err = {}

    def __call__(self, name, kernel, got, want, ln: bool):
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        lim_max = 5e-2 if ln else 2.0 ** -6 * want.float().abs().max().item()
        lim_mean = 5e-3 if ln else 1e-3
        ok = (mx <= lim_max and mean <= lim_mean
              and bool(torch.isfinite(got.float()).all()))
        log(f"  {'ok ' if ok else 'BAD'} {name}: max {mx:.3e} (<= "
            f"{lim_max:.3e}) mean {mean:.3e} (<= {lim_mean:.0e})")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 "version")
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), mx)

    def rel(self, name, kernel, got, want, tol: float):
        """max |got - want| <= tol * max |want| (f32 row reductions in
        another order)."""
        d = (got.float() - want.float()).abs().max().item()
        lim = tol * want.float().abs().max().item()
        ok = d <= lim and bool(torch.isfinite(got.float()).all())
        log(f"  {'ok ' if ok else 'BAD'} {name}: max {d:.3e} (<= {lim:.3e})")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 "version")
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), d)

    def sums(self, name, kernel, got, want):
        """Sums of bf16-rounded products that both sides round in other
        places (the attention backward's ds and p_v): max |d| <= 2**-6 *
        max |want| and mean |d| <= 2**-6 * mean |want|."""
        d = (got.float() - want.float()).abs()
        w = want.float().abs()
        mx, mean = d.max().item(), d.mean().item()
        lim_max, lim_mean = 2.0 ** -6 * w.max().item(), \
            2.0 ** -6 * w.mean().item()
        ok = (mx <= lim_max and mean <= lim_mean
              and bool(torch.isfinite(got.float()).all()))
        log(f"  {'ok ' if ok else 'BAD'} {name}: max {mx:.3e} (<= "
            f"{lim_max:.3e}) mean {mean:.3e} (<= {lim_mean:.3e})")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 "version")
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), mx)

    def exact(self, name, kernel, got, want, bf16_ulps: int = 0,
              floor: float = 0.0):
        """Bit-equality, or at most ``bf16_ulps`` bf16 ulps of ``want``
        per element (the GELU epilogue: erff against torch.erf), plus
        ``floor`` times the largest |want| (row statistics summed in
        another order move an f32 value by a few ulps of the row's
        magnitude, which shows in bf16 ulps where cancellation leaves an
        element near 0)."""
        d = (got.float() - want.float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(2.0 ** -126))) - 7)
        lim = bf16_ulps * ulp + floor * want.float().abs().max()
        ok = bool((d <= lim).all()) and got.dtype == want.dtype
        mx = d.max().item()
        n_diff = int((d > 0).sum())
        floor_s = f" + {floor:.1e} of max" if floor else ""
        log(f"  {'ok ' if ok else 'BAD'} {name}: {n_diff} of {d.numel()} "
            f"differ, max {mx:.3e} (<= {bf16_ulps} bf16 ulp{floor_s})")
        if not ok:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 "version")
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), mx)


def int8_weights(p):
    """The bf16 weights quantized as the int8 Predictor holds them."""
    from nbest_asr_tpu_torch.ops.quant import kernel_layout, quantize_weight

    out = {}
    for name in ("wqkv", "wo", "w1", "w2"):
        q, scale = quantize_weight(p[name].float())
        out[name] = (kernel_layout(q), scale.reshape(-1))
    return out


def check_int8(K, p, q8, x, x2, pad, packed, check):
    """Each int8 kernel and both int8 blocks against their plain versions
    on the card; returns the kernels' intermediate outputs."""
    from nbest_asr_tpu_torch.ops.int8_serving import (
        int8_attention_block, int8_attention_block_reference,
        int8_ffn_block, int8_ffn_block_reference)

    def quant(name, a):
        q, sc = K.quantize_rows(a)
        torch.cuda.synchronize()
        rq, rs = K.quantize_rows_reference(a)
        check.exact(f"quantize_rows {name} q", "quantize_rows", q, rq)
        check.exact(f"quantize_rows {name} scale", "quantize_rows", sc, rs)
        return q, sc

    xq = quant("x", x2)
    qkv = K.gemm_i8_bias_act(*xq, *q8["wqkv"], p["bqkv"])
    torch.cuda.synchronize()
    check.exact("gemm_i8_bias_act qkv", "gemm_i8_bias_act", qkv,
                K.gemm_i8_bias_act_reference(*xq, *q8["wqkv"], p["bqkv"]))
    cq = quant("ctx", K.seg_attention(qkv, pad, NH))
    sres = K.gemm_i8_bias_residual(*cq, *q8["wo"], p["bo"], x2)
    torch.cuda.synchronize()
    check.exact("gemm_i8_bias_residual out-proj", "gemm_i8_bias_residual",
                sres, K.gemm_i8_bias_residual_reference(*cq, *q8["wo"],
                                                        p["bo"], x2))
    g = K.gemm_i8_bias_act(*xq, *q8["w1"], p["b1"], "gelu")
    torch.cuda.synchronize()
    check.exact("gemm_i8_bias_act w1+gelu", "gemm_i8_bias_act", g,
                K.gemm_i8_bias_act_reference(*xq, *q8["w1"], p["b1"],
                                             "gelu"), bf16_ulps=1)
    gq = quant("gelu", g)
    s2 = K.gemm_i8_bias_residual(*gq, *q8["w2"], p["b2"], x2)
    torch.cuda.synchronize()
    check.exact("gemm_i8_bias_residual w2", "gemm_i8_bias_residual", s2,
                K.gemm_i8_bias_residual_reference(*gq, *q8["w2"], p["b2"],
                                                  x2))
    attn_args = (x, *q8["wqkv"], p["bqkv"], *q8["wo"], p["bo"], p["ls"],
                 p["lb"])
    for mname, m in (("padded", pad), ("packed", packed)):
        got = int8_attention_block(*attn_args, m, n_heads=NH)
        torch.cuda.synchronize()
        check(f"int8_attention_block {mname}", "block", got,
              int8_attention_block_reference(*attn_args, m, n_heads=NH),
              True)
    ffn_args = (x, *q8["w1"], p["b1"], *q8["w2"], p["b2"], p["ls"], p["lb"])
    got = int8_ffn_block(*ffn_args)
    torch.cuda.synchronize()
    check("int8_ffn_block", "block", got, int8_ffn_block_reference(
        *ffn_args), True)
    return xq, cq, g, gq, attn_args, ffn_args


def masks(b, s, gen, dev):
    """(padded 1/0 mask, packed mask of segments 1..3 then pads)."""
    pad = (torch.rand(b, s, generator=gen) > 0.2).float()
    pad[:, 0] = 1.0
    packed = torch.zeros(b, s)
    for i in range(b):
        c = torch.sort(torch.randperm(s - 1, generator=gen)[:3] + 1).values
        packed[i, :c[0]], packed[i, c[0]:c[1]] = 1.0, 2.0
        packed[i, c[1]:c[2]] = 3.0
    return pad.to(dev), packed.to(dev)


def phase_kernels(dev, card: str):
    from nbest_asr_tpu_torch.ops import kernels as K
    from nbest_asr_tpu_torch.ops.fused_attention import (
        fused_attention_block, fused_attention_block_reference)
    from nbest_asr_tpu_torch.ops.fused_ffn import (fused_ffn_block,
                                                   fused_ffn_block_reference)
    from nbest_asr_tpu_torch.ops.int8_serving import (
        int8_attention_block, int8_attention_block_reference,
        int8_ffn_block, int8_ffn_block_reference)

    gen = torch.Generator().manual_seed(1)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    p = {"wqkv": rn(H, 3 * H, std=0.02), "bqkv": rn(3 * H, std=0.02,
                                                     dtype=torch.float32),
         "wo": rn(H, H, std=0.02), "bo": rn(H, std=0.02,
                                            dtype=torch.float32),
         "w1": rn(H, INTER, std=0.02), "b1": rn(INTER, std=0.02,
                                                dtype=torch.float32),
         "w2": rn(INTER, H, std=0.02), "b2": rn(H, std=0.02,
                                               dtype=torch.float32),
         "ls": 1.0 + rn(H, std=0.1, dtype=torch.float32),
         "lb": rn(H, std=0.1, dtype=torch.float32)}
    q8 = int8_weights(p)
    check = Checker()
    times = {}
    for b, s in [(3, 20)] + [(BATCH, s) for s in BUCKETS]:
        log(f"[kernels] batch {b} x seq {s}")
        x = rn(b, s, H)
        x2 = x.reshape(b * s, H)
        pad, packed = masks(b, s, gen, dev)
        qkv = K.gemm_bias_act(x2, p["wqkv"], p["bqkv"])
        torch.cuda.synchronize()
        check("gemm_bias_act qkv", "gemm_bias_act", qkv,
              K.gemm_bias_act_reference(x2, p["wqkv"], p["bqkv"]), False)
        for mname, m in (("padded", pad), ("packed", packed)):
            ctx = K.seg_attention(qkv, m, NH)
            torch.cuda.synchronize()
            check(f"seg_attention {mname}", "seg_attention", ctx,
                  K.seg_attention_reference(qkv, m, NH), False)
        sres = K.gemm_bias_residual(ctx, p["wo"], p["bo"], x2)
        torch.cuda.synchronize()
        check("gemm_bias_residual out-proj", "gemm_bias_residual", sres,
              K.gemm_bias_residual_reference(ctx, p["wo"], p["bo"], x2),
              False)
        y = K.layer_norm_rows(sres, p["ls"], p["lb"], 1e-12)
        torch.cuda.synchronize()
        check("layer_norm", "layer_norm", y,
              K.layer_norm_reference(sres, p["ls"], p["lb"], 1e-12,
                                     torch.bfloat16), True)
        g = K.gemm_bias_act(x2, p["w1"], p["b1"], act="gelu")
        torch.cuda.synchronize()
        check("gemm_bias_act w1+gelu", "gemm_bias_act", g,
              K.gemm_bias_act_reference(x2, p["w1"], p["b1"], act="gelu"),
              False)
        s2 = K.gemm_bias_residual(g, p["w2"], p["b2"], x2)
        torch.cuda.synchronize()
        check("gemm_bias_residual w2", "gemm_bias_residual", s2,
              K.gemm_bias_residual_reference(g, p["w2"], p["b2"], x2),
              False)
        attn_args = (x, p["wqkv"], p["bqkv"], p["wo"], p["bo"], p["ls"],
                     p["lb"])
        for mname, m in (("padded", pad), ("packed", packed)):
            got = fused_attention_block(*attn_args, m, n_heads=NH)
            torch.cuda.synchronize()
            check(f"fused_attention_block {mname}", "block", got,
                  fused_attention_block_reference(*attn_args, m,
                                                  n_heads=NH), True)
        ffn_args = (x, p["w1"], p["b1"], p["w2"], p["b2"], p["ls"],
                    p["lb"])
        got = fused_ffn_block(*ffn_args)
        torch.cuda.synchronize()
        check("fused_ffn_block", "block", got,
              fused_ffn_block_reference(*ffn_args), True)
        xq, cq, g8, gq, i8_attn, i8_ffn = check_int8(K, p, q8, x, x2, pad,
                                                     packed, check)
        if b != BATCH:
            continue
        # per-layer time of each kernel's launches, kernel vs plain
        t = {
            "gemm_bias_act": (
                lambda: (K.gemm_bias_act(x2, p["wqkv"], p["bqkv"]),
                         K.gemm_bias_act(x2, p["w1"], p["b1"], "gelu")),
                lambda: (K.gemm_bias_act_reference(x2, p["wqkv"],
                                                   p["bqkv"]),
                         K.gemm_bias_act_reference(x2, p["w1"], p["b1"],
                                                   "gelu"))),
            "gemm_bias_residual": (
                lambda: (K.gemm_bias_residual(ctx, p["wo"], p["bo"], x2),
                         K.gemm_bias_residual(g, p["w2"], p["b2"], x2)),
                lambda: (K.gemm_bias_residual_reference(ctx, p["wo"],
                                                        p["bo"], x2),
                         K.gemm_bias_residual_reference(g, p["w2"],
                                                        p["b2"], x2))),
            "layer_norm": (
                lambda: [K.layer_norm_rows(sres, p["ls"], p["lb"], 1e-12)
                         for _ in range(2)],
                lambda: [K.layer_norm_reference(sres, p["ls"], p["lb"],
                                                1e-12, torch.bfloat16)
                         for _ in range(2)]),
            "seg_attention": (
                lambda: K.seg_attention(qkv, pad, NH),
                lambda: K.seg_attention_reference(qkv, pad, NH)),
            "attention_block": (
                lambda: fused_attention_block(*attn_args, pad, n_heads=NH),
                lambda: fused_attention_block_reference(*attn_args, pad,
                                                        n_heads=NH)),
            "ffn_block": (
                lambda: fused_ffn_block(*ffn_args),
                lambda: fused_ffn_block_reference(*ffn_args)),
            # int8: quantize x for both blocks, ctx and the GELU output
            "quantize_rows": (
                lambda: [K.quantize_rows(a) for a in (x2, ctx, x2, g8)],
                lambda: [K.quantize_rows_reference(a)
                         for a in (x2, ctx, x2, g8)]),
            "gemm_i8_bias_act": (
                lambda: (K.gemm_i8_bias_act(*xq, *q8["wqkv"], p["bqkv"]),
                         K.gemm_i8_bias_act(*xq, *q8["w1"], p["b1"],
                                            "gelu")),
                lambda: (K.gemm_i8_bias_act_reference(*xq, *q8["wqkv"],
                                                      p["bqkv"]),
                         K.gemm_i8_bias_act_reference(*xq, *q8["w1"],
                                                      p["b1"], "gelu"))),
            "gemm_i8_bias_residual": (
                lambda: (K.gemm_i8_bias_residual(*cq, *q8["wo"], p["bo"],
                                                 x2),
                         K.gemm_i8_bias_residual(*gq, *q8["w2"], p["b2"],
                                                 x2)),
                lambda: (K.gemm_i8_bias_residual_reference(
                    *cq, *q8["wo"], p["bo"], x2),
                         K.gemm_i8_bias_residual_reference(
                             *gq, *q8["w2"], p["b2"], x2))),
            "int8_attention_block": (
                lambda: int8_attention_block(*i8_attn, pad, n_heads=NH),
                lambda: int8_attention_block_reference(*i8_attn, pad,
                                                       n_heads=NH)),
            "int8_ffn_block": (
                lambda: int8_ffn_block(*i8_ffn),
                lambda: int8_ffn_block_reference(*i8_ffn)),
        }
        lib = serving_library_calls(p, q8, x, x2, qkv, pad, ctx, g, sres,
                                    xq, cq, gq)
        bounds = serving_bounds(b * s, b, s)
        flops = {"gemm_bias_act": 2.0 * b * s * H * (3 * H + INTER),
                 "gemm_bias_residual": 2.0 * b * s * H * (H + INTER)}
        flops["gemm_i8_bias_act"] = flops["gemm_bias_act"]
        flops["gemm_i8_bias_residual"] = flops["gemm_bias_residual"]
        for name, (fk, fp) in t.items():
            if name in DEVICE_TIMED:
                k_ms, l_ms = time_device(name, f"b{b} s{s}", fk,
                                         lib.get(name), flops.get(name),
                                         bounds[name][0], card)
            else:
                k_ms = cuda_ms(fk)
                l_ms = cuda_ms(lib[name]) if name in lib else None
            times[(name, s)] = (k_ms, cuda_ms(fp, iters=3), l_ms)
        for name in t:
            k_ms, p_ms, l_ms = times[(name, s)]
            lib_s = "" if l_ms is None else f", library {l_ms:.4f} ms"
            if name in bounds:
                lib_s += (f", bound {bounds[name][0]:.4f} ms "
                          f"({bounds[name][1]})")
            log(f"  time {name:<18} b{b} s{s}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms{lib_s} [{card}]")
    return check.max_err, times


def serving_library_calls(p, q8, x, x2, qkv, pad, ctx, g, sres, xq, cq, gq):
    """One PyTorch call per kernel launch of a serving layer that
    computes the same function where PyTorch has one, timed as the
    kernels' yardstick and used nowhere in the port: ``torch.addmm`` for
    each bf16 GEMM (its bias in bf16, no epilogue), ``torch._int_mm`` for
    each int8 GEMM (the integer product only), ``F.layer_norm`` (f32 out)
    and ``F.scaled_dot_product_attention`` with the boolean segment
    mask."""
    F = torch.nn.functional
    bf = {k: p[k].to(torch.bfloat16) for k in ("bqkv", "bo", "b1", "b2")}
    b, s = pad.shape
    q, k, v = qkv.view(b, s, 3, NH, H // NH).permute(2, 0, 3, 1, 4)
    same = (pad[:, None, :, None] == pad[:, None, None, :])
    return {
        "gemm_bias_act": lambda: (torch.addmm(bf["bqkv"], x2, p["wqkv"]),
                                  torch.addmm(bf["b1"], x2, p["w1"])),
        "gemm_bias_residual": lambda: (torch.addmm(bf["bo"], ctx, p["wo"]),
                                       torch.addmm(bf["b2"], g, p["w2"])),
        "layer_norm": lambda: [F.layer_norm(sres, (H,), p["ls"], p["lb"],
                                            1e-12) for _ in range(2)],
        "seg_attention": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=same),
        "gemm_i8_bias_act": lambda: (torch._int_mm(xq[0], q8["wqkv"][0]),
                                     torch._int_mm(xq[0], q8["w1"][0])),
        "gemm_i8_bias_residual": lambda: (
            torch._int_mm(cq[0], q8["wo"][0]),
            torch._int_mm(gq[0], q8["w2"][0])),
    }


def serving_bounds(M: int, b: int, s: int):
    """Per serving layer at M = b * s rows: each kernel's bound over all
    its launches, from the shapes (bytes: each input read once, each
    output written once)."""
    h3, i = 3 * H, INTER
    gb = lambda m, n, k, extra, kind="bf16": gemm_bound(m, n, k, extra,
                                                        kind)
    ln = bound(8.0 * M * H, M * H * 4 + 2 * H * 4 + M * H * 2, "f32")
    quant = [bound(3.0 * M * k, M * k * 2 + M * k + M * 4, "f32")
             for k in (H, H, H, i)]
    return {
        "gemm_bias_act": bound_sum([
            gb(M, h3, H, h3 * 4 + M * h3 * 2),
            gb(M, i, H, i * 4 + M * i * 2)]),
        "gemm_bias_residual": bound_sum([
            gb(M, H, H, H * 4 + M * H * 2 + M * H * 4),
            gb(M, H, i, H * 4 + M * H * 2 + M * H * 4)]),
        "layer_norm": bound_sum([ln, ln]),
        "seg_attention": bound(4.0 * b * NH * s * s * (H // NH),
                               M * h3 * 2 + b * s * 4 + M * H * 2, "bf16"),
        "quantize_rows": bound_sum(quant),
        "gemm_i8_bias_act": bound_sum([
            gb(M, h3, H, M * 4 + h3 * 8 + M * h3 * 2, "s8"),
            gb(M, i, H, M * 4 + i * 8 + M * i * 2, "s8")]),
        "gemm_i8_bias_residual": bound_sum([
            gb(M, H, H, M * 4 + H * 8 + M * H * 6, "s8"),
            gb(M, H, i, M * 4 + H * 8 + M * H * 6, "s8")]),
    }


def dstc2_like_memory():
    """A synthetic label hierarchy shaped like DSTC2's: value-bearing
    inform/confirm/deny groups (with their NONE labels), request-slot and
    bare-act singletons, and a word vocabulary of ~900 words."""
    from nbest_asr_tpu_torch.data.etl import build_memory

    values = {"food": ["chinese", "indian", "italian", "thai", "french",
                       "korean", "british", "european", "spanish"],
              "area": ["north", "south", "east", "west", "centre"],
              "pricerange": ["cheap", "moderate", "expensive"]}
    labels = []
    for act in ("inform", "confirm", "deny"):
        for slot, vals in values.items():
            labels += [f"{act}-{slot}-{v}" for v in vals]
    labels += [f"request-{s}" for s in ("phone", "addr", "postcode", "food",
                                        "area", "pricerange", "name")]
    labels += ["thankyou", "bye", "hello", "affirm", "negate", "repeat",
               "reqalts", "ack", "restart", "reqmore"]
    words = [w for vals in values.values() for w in vals]
    words += ("i want a restaurant in the part of town serving food what "
              "is phone number address post code price range thank you "
              "good bye yes no is there anything else please").split()
    words += [f"w{i}" for i in range(850)]
    return build_memory(words * 2, labels, ["inform", "request", "offer"])


def requests(memory, seed):
    """Four requests of REQUEST utterances; in request i the longest
    utterance packs to bucket BUCKETS[i], the others spread below it."""
    rng = np.random.RandomState(seed)
    words = [w for w in memory.word2idx if w.isalnum()]
    out = []
    lo = 8
    for bucket in BUCKETS:
        batch = []
        for j in range(REQUEST):
            # tokens = [CLS] + sys + [sep] + hyps with [sep] between + [sep]
            target = bucket - 4 if j == 0 else rng.randint(lo, bucket - 3)
            n_sys = rng.randint(1, max(2, target // 4))
            n_hyp = rng.randint(1, 6)
            budget = max(n_hyp, target - n_sys - 3 - (n_hyp - 1))
            cuts = np.sort(rng.choice(np.arange(1, budget), n_hyp - 1,
                                      replace=False)) if n_hyp > 1 else []
            sizes = np.diff(np.concatenate([[0], cuts, [budget]])).astype(int)
            hyps = [" ".join(rng.choice(words, size=max(int(k), 1)))
                    for k in sizes]
            batch.append(" ".join(["[CLS]", "[SYS]",
                                   *rng.choice(words, size=n_sys), "[USR]",
                                   " [SEP] ".join(hyps)]))
        out.append(batch)
        lo = bucket - 8
    return out


def head_outputs(predictor, req):
    """(top scores, group probs) of ``predictor``'s forward on ``req``,
    batch by batch as ``predict`` runs them, as numpy."""
    from nbest_asr_tpu_torch.models.model import model_forward

    pk = predictor._pack([u.split() for u in req])
    tops, probs = [], []
    with torch.inference_mode():
        for start in range(0, len(req), BATCH):
            ids = torch.from_numpy(pk.input_ids[start:start + BATCH])
            top, prob, _, _, _ = model_forward(
                predictor._fwd_params, predictor.cfg, predictor.hier,
                ids.to(predictor.device),
                torch.from_numpy(pk.attn_mask[start:start + BATCH]).to(
                    predictor.device),
                torch.zeros_like(ids).to(predictor.device))
            tops.append(top.float().cpu().numpy())
            probs.append(prob.float().cpu().numpy())
    return np.concatenate(tops), np.concatenate(probs)


def resolvable_disagreements(a, b, ref, arrays, tau: float):
    """Per utterance: do paths ``a`` and ``b`` make a different decision
    that the f32 reference ``ref`` resolves by more than ``tau``?

    The decode (train/decode.py) makes two kinds of decision: a top group
    fires when its score passes 0.5, and a firing multi-member group emits
    its arg-max member.  A decision is resolvable when the reference's
    margin -- |top - 0.5|, or the gap between the group's two largest
    probabilities -- exceeds ``tau``.  Each of ``a``, ``b``, ``ref`` is
    (top (n, n_top), probs (n, n_bottom))."""
    fire_a, fire_b = a[0] > 0.5, b[0] > 0.5
    res_top = np.abs(ref[0] - 0.5) > tau
    bad = ((fire_a != fire_b) & res_top).any(axis=1)
    member = arrays.membership > 0                      # (n_top, n_bottom)
    for g in np.nonzero(arrays.is_multi_top)[0]:
        cols = np.nonzero(member[g])[0]
        srt = np.sort(ref[1][:, cols], axis=1)
        res = (srt[:, -1] - srt[:, -2]) > tau
        win_a = cols[np.argmax(a[1][:, cols], axis=1)]
        win_b = cols[np.argmax(b[1][:, cols], axis=1)]
        bad |= fire_a[:, g] & fire_b[:, g] & res & (win_a != win_b)
    n_dec = res_top.size
    return bad, 1.0 - res_top.sum() / n_dec


def drive(predictor, reqs, per_layer, per_forward=None):
    """The main path: every request through ``predict``,
    ``predict_async`` and ``scores``, with the launch counters set to 0
    just before and read just after.  Fails unless each kernel launched
    exactly layers x forwards x its launches per layer plus forwards x its
    launches per forward (0 if absent)."""
    from nbest_asr_tpu_torch.ops import _cuda

    predictor.predict(reqs[0][:BATCH])             # warm-up, not counted
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    pass0 = quant_pass_launches()
    labels, scores = [], []
    for req in reqs:
        labels.append(predictor.predict(req))
        if predictor.predict_async(req).result() != labels[-1]:
            raise AssertionError("predict_async disagrees with predict")
        scores.append(predictor.scores(req))
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    n_forwards = 3 * len(reqs) * (REQUEST // BATCH)
    per_forward = per_forward or {}
    want = {k: (per_layer.get(k, 0) * LAYERS + per_forward.get(k, 0))
            * n_forwards for k in counts}
    log(f"[slice] {predictor.quantize}: launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("kernel launch counts differ from layers x "
                             "batches x launches per layer")
    hold_quant_pass(f"slice {predictor.quantize}", pass0, counts)
    return labels, scores, counts


def quant_pass_launches():
    """The row passes' launches by K: (quantize_rows', quantize_grad_rows')."""
    from nbest_asr_tpu_torch.ops.kernels import (
        quantize_grad_rows_pass_launches, quantize_rows_pass_launches)

    return quantize_rows_pass_launches(), quantize_grad_rows_pass_launches()


def hold_quant_pass(what, before, counts):
    """Every ``quantize_rows`` and ``quantize_grad_rows`` launch of a
    counted run took its row pass (csrc/quant_rows.cu), and a run that
    quantizes did so at the encoder's widths: K = 768 and 3072 for the
    activations, all four of a layer's gradient widths (768, 3072, 768,
    2304) for the gradients; ``before``: the row passes' launches by K
    when the run's counters were set to 0."""
    after = quant_pass_launches()
    for kernel, a, b, widths in (
            ("quantize_rows", after[0], before[0], {768, 3072}),
            ("quantize_grad_rows", after[1], before[1], {768, 2304, 3072})):
        d = {k: a[k] - b[k] for k in a if a[k] != b[k]}
        n = counts[kernel]
        log(f"[{what}] {kernel} launches on the row pass, by K: {d} of {n}")
        if sum(d.values()) != n or (n and set(d) != widths):
            raise AssertionError(f"{what}: {kernel} did not run its row "
                                 f"pass at K in {widths} at every launch")


def hold_to_plain(name, kp, pp, fp, reqs, k_labels, k_scores, arrays,
                  max_mean, max_abs=None):
    """Gate the kernel path ``kp`` against the plain path ``pp`` on the
    decisions the f32 run ``fp`` resolves by more than tau (twice the
    plain path's own largest deviation from f32), and its scores against
    the f32 run: mean |d| <= ``max_mean`` and, if given, max |d| <=
    ``max_abs``."""
    raw = bad_total = total = 0
    for i, req in enumerate(reqs):
        sc = k_scores[i]
        if sc.shape != (REQUEST, kp.memory.n_bottom) or \
                not np.isfinite(sc).all():
            raise AssertionError(f"scores: shape {sc.shape}, finite "
                                 f"{np.isfinite(sc).all()}")
        p_labels = pp.predict(req)
        p_scores = pp.scores(req)
        f_scores = fp.scores(req)
        ko, po, fo = (head_outputs(p, req) for p in (kp, pp, fp))
        tau = 2.0 * max(np.abs(po[0] - fo[0]).max(),
                        np.abs(po[1] - fo[1]).max())
        bad, unresolved = resolvable_disagreements(ko, po, fo, arrays, tau)
        a = sum(x == y for x, y in zip(k_labels[i], p_labels))
        raw += a
        bad_total += int(bad.sum())
        total += len(req)
        d = np.abs(sc - p_scores)
        dk, dp = np.abs(sc - f_scores), np.abs(p_scores - f_scores)
        log(f"[slice] {name} bucket {BUCKETS[i]}: raw label agreement "
            f"kernel vs plain {a}/{len(req)}; resolvable disagreements "
            f"{bad.sum()} (tau {tau:.3e}, {unresolved:.3f} of top decisions "
            f"unresolved); |scores kernel - plain| max {d.max():.3e} mean "
            f"{d.mean():.3e}; |scores - f32| kernel max {dk.max():.3e} "
            f"mean {dk.mean():.3e}, plain max {dp.max():.3e} mean "
            f"{dp.mean():.3e}")
        if dk.mean() > max_mean:
            raise AssertionError(f"{name}: kernel-path scores off f32 by "
                                 f"{dk.mean():.3e} on average")
        if max_abs is not None and dk.max() > max_abs:
            raise AssertionError(f"{name}: kernel-path scores off f32 by "
                                 f"{dk.max():.3e} > {max_abs}")
    rate = 1.0 - bad_total / total
    log(f"[slice] {name}: agreement kernel vs plain on resolvable "
        f"decisions: {total - bad_total}/{total} = {rate:.4f}; raw label "
        f"agreement {raw}/{total} = {raw / total:.4f}")
    if rate < 0.98:
        raise AssertionError(f"{name}: agreement {rate:.4f} < 0.98")


def phase_slice(dev):
    import dataclasses

    from nbest_asr_tpu_torch.data.tokenizer import WordVocabTokenizer
    from nbest_asr_tpu_torch.models.encoder import EncoderConfig
    from nbest_asr_tpu_torch.models.model import (ModelConfig,
                                                  init_model_params)
    from nbest_asr_tpu_torch.serve import Predictor

    memory = dstc2_like_memory()
    tok = WordVocabTokenizer(memory)
    enc = EncoderConfig.bert_base(vocab_size=VOCAB,
                                  compute_dtype="bfloat16",
                                  use_fused_attn=True, use_fused_ffn=True,
                                  use_fused_attn_eval=True)
    cfg = ModelConfig(encoder=enc, n_top=memory.n_top,
                      n_bottom=memory.n_bottom)
    t0 = time.perf_counter()
    params = init_model_params(torch.Generator().manual_seed(0), cfg)
    log(f"[slice] BERT-base init {time.perf_counter() - t0:.1f} s; "
        f"n_top {memory.n_top}, n_bottom {memory.n_bottom}, "
        f"word vocab {tok.vocab_size}")
    plain_cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        enc, use_fused_attn=False, use_fused_ffn=False,
        use_fused_attn_eval=False))
    f32_cfg = dataclasses.replace(plain_cfg, encoder=dataclasses.replace(
        plain_cfg.encoder, compute_dtype="float32"))
    kw = dict(device=dev, batch_size=BATCH, max_len=BUCKETS[-1])
    kp = Predictor(params, cfg, memory, tok, quantize="none", **kw)
    pp = Predictor(params, plain_cfg, memory, tok, quantize="none", **kw)
    fp = Predictor(params, f32_cfg, memory, tok, quantize="none", **kw)
    reqs = requests(memory, seed=0)
    for bucket, req in zip(BUCKETS, reqs):
        got = kp._pack([u.split() for u in req]).max_len
        if got != bucket:
            raise AssertionError(f"request meant for bucket {bucket} packed "
                                 f"to {got}")
    arrays = memory.arrays()

    # ---- bf16: main path through the kernels, counted, then held ------- #
    # Raw label agreement between two bf16 paths is printed but not the
    # gate: with random weights every top score sits within a few tenths
    # of the 0.5 threshold, where the plain path's bf16 residual rounding
    # (the JAX XLA path's; the kernels keep the residual sum in f32) flips
    # labels (H100, seed-0 BERT-base: 80% raw agreement at score
    # differences < 9e-3).  The gate is agreement on the decisions an f32
    # run resolves by more than tau = twice the plain path's own largest
    # deviation from that f32 run; a wrong kernel flips resolvable
    # decisions.  bf16 activations through 12 layers move scores in
    # [0, 1] by about 1e-3 on average; a wrong kernel moves them by O(0.1).
    k_labels, k_scores, counts = drive(kp, reqs, PER_LAYER)
    hold_to_plain("bf16", kp, pp, fp, reqs, k_labels, k_scores, arrays,
                  max_mean=5e-3)

    # ---- route C: the plain blocks with the three row-kernel flags ---- #
    # The same gate against the same plain and f32 runs: the fused
    # residual LayerNorm keeps the residual sum in f32, the fused GELU
    # adds the bias to the rounded GEMM in f32 (JAX's arithmetic on this
    # route), so its scores sit off the plain bf16 path's by bf16 noise.
    rows_cfg = dataclasses.replace(plain_cfg, encoder=dataclasses.replace(
        plain_cfg.encoder, **ROWS_FLAGS))
    cp = Predictor(params, rows_cfg, memory, tok, quantize="none", **kw)
    c_labels, c_scores, c_counts = drive(cp, reqs, PER_LAYER_ROWS,
                                         PER_FORWARD_ROWS)
    hold_to_plain("fused rows", cp, pp, fp, reqs, c_labels, c_scores,
                  arrays, max_mean=5e-3)
    counts = {k: counts[k] + c_counts[k] for k in counts}
    del pp

    # ---- int8: the same weights and requests through the int8 chains --- #
    # The int8 plain path (the three kernel flags off) runs the plain
    # int8 dense of ops/quant.py; tau is twice ITS largest deviation from
    # the f32 run.  Scores must stay within 5e-2 of the f32 run, the bound
    # the JAX package states for int8 (nbest_asr_tpu/ops/quant.py:31).
    qp = Predictor(params, cfg, memory, tok, quantize="int8", **kw)
    qpp = Predictor(params, plain_cfg, memory, tok, quantize="int8", **kw)
    q_labels, q_scores, q_counts = drive(qp, reqs, PER_LAYER_I8)
    hold_to_plain("int8", qp, qpp, fp, reqs, q_labels, q_scores, arrays,
                  max_mean=5e-2, max_abs=5e-2)
    del qpp, fp
    counts = {k: counts[k] + q_counts[k] for k in counts}

    # ---- times --------------------------------------------------------- #
    # forward ms per batch (CUDA events); predict utt/s with bf16 and int8
    # alternating ABBA so that clock drift falls on both alike
    pp = Predictor(params, plain_cfg, memory, tok, quantize="none", **kw)
    card = card_line()
    for bucket, req in zip(BUCKETS, reqs):
        packed = kp._pack([u.split() for u in req[:BATCH]])
        ids = torch.from_numpy(packed.input_ids).to(dev)
        mask = torch.from_numpy(packed.attn_mask).to(dev)
        segs = torch.zeros_like(ids)
        k_ms = cuda_ms(lambda: kp._forward(ids, mask, segs))
        q_ms = cuda_ms(lambda: qp._forward(ids, mask, segs))
        p_ms = cuda_ms(lambda: pp._forward(ids, mask, segs), iters=3)
        c_ms = cuda_ms(lambda: cp._forward(ids, mask, segs), iters=3)
        kp.predict(req)
        qp.predict(req)
        torch.cuda.synchronize()
        reps, secs = 3, {"none": 0.0, "int8": 0.0}
        for p in (kp, qp, qp, kp):
            t0 = time.perf_counter()
            for _ in range(reps):
                p.predict(req)
            secs[p.quantize] += time.perf_counter() - t0
        ups = {m: 2 * reps * len(req) / t for m, t in secs.items()}
        log(f"[times] bucket {bucket}: forward per batch of {BATCH}: bf16 "
            f"kernel {k_ms:.3f} ms, int8 kernel {q_ms:.3f} ms, bf16 plain "
            f"{p_ms:.3f} ms, route C (plain blocks, row kernels) "
            f"{c_ms:.3f} ms; predict bf16 {ups['none']:.1f} utt/s, int8 "
            f"{ups['int8']:.1f} utt/s ({len(req)} utt/request, ABBA) "
            f"[{card}]")
    return counts


# --------------------------------------------------------------------- #
# training: both blocks' training chains and the train step
# --------------------------------------------------------------------- #

def train_weights(dev, seed: int):
    """One encoder layer's random weights at BERT-base widths: bf16
    kernels, f32 biases and LN params."""
    gen = torch.Generator().manual_seed(seed)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    f32 = torch.float32
    return {"w1": rn(H, INTER, std=0.02),
            "b1": rn(INTER, std=0.02, dtype=f32),
            "w2": rn(INTER, H, std=0.02),
            "b2": rn(H, std=0.02, dtype=f32),
            "wqkv": rn(H, 3 * H, std=0.02),
            "bqkv": rn(3 * H, std=0.02, dtype=f32),
            "wo": rn(H, H, std=0.02),
            "bo": rn(H, std=0.02, dtype=f32),
            "ls": 1.0 + rn(H, std=0.1, dtype=f32),
            "lb": rn(H, std=0.1, dtype=f32)}, rn


def check_ffn_train_chain(K, p, x2, dy, seed, check):
    """Each training kernel of the FFN block against its plain version
    with the same Philox bits, on the kernels' own intermediates; returns
    them for the timings."""
    from nbest_asr_tpu_torch.ops.layers import gelu
    from nbest_asr_tpu_torch.ops.philox import keep_mask, site

    n = x2.shape[0]
    d1, d2 = site(seed, DROPOUT, 1), site(seed, DROPOUT, 2)
    k1 = keep_mask(seed, 1, 0, n, INTER, DROPOUT, x2.device)
    k2 = keep_mask(seed, 2, 0, n, H, DROPOUT, x2.device)
    tag = f"n {n}"
    h, gd = K.gemm_bias_act(x2, p["w1"], p["b1"], "gelu", drop=d1,
                            save_h=True)
    torch.cuda.synchronize()
    rh, _ = K.gemm_bias_act_reference(x2, p["w1"], p["b1"], "gelu", d1,
                                      True)
    check(f"train gemm_bias_act h {tag}", "gemm_bias_act", h, rh, False)
    check.exact(f"train gemm_bias_act gd = drop1(gelu(h)) {tag}",
                "gemm_bias_act", gd,
                d1.apply(gelu(h.float())).to(torch.bfloat16), bf16_ulps=1)
    s, y2d = K.gemm_bias_residual(gd, p["w2"], p["b2"], x2, drop=d2,
                                  save_y2d=True)
    torch.cuda.synchronize()
    rs, ry2d = K.gemm_bias_residual_reference(gd, p["w2"], p["b2"], x2, d2,
                                              True)
    check(f"train gemm_bias_residual sum {tag}", "gemm_bias_residual", s,
          rs, False)
    check(f"train gemm_bias_residual y2d {tag}", "gemm_bias_residual", y2d,
          ry2d, False)
    if not (bool((y2d[~k2] == 0).all())
            and torch.equal(s[~k2], x2.float()[~k2])):
        raise AssertionError("gemm_bias_residual: a dropped element "
                             "survived")
    y, mean, rstd = K.layer_norm_rows(s, p["ls"], p["lb"], 1e-12,
                                      stats=True)
    torch.cuda.synchronize()
    ry, rmean, rrstd = K.layer_norm_reference(s, p["ls"], p["lb"], 1e-12,
                                              torch.bfloat16, stats=True)
    check(f"train layer_norm {tag}", "layer_norm", y, ry, True)
    check.rel(f"train layer_norm mean {tag}", "layer_norm", mean, rmean,
              1e-5)
    check.rel(f"train layer_norm rstd {tag}", "layer_norm", rstd, rrstd,
              1e-5)
    dy2, xhat, ds = K.ffn_bwd_rows(x2, y2d, dy, p["ls"], mean, rstd,
                                   drop=d2)
    torch.cuda.synchronize()
    rdy2, rxhat, rds = K.ffn_bwd_rows_reference(x2, y2d, dy, p["ls"], mean,
                                                rstd, d2)
    check.rel(f"ffn_bwd_rows ds {tag}", "ffn_bwd_rows", ds, rds, 1e-5)
    check.exact(f"ffn_bwd_rows xhat {tag}", "ffn_bwd_rows", xhat, rxhat,
                bf16_ulps=1)
    check(f"ffn_bwd_rows dy2 {tag}", "ffn_bwd_rows", dy2, rdy2, False)
    check.exact(f"ffn_bwd_rows dy2 = drop2(ds) {tag}", "ffn_bwd_rows", dy2,
                d2.apply(ds).to(torch.bfloat16), bf16_ulps=0)
    dh, gd_b = K.gemm_dgrad(dy2, p["w2"], "dgelu", h=h, drop=d1)
    torch.cuda.synchronize()
    rdh, _ = K.gemm_dgrad_reference(dy2, p["w2"], "dgelu", h=h, drop=d1)
    check(f"gemm_dgrad dgelu dh {tag}", "gemm_dgrad", dh, rdh, False)
    check.exact(f"gemm_dgrad regenerated gd == forward gd {tag}",
                "gemm_dgrad", gd_b, gd, bf16_ulps=0)
    if not bool((gd[~k1] == 0).all()):
        raise AssertionError("gemm_bias_act: a dropped element survived")
    dx = K.gemm_dgrad(dh, p["w1"], "residual", ds=ds)
    torch.cuda.synchronize()
    check(f"gemm_dgrad residual dx {tag}", "gemm_dgrad", dx,
          K.gemm_dgrad_reference(dh, p["w1"], "residual", ds=ds), False)
    return dict(h=h, gd=gd, s=s, y2d=y2d, mean=mean, rstd=rstd, dy2=dy2,
                ds=ds, dh=dh, d1=d1, d2=d2)


def check_attn_train_chain(K, p, x, mask_list, dy, seed, check):
    """Each training kernel of the attention block against its plain
    version with the same Philox bits (streams 3 and 4), on the kernels'
    own intermediates, for each (name, mask); returns the first mask's
    intermediates for the timings."""
    from nbest_asr_tpu_torch.ops.philox import keep_mask, site

    b, s, _ = x.shape
    n = b * s
    x2 = x.reshape(n, H)
    da, dh = site(seed, DROPOUT, 3), site(seed, DROPOUT, 4)
    k4 = keep_mask(seed, 4, 0, n, H, DROPOUT, x.device)
    qkv = K.gemm_bias_act(x2, p["wqkv"], p["bqkv"])
    torch.cuda.synchronize()
    check(f"train gemm_bias_act qkv n {n}", "gemm_bias_act", qkv,
          K.gemm_bias_act_reference(x2, p["wqkv"], p["bqkv"]), False)
    out = None
    for mname, m in mask_list:
        tag = f"n {n} ({b} x {s}) {mname}"
        ctx, st = K.seg_attention(qkv, m, NH, drop=da, stats=True)
        torch.cuda.synchronize()
        rctx, rst = K.seg_attention_reference(qkv, m, NH, da, stats=True)
        check(f"train seg_attention ctx {tag}", "seg_attention", ctx, rctx,
              False)
        check.rel(f"train seg_attention row max {tag}", "seg_attention",
                  st[0], rst[0], 1e-5)
        check.rel(f"train seg_attention row sum {tag}", "seg_attention",
                  st[1], rst[1], 1e-5)
        sres, od = K.gemm_bias_residual(ctx, p["wo"], p["bo"], x2, drop=dh,
                                        save_y2d=True)
        torch.cuda.synchronize()
        rs, rod = K.gemm_bias_residual_reference(ctx, p["wo"], p["bo"], x2,
                                                 dh, True)
        check(f"train gemm_bias_residual out-proj sum {tag}",
              "gemm_bias_residual", sres, rs, False)
        check(f"train gemm_bias_residual od {tag}", "gemm_bias_residual",
              od, rod, False)
        if not (bool((od[~k4] == 0).all())
                and torch.equal(sres[~k4], x2.float()[~k4])):
            raise AssertionError("gemm_bias_residual: a dropped out-proj "
                                 "element survived")
        _, mean, rstd = K.layer_norm_rows(sres, p["ls"], p["lb"], 1e-12,
                                          stats=True)
        dout, _, ds = K.ffn_bwd_rows(x2, od, dy, p["ls"], mean, rstd,
                                     drop=dh)
        torch.cuda.synchronize()
        check.exact(f"ffn_bwd_rows dout = drop_h(ds) {tag}", "ffn_bwd_rows",
                    dout, dh.apply(ds).to(torch.bfloat16), bf16_ulps=0)
        dctx = K.gemm_dgrad(dout, p["wo"], "none")
        torch.cuda.synchronize()
        check(f"gemm_dgrad none dctx {tag}", "gemm_dgrad", dctx,
              K.gemm_dgrad_reference(dout, p["wo"], "none"), False)
        dqkv = K.seg_attention_bwd(qkv, dctx, m, st, NH, drop=da)
        torch.cuda.synchronize()
        rdqkv = K.seg_attention_bwd_reference(qkv, dctx, m, st, NH, da)
        for i, part in enumerate("qkv"):
            cols = slice(i * H, (i + 1) * H)
            check.sums(f"seg_attention_bwd d{part} {tag}",
                       "seg_attention_bwd", dqkv[:, cols], rdqkv[:, cols])
        dx = K.gemm_dgrad(dqkv, p["wqkv"], "residual", ds=ds)
        torch.cuda.synchronize()
        check(f"gemm_dgrad residual dx {tag}", "gemm_dgrad", dx,
              K.gemm_dgrad_reference(dqkv, p["wqkv"], "residual", ds=ds),
              False)
        if out is None:
            out = dict(qkv=qkv, ctx=ctx, st=st, s=sres, od=od, mean=mean,
                       rstd=rstd, dout=dout, ds=ds, dctx=dctx, dqkv=dqkv,
                       mask=m, da=da, dh=dh)
    return out


def check_prob_mask_probe(K, dev):
    """The backward regenerates the forward's prob mask bit for bit.
    With one-hot K and V (row k = e_k; s = 64 = head dim) the forward's
    ctx is the dropped probs, the dK/dV kernel's dV for one-hot dO their
    transpose, and the dQ kernel's dq for dO = 1 is negative exactly where
    a prob was dropped (a kept prob's ds is p * inv_keep * (1 - kept
    mass) >= 0, about 1e-10 where a whole row is kept; a dropped one's
    -p * inv_keep * kept mass): each must equal the stream-3 keep bits.
    Then, with random K (one-hot V), the backward's rebuilt bf16 probs
    (the wgmma pair issues the forward's own score products) equal the
    forward's: 0 differ."""
    from nbest_asr_tpu_torch.ops.philox import keep_mask, site

    b, s, d, seed = 4, 64, H // NH, 4321
    gen = torch.Generator().manual_seed(5)
    eye = torch.eye(s, device=dev, dtype=torch.bfloat16)
    mask = torch.ones(b, s, device=dev)
    drop = site(seed, DROPOUT, 3)
    keep = keep_mask(seed, 3, 0, b * NH * s, s, DROPOUT, dev).reshape(
        b, NH, s, s)
    for onehot_k in (True, False):
        kind = "one-hot" if onehot_k else "random"
        qkv = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        for hd in range(NH):
            for part in (1, 2) if onehot_k else (2,):
                qkv[:, part * H + hd * d:part * H + (hd + 1) * d] = \
                    eye.repeat(b, 1)
        ctx, st = K.seg_attention(qkv, mask, NH, drop=drop, stats=True)
        d_v = K.seg_attention_bwd(qkv, eye.repeat(b, NH).contiguous(), mask,
                                  st, NH, drop=drop)
        d_q = K.seg_attention_bwd(qkv, torch.ones_like(ctx), mask, st, NH,
                                  drop=drop)
        torch.cuda.synchronize()
        p_fwd = ctx.reshape(b, s, NH, d).permute(0, 2, 1, 3)
        p_bwd = d_v[:, 2 * H:].reshape(b, s, NH, d).permute(0, 2, 3, 1)
        seen = {"forward (ctx)": p_fwd != 0, "dK/dV kernel (dV)": p_bwd != 0}
        if onehot_k:
            seen["dQ kernel (dq)"] = d_q[:, :H].reshape(b, s, NH, d).permute(
                0, 2, 1, 3).float() > -1e-6
        for name, m in seen.items():
            n_diff = int((m != keep).sum())
            log(f"  {'ok ' if n_diff == 0 else 'BAD'} prob mask of the {name} "
                f"vs the stream-3 keep bits ({kind} K): {n_diff} of "
                f"{keep.numel()} differ")
            if n_diff:
                raise AssertionError(f"the {name} does not regenerate the "
                                     "forward's prob mask")
        w = p_fwd[keep].float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs())) - 7)
        ulps = ((p_bwd[keep].float() - w).abs() / ulp).max().item()
        n_diff = int((p_fwd != p_bwd).sum())
        ok = n_diff == 0
        log(f"  {'ok ' if ok else 'BAD'} rebuilt probs ({kind} K): {n_diff} "
            f"of {keep.numel()} bf16 probs differ from the forward's, max "
            f"{ulps:.0f} bf16 ulp (0 differ allowed)")
        if not ok:
            raise AssertionError("the backward's rebuilt probs differ from "
                                 "the forward's")


def check_attn_bwd_buckets(K, dev, gen, check, card):
    """seg_attention_bwd at each bucket's training micro (BERT-base
    heads): on the QKV buffer with padded and packed masks at dropout 0
    and 0.1, and on standalone (b, s, heads, d) tensors (route A's
    unpacked operands), against its plain version (``Checker.sums``); a
    second run bit-equal; each launch on the wgmma pair; then its device
    ms beside SDPA's backward alone on the same operands."""
    from nbest_asr_tpu_torch.ops.philox import site

    F = torch.nn.functional
    d = H // NH
    for s, b in TRAIN_MICRO.items():
        dctx = (torch.randn(b * s, H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        qkv = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        for mname, m in zip(("padded", "packed"), masks(b, s, gen, dev)):
            for rate in (0.0, DROPOUT):
                tag = f"{b} x {s} {mname} rate {rate}"
                drop = site(400 + s, rate, 3)
                _, st = K.seg_attention(qkv, m, NH, drop=drop, stats=True)
                n0 = K.seg_attention_bwd_wgmma_launches()
                got = K.seg_attention_bwd(qkv, dctx, m, st, NH, drop=drop)
                torch.cuda.synchronize()
                if K.seg_attention_bwd_wgmma_launches() - n0 != 1:
                    raise AssertionError(f"seg_attention_bwd {tag}: not on "
                                         "the wgmma pair")
                want = K.seg_attention_bwd_reference(qkv, dctx, m, st, NH,
                                                     drop)
                for i, part in enumerate("qkv"):
                    cols = slice(i * H, (i + 1) * H)
                    check.sums(f"seg_attention_bwd d{part} {tag}",
                               "seg_attention_bwd", got[:, cols],
                               want[:, cols])
                if not torch.equal(K.seg_attention_bwd(
                        qkv, dctx, m, st, NH, drop=drop), got):
                    raise AssertionError(f"seg_attention_bwd {tag}: two runs "
                                         "differ")
        q, k, v, do = (t.contiguous() for t in (
            *qkv.view(b, s, 3, NH, d).unbind(2), dctx.view(b, s, NH, d)))
        drop = site(500 + s, DROPOUT, 3)
        _, st = K.sb_attention(q, k, v, m, d ** -0.5, drop, True)
        for part, g, r in zip("qkv", K.sb_attention_bwd(
                q, k, v, do, m, st, d ** -0.5, drop),
                K.sb_attention_bwd_reference(q, k, v, do, m, st, d ** -0.5,
                                             drop)):
            check.sums(f"seg_attention_bwd (b, s, heads, d) d{part} {b} x "
                       f"{s} packed rate {DROPOUT}", "seg_attention_bwd", g,
                       r)
        # times: padded mask, dropout 0.1
        m = masks(b, s, gen, dev)[0]
        drop = site(600 + s, DROPOUT, 3)
        _, st = K.seg_attention(qkv, m, NH, drop=drop, stats=True)
        k_ms = device_ms(lambda: K.seg_attention_bwd(qkv, dctx, m, st, NH,
                                                     drop=drop))
        a = {"qkv": qkv, "mask": m, "dctx": dctx}
        _, fwd_bwd, bwd = attention_library_calls(a, b, s)
        b_ms = train_layer_bounds(b * s, b, s)["seg_attention_bwd"][0]
        log(f"  time seg_attention_bwd b{b} s{s}: kernel {k_ms:.4f} ms "
            f"device; SDPA backward alone {device_ms(bwd):.4f} ms (forward "
            f"+ backward {device_ms(fwd_bwd):.4f}); bound {b_ms:.4f} ms "
            f"[{card}]")


def train_int8_weights(p):
    """The four GEMM weights quantized as an int8 training step quantizes
    them (quant.quantize_train_weight): (q column-major, q row-major,
    scale (out,))."""
    from nbest_asr_tpu_torch.ops.quant import quantize_train_weight

    return {k: quantize_train_weight(p[k]) for k in ("w1", "w2", "wqkv",
                                                     "wo")}


def check_int8_train_chain(K, p, q8, x, mask_list, dy2, seed, check):
    """Each int8 training kernel and epilogue of both blocks against its
    plain version with the same Philox bits, on the kernels' own
    intermediates; returns them (first mask) for the timings."""
    from nbest_asr_tpu_torch.ops.philox import keep_mask, site

    b, s, _ = x.shape
    n = b * s
    x2 = x.reshape(n, H)
    tag = f"n {n}"
    d1, d2 = site(seed, DROPOUT, 1), site(seed, DROPOUT, 2)
    da, dh = site(seed, DROPOUT, 3), site(seed, DROPOUT, 4)
    (w1q, w1r, w1s), (w2q, w2r, w2s) = q8["w1"], q8["w2"]
    (aq, ar, a_s), (oq, orr, o_s) = q8["wqkv"], q8["wo"]
    k1 = keep_mask(seed, 1, 0, n, INTER, DROPOUT, x.device)
    k4 = keep_mask(seed, 4, 0, n, H, DROPOUT, x.device)

    def quant(name, kernel, got, want):
        torch.cuda.synchronize()
        check.exact(f"{kernel} {name} q {tag}", kernel, got[0], want[0])
        check.exact(f"{kernel} {name} scale {tag}", kernel, got[1], want[1])
        return got

    # FFN forward and int8 backward
    xq = quant("x", "quantize_rows", K.quantize_rows(x2),
               K.quantize_rows_reference(x2))
    h, gd = K.gemm_i8_bias_act(*xq, w1q, w1s, p["b1"], "gelu", drop=d1,
                               save_h=True)
    torch.cuda.synchronize()
    rh, rgd = K.gemm_i8_bias_act_reference(*xq, w1q, w1s, p["b1"], "gelu",
                                           torch.bfloat16, d1, True)
    check.exact(f"train gemm_i8_bias_act h {tag}", "gemm_i8_bias_act", h, rh)
    check.exact(f"train gemm_i8_bias_act gd = drop1(gelu(h)) {tag}",
                "gemm_i8_bias_act", gd, rgd, bf16_ulps=1)
    if not bool((gd[~k1] == 0).all()):
        raise AssertionError("gemm_i8_bias_act: a dropped element survived")
    gq = quant("gd", "quantize_rows", K.quantize_rows(gd),
               K.quantize_rows_reference(gd))
    sres, y2d = K.gemm_i8_bias_residual(*gq, w2q, w2s, p["b2"], x2, drop=d2,
                                        save_y2d=True)
    torch.cuda.synchronize()
    rs, ry2d = K.gemm_i8_bias_residual_reference(*gq, w2q, w2s, p["b2"], x2,
                                                 d2, True)
    check.exact(f"train gemm_i8_bias_residual sum {tag}",
                "gemm_i8_bias_residual", sres, rs)
    check.exact(f"train gemm_i8_bias_residual y2d {tag}",
                "gemm_i8_bias_residual", y2d, ry2d)
    _, mean, rstd = K.layer_norm_rows(sres, p["ls"], p["lb"], 1e-12,
                                      stats=True)
    _, _, ds = K.ffn_bwd_rows(x2, y2d, dy2, p["ls"], mean, rstd, drop=d2)
    g1 = quant("drop2(ds) * w2 scale", "quantize_grad_rows",
               K.quantize_grad_rows(ds, w2s, d2),
               K.quantize_grad_rows_reference(ds, w2s, d2))
    dhb, dh32, gd_b = K.gemm_i8_dgrad(*g1, w2r, "dgelu", h=h, drop=d1)
    torch.cuda.synchronize()
    rdh, rdh32, _ = K.gemm_i8_dgrad_reference(*g1, w2r, "dgelu", h=h,
                                              drop=d1)
    check.exact(f"gemm_i8_dgrad dgelu dh {tag}", "gemm_i8_dgrad", dhb, rdh,
                bf16_ulps=1)
    check.rel(f"gemm_i8_dgrad dgelu f32 dh {tag}", "gemm_i8_dgrad", dh32,
              rdh32, 1e-6)
    check.exact(f"gemm_i8_dgrad regenerated gd == forward gd {tag}",
                "gemm_i8_dgrad", gd_b, gd)
    g2 = quant("dh * w1 scale", "quantize_grad_rows",
               K.quantize_grad_rows(dh32, w1s),
               K.quantize_grad_rows_reference(dh32, w1s))
    dx = K.gemm_i8_dgrad(*g2, w1r, "residual", ds=ds)
    torch.cuda.synchronize()
    check.exact(f"gemm_i8_dgrad residual dx {tag}", "gemm_i8_dgrad", dx,
                K.gemm_i8_dgrad_reference(*g2, w1r, "residual", ds=ds))
    out = dict(xq=xq, h=h, gd=gd, gq=gq, ds_f=ds, g1=g1, dh32=dh32, g2=g2,
               d1=d1, d2=d2)
    # attention forward and int8 backward, per mask
    qkv = K.gemm_i8_bias_act(*xq, aq, a_s, p["bqkv"])
    torch.cuda.synchronize()
    check.exact(f"train gemm_i8_bias_act qkv {tag}", "gemm_i8_bias_act", qkv,
                K.gemm_i8_bias_act_reference(*xq, aq, a_s, p["bqkv"]))
    for mname, m in mask_list:
        mtag = f"{tag} {mname}"
        ctx, st = K.seg_attention(qkv, m, NH, drop=da, stats=True)
        cq = quant(f"ctx {mname}", "quantize_rows", K.quantize_rows(ctx),
                   K.quantize_rows_reference(ctx))
        sres, od = K.gemm_i8_bias_residual(*cq, oq, o_s, p["bo"], x2,
                                           drop=dh, save_y2d=True)
        torch.cuda.synchronize()
        rs, rod = K.gemm_i8_bias_residual_reference(*cq, oq, o_s, p["bo"],
                                                    x2, dh, True)
        check.exact(f"train gemm_i8_bias_residual out-proj sum {mtag}",
                    "gemm_i8_bias_residual", sres, rs)
        check.exact(f"train gemm_i8_bias_residual od {mtag}",
                    "gemm_i8_bias_residual", od, rod)
        _, mean, rstd = K.layer_norm_rows(sres, p["ls"], p["lb"], 1e-12,
                                          stats=True)
        _, _, ds = K.ffn_bwd_rows(x2, od, dy2, p["ls"], mean, rstd, drop=dh)
        g3 = quant(f"drop_h(ds) * wo scale {mname}", "quantize_grad_rows",
                   K.quantize_grad_rows(ds, o_s, dh),
                   K.quantize_grad_rows_reference(ds, o_s, dh))
        if not bool((g3[0][~k4] == 0).all()):
            raise AssertionError("quantize_grad_rows: a dropped element "
                                 "survived")
        dctx = K.gemm_i8_dgrad(*g3, orr, "none")
        torch.cuda.synchronize()
        check.exact(f"gemm_i8_dgrad none dctx {mtag}", "gemm_i8_dgrad", dctx,
                    K.gemm_i8_dgrad_reference(*g3, orr, "none"))
        dqkv = K.seg_attention_bwd(qkv, dctx, m, st, NH, drop=da)
        g4 = quant(f"dqkv * wqkv scale {mname}", "quantize_grad_rows",
                   K.quantize_grad_rows(dqkv, a_s),
                   K.quantize_grad_rows_reference(dqkv, a_s))
        dxa = K.gemm_i8_dgrad(*g4, ar, "residual", ds=ds)
        torch.cuda.synchronize()
        check.exact(f"gemm_i8_dgrad residual dx {mtag}", "gemm_i8_dgrad",
                    dxa, K.gemm_i8_dgrad_reference(*g4, ar, "residual",
                                                   ds=ds))
        if "ctx" not in out:
            out.update(ctx=ctx, cq=cq, ds_a=ds, g3=g3, dqkv=dqkv, g4=g4,
                       dh_site=dh)
    return out


def check_wide_heads(K, dev, check):
    """The attention kernels' d = 192 and 256 instances (head dims JAX
    sends to its megakernels, e.g. hidden 384 with 2 heads) against their
    plain versions: forward with prob dropout and statistics, and the
    backward."""
    from nbest_asr_tpu_torch.ops.philox import site

    gen = torch.Generator().manual_seed(8)
    b, s, nh = 8, 160, 2
    for d in (192, 256):
        h = nh * d
        qkv = (torch.randn(b * s, 3 * h, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        dctx = (torch.randn(b * s, h, generator=gen) * 0.1).to(
            dev, torch.bfloat16)
        mask = masks(b, s, gen, dev)[1]
        drop = site(99, DROPOUT, 3)
        ctx, st = K.seg_attention(qkv, mask, nh, drop=drop, stats=True)
        dqkv = K.seg_attention_bwd(qkv, dctx, mask, st, nh, drop=drop)
        torch.cuda.synchronize()
        rctx, rst = K.seg_attention_reference(qkv, mask, nh, drop, True)
        check(f"seg_attention d {d}", "seg_attention", ctx, rctx, False)
        check.rel(f"seg_attention d {d} row sum", "seg_attention", st[1],
                  rst[1], 1e-5)
        rdqkv = K.seg_attention_bwd_reference(qkv, dctx, mask, st, nh, drop)
        for i, part in enumerate("qkv"):
            cols = slice(i * h, (i + 1) * h)
            check.sums(f"seg_attention_bwd d {d} d{part}",
                       "seg_attention_bwd", dqkv[:, cols], rdqkv[:, cols])


def block_grads(fn, names, x, p, dy, f32: bool, *extra, **kw):
    """Output and gradients of a block ``fn`` over x and the weights
    ``names`` of ``p`` (f32 copies with ``f32``); ``extra`` and ``kw``
    are passed on."""
    args = [(a.float() if f32 else a).clone().requires_grad_(True)
            for a in [x] + [p[k] for k in names]]
    y = fn(*args, *extra, seed=77, **kw)
    y.backward(dy.float() if f32 else dy)
    return [y.detach()] + [a.grad for a in args]


FFN_NAMES = ("w1", "b1", "w2", "b2", "ls", "lb")
ATTN_NAMES = ("wqkv", "bqkv", "wo", "bo", "ls", "lb")
FFN_KW = dict(dropout_rate=DROPOUT)
ATTN_KW = dict(n_heads=NH, attn_dropout=DROPOUT, hidden_dropout=DROPOUT)


def hold_block(name, got, want, grads):
    """A block's output and gradients against autograd through the plain
    block in f32: max within 2% of the tensor's largest value, mean within
    1% of its mean magnitude."""
    for g_name, g, w in zip(("y",) + grads, got, want):
        d = (g.float() - w).abs()
        mx, mean = d.max().item(), d.mean().item()
        lim_mx = 2e-2 * w.abs().max().item()
        lim_mean = 1e-2 * w.abs().mean().item()
        ok = mx <= lim_mx and mean <= lim_mean
        log(f"  {'ok ' if ok else 'BAD'} {name} train {g_name}: max "
            f"{mx:.3e} (<= {lim_mx:.3e}) mean {mean:.3e} (<= "
            f"{lim_mean:.3e})")
        if not ok:
            raise AssertionError(f"{name} {g_name}: kernels disagree with "
                                 "autograd through the plain block")


def train_layer_bounds(M: int, b: int, s: int):
    """Per training layer at M = b * s rows: the bound of each training
    kernel's launches in both blocks (bytes: each input read once, each
    output written once; operations from the shapes)."""
    i, h3, d = INTER, 3 * H, H // NH
    stats = 2 * b * NH * s * 4
    ln = bound(8.0 * M * H, M * H * 4 + 2 * H * 4 + M * H * 2 + M * 8,
               "f32")
    rows = bound(16.0 * M * H, 3 * M * H * 2 + H * 4 + M * 8
                 + 2 * M * H * 2 + M * H * 4, "f32")
    res = H * 4 + M * H * 2 + M * H * 4 + M * H * 2
    return {
        "gemm_bias_act": bound_sum([
            gemm_bound(M, i, H, i * 4 + 2 * M * i * 2),
            gemm_bound(M, h3, H, h3 * 4 + M * h3 * 2)]),
        "gemm_bias_residual": bound_sum([gemm_bound(M, H, i, res),
                                         gemm_bound(M, H, H, res)]),
        "layer_norm": bound_sum([ln, ln]),
        "ffn_bwd_rows": bound_sum([rows, rows]),
        "gemm_dgrad": bound_sum([
            gemm_bound(M, i, H, 3 * M * i * 2),
            gemm_bound(M, H, i, M * H * 4 + M * H * 2),
            gemm_bound(M, H, H, M * H * 2),
            gemm_bound(M, H, h3, M * H * 4 + M * H * 2)]),
        "seg_attention": bound(4.0 * b * NH * s * s * d,
                               M * h3 * 2 + b * s * 4 + M * H * 2 + stats,
                               "bf16"),
        # QK^T, dO V^T, dV, dQ, dK: five s x s x d products a head
        "seg_attention_bwd": bound(10.0 * b * NH * s * s * d,
                                   M * h3 * 2 + M * H * 2 + b * s * 4
                                   + stats + M * h3 * 2, "bf16"),
    }


def train_int8_layer_bounds(M: int):
    """Per int8 training layer at M rows (route 2: int8 forwards and
    backwards): each new kernel's bound over all its launches in both
    blocks, from the shapes."""
    i, h3 = INTER, 3 * H
    quant = [bound(3.0 * M * k, M * k * w + M * k + M * 4, "f32")
             for k, w in ((H, 2), (H, 2), (H, 2), (i, 2))]
    gquant = [bound(5.0 * M * k, M * k * w + k * 4 + M * k + M * 4, "f32")
              for k, w in ((H, 4), (i, 4), (H, 4), (h3, 2))]

    def gb(m, n, k, extra):
        return gemm_bound(m, n, k, extra, "s8")

    return {
        "quantize_rows [train]": bound_sum(quant),
        "quantize_grad_rows": bound_sum(gquant),
        "gemm_i8_bias_act [train]": bound_sum([
            gb(M, i, H, M * 4 + i * 8 + 2 * M * i * 2),
            gb(M, h3, H, M * 4 + h3 * 8 + M * h3 * 2)]),
        "gemm_i8_bias_residual [train]": bound_sum([
            gb(M, H, i, M * 4 + H * 8 + M * H * 8),
            gb(M, H, H, M * 4 + H * 8 + M * H * 8)]),
        "gemm_i8_dgrad": bound_sum([
            gb(M, i, H, M * 4 + M * i * 10),
            gb(M, H, i, M * 4 + M * H * 6),
            gb(M, H, H, M * 4 + M * H * 2),
            gb(M, H, h3, M * 4 + M * H * 6)]),
    }


def attention_library_calls(a, b, s):
    """F.scaled_dot_product_attention with the boolean segment mask and
    prob dropout: forward (seg_attention's yardstick), forward + backward,
    and the backward alone (seg_attention_bwd's: autograd.grad over a
    retained forward); timed, used nowhere in the port."""
    F = torch.nn.functional
    d = H // NH
    q, k, v = a["qkv"].view(b, s, 3, NH, d).permute(2, 0, 3, 1, 4)
    m = a["mask"]
    same = m[:, None, :, None] == m[:, None, None, :]
    go = a["dctx"].view(b, s, NH, d).transpose(1, 2)

    def fwd_bwd():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        F.scaled_dot_product_attention(qq, kk, vv, attn_mask=same,
                                       dropout_p=DROPOUT).backward(go)

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=same,
                                         dropout_p=DROPOUT)

    def bwd():
        torch.autograd.grad(out, leaves, go, retain_graph=True)

    return (lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=same, dropout_p=DROPOUT)), fwd_bwd, bwd


def phase_train_kernels(dev, card: str):
    """Training kernels against their plain versions; per training layer
    kernel / plain / library ms at 8192 rows, and each block's forward +
    backward at every bucket's micro shape."""
    from nbest_asr_tpu_torch.ops import kernels as K
    from nbest_asr_tpu_torch.ops.fused_attention import (
        fused_attention_block, fused_attention_block_reference)
    from nbest_asr_tpu_torch.ops.fused_ffn import (
        fused_ffn_block, fused_ffn_block_int8_train,
        fused_ffn_block_int8_train_reference, fused_ffn_block_reference)
    from nbest_asr_tpu_torch.ops.fused_attention import (
        fused_attention_block_int8_train,
        fused_attention_block_int8_train_reference)
    from nbest_asr_tpu_torch.ops.quant import quantize_train_weight

    F = torch.nn.functional
    p, rn = train_weights(dev, 2)
    q8 = train_int8_weights(p)
    gen = torch.Generator().manual_seed(6)
    check = Checker()
    times = {}
    log("[train-kernels] the backward's prob mask, one-hot probe")
    check_prob_mask_probe(K, dev)
    log("[train-kernels] attention kernels at head dims 192 and 256")
    check_wide_heads(K, dev, check)
    log("[train-kernels] the attention backward at every bucket's micro")
    check_attn_bwd_buckets(K, dev, gen, check, card)
    bounds = train_layer_bounds(8192, 32, 256)
    bounds.update(train_int8_layer_bounds(8192))
    for b, s in ((3, 20), (80, 96), (32, 256)):
        n = b * s
        log(f"[train-kernels] n {n} rows ({b} x {s}), dropout {DROPOUT}")
        x, dy = rn(b, s, H), rn(b, s, H)
        x2, dy2 = x.reshape(n, H), dy.reshape(n, H)
        pad, packed = masks(b, s, gen, dev)
        o = check_ffn_train_chain(K, p, x2, dy2, seed=1000 + n, check=check)
        a = check_attn_train_chain(K, p, x, (("padded", pad),
                                             ("packed", packed)),
                                   dy2, seed=2000 + n, check=check)
        log(f"[train-kernels] int8 training chains, n {n}")
        q = check_int8_train_chain(K, p, q8, x, (("padded", pad),
                                                 ("packed", packed)),
                                   dy2, seed=3000 + n, check=check)
        if n != 8192:
            continue
        # each int8 block, both backwards, forward and all gradients,
        # against the same Function on the kernels' plain versions
        for int8_bwd in (False, True):
            route = "int8 bwd" if int8_bwd else "bf16 bwd"
            hold_block(f"int8 ffn block ({route})", *(
                block_grads(fn, FFN_NAMES, x2, p, dy2, False,
                            int8_bwd=int8_bwd, **FFN_KW)
                for fn in (fused_ffn_block_int8_train,
                           fused_ffn_block_int8_train_reference)),
                ("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"))
            for mname, m in (("padded", pad), ("packed", packed)):
                hold_block(f"int8 attention block ({route}) {mname}", *(
                    block_grads(fn, ATTN_NAMES, x, p, dy, False, m,
                                int8_bwd=int8_bwd, **ATTN_KW)
                    for fn in (fused_attention_block_int8_train,
                               fused_attention_block_int8_train_reference)),
                    ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dls", "dlb"))
        (w1q, w1r, w1s), (w2q, w2r, w2s) = q8["w1"], q8["w2"]
        (aq, ar, a_s), (oq, orr, o_s) = q8["wqkv"], q8["wo"]
        # per int8 training layer (route 2): every launch of each new
        # kernel or epilogue in both blocks; library: torch._int_mm (the
        # integer product alone)
        ti8 = {
            "quantize_rows [train]": (
                lambda: [K.quantize_rows(t) for t in (x2, q["ctx"], x2,
                                                      q["gd"])],
                lambda: [K.quantize_rows_reference(t)
                         for t in (x2, q["ctx"], x2, q["gd"])], None),
            "quantize_grad_rows": (
                lambda: (K.quantize_grad_rows(q["ds_f"], w2s, q["d2"]),
                         K.quantize_grad_rows(q["dh32"], w1s),
                         K.quantize_grad_rows(q["ds_a"], o_s, q["dh_site"]),
                         K.quantize_grad_rows(q["dqkv"], a_s)),
                lambda: (K.quantize_grad_rows_reference(q["ds_f"], w2s,
                                                        q["d2"]),
                         K.quantize_grad_rows_reference(q["dh32"], w1s),
                         K.quantize_grad_rows_reference(q["ds_a"], o_s,
                                                        q["dh_site"]),
                         K.quantize_grad_rows_reference(q["dqkv"], a_s)),
                None),
            "gemm_i8_bias_act [train]": (
                lambda: (K.gemm_i8_bias_act(*q["xq"], w1q, w1s, p["b1"],
                                            "gelu", drop=q["d1"],
                                            save_h=True),
                         K.gemm_i8_bias_act(*q["xq"], aq, a_s, p["bqkv"])),
                lambda: (K.gemm_i8_bias_act_reference(
                    *q["xq"], w1q, w1s, p["b1"], "gelu", torch.bfloat16,
                    q["d1"], True),
                         K.gemm_i8_bias_act_reference(*q["xq"], aq, a_s,
                                                      p["bqkv"])),
                lambda: (torch._int_mm(q["xq"][0], w1q),
                         torch._int_mm(q["xq"][0], aq))),
            "gemm_i8_bias_residual [train]": (
                lambda: (K.gemm_i8_bias_residual(*q["gq"], w2q, w2s, p["b2"],
                                                 x2, drop=q["d2"],
                                                 save_y2d=True),
                         K.gemm_i8_bias_residual(*q["cq"], oq, o_s, p["bo"],
                                                 x2, drop=q["dh_site"],
                                                 save_y2d=True)),
                lambda: (K.gemm_i8_bias_residual_reference(
                    *q["gq"], w2q, w2s, p["b2"], x2, q["d2"], True),
                         K.gemm_i8_bias_residual_reference(
                             *q["cq"], oq, o_s, p["bo"], x2, q["dh_site"],
                             True)),
                lambda: (torch._int_mm(q["gq"][0], w2q),
                         torch._int_mm(q["cq"][0], oq))),
            "gemm_i8_dgrad": (
                lambda: (K.gemm_i8_dgrad(*q["g1"], w2r, "dgelu", h=q["h"],
                                         drop=q["d1"]),
                         K.gemm_i8_dgrad(*q["g2"], w1r, "residual",
                                         ds=q["ds_f"]),
                         K.gemm_i8_dgrad(*q["g3"], orr, "none"),
                         K.gemm_i8_dgrad(*q["g4"], ar, "residual",
                                         ds=q["ds_a"])),
                lambda: (K.gemm_i8_dgrad_reference(*q["g1"], w2r, "dgelu",
                                                   h=q["h"], drop=q["d1"]),
                         K.gemm_i8_dgrad_reference(*q["g2"], w1r, "residual",
                                                   ds=q["ds_f"]),
                         K.gemm_i8_dgrad_reference(*q["g3"], orr, "none"),
                         K.gemm_i8_dgrad_reference(*q["g4"], ar, "residual",
                                                   ds=q["ds_a"])),
                # the weights as w.t() views (column-major B): cuBLASLt's
                # int8 layout, 4.8x faster than a row-major copy made
                # beforehand (chip_time_attention.py's train_i8_ms)
                lambda: (torch._int_mm(q["g1"][0], w2r.t()),
                         torch._int_mm(q["g2"][0], w1r.t()),
                         torch._int_mm(q["g3"][0], orr.t()),
                         torch._int_mm(q["g4"][0], ar.t()))),
        }
        i8_ops = {"gemm_i8_bias_act [train]": 2.0 * 8192 * H * (INTER
                                                                + 3 * H),
                  "gemm_i8_bias_residual [train]": 2.0 * 8192 * H * (INTER
                                                                     + H),
                  "gemm_i8_dgrad": 2.0 * 8192 * H * (2 * INTER + 4 * H)}
        for name, (fk, fp, fl) in ti8.items():
            k_ms, l_ms = time_device(f"train {name}", "n 8192", fk, fl,
                                     i8_ops.get(name), bounds[name][0],
                                     card)
            times[name] = (k_ms, cuda_ms(fp, iters=3), l_ms)
        times["weight quantization"] = cuda_ms(
            lambda: [quantize_train_weight(p[k]) for k in ("wqkv", "wo",
                                                           "w1", "w2")])
        # each whole block, forward and all gradients, against torch
        # autograd through the plain block on f32 copies, same masks
        hold_block("ffn block", *(
            block_grads(fn, FFN_NAMES, x2, p, dy2, f32, **FFN_KW)
            for fn, f32 in ((fused_ffn_block, False),
                            (fused_ffn_block_reference, True))),
            ("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"))
        for mname, m in (("padded", pad), ("packed", packed)):
            hold_block(f"attention block {mname}", *(
                block_grads(fn, ATTN_NAMES, x, p, dy, f32, m, **ATTN_KW)
                for fn, f32 in ((fused_attention_block, False),
                                (fused_attention_block_reference, True))),
                ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dls", "dlb"))
        bfb = {k: p[k].to(torch.bfloat16) for k in ("b1", "b2", "bqkv", "bo")}
        sdpa_fwd, sdpa_fwd_bwd, sdpa_bwd = attention_library_calls(a, b, s)
        # per training layer: every launch of the kernel in both blocks
        t = {
            "gemm_bias_act": (
                lambda: (K.gemm_bias_act(x2, p["w1"], p["b1"], "gelu",
                                         drop=o["d1"], save_h=True),
                         K.gemm_bias_act(x2, p["wqkv"], p["bqkv"])),
                lambda: (K.gemm_bias_act_reference(x2, p["w1"], p["b1"],
                                                   "gelu", o["d1"], True),
                         K.gemm_bias_act_reference(x2, p["wqkv"],
                                                   p["bqkv"])),
                lambda: (torch.addmm(bfb["b1"], x2, p["w1"]),
                         torch.addmm(bfb["bqkv"], x2, p["wqkv"]))),
            "gemm_bias_residual": (
                lambda: (K.gemm_bias_residual(o["gd"], p["w2"], p["b2"], x2,
                                              drop=o["d2"], save_y2d=True),
                         K.gemm_bias_residual(a["ctx"], p["wo"], p["bo"], x2,
                                              drop=a["dh"], save_y2d=True)),
                lambda: (K.gemm_bias_residual_reference(
                    o["gd"], p["w2"], p["b2"], x2, o["d2"], True),
                         K.gemm_bias_residual_reference(
                             a["ctx"], p["wo"], p["bo"], x2, a["dh"], True)),
                lambda: (torch.addmm(bfb["b2"], o["gd"], p["w2"]),
                         torch.addmm(bfb["bo"], a["ctx"], p["wo"]))),
            "layer_norm": (
                lambda: [K.layer_norm_rows(r, p["ls"], p["lb"], 1e-12,
                                           stats=True)
                         for r in (o["s"], a["s"])],
                lambda: [K.layer_norm_reference(r, p["ls"], p["lb"], 1e-12,
                                                torch.bfloat16, True)
                         for r in (o["s"], a["s"])],
                lambda: [F.layer_norm(r, (H,), p["ls"], p["lb"], 1e-12)
                         for r in (o["s"], a["s"])]),
            "ffn_bwd_rows": (
                lambda: (K.ffn_bwd_rows(x2, o["y2d"], dy2, p["ls"],
                                        o["mean"], o["rstd"], drop=o["d2"]),
                         K.ffn_bwd_rows(x2, a["od"], dy2, p["ls"], a["mean"],
                                        a["rstd"], drop=a["dh"])),
                lambda: (K.ffn_bwd_rows_reference(
                    x2, o["y2d"], dy2, p["ls"], o["mean"], o["rstd"],
                    o["d2"]),
                         K.ffn_bwd_rows_reference(
                             x2, a["od"], dy2, p["ls"], a["mean"],
                             a["rstd"], a["dh"])),
                None),
            "gemm_dgrad": (
                lambda: (K.gemm_dgrad(o["dy2"], p["w2"], "dgelu", h=o["h"],
                                      drop=o["d1"]),
                         K.gemm_dgrad(o["dh"], p["w1"], "residual",
                                      ds=o["ds"]),
                         K.gemm_dgrad(a["dout"], p["wo"], "none"),
                         K.gemm_dgrad(a["dqkv"], p["wqkv"], "residual",
                                      ds=a["ds"])),
                lambda: (K.gemm_dgrad_reference(o["dy2"], p["w2"], "dgelu",
                                                h=o["h"], drop=o["d1"]),
                         K.gemm_dgrad_reference(o["dh"], p["w1"],
                                                "residual", ds=o["ds"]),
                         K.gemm_dgrad_reference(a["dout"], p["wo"], "none"),
                         K.gemm_dgrad_reference(a["dqkv"], p["wqkv"],
                                                "residual", ds=a["ds"])),
                lambda: (torch.matmul(o["dy2"], p["w2"].t()),
                         torch.matmul(o["dh"], p["w1"].t()),
                         torch.matmul(a["dout"], p["wo"].t()),
                         torch.matmul(a["dqkv"], p["wqkv"].t()))),
            "seg_attention": (
                lambda: K.seg_attention(a["qkv"], a["mask"], NH,
                                        drop=a["da"], stats=True),
                lambda: K.seg_attention_reference(a["qkv"], a["mask"], NH,
                                                  a["da"], True),
                sdpa_fwd),
            "seg_attention_bwd": (
                lambda: K.seg_attention_bwd(a["qkv"], a["dctx"], a["mask"],
                                            a["st"], NH, drop=a["da"]),
                lambda: K.seg_attention_bwd_reference(
                    a["qkv"], a["dctx"], a["mask"], a["st"], NH, a["da"]),
                sdpa_bwd),
        }
        flops = {"gemm_bias_act": 2.0 * 8192 * H * (INTER + 3 * H),
                 "gemm_bias_residual": 2.0 * 8192 * H * (INTER + H),
                 "gemm_dgrad": 2.0 * 8192 * H * (2 * INTER + H + 3 * H),
                 "seg_attention": None}
        for name, (fk, fp, fl) in t.items():
            if name in DEVICE_TIMED:
                k_ms, l_ms = time_device(f"train {name}", "n 8192", fk, fl,
                                         flops.get(name), bounds[name][0],
                                         card)
            else:
                k_ms = cuda_ms(fk)
                l_ms = None if fl is None else cuda_ms(fl)
            times[name] = (k_ms, cuda_ms(fp, iters=3), l_ms)
        log(f"  time train SDPA forward + backward n 8192 (beside "
            f"seg_attention_bwd's backward alone): {device_ms(sdpa_fwd_bwd):.4f}"
            f" ms device [{card}]")
    wq_ms = times.pop("weight quantization")
    log(f"  time train weight quantization (4 weights of a layer, q in both "
        f"layouts): {wq_ms:.4f} ms per layer [{card}]")
    for name, (k_ms, p_ms, l_ms) in times.items():
        lib_s = "" if l_ms is None else f", library {l_ms:.4f} ms"
        log(f"  time train {name:<18} n 8192: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms{lib_s}, bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}) [{card}]")
    # each block's forward + backward per layer at each bucket's micro
    for s, b in TRAIN_MICRO.items():
        x, dyb = rn(b, s, H), rn(b, s, H)
        m = masks(b, s, gen, dev)[0]
        blocks = {
            "ffn_block_train": (
                lambda fn: block_grads(fn, FFN_NAMES, x, p, dyb, False,
                                       **FFN_KW),
                fused_ffn_block, fused_ffn_block_reference),
            "attn_block_train": (
                lambda fn: block_grads(fn, ATTN_NAMES, x, p, dyb, False, m,
                                       **ATTN_KW),
                fused_attention_block, fused_attention_block_reference)}
        for int8_bwd in (False, True):
            tag = "i8b" if int8_bwd else "i8"
            blocks[f"ffn_block_train_{tag}"] = (
                lambda fn, ib=int8_bwd: block_grads(
                    fn, FFN_NAMES, x, p, dyb, False, int8_bwd=ib, **FFN_KW),
                fused_ffn_block_int8_train,
                fused_ffn_block_int8_train_reference)
            blocks[f"attn_block_train_{tag}"] = (
                lambda fn, ib=int8_bwd: block_grads(
                    fn, ATTN_NAMES, x, p, dyb, False, m, int8_bwd=ib,
                    **ATTN_KW),
                fused_attention_block_int8_train,
                fused_attention_block_int8_train_reference)
        for key, (run, fk, fp) in blocks.items():
            times[(key, s)] = (cuda_ms(lambda: run(fk)),
                               cuda_ms(lambda: run(fp), iters=3))
        log(f"  time train block fwd+bwd b{b} s{s}, kernels (plain): " +
            "; ".join(f"{key} {times[(key, s)][0]:.4f} ms "
                      f"({times[(key, s)][1]:.4f})" for key in blocks) +
            f" [{card}]")
    times["weight_quant_ms"] = wq_ms
    return check.max_err, times, bounds


# --------------------------------------------------------------------- #
# the flash route: single-block and tiled kernels
# --------------------------------------------------------------------- #

def flash_operands(gen, dev, b, s, nh, d, views: bool):
    """q, k, v (b, s, nh, d) bf16 -- split views of one (b*s, 3 nh d)
    buffer, as the encoder passes them, or standalone tensors -- and dO."""
    def rn(*shape, std):
        return (torch.randn(*shape, generator=gen) * std).to(dev,
                                                             torch.bfloat16)

    if views:
        q, k, v = rn(b * s, 3 * nh * d, std=0.5).view(b, s, 3, nh,
                                                       d).unbind(2)
    else:
        q, k, v = (rn(b, s, nh, d, std=0.5) for _ in range(3))
    return q, k, v, rn(b, s, nh, d, std=0.1)


def flash_bounds(b: int, s: int, nh: int, d: int):
    """Each tiled kernel's bound at (b, s, nh, d): its inputs read once
    and outputs written once (bf16 operands, f32 mask, lse and di), and
    the tensor-core products it does on them: QK^T and PV in the forward;
    QK^T, dO V^T and dS K in the dQ kernel; K Q^T, V dO^T, dV and dK in
    the dK/dV kernel (2 b nh s^2 d operations each)."""
    x, st, m = b * s * nh * d * 2, b * nh * s * 4, b * s * 4
    prod = 2.0 * b * nh * s * s * d
    return {"flash_fwd": bound(2 * prod, 3 * x + m + x + st, "bf16"),
            "flash_bwd_dq": bound(3 * prod, 5 * x + m + st + x + st,
                                  "bf16"),
            "flash_bwd_dkv": bound(4 * prod, 4 * x + m + 2 * st + 2 * x,
                                   "bf16")}


def flash_library_calls(q, k, v, do, mask):
    """F.scaled_dot_product_attention with the boolean segment mask and
    prob dropout on the same (b, s, nh, d) operands: forward (flash_fwd's
    yardstick), forward + backward, and the backward alone (the backward
    kernels' yardstick: autograd.grad over a retained forward, as
    attention_library_calls); timed, used nowhere in the port."""
    F = torch.nn.functional
    same = mask[:, None, :, None] == mask[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    go = do.transpose(1, 2)

    def fwd_bwd():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        F.scaled_dot_product_attention(qq, kk, vv, attn_mask=same,
                                       dropout_p=DROPOUT).backward(go)

    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=same,
                                         dropout_p=DROPOUT)

    def bwd():
        torch.autograd.grad(out, leaves, go, retain_graph=True)

    return (lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=same, dropout_p=DROPOUT)), fwd_bwd, bwd


def check_flash_mask_shared(dev):
    """At s = 256 the tiled kernels (forced by a block size) draw the
    single-block kernels' prob mask: with four packed segments of 64 and
    one-hot v within a segment (v[k] = e_{k mod 64}), o[q, c] is the
    dropped prob of key 64 seg(q) + c, so o != 0 must equal the stream-3
    keep bits on the diagonal blocks on both routes; with random operands
    the routes' outputs and gradients agree within the kernels'
    tolerance.  Returns the max differences."""
    from nbest_asr_tpu_torch.ops.flash_attention import flash_attention
    from nbest_asr_tpu_torch.ops.philox import keep_mask

    b, s, d, seed = 32, 256, H // NH, 2468
    gen = torch.Generator().manual_seed(12)
    mask = (torch.arange(s, device=dev) // 64 + 1).float()[None].repeat(b,
                                                                       1)
    keep = keep_mask(seed, 3, 0, b * NH * s, s, DROPOUT, dev).reshape(
        b, NH, s, s)
    seg = torch.arange(s, device=dev) // 64
    cols = seg[:, None] * 64 + torch.arange(64, device=dev)[None]
    want = torch.gather(keep, 3, cols[None, None].expand(b, NH, s, 64))
    q, k, _, do = flash_operands(gen, dev, b, s, NH, d, True)
    eye = torch.eye(64, device=dev, dtype=torch.bfloat16)
    v1 = eye.repeat(4, 1)[None, :, None, :].expand(b, s, NH, d).contiguous()
    for route, kw in (("single-block", {}),
                      ("tiled", dict(block_q=128, block_k=128))):
        o = flash_attention(q, k, v1, mask, dropout_rate=DROPOUT, seed=seed,
                            **kw)
        torch.cuda.synchronize()
        n_diff = int(((o.permute(0, 2, 1, 3) != 0) != want).sum())
        log(f"  {'ok ' if n_diff == 0 else 'BAD'} flash {route} route, s "
            f"{s}: dropped probs vs the stream-3 keep bits: {n_diff} of "
            f"{want.numel()} differ")
        if n_diff:
            raise AssertionError(f"the {route} flash route does not draw "
                                 "the stream-3 prob mask")
    q, k, v, do = flash_operands(gen, dev, b, s, NH, d, True)
    outs = []
    for kw in ({}, dict(block_q=128, block_k=128)):
        qq, kk, vv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        o = flash_attention(qq, kk, vv, mask, dropout_rate=DROPOUT,
                            seed=seed, **kw)
        o.backward(do)
        outs.append((o.detach(), qq.grad, kk.grad, vv.grad))
    torch.cuda.synchronize()
    for name, a, w in zip(("o", "dq", "dk", "dv"), *outs):
        dmax = (a.float() - w.float()).abs().max().item()
        lim = 2.0 ** -6 * w.float().abs().max().item()
        ok = dmax <= lim
        log(f"  {'ok ' if ok else 'BAD'} flash tiled vs single-block {name}"
            f", s {s}, same seed: max {dmax:.3e} (<= {lim:.3e})")
        if not ok:
            raise AssertionError(f"flash routes disagree on {name}")


def phase_flash_kernels(dev, card: str):
    """The flash route's kernels against their plain versions at the
    shapes the training routes give them: the widened single-block pair
    on (b, s, heads, d) operands (QKV views at d = 64, standalone tensors
    at d = 32 and 128), the tiled kernels at 32 x 1024 and 8 x 2048, d =
    64 and 128, padded and packed masks, dropout 0 and 0.1; the forced
    tiled route against the single-block one; per-kernel kernel / plain /
    library / bound ms at 32 x 1024 (route B's layer), and flash attention
    forward + backward against the plain attention at every training
    shape.  Returns (max errors, times, bounds)."""
    from nbest_asr_tpu_torch.ops import kernels as K
    from nbest_asr_tpu_torch.ops.attention import multi_head_attention
    from nbest_asr_tpu_torch.ops.flash_attention import flash_attention
    from nbest_asr_tpu_torch.ops.philox import generator, site

    gen = torch.Generator().manual_seed(11)
    check = Checker()
    times = {}
    log("[flash-kernels] single-block kernels on (b, s, heads, d) operands")
    for b, s, nh, d, views in FLASH_SB_SHAPES:
        q, k, v, do = flash_operands(gen, dev, b, s, nh, d, views)
        sc = 1.0 / d ** 0.5
        for mname, m in zip(("padded", "packed"), masks(b, s, gen, dev)):
            for rate in (0.0, DROPOUT):
                tag = f"{b} x {s} d {d} {mname} rate {rate}"
                drop = site(100 + s, rate, 3)
                o, st = K.sb_attention(q, k, v, m, sc, drop, True)
                grads = K.sb_attention_bwd(q, k, v, do, m, st, sc, drop)
                torch.cuda.synchronize()
                ro, rst = K.sb_attention_reference(q, k, v, m, sc, drop,
                                                   True)
                check(f"flash sb o {tag}", "seg_attention", o, ro, False)
                check.rel(f"flash sb row sum {tag}", "seg_attention", st[1],
                          rst[1], 1e-5)
                for part, g, r in zip("qkv", grads,
                                      K.sb_attention_bwd_reference(
                                          q, k, v, do, m, st, sc, drop)):
                    check.sums(f"flash sb d{part} {tag}",
                               "seg_attention_bwd", g, r)
    log("[flash-kernels] tiled kernels")
    for b, s, nh, d in FLASH_TILED_SHAPES:
        q, k, v, do = flash_operands(gen, dev, b, s, nh, d, True)
        sc = 1.0 / d ** 0.5
        for mname, m in zip(("padded", "packed"), masks(b, s, gen, dev)):
            for rate in (0.0, DROPOUT):
                tag = f"{b} x {s} d {d} {mname} rate {rate}"
                drop = site(200 + s, rate, 3)
                n0 = K.flash_wgmma_launches()
                o, lse = K.flash_fwd(q, k, v, m, sc, drop)
                dq, di = K.flash_bwd_dq(q, k, v, m, o, lse, do, sc, drop)
                dk, dv = K.flash_bwd_dkv(q, k, v, m, lse, di, do, sc, drop)
                torch.cuda.synchronize()
                n1 = K.flash_wgmma_launches()
                if any(n1[n] - n0[n] != int(d == 64) for n in n1):
                    raise AssertionError(
                        f"flash kernels {tag}: wgmma launches {n0} -> {n1}"
                        "; the wgmma + TMA kernels run exactly at d = 64")
                ro, rlse = K.flash_fwd_reference(q, k, v, m, sc, drop)
                check(f"flash_fwd o {tag}", "flash_fwd", o, ro, False)
                check.rel(f"flash_fwd lse {tag}", "flash_fwd", lse, rlse,
                          1e-5)
                del ro, rlse
                rdq, rdi = K.flash_bwd_dq_reference(q, k, v, m, o, lse, do,
                                                    sc, drop)
                check.rel(f"flash_bwd_dq di {tag}", "flash_bwd_dq", di, rdi,
                          1e-4)
                check.sums(f"flash_bwd_dq dq {tag}", "flash_bwd_dq", dq,
                           rdq)
                del rdq, rdi
                for part, g, r in zip("kv", (dk, dv),
                                      K.flash_bwd_dkv_reference(
                                          q, k, v, m, lse, di, do, sc,
                                          drop)):
                    check.sums(f"flash_bwd_dkv d{part} {tag}",
                               "flash_bwd_dkv", g, r)
    log("[flash-kernels] forced tiled route against the single-block one")
    check_flash_mask_shared(dev)

    # per route-B layer (32 x 1024, d 64), padded mask, dropout 0.1
    b, s, d = LONG_BATCH, LONG_SEQ, H // NH
    q, k, v, do = flash_operands(gen, dev, b, s, NH, d, True)
    m = masks(b, s, gen, dev)[0]
    sc, drop = 1.0 / d ** 0.5, site(300, DROPOUT, 3)
    o, lse = K.flash_fwd(q, k, v, m, sc, drop)
    _, di = K.flash_bwd_dq(q, k, v, m, o, lse, do, sc, drop)
    sdpa_fwd, sdpa_fwd_bwd, sdpa_bwd = flash_library_calls(q, k, v, do, m)
    sdpa_bwd_ms = device_ms(sdpa_bwd)
    t = {"flash_fwd": (
             lambda: K.flash_fwd(q, k, v, m, sc, drop),
             lambda: K.flash_fwd_reference(q, k, v, m, sc, drop),
             device_ms(sdpa_fwd)),
         "flash_bwd_dq": (
             lambda: K.flash_bwd_dq(q, k, v, m, o, lse, do, sc, drop),
             lambda: K.flash_bwd_dq_reference(q, k, v, m, o, lse, do, sc,
                                              drop), sdpa_bwd_ms),
         "flash_bwd_dkv": (
             lambda: K.flash_bwd_dkv(q, k, v, m, lse, di, do, sc, drop),
             lambda: K.flash_bwd_dkv_reference(q, k, v, m, lse, di, do, sc,
                                               drop), sdpa_bwd_ms)}
    for name, (fk, fp, l_ms) in t.items():
        times[name] = (device_ms(fk), cuda_ms(fp, iters=1, warmup=1), l_ms)
    fwd_bwd_ms = device_ms(sdpa_fwd_bwd)
    bounds = flash_bounds(b, s, NH, d)
    for name, (k_ms, p_ms, l_ms) in times.items():
        what = "forward" if name == "flash_fwd" else "backward alone"
        log(f"  time {name:<14} {b} x {s} d {d}: kernel {k_ms:.4f} ms "
            f"device, plain {p_ms:.4f} ms, library (SDPA's {what}) "
            f"{l_ms:.4f} ms device, bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}) [{card}]")
    # the backward pair against SDPA's backward alone on the same operands,
    # and without dropout (what the Philox keep bits cost)
    pair_ms = times["flash_bwd_dq"][0] + times["flash_bwd_dkv"][0]
    o0, lse0 = K.flash_fwd(q, k, v, m, sc)
    _, di0 = K.flash_bwd_dq(q, k, v, m, o0, lse0, do, sc)
    pair0_ms = (device_ms(lambda: K.flash_bwd_dq(q, k, v, m, o0, lse0, do,
                                                 sc))
                + device_ms(lambda: K.flash_bwd_dkv(q, k, v, m, lse0, di0,
                                                    do, sc)))
    log(f"  time flash backward pair {b} x {s} d {d}, dropout {DROPOUT}: "
        f"kernels {pair_ms:.4f} ms device ({times['flash_bwd_dq'][0]:.4f} + "
        f"{times['flash_bwd_dkv'][0]:.4f}), SDPA's backward alone "
        f"{sdpa_bwd_ms:.4f} ms device ({pair_ms / sdpa_bwd_ms:.3f}x; its "
        f"forward + backward {fwd_bwd_ms:.4f}); without dropout "
        f"{pair0_ms:.4f} ms; bounds {bounds['flash_bwd_dq'][0]:.4f} + "
        f"{bounds['flash_bwd_dkv'][0]:.4f} ms [{card}]")
    del o, lse, di, o0, lse0, di0

    # flash attention forward + backward per layer (q, k, v views of the
    # QKV buffer, prob dropout) against the plain path's attention at the
    # training shapes: each bucket's micro (route A) and 32 x 1024 (B)
    for s, b in list(TRAIN_MICRO.items()) + [(LONG_SEQ, LONG_BATCH)]:
        q, k, v, do = flash_operands(gen, dev, b, s, NH, d, True)
        m = masks(b, s, gen, dev)[0]

        def run(fn):
            qq, kk, vv = (t.detach().requires_grad_(True)
                          for t in (q, k, v))
            fn(qq, kk, vv).backward(do)

        times[("flash_attn_train", s)] = (
            cuda_ms(lambda: run(lambda a, b_, c: flash_attention(
                a, b_, c, m, dropout_rate=DROPOUT, seed=7))),
            cuda_ms(lambda: run(lambda a, b_, c: multi_head_attention(
                a, b_, c, m, dropout_rate=DROPOUT, gen=generator(7, dev),
                deterministic=False)), iters=3, warmup=1))
        k_ms, p_ms = times[("flash_attn_train", s)]
        # autograd's backward of the encoder's qkv split concatenates the
        # separate dq, dk, dv into one (b, s, 3h) gradient
        g = do.reshape(b, s, H)
        cat_ms = cuda_ms(lambda: torch.cat((g, g, g), dim=-1))
        route = "tiled" if s > 512 else "single-block"
        log(f"  time flash attention fwd+bwd ({route}) {b} x {s}: kernels "
            f"{k_ms:.4f} ms, plain attention path {p_ms:.4f} ms; the qkv "
            f"split's gradient concatenation {cat_ms:.4f} ms [{card}]")
    return check.max_err, times, bounds


# --------------------------------------------------------------------- #
# route C: the plain blocks' row kernels
# --------------------------------------------------------------------- #

def rows_bounds(M: int, n_word_rows: int, n_type_rows: int, seq: int):
    """Per training layer at M rows (embed_lookup: per micro), from the
    shapes and this run's ids: each kernel's bound over its launches and
    the single launch's (bytes: inputs read once -- the embedding's word
    and type rows as many as the ids name distinct rows, its position rows
    ``seq`` --, outputs written once; bf16 activations, f32 tables)."""
    stats = M * 8
    ln = bound(10.0 * M * H, 2 * M * H * 2 + 2 * H * 4 + M * H * 2 + stats,
               "f32")
    ln_bwd = bound(14.0 * M * H, 3 * M * H * 2 + H * 4 + stats
                   + M * H * 2 + 2 * H * 4, "f32")
    gelu = bound(30.0 * M * INTER, M * INTER * 4 + INTER * 4, "f32")
    gelu_bwd = bound(40.0 * M * INTER, M * INTER * 6 + INTER * 4, "f32")
    emb = bound(10.0 * M * H, (n_word_rows + n_type_rows + seq) * H * 4
                + 2 * H * 4 + 2 * M * 4 + M * H * 4, "f32")
    single = {"residual_layer_norm": ln, "residual_layer_norm_bwd": ln_bwd,
              "bias_gelu": gelu, "bias_gelu_bwd": gelu_bwd,
              "embed_lookup": emb}
    return ({"residual_layer_norm": bound_sum([ln, ln]),
             "residual_layer_norm_bwd": bound_sum([ln_bwd, ln_bwd]),
             "bias_gelu": gelu, "bias_gelu_bwd": gelu_bwd,
             "embed_lookup": emb}, single)


def phase_rows_kernels(dev, card: str):
    """Route C's five kernels against their plain versions on the card:
    the residual LayerNorm forward and backward at 8192 x 768 and 7688 x
    1024 (31 x 248), bf16 and f32 activations; the bias-GELU forward and
    backward at 8192 x 3072 and 7688 x 4096, bf16; the embedding lookup
    at 8192 and 7688 tokens (h 768 and 1024, position offsets 0 and 2,
    with and without type ids), f32 and bf16 tables.  Tolerances: bf16
    outputs within one bf16 ulp of the plain version per element (exact
    rounding of an f32 value whose row statistics are summed in another
    order), plus 2**-16 of the tensor's largest value for elements that
    cancellation leaves near 0; f32 outputs and statistics within 1e-5 of
    the largest value; dscale and dbias within 1e-4 of theirs.  Then per training layer at
    8192 rows (BERT-base, batch 32 x seq 256): kernel / plain / library /
    bound ms, kernel and library as device time (``device_ms``).  Returns
    (max errors, times, bounds)."""
    from nbest_asr_tpu_torch.ops import kernels as K

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(17)
    check = Checker()

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    def hold(name, kernel, got, want):
        if want.dtype == torch.bfloat16:
            check.exact(name, kernel, got, want, bf16_ulps=1,
                        floor=2.0 ** -16)
        else:
            check.rel(name, kernel, got, want, 1e-5)

    for m, n in ((8192, H), (7688, 1024)):
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{m} x {n} {str(dtype)[6:]}"
            x, r, dy = rn(m, n, dtype=dtype), rn(m, n, dtype=dtype), \
                rn(m, n, dtype=dtype)
            g = 1.0 + rn(n, std=0.1, dtype=torch.float32)
            b = rn(n, std=0.1, dtype=torch.float32)
            y, mean, rstd = K.residual_layer_norm(x, r, g, b, 1e-12)
            dx, dg, db = K.residual_layer_norm_bwd(x, r, dy, g, mean, rstd)
            torch.cuda.synchronize()
            ry, rm, rr = K.residual_layer_norm_reference(x, r, g, b, 1e-12)
            hold(f"residual_layer_norm y {tag}", "residual_layer_norm", y,
                 ry)
            check.rel(f"residual_layer_norm mean {tag}",
                      "residual_layer_norm", mean, rm, 1e-5)
            check.rel(f"residual_layer_norm rstd {tag}",
                      "residual_layer_norm", rstd, rr, 1e-5)
            rdx, rdg, rdb = K.residual_layer_norm_bwd_reference(
                x, r, dy, g, mean, rstd)
            hold(f"residual_layer_norm_bwd dx {tag}",
                 "residual_layer_norm_bwd", dx, rdx)
            check.rel(f"residual_layer_norm_bwd dscale {tag}",
                      "residual_layer_norm_bwd", dg, rdg, 1e-4)
            check.rel(f"residual_layer_norm_bwd dbias {tag}",
                      "residual_layer_norm_bwd", db, rdb, 1e-4)
    # (193, 3076): N % 8 == 4, the kernels' 4-wide instance
    for m, n, dtype in ((8192, INTER, torch.bfloat16),
                        (7688, 4096, torch.bfloat16),
                        (193, 3076, torch.bfloat16),
                        (193, 3076, torch.float32)):
        tag = f"{m} x {n} {str(dtype)[6:]}"
        x, dy = rn(m, n, std=2.0, dtype=dtype), rn(m, n, dtype=dtype)
        b = rn(n, dtype=torch.float32)
        y, dx = K.bias_gelu(x, b), K.bias_gelu_bwd(x, b, dy)
        torch.cuda.synchronize()
        hold(f"bias_gelu {tag}", "bias_gelu", y, K.bias_gelu_reference(x, b))
        hold(f"bias_gelu_bwd {tag}", "bias_gelu_bwd", dx,
             K.bias_gelu_bwd_reference(x, b, dy))

    def embed_operands(m, n, seq, off, dtype):
        word = rn(VOCAB, n, std=0.05, dtype=dtype)
        pos = rn(514, n, std=0.05, dtype=dtype)[off:off + seq]
        type_ = rn(2, n, std=0.05, dtype=dtype)
        sc = 1.0 + rn(n, std=0.1, dtype=torch.float32)
        bi = rn(n, std=0.1, dtype=torch.float32)
        ids = torch.randint(0, VOCAB, (m,), generator=gen).to(dev,
                                                              torch.int32)
        tids = torch.randint(0, 2, (m,), generator=gen).to(dev, torch.int32)
        return word, pos, type_, sc, bi, ids, tids

    for m, n, seq, off in ((8192, H, 256, 0), (7688, 1024, 248, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            e = embed_operands(m, n, seq, off, dtype)
            for typed in (True, False):
                args = (*e[:6], e[6] if typed else None, seq, 1e-12)
                got = K.embed_lookup(*args)
                torch.cuda.synchronize()
                hold(f"embed_lookup {m} x {n} off {off} {str(dtype)[6:]} "
                     f"{'typed' if typed else 'type row 0'}", "embed_lookup",
                     got, K.embed_lookup_reference(*args))

    # ---- per training layer at 8192 rows (embed_lookup: per micro) ---- #
    M = 8192
    x, r, dy = rn(M, H), rn(M, H), rn(M, H)
    g, b = 1.0 + rn(H, std=0.1, dtype=torch.float32), \
        rn(H, std=0.1, dtype=torch.float32)
    _, mean, rstd = K.residual_layer_norm(x, r, g, b, 1e-12)
    h, dh = rn(M, INTER, std=2.0), rn(M, INTER)
    b1 = rn(INTER, dtype=torch.float32)
    word, pos, type_, sc, bi, ids, tids = embed_operands(M, H, 256, 0,
                                                         torch.float32)
    rows = (torch.arange(M, device=dev) % 256).to(torch.int32)
    gl, bl, b1l = g.to(torch.bfloat16), b.to(torch.bfloat16), \
        b1.to(torch.bfloat16)
    xl, rl, hl, gl, bl = (t.detach().requires_grad_(True)
                          for t in (x, r, h, gl, bl))
    y_lib = F.layer_norm(xl + rl, (H,), gl, bl, 1e-12)
    g_lib = F.gelu(hl + b1l)
    eargs = (word, pos, type_, sc, bi, ids, tids, 256, 1e-12)
    t = {
        "residual_layer_norm": (
            lambda: [K.residual_layer_norm(x, r, g, b, 1e-12)
                     for _ in range(2)],
            lambda: [K.residual_layer_norm_reference(x, r, g, b, 1e-12)
                     for _ in range(2)],
            lambda: [F.layer_norm(x + r, (H,), gl.detach(), bl.detach(),
                                  1e-12) for _ in range(2)]),
        "residual_layer_norm_bwd": (
            lambda: [K.residual_layer_norm_bwd(x, r, dy, g, mean, rstd)
                     for _ in range(2)],
            lambda: [K.residual_layer_norm_bwd_reference(x, r, dy, g, mean,
                                                         rstd)
                     for _ in range(2)],
            lambda: [torch.autograd.grad(y_lib, (xl, rl, gl, bl), dy,
                                         retain_graph=True)
                     for _ in range(2)]),
        "bias_gelu": (lambda: K.bias_gelu(h, b1),
                      lambda: K.bias_gelu_reference(h, b1),
                      lambda: F.gelu(h + b1l)),
        "bias_gelu_bwd": (lambda: K.bias_gelu_bwd(h, b1, dh),
                          lambda: K.bias_gelu_bwd_reference(h, b1, dh),
                          lambda: torch.autograd.grad(g_lib, (hl,), dh,
                                                      retain_graph=True)),
        "embed_lookup": (
            lambda: K.embed_lookup(*eargs),
            lambda: K.embed_lookup_reference(*eargs),
            lambda: F.layer_norm(F.embedding(ids, word)
                                 + F.embedding(rows, pos)
                                 + F.embedding(tids, type_), (H,), sc, bi,
                                 1e-12)),
    }
    # kernel and library: device time (the calls queued back to back);
    # beside it the enqueue-bound time of back-to-back calls, which the
    # host's Python sets for launches this short
    times, enqueue = {}, {}
    for name, (fk, fp, fl) in t.items():
        times[name] = (device_ms(fk), cuda_ms(fp, iters=3), device_ms(fl))
        enqueue[name] = (cuda_ms(fk), cuda_ms(fl))
    bounds, single = rows_bounds(M, int(torch.unique(ids).numel()),
                                 int(torch.unique(tids).numel()), 256)
    for name, (k_ms, p_ms, l_ms) in times.items():
        one = single[name]
        log(f"  time rows {name:<24} n {M}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound "
            f"{bounds[name][0]:.4f} ms ({bounds[name][1]}); one launch's "
            f"bound {one[0] * 1e3:.1f} us, {one[0] * HBM / 1e9:.1f} MB at "
            f"3.35 TB/s; back-to-back from the host: kernel "
            f"{enqueue[name][0]:.4f} ms, library {enqueue[name][1]:.4f} ms "
            f"[{card}]")
    return check.max_err, times, bounds


def train_split(memory, tok, reqs, dev, seed: int):
    """Per bucket, the request's utterances as a training split on the
    device: DSTC2-shaped rows with 0-3 gold labels, one per top group."""
    from nbest_asr_tpu_torch.data.dataset import RawSplit
    from nbest_asr_tpu_torch.data.input_builder import pack_split

    rng = np.random.RandomState(seed)
    groups = [sorted(m) for t, m in memory.top2bottom.items() if t > 1]
    out = {}
    for bucket, req in zip(BUCKETS, reqs):
        seqs = [u.split() for u in req]
        labels = []
        for _ in seqs:
            pick = rng.choice(len(groups), size=rng.randint(0, 4),
                              replace=False)
            labels.append([memory.idx2label[groups[g][rng.randint(
                len(groups[g]))]] for g in pick])
        pk = pack_split(RawSplit(seqs, seqs, labels), tok, memory,
                        max_len=bucket)
        out[bucket] = {k: torch.from_numpy(getattr(pk, k)).to(dev)
                       for k in ("input_ids", "segment_ids", "attn_mask",
                                 "trans_input_ids", "trans_segment_ids",
                                 "trans_attn_mask", "labels")}
    return out


def plain_attention_ms(params, cfg, b, s, dev):
    """One encoder layer's attention block on the plain training path
    (encoder.py: QKV dense, segment attention with prob dropout,
    out-proj, hidden dropout, residual LN), forward + backward ms, every
    input and weight with a gradient."""
    from nbest_asr_tpu_torch.ops.attention import multi_head_attention
    from nbest_asr_tpu_torch.ops.layers import dense, dropout, layer_norm
    from nbest_asr_tpu_torch.ops.philox import generator

    lp = {k: v[0] for k, v in params["encoder"]["layers"].items()}
    w = {k: (lp[k].to(torch.bfloat16) if "kernel" in k else lp[k].clone())
         .requires_grad_(True)
         for k in ("qkv_kernel", "qkv_bias", "attn_out_kernel",
                   "attn_out_bias", "attn_ln_scale", "attn_ln_bias")}
    h, nh = cfg.encoder.hidden_size, cfg.encoder.num_heads
    x = torch.randn(b, s, h, device=dev).to(torch.bfloat16) \
        .requires_grad_(True)
    mask = torch.ones(b, s, device=dev)
    dyb = torch.randn(b, s, h, device=dev).to(torch.bfloat16)
    hd = h // nh

    def run():
        qkv = dense(x, w["qkv_kernel"], w["qkv_bias"])
        q, k, v = qkv.split(h, dim=-1)
        ctx = multi_head_attention(
            q.reshape(b, s, nh, hd), k.reshape(b, s, nh, hd),
            v.reshape(b, s, nh, hd), mask, dropout_rate=DROPOUT,
            gen=generator(1, dev), deterministic=False).reshape(b, s, h)
        ctx = dropout(dense(ctx, w["attn_out_kernel"], w["attn_out_bias"]),
                      DROPOUT, generator(2, dev))
        layer_norm(x + ctx, w["attn_ln_scale"], w["attn_ln_bias"],
                   1e-12).backward(dyb)

    return cuda_ms(run, iters=5)


# the training phases' routes: the encoder flags of the main path, its
# launches per layer (per bucket where they differ), a second route taken
# for one counted step, the per-layer timings (phase 5 / 8) of the main
# path's attention and FFN, and the buckets of the dropout-0 gate and of
# the 30-step loss halving (buckets where the route's kernels run)
TRAIN_ROUTES = {
    "bf16": dict(
        flags=dict(use_fused_ffn=True, use_fused_attn=True),
        per_layer=PER_LAYER_TRAIN,
        second=("FFN-only route", dict(use_fused_attn=False),
                PER_LAYER_TRAIN_FFN),
        blocks=("attn_block_train", "ffn_block_train")),
    "int8": dict(
        flags=dict(use_fused_ffn=True, use_fused_attn=True,
                   use_int8_train=True, use_int8_train_attn=True,
                   use_int8_train_bwd=True),
        per_layer=PER_LAYER_TRAIN_I8,
        second=("int8 forwards, bf16 backwards (NBEST_BENCH_INT8=1)",
                dict(use_int8_train_bwd=False), PER_LAYER_TRAIN_I8_FWD),
        blocks=("attn_block_train_i8b", "ffn_block_train_i8b")),
    # route A: JAX's --no_fused_attn (flash_min_seq 160)
    "flash": dict(
        flags=dict(use_fused_ffn=True, use_fused_attn=False,
                   use_flash_attention=True),
        per_layer=lambda bucket: (PER_LAYER_TRAIN_FLASH_SB if bucket >= 160
                                  else PER_LAYER_TRAIN_FFN),
        second=None,
        blocks=("flash_attn_train", "ffn_block_train"),
        gate_bucket=256, fixed_bucket=160),
    # route C: both megakernels and flash off (JAX's EncoderConfig
    # defaults), the three row-kernel flags on; unpacked rows carry no
    # position_ids, so the fused embedding runs every micro
    "fused_rows": dict(
        flags=ROWS_FLAGS,
        per_layer=PER_LAYER_TRAIN_ROWS,
        per_micro=PER_FORWARD_ROWS,
        second=None,
        blocks=None),
}


def train_rig(dev):
    """What both training phases share: the synthetic hierarchy, seed-0
    BERT-base weights (f32 masters on the card), the per-bucket training
    splits, the base encoder config (bf16 compute, dropout 0.1, no kernel
    flags) and the generators."""
    from nbest_asr_tpu_torch.data.tokenizer import WordVocabTokenizer
    from nbest_asr_tpu_torch.models.encoder import EncoderConfig
    from nbest_asr_tpu_torch.models.heads import hierarchy_device_arrays
    from nbest_asr_tpu_torch.models.model import (ModelConfig,
                                                  init_model_params)
    from nbest_asr_tpu_torch.train.optimizer import tree_map

    memory = dstc2_like_memory()
    tok = WordVocabTokenizer(memory)
    enc = EncoderConfig.bert_base(vocab_size=VOCAB,
                                  compute_dtype="bfloat16",
                                  hidden_dropout=DROPOUT,
                                  attn_dropout=DROPOUT)
    cfg = ModelConfig(encoder=enc, n_top=memory.n_top,
                      n_bottom=memory.n_bottom)
    params = tree_map(lambda a: a.to(dev), init_model_params(
        torch.Generator().manual_seed(0), cfg))
    return dict(cfg=cfg, params=params,
                hier=hierarchy_device_arrays(memory.arrays(), dev),
                data=train_split(memory, tok, requests(memory, seed=1), dev,
                                 seed=2),
                gen=torch.Generator().manual_seed(3),
                rng=np.random.RandomState(4))


class int8_blocks_on_plain_versions:
    """Within the block, the encoder's int8 training blocks run on their
    kernels' plain versions (the encoder imports them at each call)."""

    def __enter__(self):
        from nbest_asr_tpu_torch.ops import fused_attention as fa
        from nbest_asr_tpu_torch.ops import fused_ffn as ff

        self.saved = (ff.fused_ffn_block_int8_train,
                      fa.fused_attention_block_int8_train)
        ff.fused_ffn_block_int8_train = ff.fused_ffn_block_int8_train_reference
        fa.fused_attention_block_int8_train = \
            fa.fused_attention_block_int8_train_reference

    def __exit__(self, *exc):
        from nbest_asr_tpu_torch.ops import fused_attention as fa
        from nbest_asr_tpu_torch.ops import fused_ffn as ff

        ff.fused_ffn_block_int8_train, \
            fa.fused_attention_block_int8_train = self.saved


# the dropout-0 gate's optimizer: eps = 1 makes BertAdam's first update
# linear in the gradient (with the default 1e-6 it is m / sqrt(v) = +-3.16
# for every element, whatever its size, and near-zero gradients would
# flip with bf16 noise); a constant schedule makes step 0 move the
# weights, and no weight decay leaves the deltas to the gradients alone
GATE_OPT = dict(lr=1e-3, bert_lr=1e-3, schedule="none", eps=1.0,
                weight_decay=0.0)


def hold_step(params, outs):
    """One kernel step against one plain step from the same ``params``
    (``outs``: [(new params, loss parts)] for kernel, then plain): loss
    parts within 1e-2 relative, every leaf's delta within 5e-2 of the
    plain step's largest delta for that leaf (PERF.md section 2)."""
    (kp, kl), (pp, pl) = outs
    for k in kl:
        rel = abs(kl[k] - pl[k]) / max(abs(pl[k]), 1e-30)
        log(f"  dropout 0 loss {k}: kernel {kl[k]:.6f} plain {pl[k]:.6f} "
            f"(rel {rel:.2e} <= 1e-2)")
        if rel > 1e-2:
            raise AssertionError(f"kernel and plain steps disagree on {k}")
    worst = 0.0

    def walk(a, b, c, path=""):
        nonlocal worst
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], c[key], f"{path}/{key}")
            return
        dk, dp = (b - a).double(), (c - a).double()
        scale = dp.abs().max().item()
        rr = (dk - dp).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, rr)
        if rr > 5e-2 or scale == 0:
            raise AssertionError(f"{path}: kernel-step delta off the plain "
                                 f"step's by {rr:.3e} of its max {scale:.3e}")

    walk(params, kp, pp)
    log(f"  dropout 0 parameter deltas: worst leaf {worst:.3e} of its "
        f"largest delta (<= 5e-2)")


def phase_train(dev, card: str, block_ms, rig, route: str, beside=None):
    """The training slice through ``make_train_step`` on ``route``'s
    configuration (TRAIN_ROUTES); returns the launch counts of its
    main-path runs (the main path, then one step of the second route),
    its step ms per bucket and its peak memory.  ``beside``: another
    route's step ms per bucket, printed next to this one's."""
    import dataclasses

    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.ops.kernels import \
        seg_attention_bwd_wgmma_launches as wgmma_bwd
    from nbest_asr_tpu_torch.parallel.train_step import (TrainState,
                                                         make_eval_step,
                                                         make_train_step)
    from nbest_asr_tpu_torch.train.losses import LossConfig
    from nbest_asr_tpu_torch.train.optimizer import (OptimizerConfig,
                                                     make_optimizer)

    r = TRAIN_ROUTES[route]
    base, params, data, hier = (rig["cfg"], rig["params"], rig["data"],
                                rig["hier"])
    gen, rng = rig["gen"], rig["rng"]
    enc = dataclasses.replace(base.encoder, **r["flags"])
    cfg = dataclasses.replace(base, encoder=enc)
    plain_enc = base.encoder           # every kernel flag off

    def indices(bucket):
        n_rows = data[bucket]["input_ids"].shape[0]
        return rng.randint(0, n_rows, (N_ACCUM, TRAIN_MICRO[bucket]))

    def new_state(c, **okw):
        opt = make_optimizer(OptimizerConfig(**okw), params)
        return (make_train_step(c, LossConfig(), opt, hier,
                                n_accum=N_ACCUM, dual_stream=False),
                TrainState(params, opt.init(params), 0))

    per_micro = r.get("per_micro", {})

    def expect(counts, per_layer, micros_at, what):
        """per_layer: launches per layer, or a function of the bucket
        giving them; micros_at: {bucket: micros run there}; plus the
        route's launches per micro."""
        at = per_layer if callable(per_layer) else lambda _: per_layer
        want = {k: sum((at(b).get(k, 0) * LAYERS + per_micro.get(k, 0)) * n
                       for b, n in micros_at.items()) for k in counts}
        log(f"[train {route}] {what}: launches {counts}, expected {want}")
        if counts != want:
            raise AssertionError(f"{what}: launch counts differ from layers "
                                 "x micros x launches per layer")

    okw = dict(lr=5e-4, bert_lr=1e-4, warmup_proportion=0.1, t_total=100)
    step, state0 = new_state(cfg, **okw)
    for bucket in BUCKETS:                      # warm-up, not counted
        step(state0, data[bucket], indices(bucket), gen)
    torch.cuda.synchronize()

    # ---- main path: 3 steps per bucket, counted and timed -------------- #
    _cuda.reset_launch_counts()
    wgmma0 = wgmma_bwd()
    pass0 = quant_pass_launches()
    step_ms, peaks = {}, {}
    for bucket in BUCKETS:
        torch.cuda.reset_peak_memory_stats()
        state, ms = state0, []
        for _ in range(TRAIN_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, stats = step(state, data[bucket], indices(bucket), gen)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
            parts = {k: float(v) for k, v in stats["loss"].items()}
            if not all(np.isfinite(v) for v in parts.values()):
                raise AssertionError(f"bucket {bucket}: loss {parts}")
        step_ms[bucket] = ms
        torch.cuda.synchronize()
        peaks[bucket] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[train {route}] bucket {bucket} (micro {TRAIN_MICRO[bucket]} "
            f"x {N_ACCUM}): loss {parts}, counts "
            f"{ {k: float(v) for k, v in stats['counts'].items()} }")
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    # every bucket has head dim 64 and seq <= 256: the wgmma backward
    wgmma = wgmma_bwd() - wgmma0
    log(f"[train {route}] seg_attention_bwd launches on the wgmma pair: "
        f"{wgmma} of {counts['seg_attention_bwd']}")
    if wgmma != counts["seg_attention_bwd"]:
        raise AssertionError("seg_attention_bwd did not run its wgmma pair "
                             "at head dim 64, seq <= 256")
    flags_on = ", ".join(k for k, v in r["flags"].items() if v)
    expect(counts, r["per_layer"],
           {b: TRAIN_STEPS * N_ACCUM for b in BUCKETS},
           f"main path ({flags_on})")
    hold_quant_pass(f"train {route}", pass0, counts)
    peak = max(peaks.values())

    # ---- the second route: one counted step at seq 64 ------------------ #
    if r["second"] is not None:
        what, flags, second_per_layer = r["second"]
        second, _ = new_state(dataclasses.replace(
            cfg, encoder=dataclasses.replace(enc, **flags)), **okw)
        second(state0, data[64], indices(64), gen)         # warm-up
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        pass0 = quant_pass_launches()
        _, stats = second(state0, data[64], indices(64), gen)
        torch.cuda.synchronize()
        second_counts = dict(_cuda.launch_counts)
        expect(second_counts, second_per_layer, {64: N_ACCUM},
               f"{what}, one step at seq 64")
        hold_quant_pass(f"train {route}, {what}", pass0, second_counts)
        if not all(np.isfinite(float(v)) for v in stats["loss"].values()):
            raise AssertionError(f"{what}: loss {stats['loss']}")
        counts = {k: counts[k] + second_counts[k] for k in counts}

    per_step = LAYERS * N_ACCUM
    for bucket in BUCKETS:
        ms = step_ms[bucket]
        mean = sum(ms) / len(ms)
        utt = N_ACCUM * TRAIN_MICRO[bucket] / (mean / 1e3)
        beside_s = "" if beside is None else (
            f"; bf16 step mean {sum(beside[bucket]) / len(beside[bucket]):.2f}"
            " ms (phase 6)")
        if r["blocks"] is None:
            # the row kernels' share, from their 8192-row per-layer times
            rows_ms = N_ACCUM * (block_ms["embed_lookup"][0] + LAYERS * sum(
                block_ms[k][0] for k in PER_LAYER_TRAIN_ROWS))
            log(f"[train {route}] bucket {bucket}: step ms "
                f"{', '.join(f'{m:.2f}' for m in ms)} (mean {mean:.2f}); "
                f"{utt:.1f} utt/s; peak memory {peaks[bucket]:.2f} GiB; the "
                f"five row kernels ~{rows_ms:.2f} ms of the step at their "
                f"8192-row times ({rows_ms / mean:.3f}){beside_s} [{card}]")
            continue
        attn_key, ffn_key = r["blocks"]
        ffn = block_ms[(ffn_key, bucket)]
        attn = block_ms[(attn_key, bucket)]
        extra = ""
        if route == "bf16":
            extra = (f", plain training path "
                     f"{plain_attention_ms(params, cfg, TRAIN_MICRO[bucket], bucket, dev):.3f}")
        elif route == "flash":
            extra = ("; this bucket's attention takes the "
                     + ("single-block flash kernels" if bucket >= 160
                        else "plain path"))
        else:
            extra = (f"; bf16 bwd route {block_ms[('attn_block_train_i8', bucket)][0]:.3f}"
                     f" / {block_ms[('ffn_block_train_i8', bucket)][0]:.3f} ms, "
                     f"bf16 blocks {block_ms[('attn_block_train', bucket)][0]:.3f}"
                     f" / {block_ms[('ffn_block_train', bucket)][0]:.3f} ms")
        what_attn = ("flash attention (q, k, v to ctx)" if route == "flash"
                     else "attention block")
        log(f"[train {route}] bucket {bucket}: step ms "
            f"{', '.join(f'{m:.2f}' for m in ms)} (mean {mean:.2f}); "
            f"{utt:.1f} utt/s; peak memory {peaks[bucket]:.2f} GiB; per "
            f"layer fwd+bwd: {what_attn} kernels {attn[0]:.3f} ms (plain "
            f"version {attn[1]:.3f}{extra}), FFN block kernels "
            f"{ffn[0]:.3f} ms (plain {ffn[1]:.3f}); share of the step: "
            f"attention {per_step * attn[0] / mean:.3f}, FFN "
            f"{per_step * ffn[0] / mean:.3f}{beside_s} [{card}]")
    log(f"[train {route}] peak memory {peak:.2f} GiB over the main-path "
        f"steps [{card}]")
    if route == "int8":
        wq = block_ms["weight_quant_ms"]
        log(f"[train int8] weight quantization {wq:.4f} ms per layer, "
            f"{per_step * wq:.2f} ms per step (each micro's block calls "
            f"quantize their weights) [{card}]")

    # ---- dropout 0: one kernel step and one plain step agree ------------ #
    # (GATE_OPT) bf16 and flash: the plain step is the plain encoder path
    # (all kernel flags off); int8: the same int8 step with both blocks on
    # their kernels' plain versions
    no_drop = dataclasses.replace(enc, hidden_dropout=0.0, attn_dropout=0.0)
    gate_bucket = r.get("gate_bucket", 64)
    idx = indices(gate_bucket)
    outs = []
    for which in ("kernel", "plain"):
        c = no_drop
        if which == "plain" and route in ("bf16", "flash", "fused_rows"):
            c = dataclasses.replace(plain_enc, hidden_dropout=0.0,
                                    attn_dropout=0.0)
        st, s0 = new_state(dataclasses.replace(cfg, encoder=c), **GATE_OPT)
        _cuda.reset_launch_counts()
        if which == "plain" and route == "int8":
            with int8_blocks_on_plain_versions():
                s1, stats = st(s0, data[gate_bucket], idx,
                               torch.Generator().manual_seed(0))
            if any(_cuda.launch_counts.values()):
                raise AssertionError("the plain-version step launched "
                                     f"kernels: {_cuda.launch_counts}")
        else:
            s1, stats = st(s0, data[gate_bucket], idx,
                           torch.Generator().manual_seed(0))
        if which == "kernel" and route == "flash" and \
                _cuda.launch_counts["seg_attention_bwd"] != LAYERS * N_ACCUM:
            raise AssertionError("the flash route's gate step did not train "
                                 f"through flash: {_cuda.launch_counts}")
        if which == "kernel" and route == "fused_rows":
            expect(dict(_cuda.launch_counts), r["per_layer"],
                   {gate_bucket: N_ACCUM}, "dropout-0 gate step")
        outs.append((s1.params, {k: float(v)
                                 for k, v in stats["loss"].items()}))
    log(f"[train {route}] dropout 0, seq {gate_bucket}: one kernel step "
        "against one plain step")
    hold_step(params, outs)

    # ---- 30 steps on one fixed micro, dropout on: the loss halves ------ #
    # lr 1e-4 under the trainer's warmup-linear schedule over the 30 steps;
    # bf16 and route C: the plain path's run is printed beside.  The gate
    # reads the micro's dropout-free loss on the plain path (make_eval_step,
    # every kernel flag off) after each step: the median of the last ten
    # must be under half the loss before the first.  One step's loss under
    # dropout is noisy, and on route C's micro one of the last updates
    # (under 8% of the peak lr) throws the fit off, at a step that varies
    # with rounding, on the plain path as on the kernels (PERF.md, PR 8)
    fix_kw = dict(lr=1e-4, bert_lr=1e-4, t_total=30)
    fixed_bucket = r.get("fixed_bucket", 64)
    fixed = rng.randint(0, data[fixed_bucket]["input_ids"].shape[0],
                        (1, TRAIN_MICRO[fixed_bucket]))
    judge = make_eval_step(dataclasses.replace(cfg, encoder=plain_enc),
                           LossConfig(), hier, dual_stream=False)

    def eval_loss(p):
        return float(judge(p, data[fixed_bucket], fixed[0])["loss"]["total"])

    before = eval_loss(params)
    curves, evals = {}, {}
    runs = [("kernels", enc)] + ([("plain", plain_enc)]
                                 if route in ("bf16", "fused_rows") else [])
    for name, c in runs:
        opt = make_optimizer(OptimizerConfig(**fix_kw), params)
        st = make_train_step(dataclasses.replace(cfg, encoder=c),
                             LossConfig(), opt, hier, n_accum=1,
                             dual_stream=False)
        state = TrainState(params, opt.init(params), 0)
        g = torch.Generator().manual_seed(5)
        curves[name], evals[name] = [], []
        for _ in range(30):
            state, stats = st(state, data[fixed_bucket], fixed, g)
            curves[name].append(float(stats["loss"]["total"]))
            evals[name].append(eval_loss(state.params))
        log(f"[train {route}] fixed micro, seq {fixed_bucket}, lr 1e-4 "
            "warmup-linear, "
            f"dropout {DROPOUT}, {name}: total loss "
            f"{', '.join(f'{v:.1f}' for v in curves[name])}; dropout-free "
            f"loss {before:.1f}, then after each step "
            f"{', '.join(f'{v:.1f}' for v in evals[name])}")
    late = float(np.median(evals["kernels"][-10:]))
    log(f"[train {route}] dropout-free loss {before:.1f} -> median of the "
        f"last ten steps {late:.1f} (< {0.5 * before:.1f})")
    if not late < 0.5 * before:
        raise AssertionError(f"dropout-free loss {before:.2f} -> {late:.2f} "
                             "(median of the last ten steps): not halved "
                             "in 30 steps")
    return counts, step_ms, peak


class flash_and_ffn_on_plain_versions:
    """Within the block, the encoder's flash attention and FFN block run
    on their kernels' plain versions (the encoder and multi_head_attention
    import them at each call)."""

    def __enter__(self):
        from nbest_asr_tpu_torch.ops import flash_attention as fa
        from nbest_asr_tpu_torch.ops import fused_ffn as ff

        self.saved = (fa.flash_attention, ff.fused_ffn_block)
        fa.flash_attention = fa.flash_attention_reference
        ff.fused_ffn_block = ff.fused_ffn_block_reference

    def __exit__(self, *exc):
        from nbest_asr_tpu_torch.ops import flash_attention as fa
        from nbest_asr_tpu_torch.ops import fused_ffn as ff

        fa.flash_attention, ff.fused_ffn_block = self.saved


def long_micros(memory, dev, seed: int):
    """Two micros of LONG_BATCH rows at seq LONG_SEQ on the device:
    DSTC2-shaped token rows (segment 0, then 1 from half the row's
    length; 0-3 gold labels, one per top group) padded from random
    lengths in [768, 1024]; and rows packed (data/packing.py, up to 8
    segments, position_ids restarting per segment) from utterances of
    150-400 tokens."""
    from nbest_asr_tpu_torch.data.packing import pack_train_data

    rng = np.random.RandomState(seed)
    groups = [sorted(m) for t, m in memory.top2bottom.items() if t > 1]

    def host(n, lo, hi):
        ids = rng.randint(5, VOCAB, (n, LONG_SEQ)).astype(np.int32)
        mask = np.zeros((n, LONG_SEQ), np.float32)
        segs = np.zeros((n, LONG_SEQ), np.int32)
        labels = np.zeros((n, memory.n_bottom), np.float32)
        for r in range(n):
            length = rng.randint(lo, hi + 1)
            mask[r, :length] = 1.0
            ids[r, length:] = 0
            segs[r, length // 2:length] = 1
            for g in rng.choice(len(groups), size=rng.randint(0, 4),
                                replace=False):
                labels[r, groups[g][rng.randint(len(groups[g]))]] = 1.0
        return {"input_ids": ids, "attn_mask": mask, "segment_ids": segs,
                "trans_input_ids": ids.copy(), "trans_attn_mask": mask.copy(),
                "trans_segment_ids": segs.copy(), "labels": labels}

    padded = host(LONG_BATCH, 3 * LONG_SEQ // 4, LONG_SEQ)
    packed, _ = pack_train_data(host(6 * LONG_BATCH, 150, 400),
                                capacity=LONG_SEQ, max_segs=8)
    packed = {k: v[:LONG_BATCH] for k, v in packed.items()}
    return [{k: torch.from_numpy(v).to(dev) for k, v in d.items()}
            for d in (padded, packed)]


def phase_train_long(dev, card: str, block_ms):
    """Route B: the JAX trainer's TPU defaults (use_flash_attention,
    use_fused_attn, use_fused_ffn) at BERT-base widths with max_position
    1024, seed-0 random weights, one micro of 32 rows at seq 1024: the
    attention megakernel's seq <= 512 fails and _flash_preferred(32, 1024,
    12) holds (3 x 32 x 12 x 1024^2 x 2 B = 2.42 GB > 2 GiB), so every
    layer's attention takes the tiled flash kernels and its FFN the FFN
    chain.  Two counted steps (the padded micro, then the packed one),
    counters by PER_LAYER_TRAIN_TILED; at dropout 0 one kernel step
    against the same step with flash and the FFN block on their kernels'
    plain versions.  Returns the counts and the step ms."""
    import dataclasses

    from nbest_asr_tpu_torch.models.encoder import EncoderConfig
    from nbest_asr_tpu_torch.models.heads import hierarchy_device_arrays
    from nbest_asr_tpu_torch.models.model import (ModelConfig,
                                                  init_model_params)
    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.ops.kernels import flash_wgmma_launches
    from nbest_asr_tpu_torch.parallel.train_step import (TrainState,
                                                         make_train_step)
    from nbest_asr_tpu_torch.train.losses import LossConfig
    from nbest_asr_tpu_torch.train.optimizer import (OptimizerConfig,
                                                     make_optimizer,
                                                     tree_map)

    memory = dstc2_like_memory()
    enc = EncoderConfig.bert_base(
        vocab_size=VOCAB, compute_dtype="bfloat16", max_position=LONG_SEQ,
        hidden_dropout=DROPOUT, attn_dropout=DROPOUT,
        use_flash_attention=True, use_fused_attn=True, use_fused_ffn=True)
    cfg = ModelConfig(encoder=enc, n_top=memory.n_top,
                      n_bottom=memory.n_bottom)
    params = tree_map(lambda a: a.to(dev), init_model_params(
        torch.Generator().manual_seed(0), cfg))
    hier = hierarchy_device_arrays(memory.arrays(), dev)
    micros = long_micros(memory, dev, seed=13)
    idx = np.arange(LONG_BATCH)[None]
    gen = torch.Generator().manual_seed(14)

    def new_state(c, **okw):
        opt = make_optimizer(OptimizerConfig(**okw), params)
        return (make_train_step(c, LossConfig(), opt, hier, n_accum=1,
                                dual_stream=False),
                TrainState(params, opt.init(params), 0))

    step, state = new_state(cfg, lr=5e-4, bert_lr=1e-4,
                            warmup_proportion=0.1, t_total=100)
    for micro in micros:                          # warm-up, not counted
        step(state, micro, idx, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    wgmma0 = flash_wgmma_launches()
    ms = []
    for name, micro in zip(("padded 768-1024", "packed"), micros):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, stats = step(state, micro, idx, gen)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
        parts = {k: float(v) for k, v in stats["loss"].items()}
        if not all(np.isfinite(v) for v in parts.values()):
            raise AssertionError(f"route B {name}: loss {parts}")
        log(f"[train long] {name} micro ({LONG_BATCH} x {LONG_SEQ}): step "
            f"{ms[-1]:.2f} ms, {LONG_BATCH / (ms[-1] / 1e3):.1f} rows/s, "
            f"loss {parts} [{card}]")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = dict(_cuda.launch_counts)
    want = {k: PER_LAYER_TRAIN_TILED.get(k, 0) * LAYERS * len(micros)
            for k in counts}
    log(f"[train long] launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("route B: launch counts differ from layers x "
                             "micros x launches per layer")
    wgmma1 = flash_wgmma_launches()
    wgmma = {n: wgmma1[n] - wgmma0[n] for n in wgmma1}
    log(f"[train long] the tiled kernels' wgmma + TMA launches {wgmma}")
    if any(wgmma[n] != want[n] for n in wgmma):
        raise AssertionError("route B: the tiled kernels did not run on "
                             "their wgmma + TMA kernels at every launch")
    attn = block_ms[("flash_attn_train", LONG_SEQ)]
    share = LAYERS * attn[0] / np.mean(ms)
    log(f"[train long] peak memory {peak:.2f} GiB; per layer fwd+bwd: flash "
        f"attention (tiled) kernels {attn[0]:.3f} ms (plain attention path "
        f"{attn[1]:.3f}), share of the step {share:.3f} [{card}]")

    no_drop = dataclasses.replace(enc, hidden_dropout=0.0, attn_dropout=0.0)
    outs = []
    for which in ("kernel", "plain"):
        st, s0 = new_state(dataclasses.replace(cfg, encoder=no_drop),
                           **GATE_OPT)
        _cuda.reset_launch_counts()
        if which == "plain":
            with flash_and_ffn_on_plain_versions():
                s1, stats = st(s0, micros[0], idx,
                               torch.Generator().manual_seed(0))
            if any(_cuda.launch_counts.values()):
                raise AssertionError("the plain-version step launched "
                                     f"kernels: {_cuda.launch_counts}")
        else:
            s1, stats = st(s0, micros[0], idx,
                           torch.Generator().manual_seed(0))
        outs.append((s1.params, {k: float(v)
                                 for k, v in stats["loss"].items()}))
    log("[train long] dropout 0, padded micro: one kernel step against the "
        "same step on the kernels' plain versions")
    hold_step(params, outs)
    return counts, ms, peak


CLI_SPLITS = {"train": 1024, "valid": 256, "test": 256}
# phase 13 runs the from-scratch CLI 2 layers deep, at BERT-base width:
# phase 14 (b) drives cli.main with these flags at the checkpoint's 12
CLI_LAYERS = 2
CLI_ARGS = ["--dataset", "dstc2", "--n_layers", str(CLI_LAYERS), "--n_head",
            str(NH), "--compute_dtype", "bfloat16", "--bert_dropout", "0.1",
            "--length_buckets", "64,96,160,256", "--token_budget", "8192",
            "--batchSize", "32", "--max_epoch", "2", "--checkpoint_every",
            "1"]
# the attention and FFN blocks' training kernels, which every train step
# runs, and the FFN block's forward, which every eval batch runs too (the
# eval attention is the plain path, as JAX's without use_fused_attn_eval)
PER_LAYER_EVAL = {"gemm_bias_act": 1, "gemm_bias_residual": 1,
                  "layer_norm": 1}


def write_dataroot(root, memory, seed: int = 0):
    """``memory.json`` and DSTC2-like train / valid / test shards
    (``asr \t<=>\t trans \t<=>\t labels``): user turns of lognormal
    length (median ~60 words, 12-220), a system turn of a sixth of that,
    one uniformly drawn gold label each -- ``bench.py``'s synthetic split
    -- and in 70% of the rows also one frequent label ("thankyou"; DSTC2's
    label counts are as skewed), which two epochs learn to predict, so
    that an epoch beats F1 0 and writes the best checkpoint."""
    from nbest_asr_tpu_torch.data.tokenizer import WordVocabTokenizer

    os.makedirs(root, exist_ok=True)
    memory.save(os.path.join(root, "memory.json"))
    rng = np.random.RandomState(seed)
    words = list(WordVocabTokenizer(memory).vocab)[8:200]
    label_names = [memory.idx2label[i] for i in range(2, memory.n_bottom)]
    for name, n in CLI_SPLITS.items():
        with open(os.path.join(root, name), "w") as fp:
            for _ in range(n):
                L = int(np.clip(rng.lognormal(4.1, 0.45), 12, 220))
                sys_part = [words[i] for i in rng.randint(
                    0, len(words), max(4, L // 6))]
                usr = [words[i] for i in rng.randint(0, len(words), L)]
                head = ["[CLS]", "[SYS]", *sys_part, "[USR]"]
                gold = {label_names[rng.randint(len(label_names))]}
                if rng.rand() < 0.7:
                    gold.add("thankyou")
                fp.write("%s\t<=>\t%s\t<=>\t%s\n" % (
                    " ".join(head + usr),
                    " ".join(head + usr[: max(4, L // 3)]),
                    ";".join(sorted(gold))))


def cli_trainer(args, dev):
    """The Trainer ``cli.main(args)`` builds, and its tokenizer, built here
    as main builds them, so that the run can be stopped after an epoch."""
    from nbest_asr_tpu_torch import cli
    from nbest_asr_tpu_torch.config import parse_arguments
    from nbest_asr_tpu_torch.data.tokenizer import load_tokenizer
    from nbest_asr_tpu_torch.train.loop import Trainer, build_model

    opt = parse_arguments(args)
    memory = cli.resolve_memory(opt)
    tok = load_tokenizer(opt.pre_trained_model, opt.tod_pre_trained_model,
                         memory, require_pretrained=opt.require_pretrained)
    splits = cli.prepare_packed_splits(opt, memory, tok)
    cfg, params = build_model(opt, memory, tok, dev)
    return Trainer(opt, memory, cfg, params, splits,
                   family=opt.pre_trained_model, device=dev), tok


def plan_counts(trainer):
    """(training micros, eval batches) of one epoch of ``trainer``: its
    steps x n_accum, and the valid and test splits' eval batches."""
    opt = trainer.opt
    micros = trainer._train_steps_per_epoch() * opt.n_accum_steps
    batches = 0
    for split in ("valid", "test"):
        for bucket in trainer.buckets[split]:
            blen = int(bucket.data["input_ids"].shape[1])
            b = max(opt.eval_batch or opt.micro_batch,
                    (opt.token_budget // blen) // 8 * 8)
            batches += -(-len(bucket) // b)
    return micros, batches


def log_lines(path, tag):
    with open(path) as fp:
        return [line.rstrip("\n") for line in fp if line.startswith(tag)]


def log_field(line, name):
    return line.split(f"{name}: ")[1].split("\t")[0]


def phase_cli(dev, card: str):
    """``cli.main`` at BERT-base width, CLI_LAYERS deep, on a synthetic
    dataroot: two epochs with the kernels' counters held to the run's
    plan, the resume check, ``--testing`` and ``load_predictor``; returns
    the launch counts of the first run."""
    import tempfile

    from nbest_asr_tpu_torch import cli
    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.serve import load_predictor

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "dataroot")
        write_dataroot(root, dstc2_like_memory())
        args = CLI_ARGS + ["--dataroot", root]
        whole = args + ["--experiment", os.path.join(tmp, "a")]
        stopped = args + ["--experiment", os.path.join(tmp, "b")]

        # ---- run 1: two epochs, counted ------------------------------- #
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        if cli.main(whole) != 0:
            raise AssertionError("cli.main returned an error")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = dict(_cuda.launch_counts)

        # the same run's Trainer, stopped after epoch 0, then resumed
        trainer, tok = cli_trainer(stopped, dev)
        micros, batches = plan_counts(trainer)
        epochs = int(CLI_ARGS[CLI_ARGS.index("--max_epoch") + 1])
        want = {k: CLI_LAYERS * epochs * (micros * PER_LAYER_TRAIN.get(k, 0)
                                          + batches * PER_LAYER_EVAL.get(k, 0))
                for k in counts}
        log(f"[cli] run 1 ({' '.join(CLI_ARGS)}): {run_s:.2f} s; "
            f"{micros} training micros and {batches} eval batches an "
            f"epoch; launches {counts}, expected {want}")
        if counts != want or not all(counts[k] for k in PER_LAYER_TRAIN):
            raise AssertionError("cli: the kernels' launches differ from "
                                 "layers x (micros x PER_LAYER_TRAIN + eval "
                                 "batches x PER_LAYER_EVAL)")
        exp_b = trainer.opt.exp_dir
        exp_a = os.path.join(tmp, "a", os.path.relpath(
            exp_b, os.path.join(tmp, "b")))
        rows = sum(-(-len(b) // trainer._bucket_micro_batch(b))
                   // trainer.opt.n_accum_steps * trainer.opt.n_accum_steps
                   * trainer._bucket_micro_batch(b)
                   for b in trainer.buckets["train"])
        for tag in ("[Train]", "[Valid]", "[Test]"):
            for line in log_lines(os.path.join(exp_a, "log.train"), tag):
                s = float(log_field(line, "Time"))
                extra = (f", {rows} rows ({micros} micros), "
                         f"{rows / s:.1f} rows/s" if tag == "[Train]"
                         else "")
                log(f"[cli] {tag} epoch {log_field(line, 'Epoch')}: "
                    f"{s:.2f} s{extra}; loss {log_field(line, 'Loss')} "
                    f"[{card}]")

        trainer.train(stop_after_epoch=0)
        del trainer
        torch.cuda.synchronize()
        if cli.main(stopped + ["--resume", "auto"]) != 0:
            raise AssertionError("cli.main --resume auto returned an error")
        last = f"ckpt_epoch{epochs - 1}"
        a, b = (torch.load(os.path.join(d, last), map_location="cpu",
                           weights_only=True) for d in (exp_a, exp_b))
        diffs = []

        def walk(x, y, path):
            if isinstance(x, dict):
                for k in x:
                    walk(x[k], y[k], f"{path}/{k}")
            elif isinstance(x, torch.Tensor):
                if not torch.equal(x, y):
                    diffs.append(path)
            elif x != y:
                diffs.append(path)

        walk(a, b, "")
        best = []
        for d in (exp_a, exp_b):
            with open(os.path.join(d, "best.json")) as fp:
                best.append(json.load(fp))
        log(f"[cli] resume: stopped after epoch 0, resumed with --resume "
            f"auto: {len(diffs)} leaves of params / opt_state / step differ "
            f"from the uninterrupted run's; best.json {best[1]} against "
            f"{best[0]}")
        if diffs or best[0] != best[1]:
            raise AssertionError(f"cli: the resumed run is not bit-equal "
                                 f"to the uninterrupted one: {diffs[:8]}")

        # ---- --testing reproduces the best epoch's valid metrics ------ #
        if cli.main(whole + ["--testing"]) != 0:
            raise AssertionError("cli.main --testing returned an error")
        new_best = log_lines(os.path.join(exp_a, "log.train"), "NEW BEST")
        (tested,) = log_lines(os.path.join(exp_a, "log.test"), "[Valid]")
        want_fa = new_best[-1].split("valid F1/Acc: ")[1].split("\t")[0]
        got_fa = "%s/%s" % (log_field(tested, "(p/r/f)").strip("()")
                            .split("/")[2], log_field(tested, "Acc"))
        log(f"[cli] --testing: valid F1/Acc {got_fa}, the best epoch's "
            f"{want_fa}; eval {log_field(tested, 'Time')} s [{card}]")
        if got_fa != want_fa:
            raise AssertionError("cli: --testing did not reproduce the best "
                                 "epoch's valid metrics")

        # ---- load_predictor ------------------------------------------- #
        from nbest_asr_tpu_torch.config import parse_arguments
        from nbest_asr_tpu_torch.data.dataset import read_sep_data
        from nbest_asr_tpu_torch.train.loop import build_model

        opt = parse_arguments(whole)
        memory = cli.resolve_memory(opt)
        cfg, _ = build_model(opt, memory, tok, dev)
        pred = load_predictor(exp_a, memory, cfg, tok, device=dev)
        saved = torch.load(os.path.join(exp_a, "model.ckpt"),
                           map_location="cpu", weights_only=True)["params"]
        diffs = []
        walk(saved, {k: _cpu_tree(v) for k, v in pred.params.items()}, "")
        utts = [" ".join(x) for x in read_sep_data(
            os.path.join(root, "valid")).asr_seqs]
        labels = pred.predict(utts)
        log(f"[cli] load_predictor: {len(diffs)} leaves differ from "
            f"model.ckpt's; predicted {len(labels)} valid utterances, "
            f"{sum(map(len, labels))} labels")
        if diffs or len(labels) != len(utts):
            raise AssertionError("cli: load_predictor did not restore "
                                 "model.ckpt's params")
    return counts


# --------------------------------------------------------------------- #
# the pretrained path: MLM pretraining, export and fine-tune from the
# checkpoint, RoBERTa-base and XLM-R-base checkpoints
# --------------------------------------------------------------------- #

BERT_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
ADDED = ["[SYS]", "[USR]"]
MLM_BUCKETS, MLM_STEPS, MLM_BUDGET = (64, 96), 20, 8192
MLM_OPT = dict(lr=1e-3, bert_lr=1e-3, warmup_proportion=0.1,
               t_total=MLM_STEPS)
XLMR_VOCAB, ROBERTA_VOCAB, ROBERTA_POSITIONS = 250002, 50265, 514


def write_bert_tokenizer(path, memory):
    """The files ``BertTokenizer.save_pretrained`` writes, for a vocab of
    ``[PAD] [UNK] [CLS] [SEP] [MASK]``, the memory's words and
    ``[unusedN]`` rows up to BERT-base's 30522, with ``[SYS]`` and
    ``[USR]`` added past it (ids 30522 and 30523)."""
    words = [w for w in memory.word2idx if w.isalnum()]
    vocab = BERT_SPECIALS + words
    vocab += [f"[unused{i}]" for i in range(VOCAB - len(vocab))]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w") as fp:
        fp.write("\n".join(vocab) + "\n")
    flags = dict(lstrip=False, normalized=False, rstrip=False,
                 single_word=False, special=True)
    decoder = {str(i): dict(content=t, **flags)
               for i, t in enumerate(BERT_SPECIALS)}
    decoder.update({str(VOCAB + i): dict(content=t, **flags)
                    for i, t in enumerate(ADDED)})
    named = dict(cls_token="[CLS]", mask_token="[MASK]", pad_token="[PAD]",
                 sep_token="[SEP]", unk_token="[UNK]")
    files = {
        "tokenizer_config.json": dict(
            added_tokens_decoder=decoder, additional_special_tokens=ADDED,
            do_lower_case=True, strip_accents=None,
            tokenize_chinese_chars=True, tokenizer_class="BertTokenizer",
            **named),
        "special_tokens_map.json": dict(additional_special_tokens=ADDED,
                                        **named),
        "added_tokens.json": {t: VOCAB + i for i, t in enumerate(ADDED)}}
    for name, obj in files.items():
        with open(os.path.join(path, name), "w") as fp:
            json.dump(obj, fp, indent=2)


def mlm_pool(raw, tok, dev):
    """Both text sides of ``raw`` in the default layout, ids from ``tok``,
    in the smallest of MLM_BUCKETS that holds them (longer rows dropped),
    as device tensors with the maskable positions (real, not special);
    ``tools/pretrain_mlm.py:pack_mlm_pool``'s packing."""
    from nbest_asr_tpu_torch.data.input_builder import build_inputs

    rows = []
    for seqs in (raw.asr_seqs, raw.trans_seqs):
        built = build_inputs(seqs, tok, "default")
        rows += [(tok.convert_tokens_to_ids(t), s)
                 for t, s in zip(built.tokens, built.segment_ids)]
    special = torch.tensor(tok.convert_tokens_to_ids(BERT_SPECIALS + ADDED),
                           dtype=torch.int32)
    out = {}
    for b in MLM_BUCKETS:
        mine = [r for r in rows if len(r[0]) <= b
                and (b == MLM_BUCKETS[0] or len(r[0]) > MLM_BUCKETS[0])]
        n = len(mine)
        ids = torch.full((n, b), tok.pad_token_id, dtype=torch.int32)
        segs = torch.zeros((n, b), dtype=torch.int32)
        mask = torch.zeros((n, b), dtype=torch.float32)
        for i, (x, s) in enumerate(mine):
            ids[i, :len(x)] = torch.tensor(x)
            segs[i, :len(x)] = torch.tensor(s)
            mask[i, :len(x)] = 1.0
        maskable = (mask > 0) & ~torch.isin(ids, special)
        out[b] = {k: v.to(dev) for k, v in dict(
            input_ids=ids, segment_ids=segs, attn_mask=mask,
            maskable=maskable).items()}
    return out, sum(len(r[0]) > MLM_BUCKETS[-1] for r in rows)


def mlm_rig(dev, memory, tok, **enc_kw):
    """BERT-base sized for ``tok``'s vocab (bf16, dropout 0.1, the blocks'
    kernels), seed-0 params with the MLM head, on the card."""
    from nbest_asr_tpu_torch.models.encoder import (EncoderConfig,
                                                    init_encoder_params)
    from nbest_asr_tpu_torch.train.mlm import init_mlm_head_params
    from nbest_asr_tpu_torch.train.optimizer import tree_map

    kw = dict(compute_dtype="bfloat16", hidden_dropout=DROPOUT,
              attn_dropout=DROPOUT, use_fused_attn=True, use_fused_ffn=True,
              use_flash_attention=True)
    kw.update(enc_kw)
    cfg = EncoderConfig(vocab_size=tok.vocab_size, hidden_size=H,
                        num_layers=LAYERS, num_heads=NH,
                        intermediate_size=INTER, **kw)
    g = torch.Generator().manual_seed(0)
    params = {"encoder": init_encoder_params(g, cfg),
              "mlm_head": init_mlm_head_params(g, cfg)}
    return cfg, tree_map(lambda t: t.to(dev), params)


def roberta_checkpoint(path, family, vocab, seed, fmt):
    """A RoBERTa-base-shaped checkpoint directory from a seed: 12 layers,
    768 wide, 514 positions, one token-type row, LayerNorm eps 1e-5, pad
    id 1, every tensor under ``roberta.`` (plus an ``lm_head.bias`` the
    reader must skip); ``fmt`` "bin" (``torch.save``) or "safetensors"
    (its bytes written here: header length, JSON header, raw f32).
    Returns the state dict."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, std=0.02):
        return torch.randn(*shape, generator=g) * std

    p = "roberta."
    sd = {p + "embeddings.word_embeddings.weight": n(vocab, H),
          p + "embeddings.position_embeddings.weight": n(ROBERTA_POSITIONS,
                                                         H),
          p + "embeddings.token_type_embeddings.weight": n(1, H),
          p + "embeddings.LayerNorm.weight": 1.0 + n(H, std=0.1),
          p + "embeddings.LayerNorm.bias": n(H, std=0.1)}
    for i in range(LAYERS):
        q = f"{p}encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            sd[q + name + ".weight"] = n(H, H)
            sd[q + name + ".bias"] = n(H)
        sd[q + "intermediate.dense.weight"] = n(INTER, H)
        sd[q + "intermediate.dense.bias"] = n(INTER)
        sd[q + "output.dense.weight"] = n(H, INTER)
        sd[q + "output.dense.bias"] = n(H)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[q + ln + ".weight"] = 1.0 + n(H, std=0.1)
            sd[q + ln + ".bias"] = n(H, std=0.1)
    sd["lm_head.bias"] = torch.zeros(vocab)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fp:
        json.dump(dict(
            architectures=["XLMRobertaForMaskedLM" if family == "xlm-roberta"
                           else "RobertaForMaskedLM"],
            model_type=family, vocab_size=vocab, hidden_size=H,
            num_hidden_layers=LAYERS, num_attention_heads=NH,
            intermediate_size=INTER,
            max_position_embeddings=ROBERTA_POSITIONS, type_vocab_size=1,
            layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0,
            eos_token_id=2, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1), fp, indent=2)
    if fmt == "bin":
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
        return sd
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for k in sorted(sd):
        nb = sd[k].numel() * 4
        header[k] = {"dtype": "F32", "shape": list(sd[k].shape),
                     "data_offsets": [off, off + nb]}
        off += nb
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(os.path.join(path, "model.safetensors"), "wb") as fp:
        fp.write(len(head).to_bytes(8, "little"))
        fp.write(head)
        for k in sorted(sd):
            fp.write(sd[k].contiguous().numpy().tobytes())
    return sd


class StandInTokenizer:
    """RoBERTa's and XLM-R's specials (``<s>`` 0, ``<pad>`` 1, ``</s>``
    2, ``<unk>`` 3) and one id per memory word: the rows a BPE or
    SentencePiece tokenizer would give, without ``transformers``."""

    cls_token, pad_token, sep_token, pad_token_id = "<s>", "<pad>", "</s>", 1

    def __init__(self, memory, double_sep: bool):
        self.double_sep = double_sep
        self.ids = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
        for w in memory.word2idx:
            if w.isalnum():
                self.ids.setdefault(w, len(self.ids))
        self.vocab_size = len(self.ids)

    def tokenize(self, word):
        return [word.lower()] if word else []

    def convert_tokens_to_ids(self, tokens):
        return [self.ids.get(t, 3) for t in tokens]


def leaves_equal(a, b):
    """Paths of the leaves where two param trees differ (device-agnostic)."""
    bad = []

    def walk(x, y, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif not torch.equal(x.cpu(), y.cpu()):
            bad.append(path)

    walk(a, b, "")
    return bad


def serve_held(name, kp, pp, fp, req, arrays, segs: bool):
    """Predictor ``kp`` (the kernels) against ``pp`` (plain, bf16) and
    ``fp`` (plain, f32) on one request: agreement on the decisions the f32
    run resolves (>= 98%) and mean |scores - f32| <= 5e-3, as phase 3's
    gate; ``segs``: the predictors feed their packed segment ids."""
    from nbest_asr_tpu_torch.models.model import model_forward

    def outputs(p):
        pk = p._pack([u.split() for u in req])
        tops, probs = [], []
        with torch.inference_mode():
            for s in range(0, len(req), BATCH):
                ids = torch.from_numpy(pk.input_ids[s:s + BATCH]).to(dev)
                sg = torch.from_numpy(pk.segment_ids[s:s + BATCH]).to(dev) \
                    if segs else torch.zeros_like(ids)
                mask = torch.from_numpy(pk.attn_mask[s:s + BATCH]).to(dev)
                top, prob, _, _, _ = model_forward(
                    p._fwd_params, p.cfg, p.hier, ids, mask, sg)
                tops.append(top.float().cpu().numpy())
                probs.append(prob.float().cpu().numpy())
        return np.concatenate(tops), np.concatenate(probs), pk.max_len

    dev = kp.device
    (kt, kb, klen), (pt, pb, _), (ft, fb, _) = (outputs(p)
                                                for p in (kp, pp, fp))
    tau = 2.0 * max(np.abs(pt - ft).max(), np.abs(pb - fb).max())
    bad, unresolved = resolvable_disagreements((kt, kb), (pt, pb), (ft, fb),
                                               arrays, tau)
    dk = np.abs(kb - fb).mean()
    rate = 1.0 - bad.mean()
    log(f"[pretrained] {name} Predictor, {len(req)} utterances in batches "
        f"of {BATCH} x {klen}: kernel vs "
        f"plain agreement on resolvable decisions {rate:.4f} (tau "
        f"{tau:.3e}, {unresolved:.3f} unresolved); |scores kernel - f32| "
        f"mean {dk:.3e}, plain {np.abs(pb - fb).mean():.3e}")
    if rate < 0.98 or dk > 5e-3 or not np.isfinite(kb).all():
        raise AssertionError(f"{name}: the kernel Predictor disagrees with "
                             "the plain one")


def expect_launches(what, got, want):
    """Fail unless a counted run's launches equal its plan."""
    log(f"[pretrained] {what}: launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"{what}: the kernels' launches differ from "
                             "the run's plan")


def add_counts(total, c):
    for k in total:
        total[k] += c[k]


def pretrained_mlm(dev, card: str, memory, root, ckpt):
    """Phase 14 (a): MLM at BERT-base width on ``root``'s train shard with
    ``ckpt``'s WordPiece tokenizer -- the dropout-0 gate, 20 counted
    steps, the decoder timed alone -- then the export into ``ckpt`` read
    back exactly.  Returns (the steps' launch counts, the encoder read
    back)."""
    import dataclasses
    import math

    from nbest_asr_tpu_torch.data.dataset import read_sep_data
    from nbest_asr_tpu_torch.data.tokenizer import WordPieceTokenizer
    from nbest_asr_tpu_torch.models.hf_convert import (
        export_hf_checkpoint, load_pretrained_encoder)
    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.train.mlm import (apply_mlm_mask,
                                               make_mlm_train_step,
                                               mlm_head_export_state,
                                               mlm_update)
    from nbest_asr_tpu_torch.train.optimizer import (OptimizerConfig,
                                                     make_optimizer,
                                                     tree_map)

    tok = WordPieceTokenizer(ckpt)
    mask_id = tok.convert_tokens_to_ids(["[MASK]"])[0]
    if tok.vocab_size != VOCAB or len(tok) != VOCAB + 2:
        raise AssertionError("the WordPiece vocab is not 30522 + 2")
    pool, dropped = mlm_pool(read_sep_data(os.path.join(root, "train")),
                             tok, dev)
    rows = {b: min(max(MLM_BUDGET // b, 8), v["input_ids"].shape[0])
            for b, v in pool.items()}
    sizes = {b: v["input_ids"].shape[0] for b, v in pool.items()}
    log(f"[pretrained] MLM corpus: {sizes} rows at buckets "
        f"{MLM_BUCKETS} ({dropped} longer dropped), "
        f"{rows} rows a step, WordPiece vocab {tok.vocab_size} + "
        f"{len(tok) - tok.vocab_size} added")
    cfg, params = mlm_rig(dev, memory, tok)
    opt = make_optimizer(OptimizerConfig(**MLM_OPT), params)
    step = make_mlm_train_step(cfg, opt, mask_id)
    state = opt.init(params)
    rng = np.random.RandomState(5)
    batches = []
    for i in range(MLM_STEPS):
        b = MLM_BUCKETS[i % len(MLM_BUCKETS)]
        sel = torch.from_numpy(rng.choice(pool[b]["input_ids"].shape[0],
                                          rows[b], replace=False)).to(dev)
        batches.append({k: v.index_select(0, sel)
                        for k, v in pool[b].items()})
    # one step at dropout 0 from the initial params: kernels against the
    # plain route (phase 6's gate; lr 1: the MLM loss is a mean over
    # ~1200 masked tokens, its gradients ~1e3 below the summed
    # classification loss's, and at lr 1e-3 the deltas of unit LN
    # scales would be a few f32 ulps of the weights)
    gcfg = dataclasses.replace(cfg, hidden_dropout=0.0, attn_dropout=0.0)
    pcfg = dataclasses.replace(gcfg, use_fused_attn=False,
                               use_fused_ffn=False,
                               use_flash_attention=False)
    batch = batches[0]
    masked, labels = apply_mlm_mask(
        torch.Generator(device=dev).manual_seed(7), batch["input_ids"],
        batch["maskable"], mask_id, cfg.vocab_size)
    outs = []
    for c_ in (gcfg, pcfg):
        gopt = make_optimizer(OptimizerConfig(**dict(
            GATE_OPT, lr=1.0, bert_lr=1.0)), params)
        new, _, loss = mlm_update(params, gopt.init(params), gopt, c_,
                                  masked, labels, batch["attn_mask"],
                                  batch["segment_ids"], 0)
        outs.append((new, {"mlm": float(loss)}))
    log("[pretrained] MLM, dropout 0: one kernel step against one plain "
        "step")
    hold_step(params, outs)
    del outs

    gen = torch.Generator().manual_seed(6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for batch in batches:
        params, state, loss = step(params, state, batch, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    mlm_s = time.perf_counter() - t0
    mlm_counts = dict(_cuda.launch_counts)
    expect_launches("MLM steps", mlm_counts, {
        k: MLM_STEPS * LAYERS * PER_LAYER_TRAIN.get(k, 0)
        for k in mlm_counts})
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[pretrained] MLM {MLM_STEPS} steps (rows by bucket {rows}, "
        f"alternating; lr {MLM_OPT['lr']}): "
        f"{1e3 * mlm_s / MLM_STEPS:.2f} ms a step, peak {peak:.2f} GiB; "
        f"loss {' '.join(f'{x:.3f}' for x in losses)}; ln V "
        f"{math.log(VOCAB):.3f} [{card}]")
    first, last = losses[0], float(np.mean(losses[-5:]))
    if not (np.isfinite(losses).all() and abs(first - math.log(VOCAB))
            < 1.0 and last < first - 1.0):
        raise AssertionError("MLM: the loss did not fall from ln V")

    # the tied decoder alone: logits, log-softmax, backward, f32
    h = torch.randn(MLM_BUDGET, H, device=dev, dtype=torch.bfloat16)
    w = params["encoder"]["embeddings"]["word"].detach()
    hw = h.float().requires_grad_(True)
    ww = w.to(torch.bfloat16).float().requires_grad_(True)

    def decoder():
        lp = torch.log_softmax(hw @ ww.t(), dim=-1)
        torch.autograd.grad(lp[:, 0].sum(), (hw, ww))

    dec_ms = cuda_ms(decoder, iters=3, warmup=1)
    log(f"[pretrained] MLM decoder (f32 matmul {MLM_BUDGET} x {H} x "
        f"{VOCAB}, log-softmax, backward): {dec_ms:.3f} ms [{card}]")
    del h, hw, ww

    # the export, read back
    enc = tree_map(lambda t: t.cpu(), params["encoder"])
    export_hf_checkpoint(cfg, enc, ckpt, extra_state=mlm_head_export_state(
        params["mlm_head"], enc["embeddings"]["word"]))
    rcfg, renc = load_pretrained_encoder(ckpt)
    bad = leaves_equal(enc, renc)
    log(f"[pretrained] export -> load_pretrained_encoder: {len(bad)} "
        f"leaves differ; vocab {rcfg.vocab_size}, eps "
        f"{rcfg.layer_norm_eps}, offset {rcfg.position_offset}")
    if bad or rcfg.vocab_size != VOCAB:
        raise AssertionError(f"export round trip: {bad[:4]}")
    return mlm_counts, renc


def pretrained_finetune(dev, card: str, root, ckpt, renc):
    """Phase 14 (b): ``cli.main`` with phase 13's flags and
    ``--tod_pre_trained_model ckpt --require_pretrained``: the encoder at
    init equal to ``renc``, the launches held to the plan, ``--testing``,
    ``load_predictor``.  Returns the two epochs' launch counts."""
    import tempfile

    from nbest_asr_tpu_torch import cli
    from nbest_asr_tpu_torch.data.dataset import read_sep_data
    from nbest_asr_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                    load_tokenizer)
    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.serve import load_predictor
    from nbest_asr_tpu_torch.train.loop import build_model

    with tempfile.TemporaryDirectory() as tmp:
        args = CLI_ARGS + ["--dataroot", root, "--tod_pre_trained_model",
                           ckpt, "--require_pretrained"]
        whole = args + ["--experiment", os.path.join(tmp, "ft")]
        trainer, ftok = cli_trainer(whole, dev)
        if not isinstance(ftok, WordPieceTokenizer) or \
                trainer.opt.layout != "tod":
            raise AssertionError("fine-tune: not the checkpoint's tokenizer "
                                 "and the TOD layout")
        bad = leaves_equal(trainer.state.params["encoder"], renc)
        log(f"[pretrained] fine-tune init: {len(bad)} encoder leaves differ "
            "from the checkpoint's")
        if bad:
            raise AssertionError(f"fine-tune init: {bad[:4]}")
        micros, n_eval = plan_counts(trainer)
        exp = trainer.opt.exp_dir
        del trainer
        epochs = int(CLI_ARGS[CLI_ARGS.index("--max_epoch") + 1])
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        if cli.main(whole) != 0:
            raise AssertionError("cli.main --tod_pre_trained_model returned "
                                 "an error")
        torch.cuda.synchronize()
        c = dict(_cuda.launch_counts)
        expect_launches(
            f"fine-tune, {epochs} epochs ({micros} micros, {n_eval} eval "
            "batches an epoch)", c,
            {k: LAYERS * epochs * (micros * PER_LAYER_TRAIN.get(k, 0)
                                   + n_eval * PER_LAYER_EVAL.get(k, 0))
             for k in c})
        for tag in ("[Train]", "[Valid]"):
            for line in log_lines(os.path.join(exp, "log.train"), tag):
                log(f"[pretrained] fine-tune {tag} epoch "
                    f"{log_field(line, 'Epoch')}: {log_field(line, 'Time')} "
                    f"s; loss {log_field(line, 'Loss')} [{card}]")
        log(f"[pretrained] fine-tune cli.main: "
            f"{time.perf_counter() - t0:.2f} s")
        if cli.main(whole + ["--testing"]) != 0:
            raise AssertionError("cli.main --testing returned an error")
        (tested,) = log_lines(os.path.join(exp, "log.test"), "[Valid]")
        want_fa = log_lines(os.path.join(exp, "log.train"),
                            "NEW BEST")[-1].split(
            "valid F1/Acc: ")[1].split("\t")[0]
        got_fa = "%s/%s" % (log_field(tested, "(p/r/f)").strip("()")
                            .split("/")[2], log_field(tested, "Acc"))
        log(f"[pretrained] --testing: valid F1/Acc {got_fa}, best epoch's "
            f"{want_fa}")
        if got_fa != want_fa:
            raise AssertionError("fine-tune: --testing did not reproduce "
                                 "the best epoch")
        fopt = cli.parse_arguments(whole)
        fmem = cli.resolve_memory(fopt)
        ftok = load_tokenizer(None, ckpt, fmem, require_pretrained=True)
        fcfg, _ = build_model(fopt, fmem, ftok, dev)
        pred = load_predictor(exp, fmem, fcfg, ftok, device=dev,
                              layout="tod")
        utts = [" ".join(x) for x in read_sep_data(
            os.path.join(root, "valid")).asr_seqs]
        n_labels = sum(map(len, pred.predict(utts)))
        log(f"[pretrained] load_predictor (TOD layout, pad id "
            f"{ftok.pad_token_id}): {len(utts)} valid utterances, "
            f"{n_labels} labels")
        del pred
    return c


def hold_embed_out_of_range(dev, family, vocab, emb):
    """``embed_lookup`` at a checkpoint's vocab held to its plain version
    with JAX's out-of-range ids: type id 1 into the one type row and word
    ids in the table's padding to 8 rows (zero rows), f32 and bf16 tables,
    eps 1e-5, offset 2; then an id past the padding gives its NaN row and
    no other row changes."""
    from nbest_asr_tpu_torch.ops import kernels as K

    e = {k: t.to(dev) for k, t in emb.items()}
    gen = torch.Generator().manual_seed(10)
    m, s = 8192, 256
    ids = torch.randint(0, vocab, (m,), generator=gen)
    ids[::97] = vocab + torch.arange(0, m, 97) % (-vocab % 8 or 1)
    tids = torch.randint(0, 2, (m,), generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        args_ = (e["word"].to(dt), e["position"][2:2 + s].to(dt),
                 e["type"].to(dt), e["ln_scale"], e["ln_bias"],
                 ids.to(dev, torch.int32), tids.to(dev, torch.int32),
                 s, 1e-5)
        got = K.embed_lookup(*args_)
        want = K.embed_lookup_reference(*args_)
        check = Checker()
        if dt == torch.bfloat16:
            check.exact(f"embed_lookup {family} {m} x {H} bf16, "
                        "out-of-range ids", "embed_lookup", got,
                        want, bf16_ulps=1, floor=2.0 ** -16)
        else:
            check.rel(f"embed_lookup {family} {m} x {H} f32, "
                      "out-of-range ids", "embed_lookup", got, want,
                      1e-5)
    bad_ids = ids.clone()
    bad_ids[5] = vocab + 8 + (-vocab % 8)
    got = K.embed_lookup(*args_[:5], bad_ids.to(dev, torch.int32),
                         *args_[6:])
    nan_rows = torch.isnan(got.float()).any(dim=1).nonzero().flatten()
    log(f"[pretrained] embed_lookup {family}: an id past the "
        f"padding gives NaN rows {nan_rows.tolist()}")
    if nan_rows.tolist() != [5]:
        raise AssertionError("embed_lookup: an id past the padding "
                             "does not give its NaN row alone")


def xlmr_trainer_steps(dev, card: str, memory, req, stok, kcfg, params,
                       tmp):
    """Two ``Trainer`` steps at XLM-R-base (``family="xlm-roberta"``,
    double separator, 4 micros of 32 x 256 under the 8192-token budget) on
    ``req`` packed by ``stok``; prints the step time, the peak memory and
    BertAdam's share.  Returns the steps' launch counts."""
    import dataclasses

    from nbest_asr_tpu_torch.config import RunOptions
    from nbest_asr_tpu_torch.data.dataset import RawSplit
    from nbest_asr_tpu_torch.data.input_builder import pack_split
    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.train.loop import Trainer
    from nbest_asr_tpu_torch.train.optimizer import apply_updates, tree_map

    seqs = [u.split() for u in req]
    lab_rng = np.random.RandomState(11)
    names = [memory.idx2label[i] for i in range(2, memory.n_bottom)]
    labels = [[names[lab_rng.randint(len(names))]] for _ in seqs]
    packed = pack_split(RawSplit(seqs, seqs, labels), stok, memory,
                        max_len=BUCKETS[-1])
    if int((packed.input_ids == 2).sum(1).max()) < 3:
        raise AssertionError("xlm-roberta rows lack the double "
                             "separator")
    topt = RunOptions(dataset="dstc2", dataroot="unused",
                      batchSize=32, n_layers=LAYERS, max_epoch=1,
                      lr=1e-4, bert_lr=1e-4, length_buckets="256",
                      token_budget=8192,
                      experiment=os.path.join(tmp, "xlmr"))
    topt.exp_dir = topt.experiment
    tcfg = dataclasses.replace(kcfg, encoder=dataclasses.replace(
        kcfg.encoder, use_fused_attn_eval=False))
    trainer = Trainer(topt, memory, tcfg, params, {"train": packed},
                      family="xlm-roberta", device=dev)
    params.clear()      # the Trainer holds them: free them with its steps
    bucket = trainer.buckets["train"][0]
    micro = trainer._bucket_micro_batch(bucket)
    n_acc = topt.n_accum_steps
    idx = [torch.arange(i * n_acc * micro, (i + 1) * n_acc * micro,
                        device=dev).reshape(n_acc, micro)
           for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    times = []
    for i in range(2):
        t0 = time.perf_counter()
        trainer.state, stats = trainer.train_step(
            trainer.state, bucket.data, idx[i], trainer._gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    c = dict(_cuda.launch_counts)
    expect_launches(f"xlm-roberta Trainer, 2 steps of {n_acc} x {micro} "
                    "rows", c, {k: 2 * n_acc * LAYERS * PER_LAYER_TRAIN.get(
                        k, 0) for k in c})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = {k: float(v) for k, v in stats["loss"].items()}
    st = trainer.state
    zeros = tree_map(torch.zeros_like, st.params)

    def adam():
        u, _ = trainer.optimizer.update(zeros, st.opt_state,
                                        st.params)
        apply_updates(st.params, u)

    adam_ms = cuda_ms(adam, iters=3, warmup=1)
    log(f"[pretrained] xlm-roberta Trainer step ({n_acc} micros x "
        f"{micro} x {BUCKETS[-1]}, vocab {XLMR_VOCAB}): "
        f"{times[1] * 1e3:.2f} ms (first {times[0] * 1e3:.2f}), "
        f"peak {peak:.2f} GiB, BertAdam {adam_ms:.2f} ms = "
        f"{adam_ms / (times[1] * 1e3):.1%} of the step; loss "
        f"{loss} [{card}]")
    if not all(np.isfinite(v) for v in loss.values()):
        raise AssertionError("xlm-roberta: a loss part is not finite")
    return c


def pretrained_roberta_xlmr(dev, card: str, memory, tmp):
    """Phase 14 (c): RoBERTa-base and XLM-R-base checkpoints written into
    ``tmp`` from a seed, read back, served and held to the plain path,
    ``embed_lookup`` at their vocabs with out-of-range ids, two XLM-R
    Trainer steps.  Returns the counted runs' launch counts."""
    import dataclasses

    from nbest_asr_tpu_torch.models.heads import init_head_params
    from nbest_asr_tpu_torch.models.hf_convert import load_pretrained_encoder
    from nbest_asr_tpu_torch.models.model import ModelConfig
    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.serve import Predictor
    from nbest_asr_tpu_torch.train.optimizer import tree_map

    counts = {k: 0 for k in _cuda.KERNELS}
    arrays = memory.arrays()
    req = requests(memory, seed=7)[-1]
    for family, vocab, fmt in (("roberta", ROBERTA_VOCAB, "bin"),
                               ("xlm-roberta", XLMR_VOCAB,
                                "safetensors")):
        path = os.path.join(tmp, family)
        t0 = time.perf_counter()
        sd = roberta_checkpoint(path, family, vocab, seed=8, fmt=fmt)
        w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ecfg, eparams = load_pretrained_encoder(path)
        r_s = time.perf_counter() - t0
        word = eparams["embeddings"]["word"]
        ok = (torch.equal(word, sd["roberta.embeddings.word_embeddings."
                                   "weight"])
              and torch.equal(eparams["layers"]["ffn_out_kernel"][-1],
                              sd[f"roberta.encoder.layer.{LAYERS - 1}."
                                 "output.dense.weight"].t()))
        log(f"[pretrained] {family}: {fmt} written in {w_s:.2f} s, read "
            f"and converted in {r_s:.2f} s; vocab {ecfg.vocab_size}, "
            f"positions {ecfg.max_position}, offset "
            f"{ecfg.position_offset}, types {ecfg.type_vocab_size}, eps "
            f"{ecfg.layer_norm_eps}; tensors as written: {ok}")
        if not ok or (ecfg.position_offset, ecfg.type_vocab_size,
                      ecfg.layer_norm_eps) != (2, 1, 1e-5):
            raise AssertionError(f"{family}: checkpoint not read as "
                                 "written")
        del sd
        stok = StandInTokenizer(memory, family == "xlm-roberta")
        kcfg = ModelConfig(
            encoder=dataclasses.replace(
                ecfg, compute_dtype="bfloat16", use_fused_attn=True,
                use_fused_ffn=True, use_fused_attn_eval=True,
                use_flash_attention=True),
            n_top=memory.n_top, n_bottom=memory.n_bottom)
        params = tree_map(lambda t: t.to(dev), {
            "encoder": eparams,
            "head": init_head_params(torch.Generator().manual_seed(9), H,
                                     memory.n_top, memory.n_bottom)})
        plain = dataclasses.replace(kcfg, encoder=dataclasses.replace(
            kcfg.encoder, use_fused_attn=False, use_fused_ffn=False,
            use_fused_attn_eval=False, use_flash_attention=False))
        f32 = dataclasses.replace(plain, encoder=dataclasses.replace(
            plain.encoder, compute_dtype="float32"))
        segs = family == "roberta"     # segment id 1 into one type row
        kw = dict(device=dev, batch_size=BATCH, max_len=BUCKETS[-1],
                  quantize="none", use_segments=segs)
        kp, pp, fp = (Predictor(params, c_, memory, stok, **kw)
                      for c_ in (kcfg, plain, f32))
        kp.predict(req[:BATCH])
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        kp.predict(req)
        torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        c = dict(_cuda.launch_counts)
        n_b = len(req) // BATCH
        expect_launches(f"{family} Predictor, {n_b} batches", c,
                        {k: n_b * LAYERS * PER_LAYER.get(k, 0) for k in c})
        add_counts(counts, c)
        log(f"[pretrained] {family} predict {len(req)} utterances: "
            f"{p_s * 1e3:.2f} ms [{card}]")
        serve_held(family, kp, pp, fp, req, arrays, segs)
        del kp, pp, fp

        hold_embed_out_of_range(dev, family, vocab, eparams["embeddings"])
        if family == "xlm-roberta":
            add_counts(counts, xlmr_trainer_steps(dev, card, memory, req,
                                                  stok, kcfg, params, tmp))
        del params, eparams
    return counts


def phase_pretrained(dev, card: str):
    """The pretrained path on the card, bf16, the blocks' kernels, in a
    temporary directory holding phase 13's synthetic dataroot and a BERT
    tokenizer: (a) MLM at BERT-base width and its export, (b) the export
    fine-tuned through ``cli.main --tod_pre_trained_model``, (c)
    RoBERTa-base and XLM-R-base checkpoints read, served and (XLM-R)
    trained.  Returns the launch counts of its main-path runs (the MLM
    steps, the CLI's two epochs, the two Predictors' counted requests,
    the XLM-R Trainer's steps)."""
    import tempfile

    from nbest_asr_tpu_torch.ops import _cuda

    counts = {k: 0 for k in _cuda.KERNELS}
    memory = dstc2_like_memory()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "dataroot")
        write_dataroot(root, memory)
        ckpt = os.path.join(tmp, "mlm_ckpt")
        write_bert_tokenizer(ckpt, memory)
        c, renc = pretrained_mlm(dev, card, memory, root, ckpt)
        add_counts(counts, c)
        add_counts(counts, pretrained_finetune(dev, card, root, ckpt, renc))
        del renc
        add_counts(counts, pretrained_roberta_xlmr(dev, card, memory, tmp))
    return counts


# --------------------------------------------------------------------- #
# multi-process training (phase 15): NCCL at a world of 1, two ranks
# sharing the card over gloo (dp = 2 direct, then tp = 2), NCCL across
# cards where there are two
# --------------------------------------------------------------------- #

# (b): a batch that holds each length bucket of phase 13's dataroot whole
# (its largest bucket has ~400 of 1024 rows), so that every step of the
# direct mode's two ranks trains on the rows of one process's step (a
# rank's rows of a global micro are its own shard's, process_data.py)
MP_BASE = ["--dataset", "dstc2", "--n_layers", str(CLI_LAYERS), "--n_head",
           str(NH), "--bert_dropout", "0", "--dropout", "0",
           "--length_buckets", "64,96,160,256", "--token_budget", "8192",
           "--max_epoch", "1"]
MP_DIRECT = MP_BASE + ["--compute_dtype", "bfloat16", "--batchSize", "512",
                       "--data_mode", "direct"]
# (c): f32, where tp = 2 and tp = 1 differ by summation order alone
MP_TP = MP_BASE + ["--compute_dtype", "float32", "--batchSize", "32"]
MP_TP_PLAIN = ["--no_fused_attn", "--no_fused_ffn", "--no_flash_attention"]
MP_TIMEOUT_S = 300


class _recorded_cli:
    """Within the block ``cli.main``'s Trainer records each epoch's
    metrics in ``epochs`` and itself in ``trainers``."""

    def __init__(self):
        self.epochs, self.trainers = [], []

    def __enter__(self):
        from nbest_asr_tpu_torch.train.loop import Trainer

        self.saved = (Trainer.run_train_epoch, Trainer.run_eval_epoch,
                      Trainer.train)
        run_train, run_eval, train = self.saved
        rec = self

        def train_epoch(self):
            m = run_train(self)
            rec.epochs.append(("train", mp_metrics(m)))
            return m

        def eval_epoch(self, split, *a, **kw):
            m, info = run_eval(self, split, *a, **kw)
            rec.epochs.append((split, mp_metrics(m)))
            return m, info

        def record(self, *a, **kw):
            rec.trainers.append(self)
            return train(self, *a, **kw)

        Trainer.run_train_epoch, Trainer.run_eval_epoch, Trainer.train = \
            train_epoch, eval_epoch, record
        return self

    def __exit__(self, *exc):
        from nbest_asr_tpu_torch.train.loop import Trainer

        Trainer.run_train_epoch, Trainer.run_eval_epoch, Trainer.train = \
            self.saved


def mp_metrics(m):
    return [m.mean_loss, m.precision, m.recall, m.f1, m.acc]


def mp_digests(params):
    """sha256 of each leaf's bytes (a flat dict)."""
    import hashlib

    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        else:
            out[path] = hashlib.sha256(
                t.detach().cpu().contiguous().view(torch.uint8).numpy()
            ).hexdigest()

    walk(params, "")
    return out


def mp_run(argv, dev, counts_too=False):
    """``cli.main(argv)`` here, recorded: -> (epochs, the Trainer, wall s,
    launch counts)."""
    from nbest_asr_tpu_torch import cli
    from nbest_asr_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    with _recorded_cli() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli.main(argv, device=dev) != 0:
            raise AssertionError(f"cli.main {argv} returned an error")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return rec.epochs, rec.trainers[-1], wall, dict(_cuda.launch_counts)


def mp_worker(rank: int, world: int, d: str) -> int:
    """One rank of phases 15 (b) to (d), started by ``mp_ranks``: joins
    the group (``spec.json``: gloo on the one card, or NCCL on card
    ``rank``), runs each of the spec's ``cli.main`` command lines, and
    writes its epochs, launch counts, wall seconds, parameter digests and
    the all-reduce's ms to ``out<rank>.json`` (rank 0: its parameters to
    ``params<run>.pt`` too)."""
    import datetime

    import torch.distributed as dist

    from nbest_asr_tpu_torch.parallel.mesh import (gather_params,
                                                   reduce_from_tp)
    from nbest_asr_tpu_torch.parallel.train_step import all_reduce_grads
    from nbest_asr_tpu_torch.train.optimizer import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(d, "spec.json")) as fp:
        spec = json.load(fp)
    dev = torch.device("cuda", rank if spec["backend"] == "nccl" else 0)
    torch.cuda.set_device(dev)
    kw = {"device_id": dev} if spec["backend"] == "nccl" else {}
    dist.init_process_group(
        spec["backend"], init_method="file://" + os.path.join(d, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MP_TIMEOUT_S - 60), **kw)
    out = {}
    try:
        for name, argv in spec["runs"]:
            argv = argv + spec["rank_argv"].get(f"{name}/{rank}", [])
            epochs, tr, wall, counts = mp_run(argv, dev)
            full = gather_params(tr.state.params, tr.mesh,
                                 tr.cfg.encoder.vocab_size)
            if rank == 0:
                torch.save(_cpu_tree(full), os.path.join(d, f"params_{name}"
                                                         ".pt"))
            if tr.mesh.tp_size == 1:    # the step's gradient all-reduce
                grads = [torch.zeros_like(p) for p in
                         tree_leaves(tr.state.params)]
                ar_ms = cuda_ms(lambda: all_reduce_grads(
                    grads, tr.mesh.dp_group), iters=5, warmup=1)
            else:                       # one tp all-reduce of a micro
                y = torch.zeros(128 * 64, H, device=dev)
                ar_ms = cuda_ms(lambda: reduce_from_tp(y, tr.mesh), iters=5,
                                warmup=1)
            out[name] = dict(epochs=epochs, counts=counts, wall=wall,
                             digests=mp_digests(full), ar_ms=ar_ms,
                             micros=plan_counts(tr)[0],
                             mesh=[tr.mesh.dp_size, tr.mesh.tp_size])
            del tr, full
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(d, f"out{rank}.json"), "w") as fp:
        json.dump(out, fp)
    return 0


def mp_ranks(d: str, world: int, backend: str, runs, rank_argv):
    """Start ``world`` ranks of this script (``--mp-rank``), wait for all
    (each must exit 0 within MP_TIMEOUT_S), -> their outputs."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "spec.json"), "w") as fp:
        json.dump(dict(backend=backend, runs=runs, rank_argv=rank_argv), fp)
    logs = [open(os.path.join(d, f"log{r}"), "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mp-rank", str(r),
         str(world), d], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        rcs = [p.wait(timeout=MP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log_fp in logs:
            log_fp.close()
    for r, rc in enumerate(rcs):
        if rc != 0:
            with open(os.path.join(d, f"log{r}")) as fp:
                tail = fp.read()[-4000:]
            raise AssertionError(f"phase 15: rank {r} of {world} "
                                 f"({backend}) exited {rc}:\n{tail}")
    outs = []
    for r in range(world):
        with open(os.path.join(d, f"out{r}.json")) as fp:
            outs.append(json.load(fp))
    return outs


def mp_hold_epochs(what, got, want, rtol, cols=None):
    """Each epoch line of ``got`` against ``want`` (train / valid / test:
    loss, P, R, F1, Acc; ``cols`` picks some) within ``rtol``."""
    worst = 0.0
    if [k for k, _ in got] != [k for k, _ in want]:
        raise AssertionError(f"{what}: epochs {got} against {want}")
    for (split, g), (_, w) in zip(got, want):
        for i in (cols or range(len(w))):
            rel = abs(g[i] - w[i]) / max(abs(w[i]), 1e-12)
            worst = max(worst, rel)
            if rel > rtol:
                raise AssertionError(
                    f"{what}: {split} metric {i} {g[i]!r} against "
                    f"{w[i]!r} (rel {rel:.2e} > {rtol})")
    return worst


def mp_nccl_world1(dev, card, rig):
    """(a): three ``make_train_step`` steps over a one-rank NCCL mesh
    beside three without it (A B B A), BERT-base 12 layers, bf16, both
    blocks, dropout 0, n_accum 2, bucket 64: bit-equal parameters and the
    blocks' launches by the plan in each run; the step's gradient
    all-reduce timed.  -> the first mesh run's launch counts."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.parallel.mesh import make_mesh
    from nbest_asr_tpu_torch.parallel.train_step import (TrainState,
                                                         all_reduce_grads,
                                                         make_train_step)
    from nbest_asr_tpu_torch.train.losses import LossConfig
    from nbest_asr_tpu_torch.train.optimizer import (OptimizerConfig,
                                                     make_optimizer,
                                                     tree_leaves)

    cfg = rig["cfg"]
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, hidden_dropout=0.0, attn_dropout=0.0,
        use_fused_ffn=True, use_fused_attn=True))
    data, micro = rig["data"][64], TRAIN_MICRO[64]
    idx = np.arange(N_ACCUM * micro).reshape(N_ACCUM, micro) % \
        data["input_ids"].shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tmp, "store"), rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_mesh(n_data=1, n_model=1)
            runs = []
            for name, m in (("no mesh", None), ("NCCL mesh", mesh),
                            ("NCCL mesh", mesh), ("no mesh", None)):
                params = rig["params"]
                opt = make_optimizer(OptimizerConfig(**GATE_OPT), params, m)
                step = make_train_step(cfg, LossConfig(), opt, rig["hier"],
                                       n_accum=N_ACCUM, dual_stream=False,
                                       mesh=m)
                state = TrainState(params, opt.init(params), 0)
                gen = torch.Generator().manual_seed(3)
                _cuda.reset_launch_counts()
                ms = []
                for _ in range(TRAIN_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, stats = step(state, data, idx, gen)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                runs.append((name, state.params, dict(_cuda.launch_counts),
                             ms, float(stats["loss"]["total"])))
            grads = [torch.zeros_like(p) for p in tree_leaves(rig["params"])]
            ar_ms = cuda_ms(lambda: all_reduce_grads(grads, mesh.dp_group),
                            iters=10)
            numel = sum(g.numel() for g in grads)
        finally:
            dist.destroy_process_group()
    want = {k: TRAIN_STEPS * N_ACCUM * LAYERS * PER_LAYER_TRAIN.get(k, 0)
            for k in _cuda.KERNELS}
    d0 = mp_digests(runs[0][1])
    diffs = []
    for name, params, c, ms, loss in runs:
        d = mp_digests(params)
        diffs += [f"{name}: {k}" for k in d0 if d0[k] != d[k]]
        if c != want:
            raise AssertionError(f"phase 15 (a) {name}: launches {c}, "
                                 f"expected {want}")
    log(f"[mp] (a) NCCL world 1, {LAYERS} layers bf16 both blocks, "
        f"{TRAIN_STEPS} steps of {N_ACCUM} x {micro} x 64, runs A B B A: "
        + "; ".join(f"{name} step ms {[round(x, 2) for x in ms]} loss "
                    f"{loss:.6f}" for name, _, _, ms, loss in runs)
        + f"; {len(diffs)} leaves differ from the first run's; launches "
        f"by the plan in each; gradient all-reduce ({numel} f32 in "
        f"{-(-numel // 2 ** 25)} buffers, NCCL, one rank) {ar_ms:.3f} ms "
        f"a step [{card}]")
    if diffs:
        raise AssertionError(f"phase 15 (a): the one-rank mesh's params "
                             f"differ: {diffs[:8]}")
    return runs[1][2]


def phase_multiprocess(dev, card: str, rig):
    """Phase 15 (module docstring); -> the launch counts of its main-path
    runs in this process ((a)'s mesh run and (b)'s one-process run)."""
    import tempfile

    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.train.optimizer import tree_leaves

    torch.cuda.empty_cache()    # the rank processes share the card
    t0 = time.perf_counter()
    counts = mp_nccl_world1(dev, card, rig)
    wall = {"a": time.perf_counter() - t0}
    memory = dstc2_like_memory()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "dataroot")
        write_dataroot(root, memory)

        def argv(base, name, extra=()):
            return base + list(extra) + ["--dataroot", root, "--experiment",
                                         os.path.join(tmp, name)]

        # ---- the one-process references, here ------------------------ #
        t0 = time.perf_counter()
        b_ref, b_tr, b_wall, b_counts = mp_run(argv(MP_DIRECT, "b1"), dev)
        add_counts(counts, b_counts)
        b_params = _cpu_tree(b_tr.state.params)
        b_files = sorted(os.listdir(b_tr.opt.exp_dir))
        micros, batches = plan_counts(b_tr)
        if micros != len(b_tr._shard.buckets):
            raise AssertionError(f"phase 15 (b): {micros} micros for "
                                 f"{len(b_tr._shard.buckets)} buckets: a "
                                 "bucket does not fit one batch")
        del b_tr
        c_ref, _, c_wall, c_counts = mp_run(
            argv(MP_TP, "c1", MP_TP_PLAIN), dev)
        if any(c_counts.values()):
            raise AssertionError(f"phase 15 (c) reference: kernels "
                                 f"launched on the plain route {c_counts}")
        wall["refs"] = time.perf_counter() - t0

        # ---- (b) and (c): two ranks sharing the card over gloo -------- #
        t0 = time.perf_counter()
        d = os.path.join(tmp, "gloo")
        outs = mp_ranks(d, 2, "gloo", [
            ("b", argv(MP_DIRECT, "b2")),
            ("c", argv(MP_TP, "c2", ["--n_model_parallel", "2"]))],
            {"b/1": ["--experiment", os.path.join(tmp, "b2_rank1")]})
        wall["b+c"] = time.perf_counter() - t0
        (b0, c0), (b1, c1) = [(o["b"], o["c"]) for o in outs]

        # (b): dp = 2 direct against one process
        rank1 = [f for _, _, fs in os.walk(os.path.join(tmp, "b2_rank1"))
                 for f in fs]
        (b_exp,) = [dp for dp, _, fs in os.walk(os.path.join(tmp, "b2"))
                    if "log.train" in fs]
        worst = max(mp_hold_epochs("phase 15 (b) rank %d" % r, o["epochs"],
                                   b_ref, 1e-4) for r, o in enumerate(
                                       (b0, b1)))
        if b0["digests"] != b1["digests"]:
            raise AssertionError("phase 15 (b): the two ranks' parameters "
                                 "differ")
        full = torch.load(os.path.join(d, "params_b.pt"), weights_only=True)
        dmax = max((a - b).abs().max().item() for a, b in zip(
            tree_leaves(full), tree_leaves(b_params)))
        want = {k: CLI_LAYERS * (micros * PER_LAYER_TRAIN.get(k, 0)
                                 + batches * PER_LAYER_EVAL.get(k, 0))
                for k in _cuda.KERNELS}
        for r, o in enumerate((b0, b1)):
            if o["counts"] != want or o["mesh"] != [2, 1]:
                raise AssertionError(
                    f"phase 15 (b) rank {r}: mesh {o['mesh']}, launches "
                    f"{o['counts']}, expected {want}")
        if rank1 or sorted(os.listdir(b_exp)) != b_files:
            raise AssertionError(f"phase 15 (b): rank 1 wrote {rank1}; rank "
                                 f"0's artifacts {sorted(os.listdir(b_exp))}"
                                 f" against one process's {b_files}")
        log(f"[mp] (b) dp = 2, --data_mode direct, gloo, two ranks sharing "
            f"one card (not a scaling figure): epoch metrics within "
            f"{worst:.2e} of one process's (<= 1e-4), the ranks' params "
            f"bit-equal, max |param - one process's| {dmax:.3e}; {micros} "
            f"micros of 256 rows a rank, launches a rank "
            f"{ {k: v for k, v in b0['counts'].items() if v} }; "
            f"rank 1 wrote nothing, rank 0 the one-process run's "
            f"{len(b_files)} files; cli.main {b0['wall']:.2f} s (one "
            f"process {b_wall:.2f} s); gradient all-reduce over gloo "
            f"{b0['ar_ms']:.3f} ms a step [{card}]")

        # (c): tp = 2 against tp = 1 on the plain route, f32
        worst = max(mp_hold_epochs("phase 15 (c) rank %d" % r, o["epochs"],
                                   c_ref, 2e-5, cols=[0])
                    for r, o in enumerate((c0, c1)))
        if c0["digests"] != c1["digests"] or c0["mesh"] != [1, 2]:
            raise AssertionError("phase 15 (c): the tp ranks' gathered "
                                 "parameters differ")
        if any(c0["counts"].values()) or any(c1["counts"].values()):
            raise AssertionError(f"phase 15 (c): a kernel launched under "
                                 f"tp = 2: {c0['counts']}")
        log(f"[mp] (c) tp = 2 (plain route, f32), gloo, two ranks sharing "
            f"one card (not a scaling figure): losses within {worst:.2e} of "
            f"tp = 1's (<= 2e-5); no kernel launched; cli.main "
            f"{c0['wall']:.2f} s (tp = 1: {c_wall:.2f} s); one tp "
            f"all-reduce of 8192 x {H} f32 over gloo {c0['ar_ms']:.3f} ms "
            f"[{card}]")
        for split, m in c0["epochs"]:
            log(f"[mp] (c) {split}: tp = 2 loss {m[0]:.6f} F1 {m[3]:.2f}; "
                f"tp = 1 {dict(c_ref)[split][0]:.6f} / "
                f"{dict(c_ref)[split][3]:.2f}")

        # (d): two ranks over NCCL, one a card
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            t0 = time.perf_counter()
            d0, d1 = [o["d"] for o in mp_ranks(
                os.path.join(tmp, "nccl"), 2, "nccl",
                [("d", argv(MP_DIRECT, "d2"))], {})]
            wall["d"] = time.perf_counter() - t0
            worst = max(mp_hold_epochs("phase 15 (d)", o["epochs"], b_ref,
                                       1e-4) for o in (d0, d1))
            if d0["digests"] != d1["digests"]:
                raise AssertionError("phase 15 (d): the ranks' parameters "
                                     "differ")
            log(f"[mp] (d) dp = 2 direct over NCCL on {n_cards} cards: epoch "
                f"metrics within {worst:.2e} of one process's; cli.main "
                f"{d0['wall']:.2f} s; gradient all-reduce {d0['ar_ms']:.3f} "
                f"ms a step [{card}]")
        else:
            log(f"[mp] (d) not run: NCCL refuses two ranks on one device, "
                f"and this machine's card count is {n_cards}")
    log(f"[mp] wall s {({k: round(v, 2) for k, v in wall.items()})} "
        f"[{card}]")
    return counts


# --------------------------------------------------------------------- #
# the offline path: raw DSTC2 logs -> ETL -> MLM pretraining with the
# port's own WordPiece vocab -> fine-tune under --remat --profile_dir
# --------------------------------------------------------------------- #

OFFLINE_SESSIONS, OFFLINE_STEPS, OFFLINE_LAYERS = 200, 30, 4
OFFLINE_ARGS = ["--dataset", "dstc2", "--compute_dtype", "bfloat16",
                "--bert_dropout", "0.1", "--length_buckets",
                "64,96,160,256", "--token_budget", "8192", "--batchSize",
                "32", "--max_epoch", "2", "--eval_artifacts", "none",
                "--save_best", "none"]
# a training layer's forward launches on both blocks' kernels, which a
# --remat recompute launches once more in the backward (= PER_LAYER)
PER_LAYER_TRAIN_FWD = dict(PER_LAYER)
# the device kernels each wrapper launches, by their csrc/ ``__global__``
# names (held to csrc/ by ``csrc_kernel_names``); the three bf16 GEMM
# wrappers launch one kernel, which a trace cannot tell apart
DEVICE_KERNELS = {
    "gemm_bias_act": ("gemm_tma_kernel",),
    "gemm_bias_residual": ("gemm_tma_kernel",),
    "gemm_dgrad": ("gemm_tma_kernel",),
    "layer_norm": ("layer_norm_kernel",),
    "ffn_bwd_rows": ("ffn_bwd_rows_kernel",),
    "seg_attention": ("seg_attn_wgmma_kernel", "seg_attention_kernel"),
    "seg_attention_bwd": ("dq_wgmma_kernel", "dkv_wgmma_kernel",
                          "dq_kernel", "dkv_kernel"),
}
DSTC2_VALUES = {
    "food": ["chinese", "indian", "thai", "italian", "modern european",
             "north american", "dontcare"],
    "area": ["north", "south", "east", "west", "centre", "dontcare"],
    "pricerange": ["cheap", "moderate", "expensive", "dontcare"],
    "name": ["the golden wok", "pizza hut", "saigon city"],
}
DSTC3_VALUES = {"childrenallowed": ["true", "false"],
                "hasinternet": ["true", "false"],
                "hastv": ["true", "false"]}
DSTC2_REQUESTS = ["phone", "addr", "postcode", "food", "area", "pricerange",
                  "signature"]
DSTC2_WORDS = ("i want a restaurant in the part of town serving food what "
               "is phone number and address thank you goodbye uh um yes "
               "no looking for something else any how about okay").split()


def write_dstc2_sessions(data_dir, n_sessions: int, seed: int,
                         dstc3: bool = False) -> dict:
    """DSTC2's raw layout under ``data_dir``: ``scripts/config/
    dstc2_{train,dev,test}.flist`` (70 / 15 / 15% of the sessions) and
    ``ori_data/<session>/{log,label}.json``, 1-8 turns a session, from
    ``seed``.  System turns carry compound acts (``reqalts``, ``reqmore``,
    ``thankyou``), request slots (``["slot", s]``) and value slots
    (``addr``, ``pricerange``; DSTC3's ``childrenallowed``, ``hasinternet``,
    ``hastv`` with ``dstc3``); user turns 0-3 acts (inform, request,
    confirm, deny, reqalts, thankyou, affirm, negate, bye, ...) over 1-10
    ASR hypotheses, some empty; about 1 turn in 10 has no user act and 1
    in 20 an empty system transcript, turns the ETL drops.  -> the turns
    it keeps per split: {"train": n, "valid": n, "test": n}."""
    rng = np.random.RandomState(seed)
    values = dict(DSTC2_VALUES, **(DSTC3_VALUES if dstc3 else {}))
    slots = sorted(values)

    def words(n):
        return [DSTC2_WORDS[i] for i in rng.randint(0, len(DSTC2_WORDS), n)]

    def slot_value():
        s = slots[rng.randint(len(slots))]
        return s, values[s][rng.randint(len(values[s]))]

    def sys_act():
        k = rng.randint(7)
        if k == 0:
            return {"act": "request", "slots": [["slot", DSTC2_REQUESTS[
                rng.randint(len(DSTC2_REQUESTS))]]]}
        if k in (1, 2):
            return {"act": ["reqmore", "reqalts", "thankyou", "welcomemsg",
                            "repeat"][rng.randint(5)], "slots": []}
        if k == 3:
            return {"act": "inform", "slots": [
                ["addr", " ".join(words(3))], list(slot_value())]}
        return {"act": ["offer", "expl-conf", "impl-conf", "canthelp"][
            rng.randint(4)], "slots": [list(slot_value())]}

    def user_act():
        k = rng.randint(6)
        if k < 2:
            s, v = slot_value()
            return {"act": ["inform", "confirm", "deny"][rng.randint(3)],
                    "slots": [[s, v]]}
        if k == 2:
            return {"act": "request", "slots": [["slot", DSTC2_REQUESTS[
                rng.randint(len(DSTC2_REQUESTS))]]]}
        return {"act": ["reqalts", "thankyou", "affirm", "negate", "bye",
                        "hello", "reqmore", "ack"][rng.randint(8)],
                "slots": []}

    names = [f"voip-{seed:04x}{i:05d}" for i in range(n_sessions)]
    cut = (int(0.7 * n_sessions), int(0.85 * n_sessions))
    splits = {"train": names[:cut[0]], "dev": names[cut[0]:cut[1]],
              "test": names[cut[1]:]}
    os.makedirs(os.path.join(data_dir, "scripts", "config"))
    kept = {}
    for split, sessions in splits.items():
        with open(os.path.join(data_dir, "scripts", "config",
                               f"dstc2_{split}.flist"), "w") as fp:
            fp.write("".join(f"Mar13_S0A0/{s}\n" for s in sessions))
        n_kept = 0
        for sid in sessions:
            log_turns, label_turns = [], []
            for t in range(1 + rng.randint(8)):
                sys_text = "" if rng.rand() < 0.05 else " ".join(
                    words(3 + rng.randint(10)))
                acts = [user_act() for _ in range(
                    0 if rng.rand() < 0.1 else 1 + rng.randint(3))]
                said = " ".join(words(2 + rng.randint(8)))
                hyps = [" " if rng.rand() < 0.15 else " ".join(
                    said.split()[:1 + rng.randint(8)] + words(
                        rng.randint(3))) for _ in range(1 + rng.randint(10))]
                log_turns.append({
                    "turn-index": t,
                    "output": {"transcript": sys_text, "dialog-acts": [
                        sys_act() for _ in range(1 + rng.randint(3))]},
                    "input": {"batch": {"asr-hyps": [
                        {"asr-hyp": h, "score": -float(i)}
                        for i, h in enumerate(hyps)]}}})
                label_turns.append({"turn-index": t, "transcription": said,
                                    "semantics": {"json": acts}})
                n_kept += bool(acts) and bool(sys_text)
            sdir = os.path.join(data_dir, "ori_data", "Mar13_S0A0", sid)
            os.makedirs(sdir)
            with open(os.path.join(sdir, "log.json"), "w") as fp:
                json.dump({"session-id": sid, "turns": log_turns}, fp)
            with open(os.path.join(sdir, "label.json"), "w") as fp:
                json.dump({"session-id": sid, "turns": label_turns}, fp)
        kept["valid" if split == "dev" else split] = n_kept
    return kept


def csrc_kernel_names() -> set:
    """The ``__global__`` functions' names in the port's csrc/*.cu."""
    import re

    names = set()
    for path in glob.glob(os.path.join(REPO, "nbest_asr_tpu_torch", "csrc",
                                       "*.cu")):
        with open(path) as fp:
            src = fp.read()
        for m in re.finditer(r"__global__\s+void\s+", src):
            i = m.end()
            if src.startswith("__launch_bounds__", i):   # skip its (...)
                i, depth = src.index("(", i), 0
                while True:
                    depth += {"(": 1, ")": -1}.get(src[i], 0)
                    i += 1
                    if depth == 0:
                        break
            names.add(re.match(r"\s*(\w+)", src[i:]).group(1))
    return names


def trace_kernel_name(event_name: str) -> str:
    """A trace's demangled kernel name (``void ns::k<...>(...)``) -> ``k``."""
    import re

    head = re.split(r"[<(]", event_name.replace("(anonymous namespace)::",
                                                ""), maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else ""


def offline_etl(tmp, card: str):
    """16 (a): the port's ``run_etl`` over OFFLINE_SESSIONS synthetic
    sessions -> the dataroot it wrote."""
    from nbest_asr_tpu_torch.data.dataset import read_sep_data
    from nbest_asr_tpu_torch.data.vocab import Memory
    from nbest_asr_tpu_torch.tools import run_etl

    raw_dir, out = os.path.join(tmp, "dstc2"), os.path.join(tmp, "etl")
    kept = write_dstc2_sessions(raw_dir, OFFLINE_SESSIONS, seed=16)
    t0 = time.perf_counter()
    if run_etl.main(["--data_dir", raw_dir, "--out_dir", out]) != 0:
        raise AssertionError("run_etl returned an error")
    etl_s = time.perf_counter() - t0
    root = os.path.join(out, "processed_data", "raw")
    got = {m: len(read_sep_data(os.path.join(root, m)))
           for m in ("train", "valid", "test")}
    mem = Memory.load(os.path.join(root, "memory.json"))
    arrays = mem.arrays()
    log(f"[offline] (a) run_etl: {OFFLINE_SESSIONS} sessions -> records "
        f"{got} (turns kept by the drop rule: {kept}); memory: "
        f"{len(mem.word2idx)} words, {mem.n_bottom} labels, {mem.n_top} "
        f"top groups ({int(arrays.is_multi_top.sum())} multi-bottom), "
        f"{len(mem.sysact2idx)} system-act tokens; {etl_s:.2f} s")
    if got != kept or "request" not in mem.sysact2idx \
            or "alternative" not in mem.sysact2idx:
        raise AssertionError("run_etl: the shards do not hold the turns "
                             "the drop rule keeps, or the compound acts "
                             "were not split")
    return root


def offline_pretrain(root, ckpt, card: str):
    """16 (b): ``pretrain_mlm`` at BERT-base width, OFFLINE_LAYERS deep,
    bf16, on ``root``'s train shard -> its launch counts."""
    import math

    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.tools import pretrain_mlm

    args = pretrain_mlm.parse_args([
        "--dataroot", root, "--out", ckpt, "--hidden", str(H),
        "--n_heads", str(NH), "--intermediate", str(INTER), "--n_layers",
        str(OFFLINE_LAYERS), "--steps", str(OFFLINE_STEPS), "--lr", "1e-3",
        "--log_every", "10"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    out = pretrain_mlm.run(args)
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, vocab = out["losses"], out["cfg"].vocab_size
    first, last = losses[0], float(np.mean(losses[-5:]))
    want = {k: OFFLINE_STEPS * OFFLINE_LAYERS * PER_LAYER_TRAIN.get(k, 0)
            for k in counts}
    log(f"[offline] (b) pretrain_mlm: vocab {vocab} (the port's WordPiece "
        f"trainer, padded to 128), batch rows {out['batch_sizes']}, "
        f"{OFFLINE_STEPS} steps at hidden {H}, {NH} heads, intermediate "
        f"{INTER}, {OFFLINE_LAYERS} layers, bf16: {out['step_ms']:.3f} ms a "
        f"step (CUDA events), loss {first:.4f} -> {last:.4f} (the last "
        f"five's mean; ln V {math.log(vocab):.3f}), peak {peak:.2f} GiB; "
        f"launches {counts}, expected {want} [{card}]")
    if counts != want or not all(counts[k] for k in PER_LAYER_TRAIN):
        raise AssertionError("pretrain_mlm: the kernels' launches differ "
                             "from steps x layers x PER_LAYER_TRAIN")
    if not (np.isfinite(losses).all() and abs(first - math.log(vocab)) < 1.0
            and last < first - 0.3):
        raise AssertionError("pretrain_mlm: the loss did not fall from ln V")
    return counts


def offline_finetune(dev, tmp, root, ckpt, card: str):
    """16 (c): ``cli.main`` from the export with --remat and --profile_dir
    on the native packer -> its launch counts."""
    from nbest_asr_tpu_torch import cli
    from nbest_asr_tpu_torch.data import native_loader
    from nbest_asr_tpu_torch.ops import _cuda

    if not native_loader.native_available():
        raise AssertionError("the native packer does not build here")
    packed = []
    pack = cli.pack_file_native

    def counted(path, *a, **kw):
        packed.append(os.path.basename(path))
        return pack(path, *a, **kw)

    prof = os.path.join(tmp, "profile")
    args = OFFLINE_ARGS + [
        "--dataroot", root, "--tod_pre_trained_model", ckpt,
        "--require_pretrained", "--remat", "--profile_dir", prof,
        "--experiment", os.path.join(tmp, "ft")]
    cli.pack_file_native = counted
    try:
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        if cli.main(args) != 0:
            raise AssertionError("cli.main --remat --profile_dir returned an "
                                 "error")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        cli.pack_file_native = pack
    counts = dict(_cuda.launch_counts)
    trainer, _ = cli_trainer(args, dev)
    micros, batches = plan_counts(trainer)
    epochs = int(OFFLINE_ARGS[OFFLINE_ARGS.index("--max_epoch") + 1])
    want = {k: OFFLINE_LAYERS * epochs * (
        micros * (PER_LAYER_TRAIN.get(k, 0) + PER_LAYER_TRAIN_FWD.get(k, 0))
        + batches * PER_LAYER_EVAL.get(k, 0)) for k in counts}
    del trainer
    traces = sorted(glob.glob(os.path.join(prof, "*.json")))
    if len(traces) != 1:
        raise AssertionError(f"--profile_dir wrote {traces}")
    with open(traces[0]) as fp:
        events = json.load(fp)["traceEvents"]
    kernels = [trace_kernel_name(e["name"]) for e in events
               if e.get("cat") == "kernel"]
    csrc_names = csrc_kernel_names()
    stale = {d for names in DEVICE_KERNELS.values() for d in names} - \
        csrc_names
    if stale or set(PER_LAYER_TRAIN) - set(DEVICE_KERNELS):
        raise AssertionError(f"DEVICE_KERNELS names no csrc kernel {stale}"
                             f" or misses a wrapper of PER_LAYER_TRAIN")
    # the traced epoch's training launches, by the set of device kernels
    # they launch: each launch runs one of its set at least once
    epoch = {k: OFFLINE_LAYERS * micros * (PER_LAYER_TRAIN.get(k, 0)
                                           + PER_LAYER_TRAIN_FWD.get(k, 0))
             for k in counts}
    by_set = {}
    for name, dev_names in DEVICE_KERNELS.items():
        by_set.setdefault(dev_names, []).append(name)
    seen = {"+".join(names): (sum(k in dev_names for k in kernels),
                              sum(epoch[n] for n in names))
            for dev_names, names in by_set.items()}
    log(f"[offline] (c) cli.main --tod_pre_trained_model --require_pretrained"
        f" --remat --profile_dir ({' '.join(OFFLINE_ARGS)}): {run_s:.2f} s; "
        f"native packer on {packed}; {micros} training micros and {batches} "
        f"eval batches an epoch; launches {counts}, expected {want} (the "
        f"recompute's forwards counted); trace {os.path.basename(traces[0])}"
        f" ({os.path.getsize(traces[0])} B, {len(kernels)} kernel events): "
        f"csrc kernels named {sorted(set(kernels) & csrc_names)}; (events, "
        f"training launches in the traced epoch) by the wrappers that share"
        f" device kernels {seen} [{card}]")
    if sorted(set(packed)) != ["test", "train", "valid"]:
        raise AssertionError("cli: the splits were not packed natively")
    if counts != want or not all(counts[k] for k in PER_LAYER_TRAIN):
        raise AssertionError("cli --remat: the kernels' launches differ "
                             "from the plan with the recompute")
    missing = {k: v for k, v in seen.items() if v[0] < v[1]}
    if missing or sum(epoch.values()) == 0:
        raise AssertionError(f"--profile_dir: the trace holds fewer kernel "
                             f"events than launches: {missing}")
    return counts


def offline_remat_step(dev, card: str, rig):
    """16 (d): one 12-layer BERT-base bf16 step (dropout 0.1, both blocks,
    N_ACCUM x 128 x 64) without and with ``remat`` from the same params
    and seed: an unmeasured step without remat gives the reference, then
    runs A B B A (without, with, with, without): the loss and every
    gradient bit-equal to the reference's, the forward launches doubled
    and the backward's unchanged; each step's ms (CUDA events) and its
    peak memory above what was allocated before it, over the forwards and
    backwards (read when the optimizer is handed the gradients) and over
    the whole step (BertAdam's update, whose new trees of the parameters'
    size remat does not touch, included); the first must fall."""
    import dataclasses

    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.parallel.train_step import (TrainState,
                                                         make_train_step)
    from nbest_asr_tpu_torch.train.losses import LossConfig
    from nbest_asr_tpu_torch.train.optimizer import (GradientTransformation,
                                                     OptimizerConfig,
                                                     make_optimizer,
                                                     tree_leaves)

    base = dataclasses.replace(rig["cfg"].encoder, use_fused_ffn=True,
                               use_fused_attn=True)
    data, micro = rig["data"][64], TRAIN_MICRO[64]
    idx = np.arange(N_ACCUM * micro).reshape(N_ACCUM, micro) % \
        data["input_ids"].shape[0]

    def one_step(remat):
        cfg = dataclasses.replace(rig["cfg"], encoder=dataclasses.replace(
            base, remat=remat))
        opt = make_optimizer(OptimizerConfig(**GATE_OPT), rig["params"])
        seen = {}

        def update(g, s, p):
            seen["grads"] = tree_leaves(g)
            seen["peak"] = torch.cuda.max_memory_allocated()
            return opt.update(g, s, p)

        step = make_train_step(cfg, LossConfig(), GradientTransformation(
            opt.init, update), rig["hier"], n_accum=N_ACCUM,
            dual_stream=False)
        state = TrainState(rig["params"], opt.init(rig["params"]), 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _cuda.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        _, stats = step(state, data, idx, torch.Generator().manual_seed(3))
        ev[1].record()
        torch.cuda.synchronize()
        return dict(remat=remat, ms=ev[0].elapsed_time(ev[1]),
                    fwd_bwd_peak=(seen["peak"] - held) / 2 ** 30,
                    peak=(torch.cuda.max_memory_allocated() - held) / 2 ** 30,
                    counts=dict(_cuda.launch_counts),
                    loss=stats["loss"]["total"].detach().clone(),
                    grads=seen["grads"])

    ref = one_step(False)
    runs, diffs = [], []
    for i, remat in enumerate((False, True, True, False)):
        r = one_step(remat)
        diffs += [f"run {i} grad {j}" for j, (a, b) in enumerate(
            zip(ref["grads"], r.pop("grads"))) if not torch.equal(a, b)]
        if not torch.equal(ref["loss"], r["loss"]):
            diffs.append(f"run {i} loss")
        runs.append(r)
    fwd_bwd = {k: N_ACCUM * LAYERS * PER_LAYER_TRAIN.get(k, 0)
               for k in _cuda.KERNELS}
    with_remat = {k: v + N_ACCUM * LAYERS * PER_LAYER_TRAIN_FWD.get(k, 0)
                  for k, v in fwd_bwd.items()}
    log(f"[offline] (d) one step of {N_ACCUM} x {micro} x 64, {LAYERS} "
        f"layers BERT-base bf16, dropout {DROPOUT}, both blocks, after one "
        f"unmeasured step without remat, runs A B B A (remat off, on, on, "
        f"off): " + "; ".join(
            f"remat {r['remat']}: step {r['ms']:.3f} ms (CUDA events), peak "
            f"above the held memory {r['fwd_bwd_peak']:.3f} GiB over the "
            f"forwards and backwards, {r['peak']:.3f} GiB over the step, "
            f"loss {float(r['loss']):.6f}" for r in runs)
        + f"; the loss and {len(ref['grads'])} gradients of each run "
        f"against the reference step's: {len(diffs)} differ; launches "
        f"without {runs[0]['counts']}, with {runs[1]['counts']} [{card}]")
    # one more step each way under torch.profiler: the summed durations of
    # its trace's kernel events (one stream) against the step's (profiled,
    # so slower) span say how much of remat's cost is device work
    import tempfile

    split = {}
    with tempfile.TemporaryDirectory() as tmp:
        for remat in (False, True):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                r = one_step(remat)
            path = os.path.join(tmp, f"remat_{remat}.json")
            prof.export_chrome_trace(path)
            with open(path) as fp:
                events = json.load(fp)["traceEvents"]
            split[remat] = (r["ms"], sum(e.get("dur", 0) for e in events
                                         if e.get("cat") == "kernel") / 1e3)
    log(f"[offline] (d) profiled steps: " + "; ".join(
        f"remat {k}: step {ms:.3f} ms, device kernels {dev_ms:.3f} ms"
        for k, (ms, dev_ms) in split.items())
        + f"; remat adds {split[True][0] - split[False][0]:.3f} ms of step "
        f"and {split[True][1] - split[False][1]:.3f} ms of device kernels "
        f"[{card}]")
    if diffs:
        raise AssertionError(f"remat: not bit-equal: {diffs[:8]}")
    for r in runs:
        if r["counts"] != (with_remat if r["remat"] else fwd_bwd):
            raise AssertionError("remat: the forward launches did not "
                                 "double, or a backward launch changed")
    if not max(r["fwd_bwd_peak"] for r in runs if r["remat"]) < \
            min(r["fwd_bwd_peak"] for r in runs if not r["remat"]):
        raise AssertionError("remat: the forwards' and backwards' peak "
                             "memory did not fall")


def phase_offline(dev, card: str, rig):
    """Phase 16: ETL -> pretraining -> fine-tune with --remat and
    --profile_dir, then the remat step; -> the launch counts of the
    pretraining's and the fine-tune's runs, summed."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = offline_etl(tmp, card)
        ckpt = os.path.join(tmp, "mlm_ckpt")
        counts = offline_pretrain(root, ckpt, card)
        add_counts(counts, offline_finetune(dev, tmp, root, ckpt, card))
    offline_remat_step(dev, card, rig)
    log(f"[offline] phase 16: {time.perf_counter() - t0:.2f} s [{card}]")
    return counts


def _cpu_tree(t):
    if isinstance(t, dict):
        return {k: _cpu_tree(v) for k, v in t.items()}
    return t.cpu()


def ptxas_summary(report):
    """One line per kernel instance of this process's nvcc build: source,
    demangled-ish name, registers, spill stores / loads."""
    import re

    out, entry, spill = [], None, ""
    for line in report:
        src, _, text = line.partition(": ")
        m = re.search(r"Compiling entry function '(\w+)'", text)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      text)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", text)
        if m and entry:
            # the kernel's name and template arguments, mangled:
            # gemm_i8_kernel ILi3E = <3>, seg_attention_kernel ILi64ELb1E =
            # <64, true>, quant_rows_kernel IfLb1E = <float, true>
            # (a length prefix may follow hash digits: try each suffix)
            name = entry
            for k in re.finditer(r"\d+", entry):
                for j in range(len(k.group())):
                    cand = entry[k.end():k.end() + int(k.group()[j:])]
                    if cand.endswith("_kernel"):
                        tail = re.match(r"I\w*?EE",
                                        entry[k.end() + len(cand):])
                        name = cand + (tail.group() if tail else "")
            out.append(f"{src} {name}: {m.group(1)} registers, {spill}")
            entry, spill = None, ""
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs the "
                           "port on an NVIDIA GPU and nowhere else")
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--mp-rank"]:      # one rank of phase 15
        return mp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    from nbest_asr_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 GEMMs in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _cuda.lib()
    log(f"[device] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{_cuda.build_seconds if _cuda.build_seconds is not None else 0:.2f}"
        f" s) -> {_cuda.library_path().name}")

    summary = ptxas_summary(_cuda.build_report)
    for line in summary:
        log(f"[device] ptxas {line}")
    # ptxas's notes on serialised wgmma or ignored setmaxnreg, if any (a
    # library built by an earlier process leaves no report)
    notes = [line for line in _cuda.build_report
             if any(k in line.partition(": ")[2] for k in _cuda.NOTE_KEYS)]
    for line in notes:
        log(f"[device] ptxas note {line}")
    log(f"[device] ptxas notes on wgmma / setmaxnreg: {len(notes)}"
        + ("" if _cuda.build_report else " (no build in this process)"))
    # the wgmma + TMA kernels' instances -- the GEMM's (bf16 and s8:
    # gemm_tma_kernel<S8, EPI, TRAIN>) and the tiled flash kernels'
    # (flash_fwd_wgmma_kernel, flash_dq_wgmma_kernel,
    # flash_dkv_wgmma_kernel <DROP>) -- must build without spills or such
    # notes, and so must the gradient row pass's (quant_grad_pass_kernel
    # <T, N>: a whole folded row in registers)
    tma_names = ("gemm_tma_kernel", "flash_fwd_wgmma_kernel",
                 "flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel",
                 "quant_grad_pass_kernel")
    tma = {n: [line for line in summary if n in line] for n in tma_names}
    bad = [line for lines in tma.values() for line in lines
           if "spills 0/0 B" not in line]
    bad += [line for line in notes
            if line.startswith(("gemm_wgmma.cu", "flash_attention.cu",
                                "flash_attention_bwd.cu"))]
    if _cuda.build_report and (bad or not all(tma.values())):
        raise AssertionError("the wgmma + TMA kernels or the gradient row "
                             "pass: spills or ptxas notes (or no instance "
                             f"reported): {bad}")

    phase_s = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = round(time.perf_counter() - t, 2)
        return out

    max_err, times = timed("kernels", phase_kernels, dev, card)
    counts = timed("slice", phase_slice, dev)
    t_err, t_times, t_bounds = timed("train_kernels", phase_train_kernels,
                                     dev, card)
    rig = timed("train_rig", train_rig, dev)
    t_counts, bf16_ms, _ = timed("train_bf16", phase_train, dev, card,
                                 t_times, rig, "bf16")
    i_counts, _, _ = timed("train_int8", phase_train, dev, card, t_times,
                           rig, "int8", beside=bf16_ms)
    f_err, f_times, f_bounds = timed("flash_kernels", phase_flash_kernels,
                                     dev, card)
    t_times.update(f_times)
    t_bounds.update(f_bounds)
    a_counts, _, _ = timed("train_flash", phase_train, dev, card, t_times,
                           rig, "flash", beside=bf16_ms)
    b_counts, _, _ = timed("train_long", phase_train_long, dev, card,
                           t_times)
    r_err, r_times, r_bounds = timed("rows_kernels", phase_rows_kernels,
                                     dev, card)
    t_times.update(r_times)
    t_bounds.update(r_bounds)
    c_counts, _, _ = timed("train_fused_rows", phase_train, dev, card,
                           t_times, rig, "fused_rows", beside=bf16_ms)
    l_counts = timed("cli", phase_cli, dev, card)
    p_counts = timed("pretrained", phase_pretrained, dev, card)
    m_counts = timed("multiprocess", phase_multiprocess, dev, card, rig)
    o_counts = timed("offline", phase_offline, dev, card, rig)
    log(f"[time] wall s by phase {phase_s}; from the build's start "
        f"{time.perf_counter() - t0:.2f} s")

    s_bounds = serving_bounds(BATCH * BUCKETS[-1], BATCH, BUCKETS[-1])
    rows = []

    def row(name, kernel, launches, k_ms, p_ms, l_ms, b_ms, b_by):
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[kernel],
            "replaces": KERNEL_REPLACES[kernel], "launches": launches,
            "max_abs_err": max(max_err.get(kernel, 0.0),
                               t_err.get(kernel, 0.0),
                               f_err.get(kernel, 0.0),
                               r_err.get(kernel, 0.0)),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms})

    for name in _cuda.KERNELS:
        launches = (counts[name] + t_counts[name] + i_counts[name]
                    + a_counts[name] + b_counts[name] + c_counts[name]
                    + l_counts[name] + p_counts[name] + m_counts[name]
                    + o_counts[name])
        if name in s_bounds:        # a serving layer's launches
            row(name, name, launches, *times[(name, BUCKETS[-1])],
                *s_bounds[name])
        else:                       # a training layer's launches
            row(name, name, launches, *t_times[name], *t_bounds[name])
    # the int8 training epilogues of the int8 serving kernels, timed in an
    # int8 training layer; launches: the int8 training runs alone
    for kernel in ("quantize_rows", "gemm_i8_bias_act",
                   "gemm_i8_bias_residual"):
        name = f"{kernel} [train]"
        row(name, kernel, i_counts[kernel], *t_times[name], *t_bounds[name])
    record = {"kernels": rows}
    log("[record] launches: the bf16 serving, int8 serving, route C "
        "serving, bf16 training (both blocks on kernels, then one FFN-only "
        "step), int8 training (NBEST_BENCH_INT8=2, then one "
        "NBEST_BENCH_INT8=1 step), flash route A (--no_fused_attn), "
        "long-sequence route B and route C (plain blocks, use_fused_ln, "
        "use_fused_gelu, use_fused_embedding) training main-path runs "
        "and the CLI's two epochs, and the pretrained phase's runs (MLM "
        "steps, the fine-tune's two epochs, the RoBERTa and XLM-R "
        "Predictors' requests, the XLM-R Trainer's steps), and the "
        "multi-process phase's runs in this process (the one-rank NCCL "
        "mesh's steps, the one-process direct-mode epoch), and the offline "
        "phase's (pretrain_mlm's steps, the --remat fine-tune's two epochs) "
        "together, the "
        "[train] rows the int8 "
        "training runs alone; "
        "ms / plain_ms / library_ms / bound_ms: one encoder layer's "
        f"launches of the kernel -- serving at batch {BATCH} x seq "
        f"{BUCKETS[-1]} for the kernels the serving path runs, training at "
        "8192 rows (batch 32 x seq 256, both blocks) for ffn_bwd_rows, "
        "gemm_dgrad, seg_attention_bwd, quantize_grad_rows, gemm_i8_dgrad "
        "and the [train] rows (int8 forwards and backwards), route B's "
        f"layer ({LONG_BATCH} x {LONG_SEQ}, d 64, dropout 0.1) for the "
        "flash_* rows, a training layer at 8192 rows (one micro for "
        "embed_lookup, f32 tables) for the five row kernels; ms and "
        "library_ms are device time (calls queued behind a sleep) for the "
        "five row kernels, gemm_bias_act, gemm_bias_residual, gemm_dgrad, "
        "seg_attention, seg_attention_bwd, the three flash kernels, "
        "layer_norm, ffn_bwd_rows and the int8 kernels (quantize_rows, "
        "quantize_grad_rows, the three int8 GEMMs, serving and [train]); "
        "BERT-base, "
        "bf16 activations; library_ms: the "
        "PyTorch call for each launch (serving_library_calls; torch.matmul "
        "for the dgrads; torch._int_mm for the int8 GEMMs and dgrads; "
        "F.scaled_dot_product_attention with the boolean segment mask and "
        "dropout: forward for flash_fwd, the backward alone (autograd.grad "
        "over a retained forward) for seg_attention_bwd, flash_bwd_dq and "
        "flash_bwd_dkv; F.layer_norm(x "
        "+ r) and its autograd backward; F.gelu(x + b) and its autograd "
        "backward; three F.embedding and F.layer_norm), null where "
        "PyTorch has none")
    log(json.dumps(record))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
