#!/usr/bin/env bash
# The throughput training configuration of the PyTorch + CUDA port -- the
# twin of run/train_fast_tpu.sh, with its flags: everything
# train_eval_nbest_asr_tpu.sh runs, plus length buckets with the
# token-budget batch size per bucket (quality-validated in QUALITY.md on
# the JAX package).  No flag of the JAX script is TPU-only, so none is
# dropped.  Runs on cuda:0 (--deviceId N for cuda:N).
set -euo pipefail
DATAROOT=${1:?usage: $0 <dataroot> [seed]}
SEED=${2:-999}

python -m nbest_asr_tpu_torch.cli \
  --dataset dstc2 \
  --dataroot "${DATAROOT}" \
  --pre_trained_model bert \
  --add_segment_ids \
  --optim_choice bertadam \
  --lr 3e-5 --bert_lr 3e-5 \
  --warmup_proportion 0.1 \
  --dropout 0.3 --bert_dropout 0.1 \
  --batchSize 32 --max_norm 5.0 \
  --max_epoch 50 \
  --random_seed "${SEED}" \
  --compute_dtype bfloat16 \
  --length_buckets 64,96,160,256 \
  --token_budget 8192
