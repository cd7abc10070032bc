#!/usr/bin/env bash
# Canonical training run of the PyTorch + CUDA port -- the twin of
# run/train_eval_nbest_asr_tpu.sh, with its flags: the parity surface with
# the reference's run/train_eval_N_Best_ASR_Transformer_STC.sh (bertadam,
# lr=bert_lr=3e-5, warmup 0.1, dropout 0.3/0.1, batch 16, max_norm 5.0,
# 50 epochs, seed 999, --add_segment_ids, coverage 1.0), bf16 with the
# length buckets.  No flag of the JAX script is TPU-only, so none is
# dropped.  Runs on cuda:0 (--deviceId N for cuda:N).
set -euo pipefail

DATAROOT=${1:?usage: $0 <dataroot> [seed]}
SEED=${2:-999}

python -m nbest_asr_tpu_torch.cli \
  --dataset dstc2 \
  --dataroot "${DATAROOT}" \
  --pre_trained_model bert \
  --add_segment_ids \
  --coverage 1.0 \
  --optim_choice bertadam \
  --lr 3e-5 --bert_lr 3e-5 \
  --warmup_proportion 0.1 \
  --dropout 0.3 --bert_dropout 0.1 \
  --batchSize 16 --max_norm 5.0 \
  --max_epoch 50 \
  --random_seed "${SEED}" \
  --compute_dtype bfloat16 \
  --length_buckets 64,96,160,256
