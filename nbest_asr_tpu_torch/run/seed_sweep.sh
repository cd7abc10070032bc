#!/usr/bin/env bash
# 5-seed measurement protocol of the PyTorch + CUDA port -- the twin of
# run/seed_sweep.sh (reference README.md:77: published numbers are the
# average of 5 runs with unique random seeds).
set -euo pipefail
DATAROOT=${1:?usage: $0 <dataroot>}
for SEED in 999 1000 1001 1002 1003; do
  "$(dirname "$0")/train_eval_nbest_asr_tpu.sh" "${DATAROOT}" "${SEED}"
done
