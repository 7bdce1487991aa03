#!/usr/bin/env bash
# Evaluate a job with the PyTorch port (flexdm_tpu_torch).
#   bin/eval_flexdm_torch.sh --job-dir tmp/jobs/crello/<ts> [--task_mode ...]
# (add --device cpu for a run without a card).
python -m flexdm_tpu_torch.evaluation "$@"
