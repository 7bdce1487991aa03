#!/usr/bin/env bash
# Train with the PyTorch port (flexdm_tpu_torch): a timestamped job dir per run.
#   bin/train_flexdm_torch.sh [dataset] [extra --flags...]
# e.g. bin/train_flexdm_torch.sh crello --preset crello_ours_exp
# (add --device cpu for a run without a card).
set -e

# Flags-only invocation: keep the default dataset and forward everything.
if [[ "${1:-}" == -* ]]; then
    DATASET="crello"
    EXTRA=("$@")
else
    DATASET=${1:-"crello"}
    EXTRA=("${@:2}")
fi
NOW=$(date '+%Y%m%d%H%M%S')

DATA_DIR=${DATA_DIR:-"data/${DATASET}"}
JOB_DIR=${JOB_DIR:-"tmp/jobs/${DATASET}/${NOW}"}

echo "DATA_DIR=${DATA_DIR}"
echo "JOB_DIR=${JOB_DIR}"

python -m flexdm_tpu_torch \
    --dataset_name "${DATASET}" \
    --data_dir "${DATA_DIR}" \
    --job-dir "${JOB_DIR}" \
    "${EXTRA[@]}"
