#!/bin/bash
# Offline generation and SUN evaluation (scripts/gen_eval.sh of the JAX
# package): ``python -m matinvent_tpu_torch.gen_eval`` with the same
# overrides, 32 batches x 32 = 1024 structures from a checkpoint, then
# metrics.json; with reference energies also relaxed and hull-scored.
#   matinvent_tpu_torch/scripts/gen_eval.sh <model_ckpt_dir> <output_dir> \
#       [reference.extxyz] [reference_energies.json]
set -euo pipefail

MODEL_PATH=${1:?usage: gen_eval.sh <model_ckpt_dir> <output_dir> [reference.extxyz] [reference_energies.json]}
OUTPUT=${2:?}
REFERENCE=${3:-}
ENERGIES=${4:-}
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"

ARGS=(
  "model=mattergen"
  "model.model_path=${MODEL_PATH}"
  "output_dir=${OUTPUT}"
  "batch_size=32"
  "num_batches=32"
)
if [[ -n "${REFERENCE}" ]]; then
  ARGS+=("reference_path=${REFERENCE}")
fi
if [[ -n "${ENERGIES}" ]]; then
  ARGS+=("reference_energies=${ENERGIES}" "relax=true")
fi

python -m matinvent_tpu_torch.gen_eval "${ARGS[@]}"
