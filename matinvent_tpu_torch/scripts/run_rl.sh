#!/bin/bash
# RL launch helper (scripts/run_rl.sh of the JAX package): nohup-launch
# ``python -m matinvent_tpu_torch.main`` with the same overrides, the log
# in logs/<expname>.log under the working directory.
#   matinvent_tpu_torch/scripts/run_rl.sh <expname> [extra overrides...]
set -euo pipefail

EXPNAME=${1:-test}
shift || true
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="${ROOT}${PYTHONPATH:+:${PYTHONPATH}}"

mkdir -p logs
nohup python -m matinvent_tpu_torch.main \
    expname="${EXPNAME}" \
    pipeline=mat_invent \
    model=mattergen \
    reward=hhi \
    logger=csv \
    "$@" \
    > "logs/${EXPNAME}.log" 2>&1 &
echo "launched ${EXPNAME} (pid $!) -> logs/${EXPNAME}.log"
