#!/usr/bin/env bash
# Full pipeline launcher (reference component C29, run_all.slurm:30-48):
# stage 1 growth -> newest results/sim_<ts> -> stage 2 FEA pull test.
#
# The reference submits this through SLURM on a CPU cluster; here the same
# flow is one host process driving the attached GPU. Usage:
#   scripts/run_all.sh [--three-d] [extra `grow` flags...]
set -euo pipefail
cd "$(dirname "$0")/.."

python -m mycelium_tpu.cli grow --out results --snapshots csv "$@"

# newest-dir convention (run_all.slurm:33)
RESULT_DIR=$(ls -td results/sim_* | head -1)
echo "FEA on ${RESULT_DIR}"
python -m mycelium_tpu.cli fea "${RESULT_DIR}"
