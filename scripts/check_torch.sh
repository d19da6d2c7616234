#!/usr/bin/env bash
# Pre-image quality gate of the PyTorch/CUDA port: kgct-torch-lint over the
# port package (empty-findings baseline, no allowlist), then the port's
# tests (tests/test_torch_*.py) on the CPU. docker/build_cuda.sh runs this
# before building the CUDA serving image, so that image never ships
# lint-dirty or test-broken code; run it alone before a push for the same
# signal. The port's tests import JAX only as their reference, hence
# JAX_PLATFORMS=cpu.
#
# Usage: scripts/check_torch.sh [--lint-only] [--changed GIT_REF]
#   --lint-only        skip the test run (seconds instead of minutes)
#   --changed GIT_REF  lint only the port's .py files touched vs GIT_REF
#                      (kgct-torch-lint --changed), same rules
#
# Artifacts: the SARIF findings document (${TMPDIR:-/tmp}/_kgct_torch_check.sarif)
# and the test log beside it, for CI to upload.
#
# Exit codes: 0 clean; non-zero on the first failing stage (pipefail: a
# tee'd pytest failure cannot launder its exit status).
set -euo pipefail

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
cd "${REPO_ROOT}"
OUT_DIR="${TMPDIR:-/tmp}"
LINT_ONLY=0
CHANGED_REF=""

while [[ $# -gt 0 ]]; do
  case "$1" in
    --lint-only) LINT_ONLY=1; shift ;;
    --changed) CHANGED_REF="${2:?--changed needs a git ref}"; shift 2 ;;
    *) echo "unknown arg: $1" >&2; exit 2 ;;
  esac
done

echo ">> kgct-torch-lint (empty-baseline gate)"
rm -f "${OUT_DIR}/_kgct_torch_check.sarif"
LINT_ARGS=(kubernetes_gpu_cluster_tpu_torch --sarif "${OUT_DIR}/_kgct_torch_check.sarif")
if [[ -n "${CHANGED_REF}" ]]; then
  LINT_ARGS+=(--changed "${CHANGED_REF}")
fi
python -m kubernetes_gpu_cluster_tpu_torch.analysis "${LINT_ARGS[@]}"

if [[ "${LINT_ONLY}" == 1 ]]; then
  echo ">> check_torch.sh: lint clean (tests skipped via --lint-only)"
  exit 0
fi

echo ">> the port's tests"
rm -f "${OUT_DIR}/_kgct_torch_check.log"
JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q -m 'not slow' \
  -p no:cacheprovider 2>&1 | tee "${OUT_DIR}/_kgct_torch_check.log"
rc=${PIPESTATUS[0]}
echo ">> check_torch.sh: lint clean, port tests rc=${rc}"
exit "${rc}"
