#!/usr/bin/env bash
# Build (and optionally push) the PyTorch/CUDA port's serving image:
#   ghcr.io/kgct/cuda-serving:<TAG>  (kubernetes_gpu_cluster_tpu_torch/deploy/
#                                     render.py DEFAULT_IMAGE)
#
# Usage: docker/build_cuda.sh [--push]
#   REGISTRY=ghcr.io/kgct TAG=v0.3.0 docker/build_cuda.sh
#
# Needs a docker host with network (the CUDA base images and the torch
# wheels are downloads); it needs no GPU: the image's kernel stage
# cross-compiles for sm_90a. The tag defaults to exactly what the port's
# renderer writes into every manifest, so a plain
# `docker/build_cuda.sh --push` makes the rendered deployment pullable.
set -euo pipefail

REGISTRY="${REGISTRY:-ghcr.io/kgct}"
TAG="${TAG:-v0.3.0}"
NAME="cuda-serving"
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
PUSH=0

while [[ $# -gt 0 ]]; do
  case "$1" in
    --push) PUSH=1; shift ;;
    *) echo "unknown arg: $1" >&2; exit 2 ;;
  esac
done

# Quality gate BEFORE the image build: kgct-torch-lint (empty baseline) +
# the port's tests (scripts/check_torch.sh). KGCT_SKIP_CHECKS=1 is the
# explicit, logged escape hatch; KGCT_CHECK_ARGS="--lint-only" keeps the
# gate but skips the test run.
if [[ "${KGCT_SKIP_CHECKS:-0}" != 1 ]]; then
  # shellcheck disable=SC2086
  "${REPO_ROOT}/scripts/check_torch.sh" ${KGCT_CHECK_ARGS:-}
else
  echo ">> WARNING: KGCT_SKIP_CHECKS=1 — building without lint/test gate" >&2
fi

IMAGE="${REGISTRY}/${NAME}:${TAG}"
echo ">> building ${IMAGE}"
# H100 nodes are amd64 and the cu128 torch wheels used here are amd64
# builds: pin the platform so builds from arm64 hosts give a usable image.
docker build --platform linux/amd64 \
  -f "${REPO_ROOT}/docker/Dockerfile.cuda-serving" -t "${IMAGE}" "${REPO_ROOT}"
if [[ "${PUSH}" == 1 ]]; then
  echo ">> pushing ${IMAGE}"
  docker push "${IMAGE}"
fi
echo "done"
