#!/usr/bin/env bash
# Standalone metrics between two PLY sequences (compute_metrics.sh analog),
# through the PyTorch port's metrics app on $DEVICE (cuda, the default,
# needs a GPU; DEVICE=cpu runs the plain versions).
set -e
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
python -m rabbit_transcoding_tpu_torch.apps.metrics \
    --uncompressedDataPath="${1:-"$PWD"/data/cloud_%04d.ply}" \
    --reconstructedDataPath="${2:-"$PWD"/data/dec_%04d.ply}" \
    --resolution=1023 \
    --frameCount="${3:-4}" \
    --device="${DEVICE:-cuda}"
