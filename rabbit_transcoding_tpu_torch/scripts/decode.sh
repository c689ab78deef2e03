#!/usr/bin/env bash
# Decode a V3C stream to PLYs + checksums (decode.sh analog), through the
# PyTorch port's decode app on $DEVICE (cuda, the default; or cpu).
set -e
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
STREAM=${1:-"$PWD"/data/transcoded.bin}
python -m rabbit_transcoding_tpu_torch.apps.decode \
    --compressedStreamPath="$STREAM" \
    --reconstructedDataPath="$PWD"/data/dec_%04d.ply \
    --computeChecksum \
    --device="${DEVICE:-cuda}"
