#!/usr/bin/env bash
# DCT-domain fast-path transcode (the RBV-only requantisation mode; the
# analog slot of the reference's transcode_gpu.sh NVENC fast path), through
# the PyTorch port's transcode app on $DEVICE (cuda, the default; or cpu).
set -e
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
python -m rabbit_transcoding_tpu_torch.apps.transcode \
    --compressedStreamPath="${1:-"$PWD"/data/sphere_r5.bin}" \
    --outStreamPath="${2:-"$PWD"/data/transcoded_rq.bin}" \
    --mode=requant \
    --geometryQP=32 \
    --attributeQP=42 \
    --test_name=test_transcode_requant \
    --device="${DEVICE:-cuda}"
