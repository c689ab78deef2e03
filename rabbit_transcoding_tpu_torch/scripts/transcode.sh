#!/usr/bin/env bash
# Full-loop smoke: encode -> transcode -> decode(+metrics) -> metrics, the
# analog of the reference's /transcode.sh end-to-end loop, through the
# PyTorch port's apps on $DEVICE (cuda, the default, needs a GPU; DEVICE=cpu
# runs the plain versions).  Runs in the CALLER's directory; all artifacts
# land in $WORK (default ./data).
set -e
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
WORK=${WORK:-./data}
mkdir -p "$WORK"

python -m rabbit_transcoding_tpu_torch.testdata --frames 4 \
    --out "$WORK/cloud_%04d.ply"

python -m rabbit_transcoding_tpu_torch.apps.encode \
    --config="$REPO/cfg/common/ctc-common.cfg" \
    --config="$REPO/cfg/condition/ctc-random-access.cfg" \
    --config="$REPO/cfg/rate/ctc-r5.cfg" \
    --uncompressedDataPath="$WORK/cloud_%04d.ply" \
    --frameCount=4 \
    --minimumImageWidth=512 \
    --reconstructedDataPath="$WORK/rec_%04d.ply" \
    --compressedStreamPath="$WORK/sphere_r5.bin" \
    --device="$DEVICE"

python -m rabbit_transcoding_tpu_torch.apps.transcode \
    --compressedStreamPath="$WORK/sphere_r5.bin" \
    --outStreamPath="$WORK/transcoded.bin" \
    --test_name=test_transcode \
    --preset=veryfast \
    --pixelFormat=yuv420p \
    --geometryQP=32 \
    --attributeQP=42 \
    --occupancyPrecision=2 \
    --rate_mode=qp \
    --device="$DEVICE"

python -m rabbit_transcoding_tpu_torch.apps.decode \
    --compressedStreamPath="$WORK/transcoded.bin" \
    --computeMetrics \
    --uncompressedDataPath="$WORK/cloud_%04d.ply" \
    --resolution=1023 \
    --reconstructedDataPath="$WORK/dec_%04d.ply" \
    --device="$DEVICE"

python -m rabbit_transcoding_tpu_torch.apps.metrics \
    --uncompressedDataPath="$WORK/cloud_%04d.ply" \
    --reconstructedDataPath="$WORK/dec_%04d.ply" \
    --resolution=1023 \
    --frameCount=4 \
    --device="$DEVICE"
