#!/usr/bin/env bash
# 300-frame endurance pass (BASELINE config #4 analog) on the PyTorch port.
# The reference's HM-baseline loop transcodes 300 frames of 8i content with
# conformance metrics (test/runme_linux.sh, transcode_HM.sh); this drives the
# same duration through the port's encode app -> stream app (per-GOF
# checkpoint/hash-SEI) -> decode app (--computeChecksum verifies every hash
# SEI) -> sampled D1 metrics, every app on $DEVICE (cuda, the default, needs
# a GPU; DEVICE=cpu runs the plain versions).
#
#   FRAMES=300 GOF=32 POINTS=40000 bash endurance.sh [workdir]
#   SCENE=dense POINTS=500000 ... for the reference-density (~310k pts
#   after dedupe) duty cycle analog.
# The log goes to the workdir (default: endurance_torch under the temp
# directory), not beside the reference's records in results/.
set -e
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cuda}
WORK=${1:-${TMPDIR:-/tmp}/endurance_torch}
FRAMES=${FRAMES:-300}
GOF=${GOF:-32}
POINTS=${POINTS:-40000}
SCENE=${SCENE:-sphere}
SUFFIX=""
[ "$SCENE" != sphere ] && SUFFIX="_$SCENE"
mkdir -p "$WORK"
cd "$WORK"
LOG="$PWD/endurance_${FRAMES}f${SUFFIX}.log"
exec > >(tee "$LOG") 2>&1

echo "=== endurance: $FRAMES frames, GOF $GOF, $POINTS pts/frame on $DEVICE ==="
date
t0=$(date +%s)

if [ ! -f "cloud_$(printf %04d $((FRAMES-1))).ply" ]; then
  python -m rabbit_transcoding_tpu_torch.testdata --frames "$FRAMES" \
      --points "$POINTS" --scene "$SCENE" --out "cloud_%04d.ply"
fi
echo "[$(($(date +%s)-t0))s] sources ready"

if [ ! -f src.bin ]; then
  python -m rabbit_transcoding_tpu_torch.apps.encode \
      --uncompressedDataPath="cloud_%04d.ply" \
      --compressedStreamPath=src.bin \
      --frameCount="$FRAMES" --groupOfFramesSize="$GOF" \
      --minimumImageWidth=512 --minimumImageHeight=128 \
      --geometryQP=8 --attributeQP=12 --occupancyPrecision=2 \
      --device="$DEVICE"
fi
echo "[$(($(date +%s)-t0))s] src.bin: $(stat -c%s src.bin) bytes"

# the endurance subject: per-GOF checkpointed live transcode with
# hash-SEI refresh; resume-capable (sidecar state.json).  --trace writes
# the per-GOF enc_* conformance logs from the in-memory transcoded
# context, BEFORE serialization.
python -m rabbit_transcoding_tpu_torch.apps.stream \
    --compressedStreamPath=src.bin \
    --outStreamPath=out.bin \
    --mode=auto --geometryQP=28 --attributeQP=37 --occupancyPrecision=4 \
    --resume --trace \
    --device="$DEVICE"
echo "[$(($(date +%s)-t0))s] out.bin: $(stat -c%s out.bin) bytes"
cat out.bin.state.json

# decode verifies EVERY GOF's hash SEI (computeChecksum) and writes the
# dec_* conformance logs from the parsed stream — a failed checksum
# raises and fails the run
python -m rabbit_transcoding_tpu_torch.apps.decode \
    --compressedStreamPath=out.bin \
    --reconstructedDataPath="dec_%04d.ply" \
    --computeChecksum --trace \
    --device="$DEVICE"
echo "[$(($(date +%s)-t0))s] decode+checksum OK ($(ls dec_0*.ply | wc -l) frames)"

# conformance: diff the transcoder-side vs decoder-side logs per GOF
# (hls/atlas/tile/pcframe categories + level limits) — writer/reader
# drift anywhere in the run fails here (host only: takes no device)
python -m rabbit_transcoding_tpu_torch.apps.conformance --path=.
echo "[$(($(date +%s)-t0))s] conformance OK"

# hq reference decode: the encoder-loop reconstruction of the INPUT
# stream — lets the drift check isolate transcode-added error from
# content/encode variance (see endurance_metrics.py)
if [ ! -f "hqdec_$(printf %04d $((FRAMES-1))).ply" ]; then
  python -m rabbit_transcoding_tpu_torch.apps.decode \
      --compressedStreamPath=src.bin \
      --reconstructedDataPath="hqdec_%04d.ply" \
      --device="$DEVICE"
fi
echo "[$(($(date +%s)-t0))s] hq reference decode ready"

# drift check: same-phase cross-GOF D1 stability + transcode-added D1
# trend (sampled)
python -m rabbit_transcoding_tpu_torch.scripts.endurance_metrics \
    --gof "$GOF" --device="$DEVICE"
echo "[$(($(date +%s)-t0))s] endurance PASS"
date
