#!/usr/bin/env bash
# Downsample every DSEC sequence's events.h5 under a root to the
# events_2x.h5 beside it (the file the DSEC reader takes), skipping the
# sequences that already have one; the port's counterpart of dagr_tpu's
# scripts/downsample_all_events.sh, through
# `python -m dagr_tpu_torch.scripts.downsample_events` (host work only):
#
#     bash dagr_tpu_torch/scripts/downsample_all_events.sh <dsec_root>
set -euo pipefail
ROOT=${1:?usage: downsample_all_events.sh <dsec_root>}
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
find "$ROOT" -path "*/events/left/events.h5" | while read -r f; do
    out="$(dirname "$f")/events_2x.h5"
    if [ -e "$out" ]; then
        echo "skip $out (exists)"
        continue
    fi
    echo "downsampling $f -> $out"
    PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" python -m \
        dagr_tpu_torch.scripts.downsample_events \
        --input_path "$f" --output_path "$out"
done
