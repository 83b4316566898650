#!/bin/sh
# Fetch the example dataset (33-image rectified stereo stacks + Q.yaml) used
# by the reference implementation, with checksum verification — a port of
# /root/reference/data/prepare.sh semantics. In network-restricted CI this
# falls back to generating a synthetic projected-pattern dataset with
# libbicos_jax.io.synthetic_stack_pair so the pipeline remains exercisable.
set -eu

cd "$(dirname "$0")"

URL="https://data.scientia.uni-wuerzburg.de/o3dm/bicos-data.tar.xz"
ARCHIVE="bicos-data.tar.xz"

if [ -d left ] && [ -d right ]; then
    echo "data already present"
    exit 0
fi

if command -v curl >/dev/null 2>&1 && curl -fsSL --max-time 10 -o "$ARCHIVE" "$URL"; then
    # Unconditional, loud dataset-integrity check (reference
    # data/prepare.sh:44-48; set -e aborts on mismatch).
    sha256sum -c sha256sums.txt
    tar xf "$ARCHIVE"
    rm -f "$ARCHIVE"
    echo "downloaded reference dataset"
else
    echo "network unavailable; generating synthetic projected-pattern stacks"
    PYTHONPATH="$(cd .. && pwd)${PYTHONPATH:+:$PYTHONPATH}" python - <<'EOF'
import os
import numpy as np
import cv2
from libbicos_jax.io import synthetic_stack_pair

n = 33
s0, s1, disp = synthetic_stack_pair(n, 1080, 1440, dtype=np.uint8)
os.makedirs("left", exist_ok=True)
os.makedirs("right", exist_ok=True)
for i in range(n):
    cv2.imwrite(f"left/{i}.png", s0[i])
    cv2.imwrite(f"right/{i}.png", s1[i])
np.save("true_disparity.npy", disp)
fs = cv2.FileStorage("Q.yaml", cv2.FILE_STORAGE_WRITE)
Q = np.array([[1, 0, 0, -720.0],
              [0, 1, 0, -540.0],
              [0, 0, 0, 1000.0],
              [0, 0, 1.0 / 120.0, 0]], dtype=np.float64)
fs.write("Q", Q)
fs.release()
print("synthetic dataset written to data/left, data/right")
EOF
fi
