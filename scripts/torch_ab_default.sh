#!/bin/bash
# Time one of the port's 1080p paths (chip_smoke.run_full_frame, 16 timed
# frames through App.run, then 2 profiled; the default path unless a
# fourth argument names another of chip_smoke.PATHS) from two checkouts
# in alternating pairs on one card, each reading in its own process; the
# order flips every pair.  Run from the repository root on the card's
# machine, with both checkouts unpacked (e.g. by `git archive`) into
# gitignored directories:
#
#   bash scripts/torch_ab_default.sh _scratch/parent _scratch/final 10
#   bash scripts/torch_ab_default.sh _scratch/parent _scratch/final 6 reference
#
# Prints the card's name and power limit, then for each reading its pair,
# its checkout and chip_smoke's "steady state" and "profile" lines.
set -u
A=$1
B=$2
PAIRS=${3:-10}
FRAME_PATH=${4:-default}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {
  (cd "$1" && python3 -c "
import sys; sys.path.insert(0, '.')
import chip_smoke as C
from mo_renderer_tpu_torch.device import card
from mo_renderer_tpu_torch.kernels import _build
_build.library()
C.run_full_frame('cuda', card('cuda'), '$FRAME_PATH', 16)
" 2>&1 | grep --line-buffered "steady state\|profile (2")
}
for i in $(seq 1 "$PAIRS"); do
  if [ $((i % 2)) -eq 1 ]; then order="$A $B"; else order="$B $A"; fi
  for dir in $order; do
    echo "=== pair $i $dir"
    one "$dir"
  done
done
