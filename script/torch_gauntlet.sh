#!/usr/bin/env bash
# The port's accuracy gauntlet on one card (mx_rcnn_tpu_torch/tools/gauntlet.py):
# the production recipe (tiny network on synthetic_hard, 30 epochs, lr 3e-3,
# batch 2, decay at epoch 24) at each seed of SEEDS, and the quantization
# gate (--mode quant: the same training, the int8 eval) at each seed of
# QUANT_SEEDS.  Every cell is one tools/gauntlet.py process over a set of
# its own; they run JOBS at a time on the one card.  The cells' records are
# merged into OUT/results.json, then the tool itself summarizes them
# (OUT/gauntlet.md) and runs `--compare e2e quant` over them, reusing every
# record (no training).  Each process's output and log (its "Epoch[k] N
# steps in S s" lines) go to OUT/<mode>-s<seed>.txt/.err.
#
#   bash script/torch_gauntlet.sh [OUT] [SEEDS] [QUANT_SEEDS] [JOBS]
#   bash script/torch_gauntlet.sh chiprun_out/gauntlet "0 1 2 3 4" "0 1 2" 8
# EXTRA adds flags to every tools/gauntlet.py call (a CPU rehearsal:
# EXTRA="--device cpu --epochs 1").
set -euo pipefail
OUT=${1:-chiprun_out/gauntlet}
SEEDS=${2:-"0 1 2 3 4"}
QUANT_SEEDS=${3:-"0 1 2"}
JOBS=${4:-8}
WORK=${WORK:-_chip/gauntlet_recipe}
EXTRA=${EXTRA:-}
card() {
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null \
    || echo "no nvidia-smi"
}
mkdir -p "$OUT" "$WORK"
card | tee "$OUT/card.txt"

cells=()
for s in $SEEDS; do cells+=("e2e $s"); done
for s in $QUANT_SEEDS; do cells+=("quant $s"); done
pids=()
t0=$(date +%s)
for cell in "${cells[@]}"; do
  read -r mode seed <<< "$cell"
  while [ "$(jobs -rp | wc -l)" -ge "$JOBS" ]; do sleep 2; done
  echo "start $mode seed $seed at $(( $(date +%s) - t0 )) s"
  # shellcheck disable=SC2086
  python -m mx_rcnn_tpu_torch.tools.gauntlet --mode "$mode" --seeds "$seed" \
    $EXTRA --root "$WORK/$mode-s$seed" --workdir "$WORK/$mode-s$seed/work" \
    --out "$OUT/$mode-s$seed.json" \
    > "$OUT/$mode-s$seed.txt" 2> "$OUT/$mode-s$seed.err" &
  pids+=("$!")
done
fail=0
for pid in "${pids[@]}"; do wait "$pid" || fail=1; done
echo "cells done in $(( $(date +%s) - t0 )) s, failed: $fail"
rm -rf "$WORK"

python - "$OUT" <<'EOF'
import glob, json, os, sys
out = sys.argv[1]
recs = [r for f in sorted(glob.glob(os.path.join(out, "*-s*.json")))
        for r in json.load(open(f))]
with open(os.path.join(out, "results.json"), "w") as f:
    json.dump(recs, f, indent=1)
print(f"merged {len(recs)} records")
EOF
# shellcheck disable=SC2086
python -m mx_rcnn_tpu_torch.tools.gauntlet --mode e2e --seeds $SEEDS $EXTRA \
  --out "$OUT/results.json" --markdown "$OUT/gauntlet.md" | tee "$OUT/summary.txt"
# shellcheck disable=SC2086
python -m mx_rcnn_tpu_torch.tools.gauntlet --compare e2e quant \
  --seeds $QUANT_SEEDS $EXTRA --out "$OUT/results.json" | tee "$OUT/compare.txt" \
  || echo "compare exit $? (1: the CI is not inside the budget)"
card
exit $fail
