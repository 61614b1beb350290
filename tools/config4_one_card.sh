#!/usr/bin/env bash
# BASELINE config 4 on one card: tools/build_big_index_torch.py writes the
# index to INDEX_DIR (keep it outside the repository: ~40-44 GB, and the
# build's spill of ~13 bytes a seed beside it), the table's slot count is
# checked, then tools/bench_big_torch.py aligns READS reads in batches of
# 16384 on the card and holds the first batch's first 1024 reads to the
# CPU bit for bit. The host's free memory and the disk's free bytes are
# sampled every 30 s while it runs. Everything goes to OUT_DIR. DEVICE=cpu
# in the environment runs the bench on the CPU (a rehearsal at a tiny size).
#
#   tools/config4_one_card.sh INDEX_DIR OUT_DIR [GBP 1.8] [BUDGET_GB 24] [READS 10000000]
set -euo pipefail
IDX=$1 OUT=$2 GBP=${3:-1.8} BUDGET=${4:-24} READS=${5:-10000000}
mkdir -p "$OUT" "$(dirname "$IDX")"
cd "$(dirname "$0")/.."
DEVICE=${DEVICE:-cuda}
if [ "$DEVICE" = cuda ]; then
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
fi
nproc | tee "$OUT/nproc.txt"
(PID=
 trap 'kill $PID 2>/dev/null; wait $PID 2>/dev/null; exit 0' TERM
 while true; do
   echo "$(date +%s) mem_available $(awk '/MemAvailable/ {printf "%.0f", $2 * 1024}' /proc/meminfo)" \
        "disk_avail $(df -B1 --output=avail "$(dirname "$IDX")" | tail -1)"
   sleep 30 & PID=$!
   wait $PID
 done) > "$OUT/resources.log" 2>&1 &
SAMPLER=$!
trap 'kill $SAMPLER 2>/dev/null; wait $SAMPLER 2>/dev/null || true' EXIT
python tools/build_big_index_torch.py "$IDX" --gbp "$GBP" --budget-gb "$BUDGET" \
    > "$OUT/build.log" 2>&1
tail -1 "$OUT/build.log" | tee "$OUT/build.json"
# the table's home slots, without each bank's spare overflow buckets
HOME_SLOTS=$(python -c "
import json, sys
from snap_tpu_torch.index.build import BUCKET_SLOTS, SPAN_SLACK
b = json.load(open(sys.argv[1]))
print(b['table_slots'] - b['n_banks'] * SPAN_SLACK * BUCKET_SLOTS)" "$OUT/build.json")
if [ "$HOME_SLOTS" -gt $((1 << 31)) ]; then
    echo "table of $HOME_SLOTS home slots: more than 2^31, step --gbp down by 0.05" >&2
    exit 1
fi
python tools/bench_big_torch.py "$IDX" --reads "$READS" --batch 16384 \
    --device "$DEVICE" --out "$OUT/BIGIDX_torch.json" --cpu-check 1024 > "$OUT/bench.log" 2>&1
tail -1 "$OUT/bench.log"
