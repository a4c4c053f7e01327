#!/bin/bash
# Ticks of ffhq256-duplex (batch 32, bf16, 1-kimg ticks, 4 kimg a run)
# from 256 procedural TFRecords, for two sides A and B in one call, in
# alternating pairs A B, B A, A B, ... ($PAIRS pairs, default 5).  A side
# is a tree of the port (this one, or a `git archive` of another commit
# under the git-ignored results/) and the train flags in $A_FLAGS or
# $B_FLAGS.  Each run prints its ticks' sec_per_tick, data_wait_frac,
# timing/phase/h2d and the mean of data/h2d_ms where the run has it (the
# first tick of a run pays its warm-up), and keeps its log and
# stats.jsonl under $AB_OUT (default results/ab); the last lines give
# each side's median steady tick (ticks 2 on) and the pairs' differences.
# On a machine with one GPU, from the root of this tree:
#
#   bash tick_ab.sh results/parent .
set -e
ROOT=$PWD
A=$(cd "${1:?usage: tick_ab.sh TREE_A TREE_B}" && pwd)
B=$(cd "${2:?usage: tick_ab.sh TREE_A TREE_B}" && pwd)
OUT=${AB_OUT:-$ROOT/results/ab}
DATA=$(mktemp -d)
trap 'rm -rf "$DATA"' EXIT
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -m gansformer_tpu_torch.cli.prepare_data --synthetic \
    --resolution 256 --max-images 256 --to tfrecord \
    --out "$DATA/tfrecords" > /dev/null
python - "$DATA" <<'PY'
import dataclasses, os, sys
from gansformer_tpu_torch.core.config import get_experiment_preset
e = get_experiment_preset("ffhq256-duplex")
e = dataclasses.replace(e, train=dataclasses.replace(
    e.train, kimg_per_tick=1, total_kimg=4, snapshot_ticks=0,
    image_snapshot_ticks=0), data=dataclasses.replace(
    e.data, path=os.path.join(sys.argv[1], "tfrecords")))
open(os.path.join(sys.argv[1], "config.json"), "w").write(e.to_json())
PY
run() {  # side label tree flags
  side=$1; label=$2; tree=$3; flags=$4
  # shellcheck disable=SC2086
  (cd "$tree" && python -m gansformer_tpu_torch.cli.train \
      --config "$DATA/config.json" --run-dir "$DATA/run_$label" $flags \
      > "$OUT/$label.log" 2>&1)
  cp "$DATA/run_$label/stats.jsonl" "$OUT/$label.stats.jsonl"
  python - "$OUT/$label.stats.jsonl" "$side" "$label" <<'PY'
import json, sys
rows = [json.loads(ln) for ln in open(sys.argv[1])]
hist = rows[-1].get("telemetry", {}).get("histograms", {}).get("data/h2d_ms")
print(sys.argv[2], sys.argv[3], "sec_per_tick",
      [r["timing/sec_per_tick"] for r in rows], "data_wait_frac",
      [r["timing/data_wait_frac"] for r in rows], "h2d",
      [r.get("timing/phase/h2d", 0.0) for r in rows], "data/h2d_ms",
      hist["mean"] if hist else None, flush=True)
PY
}
for i in $(seq 1 "${PAIRS:-5}"); do
  if [ $((i % 2)) = 1 ]; then
    run A "a$i" "$A" "$A_FLAGS"; run B "b$i" "$B" "$B_FLAGS"
  else
    run B "b$i" "$B" "$B_FLAGS"; run A "a$i" "$A" "$A_FLAGS"
  fi
done
python - "$OUT" "${PAIRS:-5}" <<'PY'
import json, statistics, sys
def steady(label):
    rows = [json.loads(ln) for ln in open(f"{sys.argv[1]}/{label}.stats.jsonl")]
    return [r["timing/sec_per_tick"] for r in rows[1:]]
n = int(sys.argv[2])
a = {i: steady(f"a{i}") for i in range(1, n + 1)}
b = {i: steady(f"b{i}") for i in range(1, n + 1)}
print("median steady tick A", statistics.median(sum(a.values(), [])),
      "B", statistics.median(sum(b.values(), [])))
diffs = [statistics.median(b[i]) - statistics.median(a[i]) for i in a]
print("pairs B - A (s, medians of each run)", diffs, "B faster in",
      sum(d < 0 for d in diffs), "of", n)
PY
