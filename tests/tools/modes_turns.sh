#!/bin/bash
# The three modes and the bench of two checkouts in turns, on the card:
#
#     git archive <parent> | tar -x -C build/parent
#     bash tests/tools/modes_turns.sh build/parent [OUT_DIR]
#
# Runs `python -m ldso_tpu_torch.examples.time_modes --reps 1` (strict,
# lookahead, async on the 64-frame bench scene) and then
# `python -m ldso_tpu_torch.examples.bench` at its defaults, each from the
# checkout it times (with that checkout on PYTHONPATH), in the order
# parent, change, change, parent, where "change" is the current directory.
# Each run's output goes to OUT_DIR (build/turns by default):
# tm_<label>.jsonl (one JSON line per mode), bench_<label>.json (the
# bench's line) and their stderr; the card's name and power limit to
# gpu.txt. Last it prints one line per mode and per bench run: wall ms
# per frame, keyframes, ATE and K4's launches beside the arena traces
# (none for a parent without K4); fps per mode, async's keyframes per
# window and util's device ms.
set -u
parent=$(cd "$1" && pwd)
change=$(pwd)
out=$(mkdir -p "${2:-build/turns}" && cd "${2:-build/turns}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/gpu.txt"

run() {  # $1 = checkout, $2 = label
  (cd "$1" && PYTHONPATH=$PWD timeout 600 python -m \
      ldso_tpu_torch.examples.time_modes --reps 1 \
      > "$out/tm_$2.jsonl" 2> "$out/tm_$2.err"; echo "time_modes $2 rc=$?")
  (cd "$1" && PYTHONPATH=$PWD timeout 900 python -m \
      ldso_tpu_torch.examples.bench \
      > "$out/bench_$2.json" 2> "$out/bench_$2.err"; echo "bench $2 rc=$?")
}
run "$parent" parent1
run "$change" change1
run "$change" change2
run "$parent" parent2

OUT="$out" python3 - <<'PY'
import json
import os
out = os.environ["OUT"]
for lab in ("parent1", "change1", "change2", "parent2"):
    for line in open(f"{out}/tm_{lab}.jsonl"):
        r = json.loads(line)
        print("time_modes", lab, r["mode"], r["ms_per_frame_wall"],
              "keyframes", r["keyframes"], "ate_mm", r["ate_mm"],
              "k4", r.get("k4_launches"), "traces", r.get("traces"))
    try:
        b = json.loads(open(f"{out}/bench_{lab}.json").read().splitlines()[-1])
    except (OSError, ValueError, IndexError) as e:
        print("bench", lab, "no result line:", e)
        continue
    print("bench", lab, "sync_fps", b.get("sync_fps"), "strict_fps",
          b.get("strict_fps"), "value", b.get("value"),
          "piped_keyframes_windows", b.get("piped_keyframes_windows"),
          "ate_m", b.get("ate_m_sim_aligned"),
          {k: v["ms"] for k, v in b.get("util", {}).items()},
          b.get("error", ""))
PY
