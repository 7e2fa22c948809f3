#!/usr/bin/env bash
# A parent checkout and its change, measured on one card in one call:
#
#     bash mmrp_tpu_torch/same_call.sh PARENT CHANGE OUT
#
# PARENT and CHANGE are unpacked checkouts (for example `git archive HEAD` and
# `git archive $(git write-tree)`, each into a git-ignored directory); OUT is the
# directory for the logs. For each tree in turn it runs that tree's
# `chip_smoke.py` (smoke_{parent,change}.txt) and CHANGE's
# `mmrp_tpu_torch/profile_forward.py` on that tree's package, the serving
# forwards (prof_{parent,change}.txt / .jsonl) and the batch-64 train step
# (`--train`: train_{parent,change}.txt / .jsonl), so both trees are read with
# one set of routes and kernel kinds; then CHANGE's card tests (cuda.txt) and
# `compare_trees --rounds 12` (ab.txt / ab.jsonl). Prints the card's name and power
# limit and one status line per step; exits non-zero if any step failed.
set -u
parent=$(realpath "$1")
change=$(realpath "$2")
out=$(realpath -m "$3")
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
prof=$change/mmrp_tpu_torch/profile_forward.py
status=0

step() {  # step NAME LOG DIR COMMAND...: run COMMAND in DIR, its output to LOG
  local name=$1 log=$2 dir=$3
  shift 3
  (cd "$dir" && "$@") >"$log" 2>&1
  local rc=$?
  echo "$name rc=$rc"
  [ $rc -eq 0 ] || status=1
}

for side in parent change; do
  tree=${!side}
  step "smoke $side" "$out/smoke_$side.txt" "$tree" python3 chip_smoke.py
  # run_path leaves sys.path[0] at the tree, so `mmrp_tpu_torch` is the tree's own
  for what in prof train; do
    args=(--out "$out/${what}_$side.jsonl")
    [ "$what" = train ] && args+=(--train)
    step "profile $what $side" "$out/${what}_$side.txt" "$tree" python3 -c \
      'import runpy, sys; path = sys.argv.pop(1); sys.argv[0] = path; runpy.run_path(path, run_name="__main__")' \
      "$prof" "${args[@]}"
  done
done
step "card tests" "$out/cuda.txt" "$change" python3 -m pytest --noconftest -p no:cacheprovider \
  tests/test_torch_cuda.py -m cuda -q
step "compare_trees" "$out/ab.txt" "$change" python3 -m mmrp_tpu_torch.compare_trees \
  --trees "$parent" "$change" --rounds 12 --out "$out/ab.jsonl"
tail -n 1 "$out/cuda.txt"
exit $status
