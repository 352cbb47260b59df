#!/bin/bash
# chip_smoke.py of two unpacked trees in one call, parent, change, change,
# parent, each from a clean build (its yolov3_tpu_torch/_build removed), so
# that the whole script's time and its phases can be compared on one card.
#
#     git archive <parent> | tar -x -C .dev/parent   # .dev/ is in .gitignore
#     git archive $(git write-tree) | tar -x -C .dev/final
#     bash scripts/chip_smoke_ab.sh .dev/parent .dev/final [OUT]
#
# Prints the card's name and power limit, then for each run its tag, exit
# code, seconds of wall clock and the last two lines of its output; each
# run's whole output goes to OUT/ab_<tag>.log (OUT defaults to
# runs/chip_smoke_ab, relative to the directory it is started from).
set -u
parent=$1
change=$2
out=${3:-runs/chip_smoke_ab}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
run() {
  tag=$1; dir=$2
  rm -rf "$dir/yolov3_tpu_torch/_build"
  s=$(date +%s.%N)
  (cd "$dir" && timeout 800 python3 chip_smoke.py > "$OLDPWD/$out/ab_$tag.log" 2>&1)
  rc=$?
  e=$(date +%s.%N)
  echo "$tag rc=$rc seconds=$(python3 -c "print($e - $s)")"
  tail -n 2 "$out/ab_$tag.log" | cut -c1-300
}
run parent1 "$parent"
run change1 "$change"
run change2 "$change"
run parent2 "$parent"
