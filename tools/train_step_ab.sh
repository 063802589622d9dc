#!/bin/bash
# The one-process training step of this checkout against another's (a
# `git archive` of the parent unpacked in a gitignored directory), on one
# card: torch_train_probe.py's step in the order other, this, this, other
# twice, then its --cli run in the order other, this, this, other; each
# process pinned to CPUs 4-7.  Prints each run's median line and writes the
# whole output to LOG (default: build/train_step_ab.log).
#
#   [LOG=path] bash tools/train_step_ab.sh [OTHER_CHECKOUT]
#
# OTHER_CHECKOUT defaults to build/parent.
here=$(cd "$(dirname "$0")/.." && pwd)
other=$(cd "${1:-$here/build/parent}" && pwd)
cd "$here"
log=${LOG:-build/train_step_ab.log}
mkdir -p "$(dirname "$log")"
: > "$log"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$log"
pin='import os, sys; os.sched_setaffinity(0, {4, 5, 6, 7}); os.execvp(sys.argv[1], sys.argv[1:])'
run() {  # side, probe arguments...
  side=$1; shift
  dir=$here; [ $side = other ] && dir=$other
  echo "== $side $*" | tee -a "$log"
  (cd "$dir" && python3 -c "$pin" python3 torch_train_probe.py "$@") \
      >> "$log" 2>&1 || echo "RC=$? $side $*" | tee -a "$log"
  grep -E "kernel pair:|untraced" "$log" | tail -1
}
for side in other this this other other this this other; do
  run $side --rounds 3
done
for side in other this this other; do
  run $side --cli
done
