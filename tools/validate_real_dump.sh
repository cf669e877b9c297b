#!/usr/bin/env bash
# One-command real-dump validation: run the three-way spectrum comparison
# (compiled reference binary vs native oracle vs batched engine,
# tools/validate_vs_reference.py) on the ACTUAL benchmark input dump019
# the reference's published numbers use (reference README.md:61-65).
#
# The build/bench environment has no network, so every accuracy artifact so
# far is on synthetic tori (golden-file-tested against the reference's
# parser spec).  The moment dump019 is reachable, this script removes the
# "synthetic-only" asterisk:
#
#   1. fetch (manually, any machine with network):
#        curl -LO https://raw.githubusercontent.com/pseudotensor/grmonty/refs/heads/master/dump019
#      and place it at .cache/dump019 (or pass its path as $1).
#   2. run:  tools/validate_real_dump.sh [path-to-dump019] [photons]
#
# The dump's sha256 is pinned trust-on-first-use into tools/dump019.sha256
# (committed after the first verified run); later runs fail loudly on any
# mismatch so a truncated/corrupted download can't silently skew results.
set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
DUMP="${1:-$REPO/.cache/dump019}"
PHOTONS="${2:-20000}"
PIN="$REPO/tools/dump019.sha256"

if [[ ! -f "$DUMP" ]]; then
  echo "dump019 not found at $DUMP" >&2
  echo "fetch it on a networked machine:" >&2
  echo "  curl -LO https://raw.githubusercontent.com/pseudotensor/grmonty/refs/heads/master/dump019" >&2
  echo "then place it at $REPO/.cache/dump019 (or pass its path as \$1)" >&2
  exit 2
fi

SUM="$(sha256sum "$DUMP" | awk '{print $1}')"
if [[ -f "$PIN" ]]; then
  WANT="$(awk '{print $1}' "$PIN")"
  if [[ "$SUM" != "$WANT" ]]; then
    echo "sha256 MISMATCH for $DUMP" >&2
    echo "  got:    $SUM" >&2
    echo "  pinned: $WANT (tools/dump019.sha256)" >&2
    exit 3
  fi
  echo "dump019 sha256 verified: $SUM"
else
  echo "$SUM  dump019" > "$PIN"
  echo "dump019 sha256 pinned (trust-on-first-use): $SUM"
  echo "-> commit tools/dump019.sha256 after this run validates"
fi

# Structural sanity: the parser must read it (header + n1 x n2 rows).
PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" python - "$DUMP" <<'EOF'
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", "cpu")
from grmonty.models import harm

m = harm.read_dump(sys.argv[1], 4.0e19)
h = m.header
print(f"parsed dump: n1={h.n[0]} n2={h.n[1]} a={h.a} t={h.t}")
assert h.n[0] > 0 and h.n[1] > 0
EOF

# Three-way comparison at the published benchmark parameters
# (photon budget reduced from 1e6 for wall-clock; raise $2 for more power).
exec python "$REPO/tools/validate_vs_reference.py" \
  --dump "$DUMP" --photons "$PHOTONS" --mass-unit 4e19 \
  --bench-profile --json "$REPO/VSREF_dump019.json"
