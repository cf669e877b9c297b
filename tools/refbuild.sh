#!/bin/sh
# Build the REFERENCE implementation's CPU backend as a standalone binary,
# for ground-truth validation (three-way spectrum comparison: reference
# binary / native oracle / JAX engine — see tests/test_vs_reference.py).
#
# The reference's own build needs Bazel + abseil + spdlog; here it compiles
# with plain g++ against two tiny support files (a spdlog stub header and a
# plain-argv main, tools/refsupport/) and the UNMODIFIED reference sources
# read in place from $GRMONTY_REFERENCE (default /root/reference).  No
# reference code is copied into this repository.
#
# Usage: tools/refbuild.sh [outdir]   ->  <outdir>/ref_grmonty
set -e

REF="${GRMONTY_REFERENCE:-/root/reference}"
HERE="$(cd "$(dirname "$0")" && pwd)"
OUT="${1:-$HERE/../.cache/refbuild}"
mkdir -p "$OUT"

if [ ! -f "$REF/cuda_grmonty/harm_model.cpp" ]; then
    echo "reference sources not found at $REF" >&2
    exit 3
fi

# Skip if up to date (reference is read-only; key on support-file mtimes).
BIN="$OUT/ref_grmonty"
SHIM="$OUT/ref_shim.so"
SRCS="$REF/cuda_grmonty/harm_model.cpp \
      $REF/cuda_grmonty/hotcross.cpp \
      $REF/cuda_grmonty/jnu_mixed.cpp \
      $REF/cuda_grmonty/radiation.cpp \
      $REF/cuda_grmonty/proba.cpp \
      $REF/cuda_grmonty/tetrads.cpp \
      $REF/cuda_grmonty/integration.cpp \
      $REF/cuda_grmonty/monty_rand.cpp"
FLAGS="-std=c++20 -O2 -w -include $HERE/refsupport/format_shim.h \
       -I $HERE/refsupport -I $REF"

newest_support() {
    [ "$1" -nt "$HERE/refsupport/ref_main.cpp" ] \
        && [ "$1" -nt "$HERE/refsupport/ref_shim.cpp" ] \
        && [ "$1" -nt "$HERE/refsupport/spdlog/spdlog.h" ] \
        && [ "$1" -nt "$HERE/refsupport/format_shim.h" ]
}

if ! { [ -f "$BIN" ] && newest_support "$BIN"; }; then
    g++ $FLAGS $SRCS "$HERE/refsupport/ref_main.cpp" -o "$BIN" -lpthread
fi
if ! { [ -f "$SHIM" ] && newest_support "$SHIM"; }; then
    g++ $FLAGS -fPIC -shared $SRCS "$HERE/refsupport/ref_shim.cpp" \
        -o "$SHIM" -lpthread
fi

echo "$BIN"
echo "$SHIM"
