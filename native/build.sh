#!/bin/sh
# Build the native data-loader shared library for THIS host's CPU.
#   sh native/build.sh [output path]   (default: native/libpatent_io.so)
# patent_tpu.input.native calls it with a path keyed on the source and the
# host's CPU, so a library built on another machine is never reused.
set -e
cd "$(dirname "$0")"
OUT="${1:-libpatent_io.so}"
mkdir -p "$(dirname "$OUT")"
TMP="$OUT.tmp.$$"
g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread \
    patent_io.cc -lz -o "$TMP"
mv -f "$TMP" "$OUT"
echo "built $OUT"
