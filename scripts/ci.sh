#!/usr/bin/env bash
# CI-style gate: fast suite + golden CLI equality on CPU, then (optional)
# the same golden on the GPU. Usage: scripts/ci.sh [--gpu]
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== native engine gate =="
# Fail LOUDLY if the native engine cannot build while g++ exists (round 3:
# a broken .cpp passed CI green because every native test skips and the
# golden run silently fell back to the Python path).
python - <<'EOF'
import shutil, sys
if shutil.which("g++") is None:
    print("no g++ on PATH; Python fallback (correctness-only) mode")
else:
    from shark_tpu.io import native
    if not native.available():
        print("FATAL: g++ present but the native engine failed to build",
              file=sys.stderr)
        sys.exit(1)
    print("native engine: OK")
EOF

echo "== fast suite (CPU) =="
python -m pytest tests/ -q -m "not slow"

echo "== golden CLI equality (CPU backend) =="
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
python -m shark_tpu --backend cpu \
  -r /root/reference/example/ENSG00000277117.fa \
  -1 /root/reference/example/sample_1.fq \
  -2 /root/reference/example/sample_2.fq \
  -o "$tmp/out1.fq" -p "$tmp/out2.fq" > "$tmp/out.ssv"
diff "$tmp/out.ssv" /root/reference/example/ENSG00000277117.truth.ssv
diff "$tmp/out1.fq" /root/reference/example/sharked.sample_1.truth.fq
diff "$tmp/out2.fq" /root/reference/example/sharked.sample_2.truth.fq
echo "golden: OK"

if [[ "${1:-}" == "--gpu" ]]; then
  echo "== GPU golden: shipped example end-to-end on the GPU =="
  # The acceptance contract (reference README.md:54-69) executed on the
  # card: byte-equality of all three truth files. No accelerator is an
  # error here, never a quiet CPU run.
  python - <<'EOF'
import jax
plat = jax.devices()[0].platform
assert plat == "gpu", f"no GPU: jax runs on {plat}"
print(f"serving backend: {plat} ({jax.devices()[0].device_kind})")
EOF
  # SHARK_EXAMPLE_DIR: the reference's example/ directory (input and
  # truth files), where this machine has it
  ex="${SHARK_EXAMPLE_DIR:-}"
  if [[ -n "$ex" && -d "$ex" ]]; then
    gout=$(mktemp -d)
    trap 'rm -rf "$tmp" "$gout"' EXIT
    python -m shark_tpu --backend gpu -r "$ex/ENSG00000277117.fa" \
      -1 "$ex/sample_1.fq" -2 "$ex/sample_2.fq" \
      -o "$gout/out1.fq" -p "$gout/out2.fq" > "$gout/out.ssv"
    diff "$gout/out.ssv" "$ex/ENSG00000277117.truth.ssv"
    diff "$gout/out1.fq" "$ex/sharked.sample_1.truth.fq"
    diff "$gout/out2.fq" "$ex/sharked.sample_2.truth.fq"
    echo "GPU golden: OK"
  else
    echo "GPU golden: skipped (SHARK_EXAMPLE_DIR names no example data);" \
      "python chip_smoke.py checks the GPU against --backend native"
  fi
fi
echo "CI gate passed"
