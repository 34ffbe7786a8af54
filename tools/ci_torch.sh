#!/usr/bin/env bash
# CI gate for the PyTorch port: byte-compile lint, the port's tests and
# its tools, one stage for each stage of tools/ci.sh, in its order.
#
#   tools/ci_torch.sh                      # the tools on the card (default)
#   tools/ci_torch.sh --device cpu         # the tools on the CPU
#   tools/ci_torch.sh --full [...]         # the whole port suite (slow too)
#
# --device DEV goes to every tool that takes it; other arguments go to
# pytest.  The tests pick their own device (the CPU; the card tests are
# marked `cuda`).  The script stops at the first failing stage.
set -euo pipefail
cd "$(dirname "$0")/.."

MARK='not slow'
DEVICE=()
PYTEST_ARGS=()
while [[ $# -gt 0 ]]; do
    case "$1" in
        --full) MARK=''; shift ;;
        --device) DEVICE=(--device "$2"); shift 2 ;;
        --device=*) DEVICE=(--device "${1#--device=}"); shift ;;
        *) PYTEST_ARGS+=("$1"); shift ;;
    esac
done

echo "== compileall lint =="
python -m compileall -q src/repro_torch tests tools

echo "== pytest (WELD_VERIFY=1: weldcheck on every compile) =="
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
# every compile in the suite re-verifies its IR after each optimizer
# pass, after kernel planning, and after recovery rewrites
export WELD_VERIFY=1
if [[ -n "$MARK" ]]; then
    python -m pytest -x -q -m "$MARK" tests/test_torch_*.py \
        ${PYTEST_ARGS[@]+"${PYTEST_ARGS[@]}"}
else
    python -m pytest -x -q tests/test_torch_*.py \
        ${PYTEST_ARGS[@]+"${PYTEST_ARGS[@]}"}
fi

echo "== weldlint smoke (static verifier corpus + overhead gate) =="
# the corpus verifies clean at every checkpoint, the verifier's overhead
# is gated at <10% of compile time, and mutation recall at >=95%
python tools/weldlint_torch.py --smoke ${DEVICE[@]+"${DEVICE[@]}"}
python tools/weldlint_torch.py --mutate 3 ${DEVICE[@]+"${DEVICE[@]}"}

echo "== weldbound smoke (size/memory-bounds certificate gate) =="
# a peak-memory certificate on every corpus pipeline, the analysis
# overhead gated at <10% of compile time, the symbolic m:n certificate
python tools/weldlint_torch.py --bounds-smoke ${DEVICE[@]+"${DEVICE[@]}"}

# == kernelplan smoke ablation ==
# tools/ci.sh runs `python -m benchmarks.bench_kernelplan --smoke`; the
# port's torch-backed benchmarks are still to come (ROADMAP A6).

# == join smoke ablation ==
# tools/ci.sh runs `python -m benchmarks.bench_join --smoke`; deferred
# with the other benchmarks (ROADMAP A6).

echo "== recovery/faults smoke (adaptive recovery + quarantine check) =="
python tools/faults_smoke_torch.py ${DEVICE[@]+"${DEVICE[@]}"}

echo "== explain/trace smoke (weldtrace observability check) =="
WELD_TRACE=1 python tools/trace_smoke_torch.py ${DEVICE[@]+"${DEVICE[@]}"}

echo "== serve smoke (AOT staging + concurrent serving check) =="
python tools/serve_smoke_torch.py ${DEVICE[@]+"${DEVICE[@]}"}
