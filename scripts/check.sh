#!/usr/bin/env bash
# One-command health check:
#   scripts/check.sh        fast tier + the multi-device dry run
#   scripts/check.sh full   full suite + the multi-device dry run
# Tests run on the CPU (tests/conftest.py forces the CPU platform with 8
# virtual devices).  The GPU path is checked by `python chip_smoke.py`
# on a machine with a card (add --four for the four-card paths).
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== pytest ${1:-fast tier}"
if [ "${1:-}" = "full" ]; then
  python -m pytest tests/ -q
else
  python -m pytest tests/ -m "not slow" -q
fi

echo "== entry() + dryrun_multichip(8) (virtual CPU mesh)"
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  python __graft_entry__.py

echo "ALL CHECKS PASSED"
