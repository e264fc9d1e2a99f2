#!/usr/bin/env bash
# Dependency-drift gate of the PyTorch/CUDA port (downloader_tpu_torch):
# hack/verify-deps.sh's check over the port's tree. The contract: the
# port uses only the stdlib plus numpy; torch (the card's path) may be
# imported at module level ONLY under downloader_tpu_torch/parallel/,
# and must stay lazy everywhere else, so HTTP jobs and HTTP daemons run
# on installs without torch (the wheel's `gpu` extra).
set -euo pipefail
cd "$(dirname "$0")/.."
python3 - <<'EOF'
import ast
import sys
from pathlib import Path

PACKAGE = "downloader_tpu_torch"
STDLIB = sys.stdlib_module_names
CORE_DEPS = {"numpy"}        # declared in pyproject [project].dependencies
ACCEL_ONLY = {"torch"}       # allowed at top level only under parallel/

failed = 0
for path in sorted(Path(PACKAGE).rglob("*.py")):
    in_parallel = path.parts[1] == "parallel"
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [(node.module or "").split(".")[0]]
        else:
            continue
        for name in names:
            if not name or name in STDLIB or name == PACKAGE:
                continue
            if name in CORE_DEPS:
                continue
            if name in ACCEL_ONLY and (in_parallel or node.col_offset > 0):
                continue
            print(f"{path}:{node.lineno}: disallowed import {name!r}")
            failed += 1
sys.exit(1 if failed else 0)
EOF
echo "verify-deps-torch: OK (stdlib+numpy core, torch confined to parallel/)"
