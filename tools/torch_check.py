#!/usr/bin/env python3
"""The port's static-analysis CLI (thin wrapper).

    python tools/torch_check.py                  # scanner_tpu_torch/, the gate
    python tools/torch_check.py scanner_tpu_torch/engine/
    python tools/torch_check.py --json
    python tools/torch_check.py --list-codes
    python tools/torch_check.py --select SC1 --select SC202

The implementation lives in scanner_tpu_torch/analysis/static/; this
wrapper only makes the repo checkout importable when invoked directly.
The flags and exit codes are tools/scanner_check.py's (0 clean, 1
findings, 2 usage or baseline error); the default target is the port
and the default baseline tools/torch_check_baseline.json.  See
docs/torch/analysis.md.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scanner_tpu_torch.analysis.static.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
