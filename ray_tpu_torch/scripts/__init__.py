"""Scripts that measure the port on a CUDA card, and its test suite's clock
(`test_timeline`); run each with `python3 -m`."""
from __future__ import annotations

import subprocess


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
