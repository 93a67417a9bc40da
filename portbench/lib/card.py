"""The card a run measures: its name and power limit."""

from __future__ import annotations

import subprocess


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e.__class__.__name__})"
    return out.stdout.strip().replace("\n", "; ") or f"unknown (exit {out.returncode})"
