"""Reproducibility helpers.

Capability parity: reference ``src/cli/utilities.py`` — git hash capture
and dirty-tree warning (used by train for run provenance, train.py:107-120).
"""

from __future__ import annotations

import subprocess


def get_git_hash() -> str:
    try:
        return subprocess.check_output(
            ['git', 'rev-parse', 'HEAD'],
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return 'unknown'


def has_uncommitted_changes() -> bool:
    try:
        out = subprocess.check_output(
            ['git', 'status', '--porcelain'],
            stderr=subprocess.DEVNULL).decode().strip()
        return bool(out)
    except Exception:
        return False
