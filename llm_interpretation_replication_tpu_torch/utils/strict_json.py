"""Strict-JSON dumping: non-finite floats become null, not bare NaN tokens.

``json.dump`` emits literal ``NaN``/``Infinity`` for non-finite floats
(allow_nan default), which jq / JavaScript ``JSON.parse`` / strict parsers
reject.  Analysis artifacts routinely contain NaN statistics (all-error
groups, empty subsets), so every artifact writer sanitizes through here.
"""

from __future__ import annotations

import json
import math
import os


def nan_to_null(obj):
    """Recursively replace non-finite floats (incl. numpy scalars) with None."""
    if isinstance(obj, dict):
        return {k: nan_to_null(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [nan_to_null(v) for v in obj]
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if hasattr(obj, "dtype") and getattr(obj, "ndim", None) == 0:
        val = float(obj)
        return val if math.isfinite(val) else None
    return obj


def dump_strict(obj, path: str, indent: int = 2) -> str:
    """Write ``obj`` as strict JSON (parent dirs created, utf-8, NaN→null)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(nan_to_null(obj), f, indent=indent, default=float)
    return path
