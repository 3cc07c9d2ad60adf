"""The numbers that decide ``correct``, and their limits.

For each output key of the reference: an exact key (counts) reads the
largest absolute difference; any other reads the largest |program -
reference| / scale, element by element, the scale being what the
reference module's ``scales`` gives for the key (an array of the
output's shape, each element against its own scale, or one number), or
else the reference's largest magnitude. A missing key, a changed shape
or a NaN reads infinity. Each number is the
largest over every snapshot of every request compared. ``inputs_changed``
is the largest relative change of a field's float64 sum between set-up
and the end of the window (the reference reads the inputs then).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np
import torch

INPUTS_CHANGED = "inputs_changed"


def snapshot_numbers(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                     scales: Dict[str, object], exact: Iterable[str]) -> Dict[str, float]:
    exact = set(exact)
    out = {}
    for key, r in ref.items():
        r = np.asarray(r, dtype=np.float64)
        g = got.get(key)
        if g is None or np.shape(g) != r.shape:
            out[key] = math.inf
            continue
        diff = np.abs(np.asarray(g, dtype=np.float64) - r)
        if key in exact:
            err = float(diff.max()) if diff.size else 0.0
        elif diff.size:
            scale = scales.get(key)
            scale = np.abs(r).max() if scale is None else np.asarray(scale, dtype=np.float64)
            err = float(np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0), diff).max())
        else:
            err = 0.0
        out[key] = math.inf if not math.isfinite(err) else err
    return out


def merge(into: Dict[str, float], numbers: Dict[str, float]) -> Dict[str, float]:
    """The larger reading of each key (NaN-safe: numbers are never NaN)."""
    for k, v in numbers.items():
        into[k] = max(into.get(k, -math.inf), v)
    return into


def fingerprints(inputs: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.sum(dtype=torch.float64)) for n, t in inputs.items()}


def inputs_changed(before: Dict[str, float], after: Dict[str, float]) -> float:
    worst = 0.0
    for n, b in before.items():
        a = after[n]
        worst = max(worst, abs(a - b) / max(abs(b), 1e-300) if math.isfinite(a) else math.inf)
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, list]:
    """{name: [reading, limit]} for every limited number, in the limits'
    order; a number without a reading reads infinity."""
    return {k: [numbers.get(k, math.inf), lim] for k, lim in limits.items()}


def passed(checks: Dict[str, list]) -> bool:
    return all(v <= lim for v, lim in checks.values())
