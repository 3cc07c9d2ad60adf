"""The cell's inputs and the program's entry that a request drives.

A traffic file's ``entry`` is one of two kinds, so that a new mix needs
only a data file:

- ``{"kind": "model", "analyses": [{"name": ..., "args": {...}}]}``:
  ``fava_tpu_torch.from_arrays`` over the snapshot's fields once at
  set-up, then each request calls the analyses by name on that model
  (their outputs come back as numpy). One snapshot a request.
- ``{"kind": "function", "function": "<module>.<name>"}``: a batch
  function of the port over the stacked (batch, nx, ny, nz) fields; each
  request calls it and copies every output to the host.

The inputs are made on the device from the seed by the configuration's
generator, one snapshot after another into stacked buffers.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from harness import spec


def make_inputs(config: dict, traffic: dict, seed: int, device, shape=None) -> Dict[str, torch.Tensor]:
    """(batch, nx, ny, nz) tensors of the traffic's fields in the
    configuration's dtype on ``device``, snapshot i drawn i-th from one
    generator seeded with ``seed``. ``shape`` replaces the configuration's
    (for tests at small sizes)."""
    shape = tuple(int(s) for s in (shape or config["shape"]))
    dtype = getattr(torch, config["dtype"])
    batch = int(traffic.get("batch", 1))
    names = list(traffic["fields"])
    missing = sorted(set(names) - set(config["fields"]))
    if missing:
        raise KeyError(f"traffic reads {missing}, which configuration {config['name']} lacks")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**64 - 1))
    fill = spec.load_module("generators", config["generator"]).fill
    stacked = {n: torch.empty((batch,) + shape, dtype=dtype, device=device) for n in names}
    for i in range(batch):
        fill({n: t[i] for n, t in stacked.items()}, config["generator_args"], gen)
    return stacked


def snapshot(inputs: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {n: t[i] for n, t in inputs.items()}


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def _flatten(prefix: str, value, out: Dict[str, np.ndarray]) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    else:
        out[prefix] = _host(value)


class Entry:
    """The program's entry for one cell, built once at set-up."""

    def __init__(self, traffic: dict, inputs: Dict[str, torch.Tensor], config: dict, device):
        self.kind = traffic["entry"]["kind"]
        self.batch = int(traffic.get("batch", 1))
        self._inputs = inputs
        if self.kind == "model":
            if self.batch != 1:
                raise ValueError("a model entry takes one snapshot a request (batch 1)")
            import fava_tpu_torch

            self._analyses = traffic["entry"]["analyses"]
            bounds = config.get("domain_bounds")
            self._model = fava_tpu_torch.from_arrays(
                snapshot(inputs, 0), domain_bounds=None if bounds is None else np.asarray(bounds),
                device=device)
        elif self.kind == "function":
            module, _, name = traffic["entry"]["function"].rpartition(".")
            self._fn = getattr(importlib.import_module(module), name)
        else:
            raise ValueError(f"unknown entry kind {self.kind!r}")

    def request(self) -> List[Dict[str, np.ndarray]]:
        """One request: the outputs of each of its snapshots, on the host."""
        if self.kind == "model":
            out: Dict[str, np.ndarray] = {}
            for a in self._analyses:
                res = getattr(self._model, a["name"])(**a.get("args", {}))
                _flatten("" if len(self._analyses) == 1 else a["name"], res, out)
            return [out]
        res = self._fn(*self._inputs.values())
        host = {k: _host(v) for k, v in res.items()}
        return [{k: v[i] for k, v in host.items()} for i in range(self.batch)]

    def release(self) -> None:
        """Drop the program's state (the inputs stay with the caller)."""
        self._model = None
        self._fn = None
