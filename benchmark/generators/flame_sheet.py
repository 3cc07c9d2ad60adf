"""A wrinkled flame sheet across two densities, with turbulent velocities.

The progress variable ``flam`` goes from 1 (ash) below the front to 0
(fuel) above it, across a tanh of ``thickness_cells`` cells; the front
lies at x = ``front_x`` (a share of the window's x extent) displaced by
``wrinkle_amplitude`` times a unit-rms Gaussian random field over (y, z)
with shell slope ``wrinkle_energy_slope``. The density runs from
``dens_fuel`` to ``dens_ash`` with ``flam``. The velocities are Gaussian
random fields with shell slope ``velocity_energy_slope`` and rms
``velocity_rms`` over the three components. Draws in a fixed order from
the generator: the wrinkles, then velx, vely, velz.
"""

from __future__ import annotations

import math

import torch

from harness.fields import gaussian_field, mode_exponent


def fill(out, args, gen) -> None:
    """Fill the (nx, ny, nz) float32 tensors of ``out`` (dens, velx,
    vely, velz, flam, any subset) from ``gen``."""
    some = next(iter(out.values()))
    nx, ny, nz = (int(s) for s in some.shape)
    dev = some.device
    wrinkles = torch.empty((ny, nz), dtype=torch.float32, device=dev)
    gaussian_field(wrinkles, mode_exponent(args["wrinkle_energy_slope"], 2), gen)
    front = wrinkles.mul_(args["wrinkle_amplitude"]).add_(args["front_x"])
    v_exp = mode_exponent(args["velocity_energy_slope"], 3)
    component_rms = args["velocity_rms"] / math.sqrt(3.0)
    for name in ("velx", "vely", "velz"):
        if name in out:
            gaussian_field(out[name], v_exp, gen).mul_(component_rms)
    if "dens" not in out and "flam" not in out:
        return
    flam = out["dens"] if "dens" in out else out["flam"]
    x = (torch.arange(nx, dtype=torch.float32, device=dev) + 0.5) / nx
    torch.sub(front[None], x[:, None, None], out=flam)
    flam.mul_(nx / args["thickness_cells"]).tanh_().add_(1.0).mul_(0.5)
    if "flam" in out and flam is not out["flam"]:
        out["flam"].copy_(flam)
    if "dens" in out:
        fuel, ash = args["dens_fuel"], args["dens_ash"]
        flam.mul_(ash - fuel).add_(fuel)
