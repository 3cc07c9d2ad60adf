"""Driven supersonic turbulence on a uniform grid.

Gaussian random velocities with a power-law shell spectrum
(``velocity_energy_slope``) at an rms Mach number ``mach`` (sound speed
``sound_speed``), and a lognormal density ``rho = mean_density *
exp(s)``, where s is a Gaussian random field (shell slope
``log_density_energy_slope``) of variance sigma^2 = ln(1 + b^2 M^2), the
density-variance relation of Federrath et al. 2010 (b the forcing
parameter: 1/3 solenoidal, 1 compressive), and mean -sigma^2 / 2.
Draws in a fixed order from the generator: velx, vely, velz, then s.
"""

from __future__ import annotations

import math

from harness.fields import gaussian_field, mode_exponent


def fill(out, args, gen) -> None:
    """Fill the (nx, ny, nz) float32 tensors of ``out`` (dens, velx,
    vely, velz, any subset) from ``gen``."""
    v_exp = mode_exponent(args["velocity_energy_slope"], 3)
    component_rms = args["mach"] * args["sound_speed"] / math.sqrt(3.0)
    for name in ("velx", "vely", "velz"):
        if name in out:
            gaussian_field(out[name], v_exp, gen).mul_(component_rms)
    if "dens" in out:
        b, mach = args["forcing_b"], args["mach"]
        sigma2 = math.log1p(b * b * mach * mach)
        s = gaussian_field(out["dens"], mode_exponent(args["log_density_energy_slope"], 3), gen)
        s.mul_(math.sqrt(sigma2)).sub_(sigma2 / 2.0).exp_().mul_(args["mean_density"])
