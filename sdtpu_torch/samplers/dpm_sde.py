"""DPM-Solver++(2M) SDE, midpoint variant, eta=1 (k-diffusion's "DPM++ 2M
SDE"), the counterpart of ``sdtpu/samplers/dpm_sde.py``. In VP space, with
``h = lambda_next - lambda`` and y the data prediction (x - sigma*eps)/alpha:

    x_next = (sigma_next/sigma) * exp(-h) * x
             + alpha_next * (1 - exp(-2h)) * [y + mix * (y - y_prev)]
             + sigma_next * sqrt(1 - exp(-2h)) * noise
    mix    = h / (2 * h_prev)            (0 at the first executed step)

Everything data-independent is a [steps] table; ``step`` takes a
standard-normal draw a step (``NEEDS_NOISE``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32

#: pipeline contract: step() takes a per-step standard-normal ``noise``
NEEDS_NOISE = True


class Plan(NamedTuple):
    """Per-step coefficient tables; every field has shape [steps]."""

    model_t: torch.Tensor      # UNet-facing timestep at the step's start
    alpha_s: torch.Tensor      # alpha(t_s)
    inv_alpha_s: torch.Tensor  # 1 / alpha(t_s)          (data-pred)
    sigma_s: torch.Tensor      # sigma(t_s)              (data-pred)
    c_x: torch.Tensor          # (sigma_next/sigma_s) * exp(-h)
    c_y: torch.Tensor          # alpha_next * (1 - exp(-2h))
    mix: torch.Tensor          # h / (2 h_prev); 0 at the first executed step
    c_n: torch.Tensor          # sigma_next * sqrt(1 - exp(-2h))


class State(NamedTuple):
    prev_y: torch.Tensor  # previous step's data prediction


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0,
         spacing: str = "uniform", *, device) -> Plan:
    """``start_step`` > 0 (a warm start): the history restarts there, the
    first executed step is 1st order (``mix`` 0)."""
    ts = schedule.times(steps, spacing)               # [steps+1], 1 -> 1/N
    model_t = schedule.model_times(ts[:-1])
    alpha = schedule.marginal_alpha(ts)
    sigma = schedule.marginal_sigma(ts)
    lam = schedule.marginal_lambda(ts)
    h = lam[1:] - lam[:-1]                        # [steps], > 0
    em2h = -np.expm1(-2.0 * h)                    # 1 - exp(-2h)
    mix = np.zeros_like(h)
    mix[1:] = h[1:] / (2.0 * h[:-1])
    mix[: start_step + 1] = 0.0
    return Plan(
        model_t=to_f32(model_t, device),
        alpha_s=to_f32(alpha[:-1], device),
        inv_alpha_s=to_f32(1.0 / alpha[:-1], device),
        sigma_s=to_f32(sigma[:-1], device),
        c_x=to_f32(sigma[1:] / sigma[:-1] * np.exp(-h), device),
        c_y=to_f32(alpha[1:] * em2h, device),
        mix=to_f32(mix, device),
        c_n=to_f32(sigma[1:] * np.sqrt(em2h), device),
    )


def init_state(x: torch.Tensor) -> State:
    return State(prev_y=torch.zeros_like(x))


def step(p: Plan, i, x, eps, state: State, noise=None):
    """One DPM++(2M) SDE update; ``noise`` is a standard-normal tensor like
    x."""
    y = (x - p.sigma_s[i] * eps) * p.inv_alpha_s[i]
    d = y + p.mix[i] * (y - state.prev_y)
    x_next = p.c_x[i] * x + p.c_y[i] * d + p.c_n[i] * noise
    return x_next, State(prev_y=y)
