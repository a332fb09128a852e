"""DPM-Solver++ (2M): 2nd-order multistep solver, data-prediction form, the
counterpart of ``sdtpu/samplers/dpm.py``.

``plan`` does the schedule math in numpy float64 and casts the per-step
coefficient tables to float32 tensors on the device once; ``step`` is
branch-free tensor math on float32 latents. The 2nd-order mix-in ``i2r`` is
0 at step 0, which makes that step 1st order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32


class Plan(NamedTuple):
    """Per-step coefficient tables; every field is a float32 [steps]."""

    model_t: torch.Tensor      # UNet-facing timestep at the step's start
    alpha_s: torch.Tensor      # alpha(t_s)
    inv_alpha_s: torch.Tensor  # 1 / alpha(t_s)          (data-pred)
    sigma_s: torch.Tensor      # sigma(t_s)              (data-pred)
    sigma_ratio: torch.Tensor  # sigma(t_next)/sigma(t_s)
    alpha_phi: torch.Tensor    # alpha(t_next) * expm1(-h_i)
    i2r: torch.Tensor          # 1/(2 r_i); 0 at step 0  (2nd-order mix-in)


class State(NamedTuple):
    prev_y: torch.Tensor  # previous step's data prediction


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0,
         spacing: str = "uniform", *, device) -> Plan:
    """``start_step`` > 0 (a warm start): the solver's history restarts
    there, so the first executed step is pure 1st order (``i2r`` 0)."""
    ts = schedule.times(steps, spacing)           # [steps+1], 1 -> 1/N
    model_t = schedule.model_times(ts[:-1])       # [steps]
    alpha = schedule.marginal_alpha(ts)           # [steps+1]
    sigma = schedule.marginal_sigma(ts)
    lam = schedule.marginal_lambda(ts)
    h = lam[1:] - lam[:-1]                        # [steps]
    phi = np.expm1(-h)
    r = np.ones_like(h)
    r[1:] = h[:-1] / h[1:]
    i2r = 1.0 / (2.0 * r)
    i2r[: start_step + 1] = 0.0  # first executed step: pure 1st order
    return Plan(
        model_t=to_f32(model_t, device),
        alpha_s=to_f32(alpha[:-1], device),
        inv_alpha_s=to_f32(1.0 / alpha[:-1], device),
        sigma_s=to_f32(sigma[:-1], device),
        sigma_ratio=to_f32(sigma[1:] / sigma[:-1], device),
        alpha_phi=to_f32(alpha[1:] * phi, device),
        i2r=to_f32(i2r, device),
    )


def init_state(x: torch.Tensor) -> State:
    """The state for latents like ``x`` (every sampler of the port takes
    the latents, where the JAX package takes their shape)."""
    return State(prev_y=torch.zeros_like(x))


def step(p: Plan, i: int, x, eps, state: State):
    """One DPM-Solver++(2M) update."""
    y = (x - p.sigma_s[i] * eps) * p.inv_alpha_s[i]
    d = (1.0 + p.i2r[i]) * y - p.i2r[i] * state.prev_y
    x_next = p.sigma_ratio[i] * x - p.alpha_phi[i] * d
    return x_next, State(prev_y=y)
