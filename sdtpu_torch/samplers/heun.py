"""Heun and DPM2 samplers (k-diffusion "Heun" / "DPM2"), the counterpart of
``sdtpu/samplers/heun.py``: single-step 2nd-order solvers that spend a
second UNet eval a step. In the k-diffusion parametrization (``x_k = x /
alpha``, ``sigma_k = sigma / alpha``, the derivative is eps):

* Heun: a full Euler step to ``t_next``, an eval there, the two
  derivatives averaged:
  ``x_k(next) = x_k + (sk_next - sk) * (eps(t_s) + eps(t_next)) / 2``;
* DPM2: an Euler step to the log-sigma midpoint, an eval there, and the
  full step with the midpoint's derivative alone:
  ``x_k(next) = x_k + (sk_next - sk) * eps(t_mid)``.

The pipeline drives them through ``NEEDS_SECOND_EVAL``: ``predictor`` gives
the probe point, the pipeline evaluates the UNet there at ``model_t2``
(its own time-embedding table), and ``step`` combines both derivatives.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32

NEEDS_SECOND_EVAL = True


class Plan(NamedTuple):
    """Per-step tables, shape [steps]."""

    model_t: torch.Tensor   # UNet-facing timestep at the step's start
    alpha_s: torch.Tensor   # alpha(t_s)
    sigma_s: torch.Tensor   # sigma(t_s)
    model_t2: torch.Tensor  # UNet-facing timestep of the second eval
    alpha_m: torch.Tensor   # alpha at the second eval's point
    sigma_m: torch.Tensor   # sigma at the second eval's point
    a_mid: torch.Tensor     # x -> probe: x_mid = a_mid * x + b_mid * eps1
    b_mid: torch.Tensor
    a_ratio: torch.Tensor   # full step: x' = a_ratio * x + b_coef * d
    b_coef: torch.Tensor
    w1: torch.Tensor        # d = w1 * eps1 + w2 * eps2
    w2: torch.Tensor


class State(NamedTuple):
    unused: torch.Tensor  # stateless; uniform interface only


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0,
         spacing: str = "uniform", kind: str = "heun", *, device) -> Plan:
    del start_step  # stateless: nothing to restart
    ts = schedule.times(steps, spacing)               # [steps+1], 1 -> 1/N
    alpha = schedule.marginal_alpha(ts)
    sigma = schedule.marginal_sigma(ts)
    sigk = sigma / alpha                              # k-diffusion sigma
    if kind == "heun":
        # probe = the full Euler step's end; derivatives average 50/50
        t_mid = ts[1:]
        sk_mid = sigk[1:]
        w1 = np.full(steps, 0.5)
        w2 = np.full(steps, 0.5)
    elif kind == "dpm2":
        # probe = the log-sigma midpoint; its derivative alone takes the step
        sk_mid = np.exp(0.5 * (np.log(sigk[:-1]) + np.log(sigk[1:])))
        # invert sigma_k(t) on the train grid, as karras_times does
        t_mid = np.interp(sk_mid, schedule.sigk_grid(), schedule.t_grid)
        w1 = np.zeros(steps)
        w2 = np.ones(steps)
    else:
        raise ValueError(f"unknown kind {kind!r}; expected 'heun' or 'dpm2'")
    a_mid = schedule.marginal_alpha(t_mid)
    s_mid = schedule.marginal_sigma(t_mid)
    return Plan(
        model_t=to_f32(schedule.model_times(ts[:-1]), device),
        alpha_s=to_f32(alpha[:-1], device),
        sigma_s=to_f32(sigma[:-1], device),
        model_t2=to_f32(schedule.model_times(t_mid), device),
        alpha_m=to_f32(a_mid, device),
        sigma_m=to_f32(s_mid, device),
        a_mid=to_f32(a_mid / alpha[:-1], device),
        b_mid=to_f32(a_mid * (sk_mid - sigk[:-1]), device),
        a_ratio=to_f32(alpha[1:] / alpha[:-1], device),
        b_coef=to_f32(alpha[1:] * (sigk[1:] - sigk[:-1]), device),
        w1=to_f32(w1, device),
        w2=to_f32(w2, device),
    )


def init_state(x: torch.Tensor) -> State:
    return State(unused=x.new_zeros(()))


def predictor(p: Plan, i, x, eps):
    """The probe point of the second eval (VP space): Euler to its time."""
    return p.a_mid[i] * x + p.b_mid[i] * eps


def step(p: Plan, i, x, eps, state: State, eps2=None):
    """The combined 2nd-order update; ``eps2`` is the model's prediction at
    the probe point."""
    d = p.w1[i] * eps + p.w2[i] * eps2
    return p.a_ratio[i] * x + p.b_coef[i] * d, state
