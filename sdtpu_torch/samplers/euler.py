"""Euler sampler (k-diffusion "Euler discrete", deterministic), the
counterpart of ``sdtpu/samplers/euler.py``. With ``x_k = x / alpha`` and
``sigma_k = sigma / alpha`` the probability-flow ODE's derivative is the
noise prediction, so a step is

    x_k(next) = x_k + (sigma_k_next - sigma_k) * eps

mapped back to the VP-space ``x`` the pipeline carries; both coefficients
fold into per-step tables. Stateless.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32


class Plan(NamedTuple):
    """Per-step tables, shape [steps]."""

    model_t: torch.Tensor   # UNet-facing timestep at the step's start
    alpha_s: torch.Tensor   # alpha(t_s)
    sigma_s: torch.Tensor   # sigma(t_s)
    a_ratio: torch.Tensor   # alpha(t_next) / alpha(t_s)
    b_coef: torch.Tensor    # alpha(t_next) * (sigma_k_next - sigma_k)


class State(NamedTuple):
    unused: torch.Tensor  # stateless; uniform interface only


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0,
         spacing: str = "uniform", *, device) -> Plan:
    del start_step  # stateless: nothing to restart
    ts = schedule.times(steps, spacing)               # [steps+1], 1 -> 1/N
    alpha = schedule.marginal_alpha(ts)
    sigma = schedule.marginal_sigma(ts)
    sigk = sigma / alpha                              # k-diffusion sigma
    return Plan(
        model_t=to_f32(schedule.model_times(ts[:-1]), device),
        alpha_s=to_f32(alpha[:-1], device),
        sigma_s=to_f32(sigma[:-1], device),
        a_ratio=to_f32(alpha[1:] / alpha[:-1], device),
        b_coef=to_f32(alpha[1:] * (sigk[1:] - sigk[:-1]), device),
    )


def init_state(x: torch.Tensor) -> State:
    return State(unused=x.new_zeros(()))


def step(p: Plan, i, x, eps, state: State):
    """x_next = alpha_next * (x/alpha + (sigk_next - sigk) * eps)."""
    return p.a_ratio[i] * x + p.b_coef[i] * eps, state
