"""Euler-ancestral sampler (k-diffusion "Euler a", stochastic), the
counterpart of ``sdtpu/samplers/euler_a.py``. One Euler step toward the
ancestral noise level, then fresh noise back up to the marginal (``x_k =
x/alpha``, ``sigma_k = sigma/alpha``):

    sigma_up^2   = sigma_k_next^2 * (sigma_k^2 - sigma_k_next^2) / sigma_k^2
    sigma_down   = sqrt(sigma_k_next^2 - sigma_up^2)
    x_k(next)    = x_k + (sigma_down - sigma_k) * eps + sigma_up * noise

mapped back to VP space. ``step`` takes a standard-normal draw a step
(``NEEDS_NOISE``), which the pipeline supplies per sample.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32

#: pipeline contract: step() takes a per-step standard-normal ``noise``
NEEDS_NOISE = True


class Plan(NamedTuple):
    """Per-step tables, shape [steps]."""

    model_t: torch.Tensor   # UNet-facing timestep at the step's start
    alpha_s: torch.Tensor   # alpha(t_s)
    sigma_s: torch.Tensor   # sigma(t_s)
    a_ratio: torch.Tensor   # alpha(t_next) / alpha(t_s)
    b_coef: torch.Tensor    # alpha(t_next) * (sigma_down - sigma_k)
    n_coef: torch.Tensor    # alpha(t_next) * sigma_up


class State(NamedTuple):
    unused: torch.Tensor  # stateless; uniform interface only


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0,
         spacing: str = "uniform", *, device) -> Plan:
    del start_step  # stateless: nothing to restart
    ts = schedule.times(steps, spacing)               # [steps+1], 1 -> 1/N
    alpha = schedule.marginal_alpha(ts)
    sigma = schedule.marginal_sigma(ts)
    sigk = sigma / alpha                      # k-diffusion sigma, decreasing
    s2, n2 = sigk[:-1] ** 2, sigk[1:] ** 2
    up2 = n2 * (s2 - n2) / s2
    down = np.sqrt(n2 - up2)
    return Plan(
        model_t=to_f32(schedule.model_times(ts[:-1]), device),
        alpha_s=to_f32(alpha[:-1], device),
        sigma_s=to_f32(sigma[:-1], device),
        a_ratio=to_f32(alpha[1:] / alpha[:-1], device),
        b_coef=to_f32(alpha[1:] * (down - sigk[:-1]), device),
        n_coef=to_f32(alpha[1:] * np.sqrt(up2), device),
    )


def init_state(x: torch.Tensor) -> State:
    return State(unused=x.new_zeros(()))


def step(p: Plan, i, x, eps, state: State, noise=None):
    """One ancestral step; ``noise`` is a standard-normal tensor like x."""
    x_next = p.a_ratio[i] * x + p.b_coef[i] * eps + p.n_coef[i] * noise
    return x_next, state
