"""DDIM sampler (eta=0, deterministic), discrete-timestep form, the
counterpart of ``sdtpu/samplers/ddim.py``.

Timesteps ``[1, 1+c, ..., 1+(S-1)c][::-1]`` with ``c = N // S`` (the CompVis
convention); the "previous" alpha-bar of the final step is
``alphas_cumprod[0]``. ``plan`` is the reference's float64 numpy math, cast
once to float32 tensors on the device; ``step`` is branch-free tensor math.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32


class Plan(NamedTuple):
    model_t: torch.Tensor          # [steps] discrete timestep fed to the UNet
    sqrt_abar: torch.Tensor        # [steps] sqrt(alphabar_t)
    sqrt_1m_abar: torch.Tensor     # [steps] sqrt(1 - alphabar_t)
    sqrt_abar_prev: torch.Tensor   # [steps]
    sqrt_1m_abar_prev: torch.Tensor

    # the marginals at each step's start, under the uniform names
    @property
    def alpha_s(self):
        return self.sqrt_abar

    @property
    def sigma_s(self):
        return self.sqrt_1m_abar


class State(NamedTuple):
    unused: torch.Tensor  # single-step: a dummy, for a uniform interface


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0, *,
         device) -> Plan:
    del start_step  # single-step: no history to restart
    ts = schedule.ddim_timesteps(steps)                # descending, 951..1
    abar = schedule.alphas_cumprod[ts]                 # [steps]
    abar_prev = np.concatenate(
        [schedule.alphas_cumprod[ts[1:]], schedule.alphas_cumprod[:1]])
    return Plan(
        model_t=to_f32(ts, device),
        sqrt_abar=to_f32(np.sqrt(abar), device),
        sqrt_1m_abar=to_f32(np.sqrt(1.0 - abar), device),
        sqrt_abar_prev=to_f32(np.sqrt(abar_prev), device),
        sqrt_1m_abar_prev=to_f32(np.sqrt(1.0 - abar_prev), device),
    )


def init_state(x: torch.Tensor) -> State:
    return State(unused=x.new_zeros(()))


def step(p: Plan, i, x, eps, state: State):
    x0 = (x - p.sqrt_1m_abar[i] * eps) / p.sqrt_abar[i]
    x_next = p.sqrt_abar_prev[i] * x0 + p.sqrt_1m_abar_prev[i] * eps
    return x_next, state
