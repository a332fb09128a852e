"""PLMS (pseudo linear multistep) sampler, the counterpart of
``sdtpu/samplers/plms.py``: Adams-Bashforth on the noise prediction with the
DDIM transfer formula. The order ramps 1 -> 4 as history fills, encoded as a
per-step ``[steps, 4]`` coefficient table so ``step`` is branch-free:

    order 1:  e
    order 2:  (3 e - e1) / 2
    order 3:  (23 e - 16 e1 + 5 e2) / 12
    order 4:  (55 e - 59 e1 + 37 e2 - 9 e3) / 24

``"plms"`` takes a plain 1st-order step 0 (one UNet eval a step);
``"plms_exact"`` is the same module, and the pipeline spends a second eval
on CompVis's pseudo-improved-Euler step 0 (``engine/pipeline.denoise``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.samplers import ddim
from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32


class Plan(NamedTuple):
    model_t: torch.Tensor
    sqrt_abar: torch.Tensor
    sqrt_1m_abar: torch.Tensor
    sqrt_abar_prev: torch.Tensor
    sqrt_1m_abar_prev: torch.Tensor
    ab_coef: torch.Tensor  # [steps, 4] weights for (e, e1, e2, e3)

    @property
    def alpha_s(self):
        return self.sqrt_abar

    @property
    def sigma_s(self):
        return self.sqrt_1m_abar


class State(NamedTuple):
    e1: torch.Tensor
    e2: torch.Tensor
    e3: torch.Tensor


_AB_TABLE = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [3.0 / 2.0, -1.0 / 2.0, 0.0, 0.0],
    [23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0, 0.0],
    [55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0],
])


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0, *,
         device) -> Plan:
    """``start_step`` > 0 (a warm start): the order ramp restarts at 1 from
    the first executed step, so zero history never enters the blend."""
    base = ddim.plan(schedule, steps, device=device)
    orders = np.clip(np.arange(steps) - start_step, 0, 3)
    return Plan(*base, ab_coef=to_f32(_AB_TABLE[orders], device))


def init_state(x: torch.Tensor) -> State:
    z = torch.zeros_like(x)
    return State(e1=z, e2=z, e3=z)


def step(p: Plan, i, x, eps, state: State):
    c = p.ab_coef[i]
    e_prime = c[0] * eps + c[1] * state.e1 + c[2] * state.e2 + c[3] * state.e3
    x0 = (x - p.sqrt_1m_abar[i] * e_prime) / p.sqrt_abar[i]
    x_next = p.sqrt_abar_prev[i] * x0 + p.sqrt_1m_abar_prev[i] * e_prime
    return x_next, State(e1=eps, e2=state.e1, e3=state.e2)
