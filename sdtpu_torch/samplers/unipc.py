"""UniPC sampler: order-2 unified predictor-corrector, data-prediction
form, the counterpart of ``sdtpu/samplers/unipc.py``. With ``h = lambda_t -
lambda_s``, ``phi1 = 1 - e^-h``, ``phik = phi1/h - 1`` and m the data
prediction (x - sigma eps)/alpha:

    predictor:  x_t = (sigma_t/sigma_s) x_s + alpha_t phi1 m_s
                      - alpha_t phik (h/h_prev) (m_s - m_prev)
    corrector:  x_t' = (sigma_t/sigma_s) x_s + alpha_t phi1 m_s
                      - alpha_t phik (m_t - m_s)

The corrector reuses the model output already taken at the predicted
sample: one UNet eval a step. Every coefficient is a [steps] table; the
first executed step gates off both the 2nd-order term and the corrector.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32


class Plan(NamedTuple):
    """Per-step tables, shape [steps]."""

    model_t: torch.Tensor      # UNet-facing timestep at the step's start
    alpha_s: torch.Tensor      # alpha(t_s)
    inv_alpha_s: torch.Tensor  # 1/alpha(t_s) (data prediction)
    sigma_s: torch.Tensor      # sigma(t_s)
    # predictor (transition i -> i+1)
    p_sr: torch.Tensor   # sigma(t_next)/sigma(t_s)
    p_m0: torch.Tensor   # alpha(t_next) * phi1(h_i)
    p_d: torch.Tensor    # -alpha(t_next) phik(h_i) h_i/h_{i-1}; 0 w/o history
    # corrector (re-does transition i-1 -> i with the step-i model output)
    c_g: torch.Tensor    # 1 where the corrector is active, 0 at the first
    c_sr: torch.Tensor   # sigma(t_s)/sigma(t_prev)
    c_m0: torch.Tensor   # alpha(t_s) * phi1(h_{i-1})
    c_d: torch.Tensor    # -alpha(t_s) * phik(h_{i-1})


class State(NamedTuple):
    last_x: torch.Tensor  # previous step's (corrected) sample
    m_prev: torch.Tensor  # previous step's data prediction


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0,
         spacing: str = "uniform", *, device) -> Plan:
    ts = schedule.times(steps, spacing)               # [steps+1], 1 -> 1/N
    alpha = schedule.marginal_alpha(ts)
    sigma = schedule.marginal_sigma(ts)
    lam = schedule.marginal_lambda(ts)
    h = lam[1:] - lam[:-1]                       # [steps], > 0
    h_prev = np.concatenate([[1.0], h[:-1]])     # [steps]; [0] is a dummy
    phi1 = -np.expm1(-h)                         # 1 - e^-h
    phik = phi1 / h - 1.0                        # negative
    p_d = -alpha[1:] * phik * h / h_prev
    p_d[: start_step + 1] = 0.0  # first executed step: no history
    # the corrector's tables are the transition (i-1 -> i): h shifted by one
    c_g = np.ones(steps)
    c_g[: start_step + 1] = 0.0  # first executed step: nothing to correct
    c_sr = np.concatenate([[1.0], sigma[1:-1] / sigma[:-2]])
    c_m0 = np.concatenate([[0.0], alpha[1:-1] * phi1[:-1]])
    c_d = np.concatenate([[0.0], -alpha[1:-1] * phik[:-1]])
    return Plan(
        model_t=to_f32(schedule.model_times(ts[:-1]), device),
        alpha_s=to_f32(alpha[:-1], device),
        inv_alpha_s=to_f32(1.0 / alpha[:-1], device),
        sigma_s=to_f32(sigma[:-1], device),
        p_sr=to_f32(sigma[1:] / sigma[:-1], device),
        p_m0=to_f32(alpha[1:] * phi1, device),
        p_d=to_f32(p_d, device),
        c_g=to_f32(c_g, device),
        c_sr=to_f32(c_sr, device),
        c_m0=to_f32(c_m0, device),
        c_d=to_f32(c_d, device),
    )


def init_state(x: torch.Tensor) -> State:
    return State(last_x=torch.zeros_like(x), m_prev=torch.zeros_like(x))


def step(p: Plan, i, x, eps, state: State):
    """Correct the arrival at ``x`` with this step's model output, then
    predict the next sample."""
    m = (x - p.sigma_s[i] * eps) * p.inv_alpha_s[i]
    corr = (p.c_sr[i] * state.last_x + p.c_m0[i] * state.m_prev
            + p.c_d[i] * (m - state.m_prev))
    xc = p.c_g[i] * corr + (1.0 - p.c_g[i]) * x
    x_next = p.p_sr[i] * xc + p.p_m0[i] * m + p.p_d[i] * (m - state.m_prev)
    return x_next, State(last_x=xc, m_prev=m)
