"""LMS sampler (k-diffusion "LMS": Adams-Bashforth on the real sigma grid),
the counterpart of ``sdtpu/samplers/lms.py``. In the k-diffusion
parametrization (``x_k = x / alpha``, ``sigma_k = sigma / alpha``, the
derivative is eps) the weights integrate the Lagrange basis over each
step's own sigma interval,

    c_j = integral_{sig_i}^{sig_{i+1}} prod_{m != j}
              (t - sig_{i-m}) / (sig_{i-j} - sig_{i-m}) dt,

so the method keeps its order under any spacing (Karras included). The
quadrature (a dense trapezoid rule) runs in numpy at plan time into a
``[steps, 4]`` table; ``step`` is one multiply-accumulate over the eps
history, whose order ramps 1 -> 4 from the first executed step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32

# numpy 2 renamed trapz; both integrate the same way
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Plan(NamedTuple):
    model_t: torch.Tensor   # [steps] UNet-facing timestep at step start
    alpha_s: torch.Tensor   # alpha(t_s)
    sigma_s: torch.Tensor   # sigma(t_s)
    a_ratio: torch.Tensor   # alpha(t_next) / alpha(t_s)
    lms_coef: torch.Tensor  # [steps, 4] alpha(t_next) * integrated weights
    #                         for (eps, e1, e2, e3)


class State(NamedTuple):
    e1: torch.Tensor
    e2: torch.Tensor
    e3: torch.Tensor


def _weights(sigk: np.ndarray, i: int, order: int, n_quad: int = 4096):
    """Integrated Lagrange-basis weights for step i at the given order."""
    lo, hi = sigk[i], sigk[i + 1]
    t = np.linspace(lo, hi, n_quad)
    out = np.zeros(4)
    for j in range(order):
        basis = np.ones_like(t)
        for m in range(order):
            if m != j:
                basis *= (t - sigk[i - m]) / (sigk[i - j] - sigk[i - m])
        out[j] = _trapezoid(basis, t)
    return out


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0,
         spacing: str = "uniform", *, device) -> Plan:
    """``start_step`` > 0 (a warm start): the order ramp restarts at 1 from
    the first executed step; zero history never enters."""
    ts = schedule.times(steps, spacing)               # [steps+1]
    alpha = np.asarray(schedule.marginal_alpha(ts), np.float64)
    sigma = np.asarray(schedule.marginal_sigma(ts), np.float64)
    sigk = sigma / alpha
    coef = np.zeros((steps, 4))
    for i in range(steps):
        order = int(min(max(i - start_step, 0) + 1, 4))
        coef[i] = alpha[i + 1] * _weights(sigk, i, order)
    return Plan(
        model_t=to_f32(schedule.model_times(ts[:-1]), device),
        alpha_s=to_f32(alpha[:-1], device),
        sigma_s=to_f32(sigma[:-1], device),
        a_ratio=to_f32(alpha[1:] / alpha[:-1], device),
        lms_coef=to_f32(coef, device),
    )


def init_state(x: torch.Tensor) -> State:
    z = torch.zeros_like(x)
    return State(e1=z, e2=z, e3=z)


def step(p: Plan, i, x, eps, state: State):
    c = p.lms_coef[i]
    d = c[0] * eps + c[1] * state.e1 + c[2] * state.e2 + c[3] * state.e3
    return p.a_ratio[i] * x + d, State(e1=eps, e2=state.e1, e3=state.e2)
