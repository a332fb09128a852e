"""LCM sampler (latent consistency models, Luo et al. 2023), the
counterpart of ``sdtpu/samplers/lcm.py``: the module, its plan and its
step (diffusers' ``LCMScheduler``, matched exactly):

* timestep grid: the original-DDIM subsequence ``k*i - 1`` (k = 1000/50)
  thinned to ``steps`` entries from the top;
* boundary scalings at scaled time ``s = 10 * t``:
  ``c_skip = 0.25 / (s^2 + 0.25)``, ``c_out = s / sqrt(s^2 + 0.25)``;
* update: ``denoised = c_out * x0_pred + c_skip * x``, then ``x' =
  alpha_next * denoised + sigma_next * noise`` (``NEEDS_NOISE``); the last
  step returns ``denoised`` (alpha_next 1, sigma_next 0 in the tables).

Guidance is not applied here: distilled checkpoints (``sd15_lcm``) take the
scale through the UNet's guidance embedding (``engine/pipeline.denoise``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdtpu_torch.samplers.schedule import NoiseSchedule, to_f32

NEEDS_NOISE = True

#: diffusers LCMScheduler defaults
ORIGINAL_INFERENCE_STEPS = 50
TIMESTEP_SCALING = 10.0
SIGMA_DATA = 0.5


class Plan(NamedTuple):
    """Per-step tables, shape [steps]."""

    model_t: torch.Tensor   # discrete UNet-facing timestep
    alpha_s: torch.Tensor   # sqrt(alphas_cumprod[t])   (x0 extraction)
    sigma_s: torch.Tensor   # sqrt(1 - alphas_cumprod[t])
    c_skip: torch.Tensor    # consistency boundary scalings
    c_out: torch.Tensor
    a_next: torch.Tensor    # re-noise marginals at the next grid point
    s_next: torch.Tensor    # (last step: 1.0 / 0.0 -> returns denoised)


class State(NamedTuple):
    unused: torch.Tensor  # stateless; uniform interface only


def timestep_grid(schedule: NoiseSchedule, steps: int,
                  original_steps: int = ORIGINAL_INFERENCE_STEPS):
    """The LCM timestep subsequence: origin grid ``arange(1,
    original_steps+1) * (N // original_steps) - 1``, reversed, thinned by
    ``original_steps // steps``, first ``steps`` kept."""
    if steps > original_steps:
        raise ValueError(
            f"LCM supports at most original_steps={original_steps} steps, "
            f"got {steps}")
    k = schedule.num_train_steps // original_steps
    origin = np.arange(1, original_steps + 1, dtype=np.int64) * k - 1
    skip = original_steps // steps
    return origin[::-1][::skip][:steps]


def plan(schedule: NoiseSchedule, steps: int, start_step: int = 0, *,
         device) -> Plan:
    del start_step  # stateless: nothing to restart
    ts = timestep_grid(schedule, steps)
    abar = schedule.alphas_cumprod
    a = np.sqrt(abar[ts])
    s = np.sqrt(1.0 - abar[ts])
    a_next = np.concatenate([np.sqrt(abar[ts[1:]]), [1.0]])
    s_next = np.concatenate([np.sqrt(1.0 - abar[ts[1:]]), [0.0]])
    scaled = ts.astype(np.float64) * TIMESTEP_SCALING
    sd2 = SIGMA_DATA * SIGMA_DATA
    return Plan(
        model_t=to_f32(ts, device),
        alpha_s=to_f32(a, device),
        sigma_s=to_f32(s, device),
        c_skip=to_f32(sd2 / (scaled ** 2 + sd2), device),
        c_out=to_f32(scaled / np.sqrt(scaled ** 2 + sd2), device),
        a_next=to_f32(a_next, device),
        s_next=to_f32(s_next, device),
    )


def init_state(x: torch.Tensor) -> State:
    return State(unused=x.new_zeros(()))


def step(p: Plan, i, x, eps, state: State, noise=None):
    """Consistency update, then re-noise to the next grid point; ``noise``
    is a standard-normal tensor like x."""
    x0 = (x - p.sigma_s[i] * eps) / p.alpha_s[i]
    denoised = p.c_out[i] * x0 + p.c_skip[i] * x
    return p.a_next[i] * denoised + p.s_next[i] * noise, state
