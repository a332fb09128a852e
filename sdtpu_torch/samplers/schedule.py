"""Diffusion noise schedule: SD v1.x linear-sqrt beta schedule tables.

Carried over from ``sdtpu/samplers/schedule.py`` (the JAX package) and
kept in numpy float64; ``to_f32`` is the one cast of a plan's tables to
float32 tensors on the device. Continuous-time
notation: ``alpha_t = sqrt(prod(1 - beta))``, ``sigma_t = sqrt(1 -
alpha_t^2)``, ``lambda_t = log(alpha_t / sigma_t)``; the tables over the
1000 train steps are interpolated linearly at continuous times.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed tables over the discrete train-time grid.

    Attributes:
      t_grid:          [N] continuous times (i+1)/N, increasing on (0, 1].
      log_alpha_grid:  [N] 0.5 * log cumprod(1 - beta_i).
      alphas_cumprod:  [N] prod(1 - beta_i)  (discrete DDPM convention).
      num_train_steps: N (1000 for SD v1.x).
    """

    t_grid: np.ndarray
    log_alpha_grid: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_steps: int

    @classmethod
    def sd_v1(
        cls,
        num_train_steps: int = 1000,
        lin_start: float = 0.00085,
        lin_end: float = 0.0120,
    ) -> "NoiseSchedule":
        betas = (
            np.linspace(
                np.sqrt(lin_start), np.sqrt(lin_end), num_train_steps,
                dtype=np.float64,
            )
            ** 2
        )
        alphas_cumprod = np.cumprod(1.0 - betas)
        log_alpha = 0.5 * np.log(alphas_cumprod)
        t_grid = np.arange(1, num_train_steps + 1, dtype=np.float64) / num_train_steps
        return cls(
            t_grid=t_grid,
            log_alpha_grid=log_alpha,
            alphas_cumprod=alphas_cumprod,
            num_train_steps=num_train_steps,
        )

    # -- continuous-time marginals (linear interpolation on the grid) -----

    def log_alpha(self, t: np.ndarray) -> np.ndarray:
        return np.interp(t, self.t_grid, self.log_alpha_grid)

    def marginal_alpha(self, t: np.ndarray) -> np.ndarray:
        return np.exp(self.log_alpha(t))

    def marginal_sigma(self, t: np.ndarray) -> np.ndarray:
        return np.sqrt(1.0 - np.exp(2.0 * self.log_alpha(t)))

    def marginal_lambda(self, t: np.ndarray) -> np.ndarray:
        la = self.log_alpha(t)
        return la - 0.5 * np.log(1.0 - np.exp(2.0 * la))

    # -- step-time grids ---------------------------------------------------

    def sampling_times(self, steps: int) -> np.ndarray:
        """Continuous times for `steps` solver steps: linspace 1 -> 1/N,
        `steps+1` points."""
        return np.linspace(1.0, 1.0 / self.num_train_steps, steps + 1)

    def model_times(self, ts: np.ndarray) -> np.ndarray:
        """UNet-facing timesteps for continuous times: (t - 1/N) * N."""
        return (ts - 1.0 / self.num_train_steps) * self.num_train_steps

    def karras_times(self, steps: int, rho: float = 7.0) -> np.ndarray:
        """Karras et al. (2022) sigma spacing, mapped back to continuous
        times: a ramp in k-diffusion sigma space (``sigma_k = sigma/alpha``)
        with exponent ``rho``, between sigma_k(1.0) and sigma_k(1/N).
        Returns [steps+1] decreasing times with the same endpoints as
        ``sampling_times``; only the interior spacing changes."""
        t_lo = 1.0 / self.num_train_steps
        la = self.log_alpha(np.array([1.0, t_lo]))
        a = np.exp(la)
        sigk = np.sqrt(1.0 - a * a) / a           # [sig_max, sig_min]
        s_max, s_min = sigk[0], sigk[1]
        i = np.linspace(0.0, 1.0, steps + 1)
        sig = (s_max ** (1 / rho)
               + i * (s_min ** (1 / rho) - s_max ** (1 / rho))) ** rho
        # invert sigma_k(t) on the train grid (monotonic increasing in t)
        ts = np.interp(sig, self.sigk_grid(), self.t_grid)
        ts[0], ts[-1] = 1.0, t_lo  # pin the endpoints exactly
        return ts

    def sigk_grid(self) -> np.ndarray:
        """sigma_k = sigma/alpha on the train grid, increasing in t."""
        a_grid = np.exp(self.log_alpha_grid)
        return np.sqrt(np.maximum(1.0 - a_grid * a_grid, 1e-20)) / a_grid

    def ddim_timesteps(self, steps: int) -> np.ndarray:
        """Discrete DDIM/PLMS timestep subsequence (uniform spacing,
        descending), e.g. steps=20, N=1000 -> [951, 901, ..., 1]."""
        c = self.num_train_steps // steps
        ts = np.arange(0, steps) * c + 1
        return ts[::-1].copy()

    def times(self, steps: int, spacing: str) -> np.ndarray:
        """The continuous-time solvers' [steps+1] grid: ``"uniform"``
        (``sampling_times``) or ``"karras"`` (``karras_times``)."""
        return (self.karras_times(steps) if spacing == "karras"
                else self.sampling_times(steps))


def to_f32(a, device) -> torch.Tensor:
    """A plan's float64 (or integer) numpy table -> a float32 tensor on
    ``device``: numpy rounds once to float32, as the JAX package's
    ``to_f32`` does, so the tables are bit-equal."""
    return torch.as_tensor(np.asarray(np.asarray(a), np.float32),
                           device=device)
