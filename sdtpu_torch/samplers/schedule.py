"""Diffusion noise schedule: SD v1.x linear-sqrt beta schedule tables.

Carried over from ``sdtpu/samplers/schedule.py`` (the JAX package), cut to
what DPM-Solver++(2M) reads, and kept in numpy float64. Continuous-time
notation: ``alpha_t = sqrt(prod(1 - beta))``, ``sigma_t = sqrt(1 -
alpha_t^2)``, ``lambda_t = log(alpha_t / sigma_t)``; the tables over the
1000 train steps are interpolated linearly at continuous times.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
