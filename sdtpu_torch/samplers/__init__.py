"""Samplers, the counterpart of ``sdtpu/samplers/__init__.py``.

Each module exposes ``plan(schedule, steps, start_step=0, ..., device=)``,
the reference's float64 numpy schedule math cast once to float32 tables on
the device, ``init_state(x)`` for latents like ``x``, and ``step(plan, i,
x, eps, state) -> (x_next, state)``: tensor math with no Python branch on
a value, so a CUDA graph can take the loop. ``NEEDS_NOISE`` modules take a
standard-normal ``noise=`` a step; ``NEEDS_SECOND_EVAL`` modules
(heun, dpm2) a ``predictor`` and ``eps2=``.
"""

from sdtpu_torch.samplers import (ddim, dpm, dpm2, dpm_sde, euler, euler_a,
                                  heun, lcm, lms, plms, unipc)
from sdtpu_torch.samplers.schedule import NoiseSchedule


class _KarrasSpacing:
    """The same solver on Karras et al. (2022) sigma spacing
    (``NoiseSchedule.karras_times``) in place of uniform time spacing: the
    continuous-time solvers only (DDIM and PLMS are discrete-grid)."""

    def __init__(self, mod):
        self._mod = mod
        self.NEEDS_NOISE = getattr(mod, "NEEDS_NOISE", False)
        self.NEEDS_SECOND_EVAL = getattr(mod, "NEEDS_SECOND_EVAL", False)

    def predictor(self, *args, **kwargs):
        return self._mod.predictor(*args, **kwargs)

    def plan(self, schedule, steps, start_step=0, *, device):
        return self._mod.plan(schedule, steps, start_step, spacing="karras",
                              device=device)

    def init_state(self, x):
        return self._mod.init_state(x)

    def step(self, *args, **kwargs):
        return self._mod.step(*args, **kwargs)


SAMPLERS = {
    "dpm": dpm,
    "dpm++": dpm,
    "ddim": ddim,
    "plms": plms,
    # CompVis-exact PLMS: the pipeline spends a second UNet eval on step 0
    "plms_exact": plms,
    "euler": euler,
    "euler_a": euler_a,
    "lms": lms,
    "dpm_sde": dpm_sde,
    "unipc": unipc,
    # two UNet evals a step (NEEDS_SECOND_EVAL)
    "heun": heun,
    "dpm2": dpm2,
    "lcm": lcm,
    "dpm_karras": _KarrasSpacing(dpm),
    "dpm_sde_karras": _KarrasSpacing(dpm_sde),
    "euler_karras": _KarrasSpacing(euler),
    "euler_a_karras": _KarrasSpacing(euler_a),
    "unipc_karras": _KarrasSpacing(unipc),
    "lms_karras": _KarrasSpacing(lms),
    "heun_karras": _KarrasSpacing(heun),
    "dpm2_karras": _KarrasSpacing(dpm2),
}


def get_sampler(name: str):
    try:
        return SAMPLERS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown sampler {name!r}; available: {sorted(SAMPLERS)}"
        ) from None


__all__ = ["NoiseSchedule", "SAMPLERS", "get_sampler"]
