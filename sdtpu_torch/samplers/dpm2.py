"""DPM2 sampler (k-diffusion "DPM2"): the ``kind="dpm2"`` leg of
``heun``, as its own module, the counterpart of ``sdtpu/samplers/dpm2.py``.
See ``heun`` for the math and the ``NEEDS_SECOND_EVAL`` protocol."""

from __future__ import annotations

import functools

from sdtpu_torch.samplers import heun as _heun
from sdtpu_torch.samplers.heun import (  # noqa: F401 - re-exported interface
    NEEDS_SECOND_EVAL,
    Plan,
    State,
    init_state,
    predictor,
    step,
)

plan = functools.partial(_heun.plan, kind="dpm2")
