"""Measurement tools of the port: per-part timing (``runner``), per-phase
timing and traces (``profile``), per-kernel device profiles (``xprof``),
FLOP counts and MFU (``flops``), the result table (``analyze``) and the
configuration sweep (``sweep``)."""
