"""Drivers, one module a traffic mix's ``driver`` names: each has
``run(cell, seed, seconds, trace, device, t0, config)`` and
``judge_data(cell, seed, device, config)``."""
