"""Noise schedule and the samplers: UniPC, DDIM, PLMS, DPM-Solver."""
