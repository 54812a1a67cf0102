"""Diffusion noise schedule and timestep grids as data.

Counterpart of ``editanything_tpu/samplers/schedule.py``. The schedule is
built in float64 numpy and stored as float32, as there; the scalar
coefficients a step needs are float32 CPU tensors, so the arithmetic on them
rounds as the JAX package's does, and they reach the device as Python
floats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class NoiseSchedule(NamedTuple):
    """alphas_cumprod: (T,) float32 CPU tensor of cumulative (1 - beta)."""
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    prediction_type: str = "epsilon"


def make_schedule(num_train_timesteps: int = 1000,
                  beta_start: float = 0.00085,
                  beta_end: float = 0.012,
                  beta_schedule: str = "scaled_linear",
                  prediction_type: str = "epsilon") -> NoiseSchedule:
    """Stable Diffusion's schedule (``scaled_linear``: linear in sqrt(beta))."""
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                            dtype=np.float64)
    elif beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps + 1, dtype=np.float64)
        f = np.cos((t / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
    return NoiseSchedule(torch.from_numpy(alphas_cumprod), num_train_timesteps,
                         prediction_type)


def make_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                   spacing: str = "linspace", steps_offset: int = 0) -> np.ndarray:
    """Descending inference timestep grid ("linspace" is UniPC's default)."""
    if spacing == "linspace":
        ts = (np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
              .round()[::-1][:-1].astype(np.int64))
    elif spacing == "leading":
        ratio = num_train_timesteps // num_inference_steps
        ts = ((np.arange(num_inference_steps) * ratio).round()[::-1]
              .astype(np.int64) + steps_offset)
    elif spacing == "trailing":
        ts = np.round(
            np.arange(num_train_timesteps, 0,
                      -num_train_timesteps / num_inference_steps)
        ).astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep spacing {spacing!r}")
    return ts


def alpha_sigma(schedule: NoiseSchedule, t: int):
    """(sqrt(abar_t), sqrt(1 - abar_t)) as float32 scalars; t = -1 is the
    final (clean) state."""
    abar = (schedule.alphas_cumprod[t] if t >= 0
            else torch.tensor(1.0, dtype=torch.float32))
    return torch.sqrt(abar), torch.sqrt(1.0 - abar)


def add_noise(schedule: NoiseSchedule, x0, noise, t: int):
    """q(x_t | x_0) at one timestep, in fp32, cast back to x0's dtype."""
    a, s = alpha_sigma(schedule, t)
    return (float(a) * x0.float() + float(s) * noise.float()).to(x0.dtype)


def to_x0(schedule: NoiseSchedule, sample, model_output, t: int):
    """The network output as an x0 prediction (fp32)."""
    a, s = alpha_sigma(schedule, t)
    a, s = float(a), float(s)
    x = sample.float()
    m = model_output.float()
    if schedule.prediction_type == "epsilon":
        return (x - s * m) / a
    if schedule.prediction_type == "v_prediction":
        return a * x - s * m
    if schedule.prediction_type == "sample":
        return m
    raise ValueError(schedule.prediction_type)


def to_epsilon(schedule: NoiseSchedule, sample, model_output, t: int):
    """The network output as an epsilon prediction (fp32)."""
    a, s = alpha_sigma(schedule, t)
    a, s = float(a), float(s)
    x = sample.float()
    m = model_output.float()
    if schedule.prediction_type == "epsilon":
        return m
    if schedule.prediction_type == "v_prediction":
        return a * m + s * x
    if schedule.prediction_type == "sample":
        return (x - a * m) / s
    raise ValueError(schedule.prediction_type)
