"""DDIM step math as plain functions.

Counterpart of ``editanything_tpu/samplers/ddim.py``: ``ddim_step`` (with
eta and the v-prediction branches through ``to_x0``/``to_epsilon``),
``stochastic_encode`` and ``ddim_encode_step``. ``t_prev = -1`` is the
clean state (alpha_bar = 1), as ``alpha_sigma`` treats it. The scalar
coefficients are float32 tensors combined in the JAX package's order; the
tensors are fp32. ``eta > 0`` takes its noise as an argument and never
draws its own.
"""

from __future__ import annotations

import torch

from editanything_tpu_torch.samplers import schedule as sched


def ddim_step(schedule: sched.NoiseSchedule, sample, model_output, t: int,
              t_prev: int, *, eta: float = 0.0, noise=None):
    """One x_t -> x_{t_prev} DDIM update. Returns (prev_sample, pred_x0),
    both in ``sample``'s dtype; the arithmetic is fp32."""
    a_t, s_t = sched.alpha_sigma(schedule, t)
    a_prev, s_prev = sched.alpha_sigma(schedule, t_prev)
    x = sample.float()
    pred_x0 = sched.to_x0(schedule, x, model_output, t)
    eps = sched.to_epsilon(schedule, x, model_output, t)
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        # sigma_t of the DDIM paper, eq. (16)
        var = (s_prev / s_t) ** 2 * (1.0 - (a_t / a_prev) ** 2)
        sigma = torch.tensor(eta, dtype=torch.float32) * torch.sqrt(var)
    else:
        sigma = torch.tensor(0.0, dtype=torch.float32)
    coef = torch.sqrt(torch.clamp(1.0 - a_prev ** 2 - sigma ** 2, min=0.0))
    prev = float(a_prev) * pred_x0 + float(coef) * eps
    if eta > 0.0:
        prev = prev + float(sigma) * noise.float()
    return prev.to(sample.dtype), pred_x0.to(sample.dtype)


def stochastic_encode(schedule: sched.NoiseSchedule, x0, t: int, noise):
    """x0 -> x_t by forward diffusion, the img2img entry (fp32)."""
    return sched.add_noise(schedule, x0.float(), noise.float(), t)


def ddim_encode_step(schedule: sched.NoiseSchedule, sample, model_output,
                     t: int, t_next: int):
    """One deterministic inversion step x_t -> x_{t_next}, t_next > t: the
    DDIM ODE run backwards (fp32)."""
    a_next, s_next = sched.alpha_sigma(schedule, t_next)
    x = sample.float()
    pred_x0 = sched.to_x0(schedule, x, model_output, t)
    eps = sched.to_epsilon(schedule, x, model_output, t)
    return float(a_next) * pred_x0 + float(s_next) * eps
