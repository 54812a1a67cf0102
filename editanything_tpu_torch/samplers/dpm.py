"""DPM-Solver++ step math: multistep at orders 2 and 3, singlestep at
orders 1-3, data prediction, state in fp32.

Counterpart of ``editanything_tpu/samplers/dpm.py``, whose docstrings give
the algebra and why the multistep order drops at the last steps and why the
singlestep plan reserves its last evaluation for an order-1 block [0, -1].
There every order and phase choice is a ``jnp.where`` over the scan
counter; here the step index, the orders, the phases and the timesteps are
Python ints and only the chosen branch is computed. The scalar coefficients
are float32 tensors combined in the JAX package's order. The singlestep
plan is host numpy, as there, and replaces the caller's timesteps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from editanything_tpu_torch.samplers import schedule as sched


def _alpha_sigma_lambda(schedule, t: int):
    """(alpha, sigma, lambda = log alpha - log sigma) at t as float32
    scalars; t = -1 is the clean state, sigma clamped at 1e-6 there."""
    a = (schedule.alphas_cumprod[t] if t >= 0
         else torch.tensor(1.0, dtype=torch.float32))
    alpha = torch.sqrt(a)
    sigma = torch.sqrt(torch.clamp(1.0 - a, min=1e-12))
    return alpha, sigma, torch.log(alpha) - torch.log(sigma)


def _to_x0(schedule, sample, model_output, t: int):
    """The model output as an x0 prediction (eps or v), fp32."""
    a = schedule.alphas_cumprod[t]
    sa, ss = float(torch.sqrt(a)), float(torch.sqrt(1.0 - a))
    out = model_output.float()
    if schedule.prediction_type == "v_prediction":
        return sa * sample - ss * out
    return (sample - ss * out) / sa


# --- multistep -----------------------------------------------------------------

class DPMState(NamedTuple):
    sample: torch.Tensor
    x0_prev: torch.Tensor
    x0_prev2: torch.Tensor
    h_prev: torch.Tensor        # float32 scalar
    h_prev2: torch.Tensor       # float32 scalar


def dpm_init(sample) -> DPMState:
    x = sample.float()
    zero = torch.tensor(0.0, dtype=torch.float32)
    return DPMState(x, torch.zeros_like(x), torch.zeros_like(x), zero, zero)


def dpm_step(schedule: sched.NoiseSchedule, state: DPMState, model_output,
             ts, step: int, *, order: int = 2):
    """One DPM-Solver++ multistep update at ``step`` of the descending grid
    ``ts``, at the effective order min(order, step + 1, n - step). Returns
    (new_state, prev_sample)."""
    n = len(ts)
    t = int(ts[step])
    t_prev = int(ts[step + 1]) if step + 1 < n else -1
    x = state.sample
    x0 = _to_x0(schedule, x, model_output, t)
    a_t, s_t, lam_t = _alpha_sigma_lambda(schedule, t)
    a_p, s_p, lam_p = _alpha_sigma_lambda(schedule, t_prev)
    h = lam_p - lam_t
    phi1 = torch.exp(-h) - 1.0
    hs = h if float(h) != 0.0 else torch.tensor(1.0, dtype=torch.float32)
    eff = min(order, step + 1, n - step)
    r0 = torch.clamp(state.h_prev / hs, min=1e-8)
    if eff >= 3:
        r1 = torch.clamp(state.h_prev2 / hs, min=1e-8)
        d1_0 = (x0 - state.x0_prev) / float(r0)
        d1_1 = (state.x0_prev - state.x0_prev2) / float(r1)
        d1 = d1_0 + float(r0 / (r0 + r1)) * (d1_0 - d1_1)
        dd2 = (d1_0 - d1_1) / float(r0 + r1)
        x_new = (float(s_p / s_t) * x - float(a_p * phi1) * x0
                 + float(a_p * (phi1 / hs + 1.0)) * d1
                 - float(a_p * ((phi1 + hs) / (hs * hs) - 0.5)) * dd2)
    else:
        d = x0
        if eff >= 2:
            d = (float(1.0 + 1.0 / (2.0 * r0)) * x0
                 - float(1.0 / (2.0 * r0)) * state.x0_prev)
        x_new = float(s_p / s_t) * x - float(a_p * phi1) * d
    return DPMState(x_new, x0, state.x0_prev, h, state.h_prev), x_new


# --- singlestep ----------------------------------------------------------------

class SinglestepPlan(NamedTuple):
    """Per-evaluation schedule of a singlestep run (host numpy, length =
    model evaluations)."""
    ts: np.ndarray        # timestep of each evaluation
    phase: np.ndarray     # position within the current block
    bsize: np.ndarray     # evaluations in the current block (1, 2 or 3)
    t_end: np.ndarray     # the block's target timestep (-1 = clean)


def singlestep_plan(schedule: sched.NoiseSchedule, num_steps: int,
                    order: int) -> SinglestepPlan:
    """`num_steps` evaluations in blocks of `order`: the leftover block
    first, a last order-1 block [0, -1], the blocks over a uniform outer
    grid and their inner points at the nearest timesteps to the log-SNR
    fractions 1/2 (order 2) or 1/3 and 2/3 (order 3), kept strictly inside
    the block (a block too narrow for them repeats its first timestep)."""
    if not 1 <= order <= 3:
        raise ValueError(f"singlestep order {order} is not 1, 2 or 3")
    main = num_steps - 1
    blocks = (([main % order] if main % order else [])
              + [order] * (main // order) + [1])
    T = schedule.num_train_timesteps
    nb = len(blocks)
    grid = (np.linspace(0, T - 1, nb).round()[::-1].astype(np.int64)
            if nb > 1 else np.asarray([T - 1], np.int64))
    outer = np.concatenate([grid, np.asarray([-1], np.int64)])
    acp = np.asarray(schedule.alphas_cumprod, np.float64)
    lam_all = 0.5 * (np.log(acp) - np.log(np.maximum(1.0 - acp, 1e-12)))

    def lam(t):
        return lam_all[t] if t >= 0 else 0.5 * np.log(1e12)

    ts, phase, bsize, t_end = [], [], [], []
    fracs = {1: (), 2: (0.5,), 3: (1.0 / 3.0, 2.0 / 3.0)}
    for j, k in enumerate(blocks):
        t_s, t_e = int(outer[j]), int(outer[j + 1])
        pts = [t_s]
        lam_s, lam_e = lam(t_s), lam(t_e)
        for r in fracs[k]:
            target = lam_s + r * (lam_e - lam_s)
            lo, hi = max(t_e, 0) + 1, t_s - 1
            if lo > hi:
                ti = t_s
            else:
                ti = int(np.argmin(np.abs(lam_all - target)))
                ti = int(np.clip(ti, lo, hi))
            pts.append(ti)
        for p, t in enumerate(pts):
            ts.append(t)
            phase.append(p)
            bsize.append(k)
            t_end.append(t_e)
    return SinglestepPlan(np.asarray(ts, np.int64), np.asarray(phase, np.int64),
                          np.asarray(bsize, np.int64),
                          np.asarray(t_end, np.int64))


class SinglestepState(NamedTuple):
    sample: torch.Tensor    # the running sample, at the next evaluation's t
    x_s: torch.Tensor       # the sample at the block's start
    m_s: torch.Tensor       # the x0 prediction there
    m_s1: torch.Tensor      # the x0 prediction at the first inner point


def singlestep_init(sample) -> SinglestepState:
    x = sample.float()
    z = torch.zeros_like(x)
    return SinglestepState(x, z, z, z)


def _clip_r(r):
    return torch.clamp(r, 1e-4, 1.0 - 1e-4)


def singlestep_step(schedule: sched.NoiseSchedule, state: SinglestepState,
                    model_output, plan: SinglestepPlan, step: int):
    """One evaluation's update of the singlestep solver. After evaluation i
    the sample sits at plan.ts[i + 1] (at the block's end after its last
    evaluation). Returns (new_state, new_sample)."""
    i = step
    n = len(plan.ts)
    phase, k = int(plan.phase[i]), int(plan.bsize[i])
    t_i, t_e = int(plan.ts[i]), int(plan.t_end[i])
    t_s = int(plan.ts[max(i - phase, 0)])
    t_s1 = int(plan.ts[min(max(i - phase + 1, 0), n - 1)])

    x0 = _to_x0(schedule, state.sample, model_output, max(t_i, 0))
    x_s = state.sample if phase == 0 else state.x_s
    m_s = x0 if phase == 0 else state.m_s
    m_s1 = x0 if phase == 1 else state.m_s1

    a_s, s_s, lam_s = _alpha_sigma_lambda(schedule, t_s)
    a_e, s_e, lam_e = _alpha_sigma_lambda(schedule, t_e)
    h = lam_e - lam_s
    hs = h if float(h) != 0.0 else torch.tensor(1.0, dtype=torch.float32)
    last = phase == k - 1
    if phase == 0:
        # first-order move to the first inner point, or to t_end
        a_n, s_n, lam_n = (_alpha_sigma_lambda(schedule, t_e) if last else
                           _alpha_sigma_lambda(schedule, t_s1))
        x_new = (float(s_n / s_s) * x_s
                 - float(a_n * torch.expm1(-(lam_n - lam_s))) * m_s)
    elif phase == 1:
        _, _, lam_s1 = _alpha_sigma_lambda(schedule, t_s1)
        r1 = _clip_r((lam_s1 - lam_s) / hs)
        if last:
            # order 2: close the block
            phi1 = torch.expm1(-h)
            x_new = (float(s_e / s_s) * x_s - float(a_e * phi1) * m_s
                     - float((0.5 / r1) * a_e * phi1) * (m_s1 - m_s))
        else:
            # order 3: move to the second inner point, plan.ts[i + 1]
            a_s2, s_s2, lam_s2 = _alpha_sigma_lambda(
                schedule, int(plan.ts[min(i + 1, n - 1)]))
            r2 = _clip_r((lam_s2 - lam_s) / hs)
            phi12 = torch.expm1(-r2 * h)
            phi22 = phi12 / (r2 * hs) + 1.0
            x_new = (float(s_s2 / s_s) * x_s - float(a_s2 * phi12) * m_s
                     + float((r2 / r1) * a_s2 * phi22) * (m_s1 - m_s))
    else:
        # order 3: close the block; t_i is the second inner point
        _, _, lam_i = _alpha_sigma_lambda(schedule, t_i)
        r2_self = _clip_r((lam_i - lam_s) / hs)
        phi1 = torch.expm1(-h)
        phi2 = phi1 / hs + 1.0
        x_new = (float(s_e / s_s) * x_s - float(a_e * phi1) * m_s
                 + float((1.0 / r2_self) * a_e * phi2) * (x0 - m_s))
    return SinglestepState(x_new, x_s, m_s, m_s1), x_new
