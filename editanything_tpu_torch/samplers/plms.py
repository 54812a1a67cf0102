"""PLMS (pseudo linear multistep) step math, state in fp32.

Counterpart of ``editanything_tpu/samplers/plms.py``: Adams-Bashforth over
the last eps predictions with the DDIM x_prev formula, the order ramping up
from a midpoint warm-up at step 0. There the order is a ``jnp.where`` over
the scan counter; here the step index is a Python int and only the chosen
combination is formed. The warm-up needs a second model evaluation at
(x after a first-order step, max(t_prev, 0)), which the loop makes at step
0 only (engine/denoise.py). Scalars are float32, combined in the JAX
package's order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from editanything_tpu_torch.samplers import schedule as sched


class PLMSState(NamedTuple):
    sample: torch.Tensor
    eps_hist: Tuple[torch.Tensor, ...]    # the last 3 eps predictions, newest first


def plms_init(sample) -> PLMSState:
    x = sample.float()
    zeros = torch.zeros_like(x)
    return PLMSState(x, (zeros, zeros, zeros))


def _to_eps(schedule, sample, model_output, t: int):
    """The model output as an eps prediction (fp32): converted from v under
    v-prediction, taken as it is otherwise, as the JAX package does."""
    out = model_output.float()
    if schedule.prediction_type == "v_prediction":
        a, s = sched.alpha_sigma(schedule, t)
        return float(a) * out + float(s) * sample
    return out


def _x_prev(schedule, sample, eps, t: int, t_prev: int):
    """The deterministic DDIM step from t to t_prev given eps; t_prev = -1 is
    the clean state."""
    a_t, s_t = sched.alpha_sigma(schedule, t)
    a_prev, s_prev = sched.alpha_sigma(schedule, t_prev)
    x0 = (sample - float(s_t) * eps) / float(a_t)
    return float(a_prev) * x0 + float(s_prev) * eps


def plms_step(schedule: sched.NoiseSchedule, state: PLMSState, model_output,
              model_output_next, t: int, t_prev: int, step: int):
    """One PLMS update. ``model_output_next`` is the model at
    (_x_prev of the first-order step, max(t_prev, 0)); only step 0 reads it
    (the midpoint warm-up). Returns (new_state, prev_sample)."""
    x = state.sample
    eps = _to_eps(schedule, x, model_output, t)
    h = state.eps_hist
    if step == 0:
        eps_next = _to_eps(schedule, _x_prev(schedule, x, eps, t, t_prev),
                           model_output_next, max(t_prev, 0))
        eps_prime = (eps + eps_next) / 2
    elif step == 1:
        eps_prime = (3 * eps - h[0]) / 2
    elif step == 2:
        eps_prime = (23 * eps - 16 * h[0] + 5 * h[1]) / 12
    else:
        eps_prime = (55 * eps - 59 * h[0] + 37 * h[1] - 9 * h[2]) / 24
    x_new = _x_prev(schedule, x, eps_prime, t, t_prev)
    return PLMSState(x_new, (eps, h[0], h[1])), x_new
