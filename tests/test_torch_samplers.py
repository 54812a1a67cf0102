"""The port's schedule and UniPC (editanything_tpu_torch.samplers) against
the JAX package's, with the same model outputs fed to both at every step.

Tolerance 1e-5 absolute on latents of magnitude ~1-5: both sides do the
same fp32 scalar arithmetic in the same order, but log/exp/expm1 and
fused multiply-adds may round an ulp apart. ``to_x0`` divides by
sqrt(abar) (~0.07 at t = 999), so its bound grows by 20 (plus 1e-5
relative); the UniPC bounds scale with the largest latent of the step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.samplers import schedule as JS
from editanything_tpu.samplers import unipc as JP
from editanything_tpu_torch.samplers import schedule as TS
from editanything_tpu_torch.samplers import unipc as TP

TOL = 1e-5


@pytest.mark.parametrize("beta_schedule",
                         ["scaled_linear", "linear", "squaredcos_cap_v2"])
def test_schedule_matches_jax(beta_schedule):
    want = JS.make_schedule(beta_schedule=beta_schedule)
    got = TS.make_schedule(beta_schedule=beta_schedule)
    assert got.alphas_cumprod.dtype == torch.float32
    np.testing.assert_array_equal(got.alphas_cumprod.numpy(),
                                  np.asarray(want.alphas_cumprod))


@pytest.mark.parametrize("spacing", ["linspace", "leading", "trailing"])
@pytest.mark.parametrize("steps", [4, 30])
def test_timesteps_match_jax(spacing, steps):
    np.testing.assert_array_equal(
        TS.make_timesteps(steps, spacing=spacing, steps_offset=1),
        JS.make_timesteps(steps, spacing=spacing, steps_offset=1))


@pytest.mark.parametrize("t", [999, 500, 0, -1])
def test_alpha_sigma_add_noise_to_x0_match_jax(t):
    js, ts = JS.make_schedule(), TS.make_schedule()
    rng = np.random.default_rng(t + 2)
    x0, noise, out = (rng.standard_normal((2, 4, 8, 8), np.float32)
                      for _ in range(3))
    ja, jsig = JS.alpha_sigma(js, jnp.asarray(t))
    ta, tsig = TS.alpha_sigma(ts, t)
    assert float(ta) == float(ja) and float(tsig) == float(jsig)
    np.testing.assert_allclose(
        TS.add_noise(ts, torch.from_numpy(x0), torch.from_numpy(noise), t),
        JS.add_noise(js, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)),
        atol=TOL, rtol=0)
    if t >= 0:
        np.testing.assert_allclose(
            TS.to_x0(ts, torch.from_numpy(x0), torch.from_numpy(out), t),
            JS.to_x0(js, jnp.asarray(x0), jnp.asarray(out), jnp.asarray(t)),
            atol=TOL * 20, rtol=1e-5)


@pytest.mark.parametrize("steps", [4, 7])
def test_unipc_steps_match_jax(steps):
    js, ts = JS.make_schedule(), TS.make_schedule()
    grid = JS.make_timesteps(steps)
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((2, 4, 8, 8), np.float32)
    jstate, tstate = JP.unipc_init(jnp.asarray(x)), TP.unipc_init(torch.from_numpy(x))
    for i in range(steps):
        out = rng.standard_normal(x.shape, np.float32)
        jstate, jprev = JP.unipc_step(js, jstate, jnp.asarray(out),
                                      jnp.asarray(grid), step=i)
        tstate, tprev = TP.unipc_step(ts, tstate, torch.from_numpy(out), grid,
                                      step=i)
        scale = max(1.0, float(np.abs(np.asarray(jprev)).max()))
        np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev),
                                   atol=TOL * scale, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(tstate.last_sample.numpy(),
                                   np.asarray(jstate.last_sample),
                                   atol=TOL * scale, rtol=0)
        for k in range(2):
            np.testing.assert_allclose(tstate.m_hist[k].numpy(),
                                       np.asarray(jstate.m_hist[k]),
                                       atol=TOL * scale, rtol=0)
        assert tstate.t_hist == tuple(int(v) for v in np.asarray(jstate.t_hist))
        assert tstate.step_index == int(jstate.step_index)


# --- v-prediction and DDIM ----------------------------------------------------

@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction",
                                             "sample"])
@pytest.mark.parametrize("t", [999, 500, 0])
def test_to_x0_and_to_epsilon_match_jax(prediction_type, t):
    js = JS.make_schedule(prediction_type=prediction_type)
    ts = TS.make_schedule(prediction_type=prediction_type)
    rng = np.random.default_rng(t + 7)
    x, out = (rng.standard_normal((2, 4, 8, 8), np.float32) for _ in range(2))
    jt = jnp.asarray(t)
    for tfn, jfn in ((TS.to_x0, JS.to_x0), (TS.to_epsilon, JS.to_epsilon)):
        want = np.asarray(jfn(js, jnp.asarray(x), jnp.asarray(out), jt))
        got = tfn(ts, torch.from_numpy(x), torch.from_numpy(out), t)
        # eps -> x0 and x0 -> eps divide by sqrt(abar) / sqrt(1 - abar)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL * 20,
                                   rtol=1e-5)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_steps_match_jax(prediction_type, eta):
    """A whole DDIM trajectory, the last step to t_prev = -1 (the clean
    state), with the same model outputs and eta noises on both sides."""
    from editanything_tpu.samplers import ddim as JD
    from editanything_tpu_torch.samplers import ddim as TD
    js = JS.make_schedule(prediction_type=prediction_type)
    ts = TS.make_schedule(prediction_type=prediction_type)
    grid = [int(v) for v in JS.make_timesteps(5, spacing="leading",
                                              steps_offset=1)]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 8, 8), np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i, t in enumerate(grid):
        t_prev = grid[i + 1] if i + 1 < len(grid) else -1
        out, noise = (rng.standard_normal(x.shape, np.float32)
                      for _ in range(2))
        jx, jx0 = JD.ddim_step(js, jx, jnp.asarray(out), jnp.asarray(t),
                               jnp.asarray(t_prev), eta=eta,
                               noise=jnp.asarray(noise))
        tx, tx0 = TD.ddim_step(ts, tx, torch.from_numpy(out), t, t_prev,
                               eta=eta, noise=torch.from_numpy(noise))
        scale = max(1.0, float(np.abs(np.asarray(jx0)).max()))
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0),
                                   atol=TOL * 20 * scale, rtol=1e-5)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                   atol=TOL * 20 * scale, rtol=1e-5,
                                   err_msg=f"step {i}, t {t} -> {t_prev}")
    assert t_prev == -1
    with pytest.raises(ValueError, match="noise"):
        TD.ddim_step(ts, tx, tx, 500, 400, eta=0.5)


def test_ddim_encode_and_stochastic_encode_match_jax():
    from editanything_tpu.samplers import ddim as JD
    from editanything_tpu_torch.samplers import ddim as TD
    js = JS.make_schedule(prediction_type="v_prediction")
    ts = TS.make_schedule(prediction_type="v_prediction")
    rng = np.random.default_rng(12)
    x, out, noise = (rng.standard_normal((2, 4, 8, 8), np.float32)
                     for _ in range(3))
    np.testing.assert_allclose(
        TD.ddim_encode_step(ts, torch.from_numpy(x), torch.from_numpy(out),
                            250, 500).numpy(),
        np.asarray(JD.ddim_encode_step(js, jnp.asarray(x), jnp.asarray(out),
                                       jnp.asarray(250), jnp.asarray(500))),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        TD.stochastic_encode(ts, torch.from_numpy(x), 600,
                             torch.from_numpy(noise)).numpy(),
        np.asarray(JD.stochastic_encode(js, jnp.asarray(x), jnp.asarray(600),
                                        jnp.asarray(noise))),
        atol=TOL, rtol=0)


def test_unipc_vpred_steps_match_jax():
    js = JS.make_schedule(prediction_type="v_prediction")
    ts = TS.make_schedule(prediction_type="v_prediction")
    grid = JS.make_timesteps(5)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 4, 8, 8), np.float32)
    jstate, tstate = JP.unipc_init(jnp.asarray(x)), TP.unipc_init(torch.from_numpy(x))
    for i in range(5):
        out = rng.standard_normal(x.shape, np.float32)
        jstate, jprev = JP.unipc_step(js, jstate, jnp.asarray(out),
                                      jnp.asarray(grid), step=i)
        tstate, tprev = TP.unipc_step(ts, tstate, torch.from_numpy(out), grid,
                                      step=i)
        scale = max(1.0, float(np.abs(np.asarray(jprev)).max()))
        np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev),
                                   atol=TOL * scale, rtol=0, err_msg=f"step {i}")


# --- PLMS and DPM-Solver ------------------------------------------------------

def _close_scaled(got, want, what):
    """TOL relative to the step's largest latent (x0 extrapolation divides
    by sqrt(abar) at high t, so the bound scales like the UniPC ones)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * scale, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_plms_steps_match_jax(prediction_type):
    """A whole PLMS trajectory with the warm-up's second output at step 0
    and the last step to the clean state, the same model outputs fed to
    both."""
    from editanything_tpu.samplers import plms as JPL
    from editanything_tpu_torch.samplers import plms as TPL
    js = JS.make_schedule(prediction_type=prediction_type)
    ts = TS.make_schedule(prediction_type=prediction_type)
    grid = [int(v) for v in JS.make_timesteps(6)]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 4, 8, 8), np.float32)
    jstate, tstate = JPL.plms_init(jnp.asarray(x)), TPL.plms_init(torch.from_numpy(x))
    for i, t in enumerate(grid):
        t_prev = grid[i + 1] if i + 1 < len(grid) else -1
        out, out_next = (rng.standard_normal(x.shape, np.float32)
                         for _ in range(2))
        jstate, jprev = JPL.plms_step(js, jstate, jnp.asarray(out),
                                      jnp.asarray(out_next), jnp.asarray(t),
                                      jnp.asarray(t_prev), jnp.asarray(i))
        tstate, tprev = TPL.plms_step(ts, tstate, torch.from_numpy(out),
                                      torch.from_numpy(out_next), t, t_prev, i)
        _close_scaled(tprev, jprev, f"step {i}")
        for k in range(3):
            _close_scaled(tstate.eps_hist[k], jstate.eps_hist[k],
                          f"step {i} eps history {k}")
    # the warm-up's first-order step, which the loop feeds back to the model
    eps = TPL._to_eps(ts, torch.from_numpy(x), torch.from_numpy(out), 999)
    _close_scaled(TPL._x_prev(ts, torch.from_numpy(x), eps, 999, 832),
                  JPL._x_prev(js, jnp.asarray(x), jnp.asarray(eps.numpy()),
                              jnp.asarray(999), jnp.asarray(832)), "x_prev")


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_dpm_multistep_matches_jax(order, prediction_type):
    """DPM-Solver++ multistep over 7 steps: the ramp-up, order 3 in the
    middle and the tail drop to the clean state."""
    from editanything_tpu.samplers import dpm as JD
    from editanything_tpu_torch.samplers import dpm as TD
    js = JS.make_schedule(prediction_type=prediction_type)
    ts = TS.make_schedule(prediction_type=prediction_type)
    grid = JS.make_timesteps(7)
    rng = np.random.default_rng(22 + order)
    x = rng.standard_normal((2, 4, 8, 8), np.float32)
    jstate, tstate = JD.dpm_init(jnp.asarray(x)), TD.dpm_init(torch.from_numpy(x))
    for i in range(len(grid)):
        out = rng.standard_normal(x.shape, np.float32)
        jstate, jprev = JD.dpm_step(js, jstate, jnp.asarray(out),
                                    jnp.asarray(grid), jnp.asarray(i),
                                    order=order)
        tstate, tprev = TD.dpm_step(ts, tstate, torch.from_numpy(out), grid, i,
                                    order=order)
        _close_scaled(tprev, jprev, f"step {i}")
        _close_scaled(tstate.x0_prev, jstate.x0_prev, f"step {i} x0")
        assert abs(float(tstate.h_prev) - float(jstate.h_prev)) <= 1e-5 * max(
            1.0, abs(float(jstate.h_prev)))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("steps", [5, 20, 30])
def test_singlestep_plan_matches_jax(order, steps):
    from editanything_tpu.samplers import dpm as JD
    from editanything_tpu_torch.samplers import dpm as TD
    want = JD.singlestep_plan(JS.make_schedule(), steps, order)
    got = TD.singlestep_plan(TS.make_schedule(), steps, order)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_singlestep_steps_match_jax(order):
    """Every evaluation of an 8-evaluation singlestep run (a leftover block,
    full blocks, the order-1 block to the clean state)."""
    from editanything_tpu.samplers import dpm as JD
    from editanything_tpu_torch.samplers import dpm as TD
    js, ts = JS.make_schedule(), TS.make_schedule()
    plan = TD.singlestep_plan(ts, 8, order)
    jplan = [jnp.asarray(getattr(plan, f)) for f in plan._fields]
    rng = np.random.default_rng(30 + order)
    x = rng.standard_normal((2, 4, 8, 8), np.float32)
    jstate = JD.singlestep_init(jnp.asarray(x))
    tstate = TD.singlestep_init(torch.from_numpy(x))
    for i in range(len(plan.ts)):
        out = rng.standard_normal(x.shape, np.float32)
        jstate, jprev = JD.singlestep_step(js, jstate, jnp.asarray(out),
                                           *jplan, jnp.asarray(i))
        tstate, tprev = TD.singlestep_step(ts, tstate, torch.from_numpy(out),
                                           plan, i)
        _close_scaled(tprev, jprev, f"evaluation {i}")
        for f in ("x_s", "m_s", "m_s1"):
            _close_scaled(getattr(tstate, f), getattr(jstate, f),
                          f"evaluation {i} {f}")
