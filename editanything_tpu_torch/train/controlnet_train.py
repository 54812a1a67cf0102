"""ControlNet training: the control branch trained, the base UNet frozen.

Counterpart of ``editanything_tpu/train/controlnet_train.py``, with the
reference's semantics (ldm/models/diffusion/ddpm.py:885-920 ``p_losses``,
the simple loss; cldm/cldm.py:328-341 ``apply_model``, :416-423 AdamW over
the control parameters only): eps-MSE (or the v target) on noised
latents. The step takes pre-encoded latents and text states; the VAE and
CLIP encodes run in the preprocessor (train/train_controlnet.py).

Where JAX threads a pure state through a jitted step, the port's
``TrainState`` holds the live ControlNet, its optimizer, the step and the
EMA copy, and ``train_step`` updates them in place. The kernels of the
forward (B, A and under ``EA_RESNET_FUSED=1`` E) are differentiated
through their ``torch.autograd.Function``s, whose backwards recompute
through the plain twins, as JAX's ``custom_vjp``s do. JAX's ``remat``
options map to torch: ``False`` keeps every activation; ``"full"`` is
``torch.utils.checkpoint`` over the ControlNet + UNet; ``True`` /
``"dots"`` is selective checkpointing that saves the matmul and conv
outputs (JAX's ``dots_saveable``) and recomputes the rest; ``"offload"``
follows JAX's ``offload_dot_with_no_batch_dims``: the outputs of the
matmuls without a batch axis (``mm``, ``addmm``: the linear layers) go to
host memory, pinned, and come back in the recompute, which reruns every
other op.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from editanything_tpu_torch.parallel.sharding import unwrap
from editanything_tpu_torch.samplers.schedule import NoiseSchedule


@dataclasses.dataclass
class TrainState:
    """The trainable ControlNet (in a DDP wrap under data parallelism),
    its optimizer, the step and the LitEma shadow (ldm/modules/ema.py:5;
    None without EMA)."""
    controlnet: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[nn.Module] = None

    def state_dict(self) -> dict:
        return {"params": unwrap(self.controlnet).state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "step": int(self.step),
                "ema": None if self.ema is None else self.ema.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        unwrap(self.controlnet).load_state_dict(sd["params"])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])
        if self.ema is not None and sd["ema"] is not None:
            self.ema.load_state_dict(sd["ema"])


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.0
                   ) -> Callable[..., torch.optim.Optimizer]:
    """A factory params -> optimizer: Adam at lr 1e-5 (the reference's
    sam_train_sd21.py:13), AdamW when `weight_decay` is set (cldm.py:422);
    the update rules of optax's ``adam`` and ``adamw``."""
    if weight_decay:
        return functools.partial(torch.optim.AdamW, lr=lr,
                                 weight_decay=weight_decay)
    return functools.partial(torch.optim.Adam, lr=lr)


def init_train_state(controlnet: nn.Module, optimizer, *,
                     use_ema: bool = False) -> TrainState:
    """A train state over a copy of `controlnet` (the caller's module stays
    as it is, as JAX copies the parameters its steps donate), with
    `optimizer` (a factory params -> optimizer) over its parameters and an
    EMA copy when `use_ema`."""
    net = copy.deepcopy(controlnet).requires_grad_(True)
    ema = copy.deepcopy(net).requires_grad_(False) if use_ema else None
    return TrainState(net, optimizer(net.parameters()), 0, ema)


# the ops whose outputs "dots" keeps: matmuls and convolutions
_DOT_OPS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("mm", "addmm", "bmm", "baddbmm", "convolution"))


# the ops whose outputs "offload" keeps on the host: the matmuls without a
# batch axis (JAX's dot_general with no batch dimensions)
_NO_BATCH_DOTS = frozenset((torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _offload_contexts():
    """The (forward, recompute) contexts of one checkpointed call under
    "offload": the forward copies each ``_NO_BATCH_DOTS`` output to host
    memory (pinned where a card is present); the recompute takes those
    copies back in order instead of running the matmuls."""
    from torch.utils._python_dispatch import TorchDispatchMode
    kept = collections.deque()

    class Offload(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in _NO_BATCH_DOTS:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=out.is_cuda)
                kept.append(host.copy_(out, non_blocking=True))
            return out

    class Reload(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in _NO_BATCH_DOTS:
                return kept.popleft().to(args[-1].device, non_blocking=True)
            return func(*args, **(kwargs or {}))
    return Offload(), Reload()


def rematerialize(fn, remat):
    """`fn` under JAX's `remat` option, as the module's note maps it."""
    if not remat:
        return fn
    from torch.utils import checkpoint as ckpt
    if remat == "full":
        context_fn = ckpt.noop_context_fn
    elif remat == "offload":
        context_fn = _offload_contexts
    elif remat is True or remat == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    else:
        raise ValueError(f"unknown remat {remat!r}")

    def checkpointed(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context_fn)
    return checkpointed


def add_noise(schedule: NoiseSchedule, x0, noise, t):
    """q(x_t | x_0) at per-sample timesteps `t` (B,): fp32 coefficients
    sqrt(abar_t), sqrt(1 - abar_t), as JAX's ``add_noise`` with an array t."""
    a, s = alpha_sigma(schedule, t, x0)
    return (a * x0.float() + s * noise.float()).to(x0.dtype)


def alpha_sigma(schedule: NoiseSchedule, t, like):
    """(sqrt(abar_t), sqrt(1 - abar_t)) of per-sample `t`, fp32, shaped
    (B, 1, 1, 1) on `like`'s device."""
    abar = schedule.alphas_cumprod[t.cpu()]
    shape = (-1,) + (1,) * (like.dim() - 1)
    return (torch.sqrt(abar).reshape(shape).to(like.device),
            torch.sqrt(1.0 - abar).reshape(shape).to(like.device))


def draw_t_noise(schedule: NoiseSchedule, latents, generator, t=None,
                 noise=None):
    """The step's timesteps (B,) and noise, drawn from `generator` where not
    given (t first, then the noise, as JAX splits its key)."""
    gdev = generator.device if generator is not None else latents.device
    if t is None:
        t = torch.randint(0, schedule.num_train_timesteps, (latents.shape[0],),
                          generator=generator, device=gdev)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=gdev,
                            dtype=torch.float32).to(latents.dtype)
    return (torch.as_tensor(t).to(latents.device, torch.long),
            torch.as_tensor(noise).to(latents.device, latents.dtype))


def diffusion_target(schedule: NoiseSchedule, pred_type: str, latents, noise,
                     t):
    """The regression target: the noise (epsilon) or v = a noise - s x0."""
    if pred_type == "epsilon":
        return noise
    if pred_type == "v_prediction":
        a, s = alpha_sigma(schedule, t, latents)
        return (a * noise.float() - s * latents.float()).to(latents.dtype)
    raise ValueError(pred_type)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def ema_update(ema: nn.Module, params: nn.Module, step: int) -> None:
    """LitEma: e = e d + (1 - d) p with d = min(0.9999, (1 + step) /
    (10 + step)) in fp32, as JAX computes it."""
    d = np.minimum(np.float32(0.9999),
                   np.float32(1.0 + step) / np.float32(10.0 + step))
    for e, p in zip(ema.parameters(), params.parameters()):
        e.copy_(e * float(d) + float(np.float32(1.0) - d) * p)


def make_train_step(schedule: NoiseSchedule, *,
                    prediction_type: Optional[str] = None, remat=False):
    """Returns train_step(state, unet, batch, *, generator=None, t=None,
    noise=None) -> (state, metrics), the state updated in place.

    batch = {"latents": (B, 4, h, w) scaled VAE latents,
             "hint":    (B, 3, 8h, 8w) control condition in [0, 1],
             "context": (B, N, D) text-encoder states};
    `t` (B,) and `noise` (the latents' shape) are drawn from `generator`
    unless given (a test hands in JAX's draws). Metrics: ``loss`` and
    ``grad_norm`` (the global L2 norm of the ControlNet's gradients), as
    tensors. The ControlNet module (the state's) carries its config, where
    JAX's step takes it as the first argument."""
    pred_type = prediction_type or schedule.prediction_type

    def backbone(controlnet, unet, noisy, t, context, hint):
        down, mid = controlnet(noisy, t, context, hint)
        return unet(noisy, t, context, down_block_residuals=down,
                    mid_block_residual=mid)

    backbone = rematerialize(backbone, remat)

    def train_step(state: TrainState, unet, batch, *, generator=None, t=None,
                   noise=None):
        lat = batch["latents"]
        t, noise = draw_t_noise(schedule, lat, generator, t, noise)
        noisy = add_noise(schedule, lat, noise, t)
        state.optimizer.zero_grad(set_to_none=True)
        pred = backbone(state.controlnet, unet, noisy, t, batch["context"],
                        batch["hint"])
        target = diffusion_target(schedule, pred_type, lat, noise, t)
        loss = torch.mean(torch.square(pred.float() - target.float()))
        loss.backward()
        grad_norm = global_norm(p.grad for p in state.controlnet.parameters()
                                if p.grad is not None)
        state.optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, unwrap(state.controlnet), state.step)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    return train_step
