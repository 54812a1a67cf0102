"""DreamBooth-inpaint finetuning of the 9-channel UNet, with prior
preservation, and its LoRA variant.

Counterpart of ``editanything_tpu/train/dreambooth_inpaint.py``, with the
reference's semantics (tools/train_dreambooth_inpaint.py: ``random_mask``
rectangles and ellipses, :59-81; instance and class batches concatenated,
loss = instance eps-MSE + w * class eps-MSE, :604-630; AdamW; the LoRA
variant utils/train_dreambooth_lora_inpaint.py trains rank-r adapters
instead of the weights). The step takes pre-encoded latents, the latent
mask and the masked image's latents; the VAE encodes run in the program's
preprocessor (train/train_dreambooth.py).

As in train/controlnet_train.py, where JAX threads a pure state through a
jitted step, the states here hold the live module and its optimizer and
the steps update them in place. The kernels of the forward (B, A) are
differentiated through ``core/kernels.py::TwinVJP``. No remat, as in JAX.
The UNet runs in its parameters' dtype and the loss is fp32. ``AdamW`` is
``optax.adamw`` with ``warmup_constant_schedule``; ``t`` and the noise are
drawn in the step from an explicit generator unless handed in.

LoRA deltas keep JAX's layout and keys: ``{"down_blocks/0/attentions/0/
transformer_blocks/0/attn1/to_q": {"down": (din, r), "up": (r, dout)}}``,
so carrying them between the packages is a rename of nothing. The merge
adds ``(down @ up).T`` to the ``(dout, din)`` weight of ``nn.Linear`` and
substitutes it through ``torch.func.functional_call``: the frozen UNet's
parameters are never written, and only the deltas get gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from editanything_tpu_torch.parallel.sharding import unwrap
from editanything_tpu_torch.samplers.schedule import NoiseSchedule
from editanything_tpu_torch.train.controlnet_train import (add_noise,
                                                           draw_t_noise,
                                                           global_norm)


def random_mask(rng: np.random.RandomState, hw: Tuple[int, int],
                ratio: float = 1.0, mask_full_image: bool = False
                ) -> np.ndarray:
    """Random rectangle or ellipse mask (reference :59-81), numpy."""
    h, w = hw
    if mask_full_image:
        sh, sw = int(h * ratio), int(w * ratio)
    else:
        sh, sw = rng.randint(0, int(h * ratio) + 1), \
            rng.randint(0, int(w * ratio) + 1)
    cy = rng.randint(sh // 2, max(h - sh // 2, sh // 2) + 1)
    cx = rng.randint(sw // 2, max(w - sw // 2, sw // 2) + 1)
    yy, xx = np.mgrid[0:h, 0:w]
    if mask_full_image or rng.randint(0, 2) == 0:
        m = ((np.abs(yy - cy) <= sh // 2) & (np.abs(xx - cx) <= sw // 2))
    else:   # ellipse
        a, b = max(sh // 2, 1), max(sw // 2, 1)
        m = ((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 <= 1.0
    return m.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(lr, weight_decay=...)`` with the learning rate of
    ``optax.warmup_constant_schedule(0, lr, warmup_steps)`` when
    `warmup_steps` is set: a factory params -> ``torch.optim.AdamW`` (the
    same update: decoupled decay scaled by the rate, eps outside the
    root), and ``lr_at(count)``, the rate of the update made at `count`
    (optax evaluates a schedule at the count before its increment, so the
    first update of a warm-up has rate 0)."""
    lr: float
    weight_decay: float = 1e-2
    warmup_steps: int = 0

    def lr_at(self, count: int) -> float:
        if not self.warmup_steps:
            return self.lr
        return self.lr * min(count, self.warmup_steps) / self.warmup_steps

    def __call__(self, params) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=self.lr_at(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)


def _apply_update(optimizer: torch.optim.Optimizer, schedule: AdamW,
                  count: int) -> None:
    for group in optimizer.param_groups:
        group["lr"] = schedule.lr_at(count)
    optimizer.step()


@dataclasses.dataclass
class DBState:
    """The UNet being finetuned (every parameter trains), its optimizer and
    the step."""
    unet: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"params": unwrap(self.unet).state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "step": int(self.step)}

    def load_state_dict(self, sd: dict) -> None:
        unwrap(self.unet).load_state_dict(sd["params"])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


def _unet_input(schedule: NoiseSchedule, batch, t, noise, dtype):
    """The 9 channels [noisy latents, mask, masked-image latents] in the
    UNet's dtype."""
    noisy = add_noise(schedule, batch["latents"], noise, t)
    return torch.cat([noisy, batch["mask"].to(noisy.dtype),
                      batch["masked_latents"].to(noisy.dtype)],
                     dim=1).to(dtype)


def db_loss(pred, noise, prior_loss_weight: float) -> torch.Tensor:
    """eps-MSE in fp32; with prior preservation the batch is [instance;
    class] halves, the class half's MSE weighted."""
    err = torch.square(pred.float() - noise.float())
    if prior_loss_weight > 0:
        inst, prior = torch.chunk(err, 2, dim=0)
        return torch.mean(inst) + prior_loss_weight * torch.mean(prior)
    return torch.mean(err)


def _check_nine_channels(unet_cfg) -> None:
    if unet_cfg.in_channels != 9:
        raise ValueError(f"DreamBooth-inpaint trains the 9-channel inpaint "
                         f"UNet; this one takes {unet_cfg.in_channels}")


def make_db_train_step(unet_cfg, schedule: NoiseSchedule, optimizer: AdamW, *,
                       prior_loss_weight: float = 0.0):
    """Returns step(state, batch, *, generator=None, t=None, noise=None) ->
    (state, metrics), the state updated in place.

    batch = {"latents": (B, 4, h, w) target latents,
             "mask": (B, 1, h, w) latent-resolution edit mask,
             "masked_latents": (B, 4, h, w) latents of the masked image,
             "context": (B, N, D)};
    with ``prior_loss_weight > 0`` the batch is [instance; class] halves
    (reference :604-630). `optimizer` gives the rate of each update
    (``AdamW.lr_at``); the state holds the torch optimizer it made. `t` (B,)
    and `noise` are drawn from `generator` unless given. Metrics: ``loss``
    and ``grad_norm``."""
    _check_nine_channels(unet_cfg)

    def step(state: DBState, batch, *, generator=None, t=None, noise=None):
        lat = batch["latents"]
        t, noise = draw_t_noise(schedule, lat, generator, t, noise)
        state.optimizer.zero_grad(set_to_none=True)
        dtype = next(state.unet.parameters()).dtype
        pred = state.unet(_unet_input(schedule, batch, t, noise, dtype), t,
                          batch["context"].to(dtype))
        loss = db_loss(pred, noise, prior_loss_weight)
        loss.backward()
        grad_norm = global_norm(p.grad for p in state.unet.parameters()
                                if p.grad is not None)
        _apply_update(state.optimizer, optimizer, state.step)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    return step


# ---------------------------------------------------------------------------
# LoRA variant (utils/train_dreambooth_lora_inpaint.py semantics)
# ---------------------------------------------------------------------------

def lora_target_modules(unet: nn.Module, targets=("to_q", "to_k", "to_v")
                        ) -> Dict[str, nn.Linear]:
    """JAX tree path ("/"-joined) -> the ``nn.Linear`` of every attention
    projection named in `targets`, in module order."""
    return {name.replace(".", "/"): m for name, m in unet.named_modules()
            if name.rsplit(".", 1)[-1] in targets and isinstance(m, nn.Linear)}


@torch.no_grad()
def init_lora_deltas(unet: nn.Module, *, rank: int = 4,
                     targets=("to_q", "to_k", "to_v"),
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Rank-r (down, up) pairs for every attention projection named in
    `targets`: down N(0, 0.01^2) drawn from `generator` (on the UNet's
    device), up zero, so training starts at the UNet's own output."""
    deltas = {}
    for path, m in lora_target_modules(unet, targets).items():
        dout, din = m.weight.shape
        w = m.weight
        down = torch.randn((din, rank), generator=generator, device=w.device,
                           dtype=torch.float32).to(w.dtype) * 0.01
        deltas[path] = {"down": down,
                        "up": torch.zeros((rank, dout), dtype=w.dtype,
                                          device=w.device)}
    return deltas


def apply_lora_deltas(unet: nn.Module, deltas, multiplier: float = 1.0
                      ) -> Dict[str, torch.Tensor]:
    """The merged weights, ``name -> W + m (down @ up).T`` in W's dtype,
    for each delta, for ``torch.func.functional_call``; the UNet is not
    touched."""
    out = {}
    for path, d in deltas.items():
        name = path.replace("/", ".") + ".weight"
        w = unet.get_parameter(name)
        out[name] = w + (multiplier * (d["down"] @ d["up"]).T).to(w.dtype)
    return out


class LoRADeltas(nn.Module):
    """The deltas as parameters named ``<path>/down`` and ``<path>/up`` (the
    JAX tree flattened with "/"), so an optimizer, a checkpoint and DDP take
    them as a module. ``forward(unet, x, t, context)`` runs the frozen UNet
    with the deltas merged."""

    def __init__(self, deltas, multiplier: float = 1.0):
        super().__init__()
        self.paths = list(deltas)
        self.multiplier = multiplier
        for path, d in deltas.items():
            for part in ("down", "up"):
                self.register_parameter(
                    f"{path}/{part}", nn.Parameter(d[part].detach().clone()))

    def tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{path: {"down", "up"}} over the live parameters."""
        return {p: {"down": self._parameters[f"{p}/down"],
                    "up": self._parameters[f"{p}/up"]} for p in self.paths}

    def forward(self, unet, x, t, context):
        merged = apply_lora_deltas(unet, self.tree(), self.multiplier)
        return torch.func.functional_call(unet, merged, (x, t, context))


@dataclasses.dataclass
class LoRAState:
    """The LoRA deltas being trained, their optimizer and the step."""
    deltas: LoRADeltas
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"params": unwrap(self.deltas).state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "step": int(self.step)}

    def load_state_dict(self, sd: dict) -> None:
        unwrap(self.deltas).load_state_dict(sd["params"])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


def make_db_lora_train_step(unet_cfg, schedule: NoiseSchedule,
                            optimizer: AdamW, *,
                            prior_loss_weight: float = 0.0):
    """The step of ``make_db_train_step`` with only the LoRA deltas trained:
    step(state: LoRAState, unet, batch, *, generator=None, t=None,
    noise=None) -> (state, metrics). `unet` is frozen (``requires_grad``
    off) and its weights stay as they are."""
    _check_nine_channels(unet_cfg)

    def step(state: LoRAState, unet, batch, *, generator=None, t=None,
             noise=None):
        unet.requires_grad_(False)
        lat = batch["latents"]
        t, noise = draw_t_noise(schedule, lat, generator, t, noise)
        state.optimizer.zero_grad(set_to_none=True)
        dtype = next(unet.parameters()).dtype
        pred = state.deltas(unet, _unet_input(schedule, batch, t, noise, dtype),
                            t, batch["context"].to(dtype))
        loss = db_loss(pred, noise, prior_loss_weight)
        loss.backward()
        grad_norm = global_norm(p.grad for p in state.deltas.parameters()
                                if p.grad is not None)
        _apply_update(state.optimizer, optimizer, state.step)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    return step
