"""Textual inversion: learn placeholder-token embeddings.

Counterpart of ``editanything_tpu/train/textual_inversion.py`` (the
reference's utils/texutal_inversion.py, run by the cross-image-drag flow
when no embedding exists, editany_lora.py:732-745): N rows appended to the
token-embedding table for the placeholder, each initialised from the
initializer token's row (:623-660); the eps-MSE diffusion loss; only the
new rows change. The reference zeroes the other rows' gradients
(:744-753); JAX masks the gradient and the update, and so does the port,
since Adam's moments would otherwise move other rows. The UNet and the
rest of the text tower stay frozen: the step differentiates the table
alone, substituted into the text tower by ``torch.func.functional_call``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from editanything_tpu_torch.checkpoints.lora import append_textual_inversion
from editanything_tpu_torch.samplers.schedule import NoiseSchedule
from editanything_tpu_torch.train.controlnet_train import (add_noise,
                                                           draw_t_noise)

# the reference's :424-452
IMAGENET_TEMPLATES_SMALL = [
    "a photo of a {}", "a rendering of a {}", "a cropped photo of the {}",
    "the photo of a {}", "a photo of a clean {}", "a photo of a dirty {}",
    "a dark photo of the {}", "a photo of my {}", "a photo of the cool {}",
    "a close-up photo of a {}", "a bright photo of the {}",
    "a cropped photo of a {}", "a photo of the {}", "a good photo of the {}",
    "a photo of one {}", "a close-up photo of the {}",
    "a rendition of the {}", "a photo of the clean {}", "a rendition of a {}",
    "a photo of a nice {}", "a good photo of a {}", "a photo of the nice {}",
    "a photo of the small {}", "a photo of the weird {}",
    "a photo of the large {}", "a photo of a cool {}",
    "a photo of a small {}",
]

TABLE = "embeddings.token_embedding.weight"


@dataclasses.dataclass
class TIState:
    """The whole (V + num_vectors, D) table being trained (a leaf tensor),
    its optimizer and the step."""
    embeddings: torch.Tensor
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"embeddings": self.embeddings.detach(),
                "opt_state": self.optimizer.state_dict(),
                "step": int(self.step)}

    def load_state_dict(self, sd: dict) -> None:
        with torch.no_grad():
            self.embeddings.copy_(sd["embeddings"])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])


def add_placeholder_tokens(text: nn.Module, tokenizer, *, num_vectors: int,
                           initializer_token: str) -> List[int]:
    """Append `num_vectors` rows, each the initializer token's first id's
    row, to the text tower's table (in place). Returns their ids."""
    table = text.embeddings.token_embedding.weight
    init = table[tokenizer.encode(initializer_token)[0]]
    return append_textual_inversion(text, init[None].expand(num_vectors, -1))


def init_ti_state(text: nn.Module, optimizer) -> TIState:
    """A state over a copy of the text tower's table; `optimizer` is a
    factory params -> optimizer."""
    table = text.embeddings.token_embedding.weight.detach().clone()
    table.requires_grad_(True)
    return TIState(table, optimizer([table]), 0)


def placeholder_prompt_ids(tokenizer, template: str,
                           placeholder_ids: Sequence[int],
                           pad_to: int) -> List[int]:
    """A template tokenized with the placeholder ids spliced in, as one
    [BOS, ids, EOS, EOS...] row of `pad_to`."""
    before, after = template.split("{}")
    ids = (tokenizer.encode(before.strip()) + list(placeholder_ids)
           + tokenizer.encode(after.strip()))
    row = [tokenizer.bos_id] + ids[:pad_to - 2] + [tokenizer.eos_id]
    return row + [tokenizer.eos_id] * (pad_to - len(row))


def make_ti_train_step(schedule: NoiseSchedule,
                       placeholder_ids: Sequence[int]):
    """Returns step(state, text, unet, batch, *, generator=None, t=None,
    noise=None) -> (state, {"loss"}), the state updated in place.

    batch = {"latents": (B, 4, h, w), "input_ids": (B, L)}; the text
    tower runs with ``state.embeddings`` as its table; `t` and `noise` are
    drawn from `generator` unless given. Only the placeholder rows'
    gradient reaches the optimizer, and only their update is kept."""
    pid0, pid1 = min(placeholder_ids), max(placeholder_ids) + 1

    def step(state: TIState, text, unet, batch, *, generator=None, t=None,
             noise=None):
        table = state.embeddings
        lat = batch["latents"]
        ids = torch.as_tensor(np.asarray(batch["input_ids"])).to(lat.device,
                                                                  torch.long)
        t, noise = draw_t_noise(schedule, lat, generator, t, noise)
        noisy = add_noise(schedule, lat, noise, t)
        state.optimizer.zero_grad(set_to_none=True)
        ctx = torch.func.functional_call(text, {TABLE: table}, (ids,))
        # the UNet runs in its parameters' dtype (bf16 on a loaded bundle),
        # the loss in fp32, as in the ControlNet step
        p_dtype = next(unet.parameters()).dtype
        pred = unet(noisy.to(p_dtype), t, ctx.to(p_dtype))
        loss = torch.mean(torch.square(pred.float() - noise.float()))
        loss.backward()
        rows = torch.zeros(table.shape[0], 1, dtype=torch.bool,
                           device=table.device)
        rows[pid0:pid1] = True
        before = table.detach().clone()
        with torch.no_grad():
            table.grad.mul_(rows)
            state.optimizer.step()
            table.copy_(torch.where(rows, table, before))
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def learned_embeddings(state: TIState, placeholder_ids: Sequence[int]
                       ) -> torch.Tensor:
    """The placeholder rows (num_vectors, D): the TI checkpoint (the
    reference's save_progress :160-168 saves {placeholder: rows})."""
    return state.embeddings.detach()[min(placeholder_ids):
                                     max(placeholder_ids) + 1]


# learned rows appended to a text tower's table in place, their ids returned
# (the ``pipe.load_textual_inversion`` path, editany_lora.py:734)
load_textual_inversion = append_textual_inversion
