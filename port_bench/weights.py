"""Random weights in the published layouts, drawn from the seed on the
device in a few large calls.

A model's parameter names and shapes come from the reference module built
on the meta device. Every value of a model is one draw of a single
uniform buffer from a generator on the device, seeded from the run's seed
and the model's name, then scaled per tensor by one product with a
per-element bound (``repeat_interleave`` of the bounds) and cast once to
the served dtype. So the same seed gives the same weights, and the port
and the reference load the same numbers (the reference upcasts them).

Draws: linear and conv weights and biases uniform in +-1/sqrt(fan_in)
(a transposed conv's fan-in is its input channels), so the ControlNets'
zero convs are drawn nonzero; norm scales 1 + U(-0.1, 0.1) and shifts
U(-0.1, 0.1); CLIP's token and position embeddings at standard deviations
0.02 and 0.01; SAM's embeddings and Fourier matrix at 1, its position
embedding at 0.02 and its relative-position tables at 0.05 (each uniform
with that standard deviation).
"""

from __future__ import annotations

import math
import zlib

import torch
import torch.nn as nn

from port_bench import harness as H

SQRT3 = math.sqrt(3.0)


def _leaf_specs(module: nn.Module):
    """(name, shape, bound, shift) for every tensor of the state dict."""
    owner = {}
    for mname, m in module.named_modules():
        for pname, _ in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            owner[f"{mname}.{pname}" if mname else pname] = (m, pname)
    specs = []
    for name, t in module.state_dict().items():
        m, leaf = owner[name]
        bound, shift = 0.1, 0.0
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else w[0].numel())
            bound = fan_in ** -0.5
        elif isinstance(m, nn.Embedding):
            bound = SQRT3 * (0.01 if name.endswith("position_embedding.weight")
                             else 0.02 if "token_embedding" in name else 1.0)
        elif leaf == "weight":               # norms
            shift = 1.0
        if name.endswith("pos_embed"):
            bound = SQRT3 * 0.02
        elif leaf.startswith("rel_pos"):
            bound = SQRT3 * 0.05
        elif leaf == "positional_encoding_gaussian_matrix":
            bound = SQRT3
        specs.append((name, tuple(t.shape), bound, shift))
    return specs


def draw(module: nn.Module, seed: int, tag: str, device, dtype) -> dict:
    """The state dict of `module` (a reference module, on any device) drawn
    for (`seed`, `tag`) on `device` in `dtype`: one uniform buffer, one
    scale, one cast."""
    specs = _leaf_specs(module)
    sizes = [math.prod(s) for _, s, _, _ in specs]
    g = torch.Generator(device).manual_seed(
        (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % 2 ** 63)
    flat = torch.rand(sum(sizes), generator=g, device=device)
    counts = torch.tensor(sizes, device=device)
    bound = torch.repeat_interleave(
        torch.tensor([b for _, _, b, _ in specs], device=device), counts)
    flat = flat.mul_(2.0).sub_(1.0).mul_(bound)
    del bound
    shift = torch.repeat_interleave(
        torch.tensor([s for _, _, _, s in specs], device=device), counts)
    flat = flat.add_(shift).to(dtype)
    del shift
    out, at = {}, 0
    for (name, shape, _, _), n in zip(specs, sizes):
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def meta(cls, cfg) -> nn.Module:
    with torch.device("meta"):
        return cls(cfg)


def reference_module(cls, cfg, state: dict, device) -> nn.Module:
    """A reference module holding `state` upcast to fp32 on `device`."""
    m = meta(cls, cfg)
    m.load_state_dict({k: v.to(device, torch.float32) for k, v in
                       state.items()}, strict=True, assign=True)
    return m.eval().requires_grad_(False)


def reference_parts(part: str, fields: dict):
    """(reference class, its config) of model `part` (``parts/<part>.py``)
    at the widths in `fields`."""
    return H.part(part).reference(fields)


def reference_config(part: str, fields: dict):
    return reference_parts(part, fields)[1]


def reference_model(part: str, fields: dict, state: dict, device):
    """The reference module of model `part` holding `state` in fp32."""
    cls, cfg = reference_parts(part, fields)
    return reference_module(cls, cfg, state, device)


def model_weights(part: str, fields: dict, seed: int, tag: str, device,
                  dtype) -> dict:
    """The drawn state dict of one model of a configuration."""
    cls, cfg = reference_parts(part, fields)
    return draw(meta(cls, cfg), seed, tag, device, dtype)
