"""Plain fp32 Stable Diffusion 1.5: the UNet, the ControlNet, the VAE and
the CLIP text tower, with diffusers' parameter names, so that one state
dict loads into these modules and into the port's.

Written from the published architectures (diffusers' UNet2DConditionModel,
ControlNetModel, AutoencoderKL and transformers' CLIPTextModel at the
configurations of runwayml/stable-diffusion-v1-5 and lllyasviel's
cldm_v15.yaml). Every product goes through ``reference/nn.py``. Modules
hold parameters only; ``forward`` computes in fp32. Imports nothing of
the port. One departure, the port's specification (the JAX package's) and
noted in PERF.md: the VAE encoder's stride-2 convs pad one pixel on every
side, where the published encoder pads the right and bottom edges only
(``VAEConfig.published_encoder_pad`` selects the published form).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference import nn as P


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: Tuple[int, ...] = (8, 8, 8, 8)   # heads per block
    use_linear_projection: bool = False
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D")
    norm_num_groups: int = 32
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    unet: UNetConfig = UNetConfig()
    conditioning_channels: int = 3
    conditioning_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    # the published encoder pads (0, 1) before its stride-2 convs; the
    # port's specification pads (1, 1) (PERF.md, departures)
    published_encoder_pad: bool = False


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_skip: int = 0
    eos_token_id: int = 49407


def from_dict(cls, d: dict):
    """A config dataclass from a JSON dict (lists become tuples)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d.items() if k in fields}
    if cls is ControlNetConfig and isinstance(kw.get("unet"), dict):
        kw["unet"] = from_dict(UNetConfig, kw["unet"])
    return cls(**kw)


class GroupNorm(nn.Module):
    def __init__(self, c, groups, eps):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, silu=False):
        return P.group_norm(x, self.weight, self.bias, self.groups, self.eps,
                            silu)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return P.layer_norm(x, self.weight, self.bias, self.eps)


def lin(m: nn.Linear, x):
    return P.linear(x, m.weight, m.bias)


def conv(m: nn.Conv2d, x):
    return P.conv2d(x, m.weight, m.bias, stride=m.stride, padding=m.padding)


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = GroupNorm(cout, groups, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = conv(self.conv1, self.norm1(x, silu=True))
        if temb is not None and self.time_emb_proj is not None:
            h = h + lin(self.time_emb_proj, F.silu(temb))[:, :, None, None]
        h = conv(self.conv2, self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = conv(self.conv_shortcut, x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim, context_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        b, n, c = x.shape
        ctx = x if context is None else context
        d = c // self.heads

        def heads(t):
            return t.view(b, t.shape[1], self.heads, d).transpose(1, 2)
        out = P.attention(heads(lin(self.to_q, x)), heads(lin(self.to_k, ctx)),
                          heads(lin(self.to_v, ctx)))
        return lin(self.to_out[0], out.transpose(1, 2).reshape(b, n, c))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = lin(self.proj, x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return lin(self.net[2], self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim, context_dim, heads):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, heads)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, c, context_dim, heads, linear, groups):
        super().__init__()
        self.linear = linear
        self.norm = GroupNorm(c, groups, 1e-6)
        make = (lambda: nn.Linear(c, c)) if linear else (
            lambda: nn.Conv2d(c, c, 1))
        self.proj_in = make()
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(c, context_dim, heads)])
        self.proj_out = make()

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.norm(x)
        if self.linear:
            y = lin(self.proj_in, y.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            y = conv(self.proj_in, y).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        if self.linear:
            y = lin(self.proj_out, y)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if not self.linear:
            y = conv(self.proj_out, y)
        return y + x


class Down(nn.Module):
    def __init__(self, conv_):
        super().__init__()
        self.conv = conv_

    def forward(self, x):
        return conv(self.conv, x)


class Up(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return conv(self.conv, F.interpolate(x, scale_factor=2.0,
                                              mode="nearest"))


class TimeEmbedding(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t):
        return lin(self.linear_2, F.silu(lin(self.linear_1, t)))


def _transformer(cfg, c, heads):
    return Transformer2D(c, cfg.cross_attention_dim, heads,
                         cfg.use_linear_projection, cfg.norm_num_groups)


class DownBlock(nn.Module):
    def __init__(self, cfg, cin, cout, attn, down, heads):
        super().__init__()
        temb, g = 4 * cfg.block_out_channels[0], cfg.norm_num_groups
        self.resnets = nn.ModuleList(
            [Resnet(cin if i == 0 else cout, cout, temb, g, 1e-5)
             for i in range(cfg.layers_per_block)])
        self.attentions = nn.ModuleList(
            [_transformer(cfg, cout, heads)
             for _ in range(cfg.layers_per_block)]) if attn else None
        self.downsamplers = nn.ModuleList([Down(nn.Conv2d(
            cout, cout, 3, stride=2, padding=1))]) if down else None


class MidBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c, g = cfg.block_out_channels[-1], cfg.norm_num_groups
        temb = 4 * cfg.block_out_channels[0]
        self.resnets = nn.ModuleList([Resnet(c, c, temb, g, 1e-5)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList(
            [_transformer(cfg, c, cfg.attention_head_dim[-1])])

    def forward(self, h, temb, context):
        h = self.resnets[0](h, temb)
        h = self.attentions[0](h, context)
        return self.resnets[1](h, temb)


class UpBlock(nn.Module):
    def __init__(self, cfg, prev, cout, skip, attn, up, heads):
        super().__init__()
        temb, g = 4 * cfg.block_out_channels[0], cfg.norm_num_groups
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList(
            [Resnet((prev if i == 0 else cout) + (skip if i == n - 1
                                                   else cout), cout, temb, g,
                    1e-5) for i in range(n)])
        self.attentions = nn.ModuleList(
            [_transformer(cfg, cout, heads) for _ in range(n)]) \
            if attn else None
        self.upsamplers = nn.ModuleList([Up(cout)]) if up else None


def down_blocks(cfg):
    blocks, prev, last = [], cfg.block_out_channels[0], \
        len(cfg.block_out_channels) - 1
    for i, (c, kind) in enumerate(zip(cfg.block_out_channels,
                                      cfg.down_block_types)):
        blocks.append(DownBlock(cfg, prev, c, kind == "CrossAttnDownBlock2D",
                                i < last, cfg.attention_head_dim[i]))
        prev = c
    return nn.ModuleList(blocks)


def encode(blocks, h, temb, context):
    res = [h]
    for blk in blocks:
        for i, r in enumerate(blk.resnets):
            h = r(h, temb)
            if blk.attentions is not None:
                h = blk.attentions[i](h, context)
            res.append(h)
        if blk.downsamplers is not None:
            h = blk.downsamplers[0](h)
            res.append(h)
    return h, res


def time_embed(module, cfg, t):
    e = P.timestep_embedding(t, cfg.block_out_channels[0],
                             cfg.flip_sin_to_cos, cfg.freq_shift)
    return module.time_embedding(e)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
        self.time_embedding = TimeEmbedding(c0, 4 * c0)
        self.down_blocks = down_blocks(cfg)
        self.mid_block = MidBlock(cfg)
        rev = list(reversed(cfg.block_out_channels))
        n = len(cfg.up_block_types)
        ups, prev = [], rev[0]
        for i, kind in enumerate(cfg.up_block_types):
            ups.append(UpBlock(cfg, prev, rev[i], rev[min(i + 1, len(rev) - 1)],
                               kind == "CrossAttnUpBlock2D", i < n - 1,
                               cfg.attention_head_dim[n - 1 - i]))
            prev = rev[i]
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(c0, cfg.norm_num_groups, 1e-5)
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)

    def forward(self, x, t, context, down_residuals=None, mid_residual=None):
        temb = time_embed(self, self.cfg, t)
        h, res = encode(self.down_blocks, conv(self.conv_in, x), temb, context)
        h = self.mid_block(h, temb, context)
        if down_residuals is not None:
            res = [r + c for r, c in zip(res, down_residuals)]
            h = h + mid_residual
        for blk in self.up_blocks:
            for i, r in enumerate(blk.resnets):
                h = r(torch.cat([h, res.pop()], dim=1), temb)
                if blk.attentions is not None:
                    h = blk.attentions[i](h, context)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h)
        return conv(self.conv_out, self.conv_norm_out(h, silu=True))


class HintEmbedding(nn.Module):
    def __init__(self, cfg: ControlNetConfig):
        super().__init__()
        ch = cfg.conditioning_embedding_channels
        self.conv_in = nn.Conv2d(cfg.conditioning_channels, ch[0], 3, padding=1)
        blocks = []
        for i in range(len(ch) - 1):
            blocks += [nn.Conv2d(ch[i], ch[i], 3, padding=1),
                       nn.Conv2d(ch[i], ch[i + 1], 3, stride=2, padding=1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(ch[-1], cfg.unet.block_out_channels[0], 3,
                                  padding=1)

    def forward(self, x):
        h = F.silu(conv(self.conv_in, x))
        for b in self.blocks:
            h = F.silu(conv(b, h))
        return conv(self.conv_out, h)


class ControlNet(nn.Module):
    def __init__(self, cfg: ControlNetConfig):
        super().__init__()
        u = cfg.unet
        self.ucfg = u
        c0 = u.block_out_channels[0]
        self.conv_in = nn.Conv2d(u.in_channels, c0, 3, padding=1)
        self.time_embedding = TimeEmbedding(c0, 4 * c0)
        self.down_blocks = down_blocks(u)
        self.mid_block = MidBlock(u)
        self.controlnet_cond_embedding = HintEmbedding(cfg)
        zero = [c0]
        for i, c in enumerate(u.block_out_channels):
            zero += [c] * u.layers_per_block
            if i < len(u.block_out_channels) - 1:
                zero.append(c)
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(c, c, 1) for c in zero])
        cm = u.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(cm, cm, 1)

    def forward(self, x, t, context, hint, scale=1.0):
        """(down residuals, mid residual), each times `scale`."""
        temb = time_embed(self, self.ucfg, t)
        h = conv(self.conv_in, x) + self.controlnet_cond_embedding(hint)
        h, res = encode(self.down_blocks, h, temb, context)
        h = self.mid_block(h, temb, context)
        down = [conv(c, r) * scale
                for c, r in zip(self.controlnet_down_blocks, res)]
        return down, conv(self.controlnet_mid_block, h) * scale


class VAEAttention(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.group_norm = GroupNorm(c, groups, 1e-6)
        self.to_q, self.to_k, self.to_v = (nn.Linear(c, c) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
        out = P.attention(lin(self.to_q, y), lin(self.to_k, y),
                          lin(self.to_v, y))
        out = lin(self.to_out[0], out.reshape(b, h * w, c))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VAEMid(nn.Module):
    def __init__(self, c, g):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(c, c, None, g, 1e-6)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(c, g)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class VAEBlock(nn.Module):
    def __init__(self, chans, g, down=False, up=False, published_pad=False):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(a, b, None, g, 1e-6)
                                      for a, b in chans])
        c = chans[-1][1]
        self.pad = (0, 1, 0, 1) if published_pad else (1, 1, 1, 1)
        self.downsamplers = nn.ModuleList([Down(nn.Conv2d(
            c, c, 3, stride=2, padding=0))]) if down else None
        self.upsamplers = nn.ModuleList([Up(c)]) if up else None

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0](F.pad(h, self.pad))
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        cb, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, cb[0], 3, padding=1)
        blocks, ch = [], cb[0]
        for i, c in enumerate(cb):
            blocks.append(VAEBlock([(ch if j == 0 else c, c)
                                    for j in range(cfg.layers_per_block)], g,
                                   down=i < len(cb) - 1,
                                   published_pad=cfg.published_encoder_pad))
            ch = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = VAEMid(ch, g)
        self.conv_norm_out = GroupNorm(ch, g, 1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = conv(self.conv_in, x)
        for b in self.down_blocks:
            h = b(h)
        h = self.mid_block(h)
        return conv(self.conv_out, self.conv_norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMid(rev[0], g)
        blocks, ch = [], rev[0]
        for i, c in enumerate(rev):
            blocks.append(VAEBlock([(ch if j == 0 else c, c)
                                    for j in range(cfg.layers_per_block + 1)],
                                   g, up=i < len(rev) - 1))
            ch = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(rev[-1], g, 1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(conv(self.conv_in, z))
        for b in self.up_blocks:
            h = b(h)
        return conv(self.conv_out, self.conv_norm_out(h, silu=True))


class VAE(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        z = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * z, 2 * z, 1)
        self.post_quant_conv = nn.Conv2d(z, z, 1)

    def encode(self, x):
        """(B, 3, H, W) in [-1, 1] -> the posterior's mode, scaled."""
        mean = conv(self.quant_conv, self.encoder(x))[:, :self.cfg.latent_channels]
        return mean * self.cfg.scaling_factor

    def decode(self, z):
        """Scaled latents -> (B, 3, 8h, 8w) in [-1, 1]."""
        return self.decoder(conv(self.post_quant_conv,
                                 z / self.cfg.scaling_factor))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads, self.act = cfg.num_heads, cfg.hidden_act
        self.layer_norm1 = LayerNorm(d)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.layer_norm2 = LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.mlp.fc2 = nn.Linear(cfg.intermediate_size, d)

    def forward(self, x, mask):
        b, n, d = x.shape
        a = self.self_attn
        y = self.layer_norm1(x)
        q, k, v = (lin(p, y).view(b, n, self.heads, -1).transpose(1, 2)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        att = P.attention(q, k, v, mask=mask).transpose(1, 2).reshape(b, n, d)
        x = x + lin(a.out_proj, att)
        h = lin(self.mlp.fc1, self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" \
            else F.gelu(h)
        return x + lin(self.mlp.fc2, h)


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg.vocab_size,
                                                       cfg.hidden_size)
        self.embeddings.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([CLIPLayer(cfg)
                                             for _ in range(cfg.num_layers)])
        self.final_layer_norm = LayerNorm(cfg.hidden_size)

    def forward(self, ids):
        """(B, N) token ids -> (B, N, D): the final layer's states after
        the final norm (SD1.5's context)."""
        n = ids.shape[1]
        e = self.embeddings
        x = (e.token_embedding.weight.float()[ids]
             + e.position_embedding.weight.float()[:n])
        i = torch.arange(n, device=ids.device)
        mask = (i[None, :] <= i[:, None])[None, None]
        for layer in self.encoder.layers[:self.cfg.num_layers
                                         - self.cfg.layer_skip]:
            x = layer(x, mask)
        return self.final_layer_norm(x)
