"""Reference-only control ("cross-image drag"): the write pass over the
noised reference latents fills feature banks, the read pass consumes them.

Counterpart of ``editanything_tpu/engine/refctrl.py``: ``RefConfig``, the
FFT magnitude mix (``add_freq_feature``, ``mix_ref_feature``), the masked
AdaIN (``masked_mean_var``, ``mix_norm_feature``), ``_resize_mask``, the
static gating weights and ``RefState``, whose banks are filled by the write
pass and consumed by position in the read pass. Activations are NCHW here,
so the spatial axes of a resnet output are (2, 3); a transformer's tokens
are laid out as a (B, h, w, C) grid for their mix.

The read attention differs in form, not in function. The JAX package
attends over concat(freq, bank) with the bank's tokens outside the
reference mask masked out of the softmax (logit finfo.min, probability
exactly 0). Here the bank keeps only the tokens inside the mask: their
indices come from the reference mask's first row, once per edit and block
size, on the host (``RefMasks``), and the attention over concat(freq,
valid bank) runs unmasked, through kernel B on a CUDA tensor. With no valid
token the keys are freq alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from editanything_tpu_torch.utils.image import resize_nearest


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """Reference-control parameters."""
    reference_attn: bool = True
    reference_adain: bool = False
    attention_auto_weight: float = 1.0    # hook a block if > its weight
    gn_auto_weight: float = 1.0           # hook a block if >= its weight
    style_fidelity: float = 0.5
    ref_scale: float = 0.0                # FFT magnitude mix ratio
    do_cfg: bool = True                   # the read batch is [uncond; cond]


# --- math ----------------------------------------------------------------

def add_freq_feature(ref, target, ref_ratio: float, dims=(2, 3)):
    """FFT magnitude mix over the spatial `dims`: the target keeps its
    phase, the magnitudes blend (1 - r) * target + r * ref. fp32 throughout,
    cast back to the target's dtype."""
    f1 = torch.fft.fftn(ref.float(), dim=dims)
    f2 = torch.fft.fftn(target.float(), dim=dims)
    mag = torch.abs(f2) * (1.0 - ref_ratio) + torch.abs(f1) * ref_ratio
    mixed = torch.polar(mag, torch.angle(f2))
    return torch.fft.ifftn(mixed, dim=dims).real.to(target.dtype)


def mix_ref_feature(target, ref_fea, ref_ratio: float, tile_cfg: bool,
                    dims=(2, 3)):
    """`ref_fea` comes from the write pass (no uncond half); tiled x2 when
    the read batch is a CFG pair."""
    if tile_cfg:
        ref_fea = torch.cat([ref_fea, ref_fea], dim=0)
    return add_freq_feature(ref_fea, target, ref_ratio, dims)


def masked_mean_var(x, mask):
    """Mean and variance over the masked pixels per (batch, channel), fp32.
    x: (B, C, H, W); mask: (1 or B, 1, H, W) in {0, 1}. Returns two
    (B, C, 1, 1)."""
    m = mask.float()
    cnt = torch.clamp(m.sum(dim=(2, 3), keepdim=True), min=1.0)
    xf = x.float()
    mean = (xf * m).sum(dim=(2, 3), keepdim=True) / cnt
    var = (m * (xf - mean) ** 2).sum(dim=(2, 3), keepdim=True) / cnt
    return mean, var


def mix_norm_feature(x, inpaint_mask, ref_mean, ref_var, cfg: RefConfig,
                     eps: float = 1e-6):
    """Masked AdaIN: the inpaint region renormalised to the reference's
    statistics (tiled for the CFG pair); under style fidelity the uncond
    rows keep their own features."""
    b = x.shape[0]
    m = _resize_mask(inpaint_mask, x.shape[2], x.shape[3])
    if cfg.do_cfg and 2 * m.shape[0] == b:
        # one mask per sample: the same for both halves of the CFG pair
        # (the JAX package broadcasts it, which fails above one sample)
        m = torch.cat([m, m], dim=0)
    mean, var = masked_mean_var(x, m)
    std = torch.sqrt(torch.clamp(var, min=eps))
    if cfg.do_cfg:
        ref_mean = torch.cat([ref_mean, ref_mean], dim=0)
        ref_var = torch.cat([ref_var, ref_var], dim=0)
    ref_std = torch.sqrt(torch.clamp(ref_var, min=eps))
    xf = x.float()
    x_uc = ((xf - mean) / std) * ref_std + ref_mean
    if cfg.do_cfg and cfg.style_fidelity > 0:
        x_c = torch.cat([xf[:b // 2], x_uc[b // 2:]], dim=0)
    else:
        x_c = x_uc
    mixed = cfg.style_fidelity * x_c + (1.0 - cfg.style_fidelity) * x_uc
    return (xf * (1.0 - m) + mixed * m).to(x.dtype)


def _resize_mask(mask, h: int, w: int):
    """(B?, 1, Hm, Wm) -> (B?, 1, h, w) fp32, nearest at half-pixel centres
    (``jax.image.resize`` "nearest")."""
    return resize_nearest(mask.float(), (h, w))


# --- static gating weights -----------------------------------------------

def attn_weights(dims_in_traversal_order: Tuple[int, ...]) -> List[float]:
    """A transformer block's weight: its rank / count over the blocks sorted
    by channel width descending (stable), aligned to traversal order."""
    n = len(dims_in_traversal_order)
    order = sorted(range(n), key=lambda i: -dims_in_traversal_order[i])
    w = [0.0] * n
    for rank, i in enumerate(order):
        w[i] = rank / float(n)
    return w


def unet_attn_weights(cfg) -> Dict[str, float]:
    """Weights of a UNetConfig's transformer blocks, keyed down.{bi}.{li} /
    mid / up.{bi}.{li}."""
    keys, dims = [], []
    for bi, bt in enumerate(cfg.down_block_types):
        if bt == "CrossAttnDownBlock2D":
            for li in range(cfg.layers_per_block):
                keys.append(f"down.{bi}.{li}")
                dims.append(cfg.block_out_channels[bi])
    keys.append("mid")
    dims.append(cfg.block_out_channels[-1])
    rev = list(reversed(cfg.block_out_channels))
    for bi, bt in enumerate(cfg.up_block_types):
        if bt == "CrossAttnUpBlock2D":
            for li in range(cfg.layers_per_block + 1):
                keys.append(f"up.{bi}.{li}")
                dims.append(rev[bi])
    return dict(zip(keys, attn_weights(tuple(dims))))


def controlnet_attn_weights(cfg) -> Dict[str, float]:
    """The same for a ControlNetConfig (down path and mid only)."""
    u = cfg.unet
    keys, dims = [], []
    for bi, bt in enumerate(u.down_block_types):
        if bt == "CrossAttnDownBlock2D":
            for li in range(u.layers_per_block):
                keys.append(f"down.{bi}.{li}")
                dims.append(u.block_out_channels[bi])
    keys.append("mid")
    dims.append(u.block_out_channels[-1])
    return dict(zip(keys, attn_weights(tuple(dims))))


def gn_weight_down(bi: int, n_down: int) -> float:
    return 1.0 - bi / float(n_down)


def gn_weight_up(bi: int, n_up: int) -> float:
    return bi / float(n_up)


# --- the banks -----------------------------------------------------------

class RefMasks:
    """The reference and inpaint masks of one edit at each block size,
    resized once per size, and the reference mask's valid token indices
    (its first row > 0.5, row-major), computed on the host from a CPU copy
    made once per edit.

    ref_mask: (1, 1, h, w) float in {0, 1}; inpaint_mask: (B, 1, h, w)."""

    def __init__(self, ref_mask, inpaint_mask):
        self.ref_mask = ref_mask
        self.inpaint_mask = inpaint_mask
        self._ref_cpu = ref_mask[:1].detach().float().cpu()
        self._cache = {}

    def _get(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def ref(self, h: int, w: int):
        return self._get(("ref", h, w),
                         lambda: _resize_mask(self.ref_mask, h, w))

    def inpaint(self, h: int, w: int):
        return self._get(("inpaint", h, w),
                         lambda: _resize_mask(self.inpaint_mask, h, w))

    def valid_tokens(self, h: int, w: int):
        """Indices of the reference tokens inside the mask at h x w, on the
        mask's device; possibly empty."""
        def make():
            m = _resize_mask(self._ref_cpu, h, w)[0, 0].reshape(-1)
            idx = torch.nonzero(m > 0.5).squeeze(1)
            return idx.to(self.ref_mask.device)
        return self._get(("valid", h, w), make)


class RefState:
    """Write mode: the hooks append to `banks`. Read mode: they consume them
    by position (the two passes of a step traverse the blocks in the same
    order)."""

    def __init__(self, cfg: RefConfig, mode: str, masks: RefMasks,
                 banks: Optional[Dict[str, list]] = None):
        if mode not in ("write", "read"):
            raise ValueError(f"unknown RefState mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.masks = masks
        self.banks = banks if banks is not None else {
            "attn_fea": [], "attn_bank": [],
            "gn_fea": [], "gn_mean": [], "gn_var": []}
        self._idx = {k: 0 for k in self.banks}

    def reader(self) -> "RefState":
        return RefState(self.cfg, "read", self.masks, banks=self.banks)

    def _pop(self, key: str):
        v = self.banks[key][self._idx[key]]
        self._idx[key] += 1
        return v

    # -- the attention hook ---------------------------------------------------

    def attn_active(self, weight: float) -> bool:
        return (self.cfg.reference_attn
                and self.cfg.attention_auto_weight > weight)

    def write_attn(self, norm_tokens, hw: Tuple[int, int]):
        """norm_tokens: (B, N, C) pre-attention hidden states of the write
        pass. Banks the masked token grid for the FFT mix and the tokens
        inside the reference mask."""
        b, n, c = norm_tokens.shape
        h, w = hw
        m = self.masks.ref(h, w).reshape(1, h, w, 1)
        grid = norm_tokens.reshape(b, h, w, c)
        self.banks["attn_fea"].append(grid * m.to(grid.dtype))
        self.banks["attn_bank"].append(
            norm_tokens[:, self.masks.valid_tokens(h, w)])

    def read_attn(self, attn, norm_tokens, hw: Tuple[int, int]):
        """The hooked self-attention output (B2, N, C) of the read pass (B2
        the CFG-doubled batch); `attn` is the block's ``Attention``."""
        cfg = self.cfg
        b2, n, c = norm_tokens.shape
        h, w = hw
        grid = norm_tokens.reshape(b2, h, w, c)
        freq = mix_ref_feature(grid, self._pop("attn_fea"), cfg.ref_scale,
                               tile_cfg=cfg.do_cfg, dims=(1, 2)
                               ).reshape(b2, n, c)
        bank = self._pop("attn_bank")
        if cfg.do_cfg:
            bank = torch.cat([bank, bank], dim=0)
        attn_uc = attn(freq, torch.cat([freq, bank.to(freq.dtype)], dim=1))
        if cfg.do_cfg and cfg.style_fidelity > 0:
            plain = attn(norm_tokens)
            attn_c = torch.cat([plain[:b2 // 2], attn_uc[b2 // 2:]], dim=0)
        else:
            attn_c = attn_uc
        return (cfg.style_fidelity * attn_c.float()
                + (1.0 - cfg.style_fidelity) * attn_uc.float()
                ).to(norm_tokens.dtype)

    # -- the AdaIN (GroupNorm) hook ---------------------------------------------

    def gn_active(self, weight: float) -> bool:
        return (self.cfg.reference_adain
                and self.cfg.gn_auto_weight >= weight)

    def write_gn(self, x):
        m = self.masks.ref(x.shape[2], x.shape[3])
        self.banks["gn_fea"].append(x * m.to(x.dtype))
        mean, var = masked_mean_var(x, m)
        self.banks["gn_mean"].append(mean)
        self.banks["gn_var"].append(var)

    def read_gn(self, x):
        x = mix_ref_feature(x, self._pop("gn_fea"), self.cfg.ref_scale,
                            tile_cfg=self.cfg.do_cfg)
        return mix_norm_feature(x, self.masks.inpaint(x.shape[2], x.shape[3]),
                                self._pop("gn_mean"), self._pop("gn_var"),
                                self.cfg)


def gn_hook(ref: Optional[RefState], h, weight: float):
    """The AdaIN hook after a plain (non-attention) down or up block's
    resnets and after the mid block."""
    if ref is None or not ref.gn_active(weight):
        return h
    if ref.mode == "write":
        ref.write_gn(h)
        return h
    return ref.read_gn(h)
