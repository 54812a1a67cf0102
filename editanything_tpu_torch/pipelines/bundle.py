"""ModelBundle: the configs and modules one edit needs, with named ControlNets.

Counterpart of ``editanything_tpu/pipelines/bundle.py``. Modules are built
on the meta device and materialised once on their target device, so a
full-size SD1.5 bundle is initialised on the GPU directly. Every random
draw takes an explicit ``torch.Generator`` on that device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from editanything_tpu_torch.checkpoints.convert import state_dict_from_tree
from editanything_tpu_torch.core import layers as L
from editanything_tpu_torch.models import config as C
from editanything_tpu_torch.models.clip_text import CLIPTextModel
from editanything_tpu_torch.models.controlnet import ControlNetModel
from editanything_tpu_torch.models.sam import LayerNorm2d, Sam, SAMConfig
from editanything_tpu_torch.models.unet import UNet2DConditionModel
from editanything_tpu_torch.models.vae import AutoencoderKL
from editanything_tpu_torch.samplers.schedule import make_schedule
from editanything_tpu_torch.text.tokenizer import tiny_tokenizer


@dataclasses.dataclass
class ModelBundle:
    """Configs + modules for one base model and its named ControlNets."""
    unet_cfg: C.UNetConfig
    vae_cfg: C.VAEConfig
    text_cfg: C.CLIPTextConfig
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text: CLIPTextModel
    tokenizer: Any
    # name -> (ControlNetConfig, module)
    controlnets: Dict[str, Tuple[C.ControlNetConfig, ControlNetModel]] = \
        dataclasses.field(default_factory=dict)
    dtype: torch.dtype = torch.bfloat16
    schedule: Any = None          # samplers.NoiseSchedule; None -> SD1.5's

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def noise_schedule(self):
        if self.schedule is None:
            self.schedule = make_schedule()
        return self.schedule

    def controlnet_cfgs(self, names) -> Tuple[C.ControlNetConfig, ...]:
        return tuple(self.controlnets[n][0] for n in names)

    def controlnet_modules(self, names):
        return [self.controlnets[n][1] for n in names]

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "ModelBundle":
        """Move every module to `device`, and cast it to `dtype` when one is
        given (in place); returns self."""
        for m in [self.unet, self.vae, self.text] + [
                net for _, net in self.controlnets.values()]:
            m.to(device=device, dtype=dtype)
        if dtype is not None:
            self.dtype = dtype
        return self


def _empty(cls, cfg, device, dtype) -> nn.Module:
    with torch.device("meta"):
        module = cls(cfg)
    return module.to_empty(device=device).to(dtype).eval()


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's random init: conv/linear weights uniform in
    +-1/sqrt(fan_in) with zero bias, norms at identity, token embeddings
    N(0, 0.02), position embeddings N(0, 0.01)."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-std, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (L.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            std = 0.01 if name.endswith("position_embedding") else 0.02
            m.weight.normal_(0.0, std, generator=generator)
    return module


FAMILIES = ("sd15", "sd15_inpaint", "sd21")


def _configs(tiny: bool, family: str):
    """(UNet, VAE, text, ControlNets' UNet) configs of a family: tiny at
    test widths, else the published ones. The inpainting UNet takes 9
    input channels; its ControlNets keep 4."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")
    sd21 = family == "sd21"
    if tiny:
        ucfg = C.UNetConfig(
            block_out_channels=(32, 64), layers_per_block=1,
            cross_attention_dim=48 if sd21 else 32,
            attention_head_dim=(2, 4) if sd21 else (2, 2),
            use_linear_projection=sd21,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            norm_num_groups=8)
        vcfg = C.VAEConfig(block_out_channels=(16, 32, 32, 32),
                           layers_per_block=1, norm_num_groups=8)
        tcfg = (C.CLIPTextConfig(vocab_size=2000, hidden_size=48,
                                 intermediate_size=192, num_layers=2,
                                 num_heads=4, max_position_embeddings=16,
                                 hidden_act="gelu") if sd21 else
                C.CLIPTextConfig(vocab_size=2000, hidden_size=32,
                                 intermediate_size=64, num_layers=2,
                                 num_heads=4, max_position_embeddings=8))
    else:
        ucfg = C.sd21_unet() if sd21 else C.sd15_unet()
        vcfg = C.VAEConfig()
        tcfg = C.openclip_vit_h() if sd21 else C.clip_vit_l()
    cn_ucfg = ucfg
    if family == "sd15_inpaint":
        ucfg = dataclasses.replace(ucfg, in_channels=9)
    return ucfg, vcfg, tcfg, cn_ucfg


def _target(device) -> torch.device:
    """The device to build on; a CUDA device must exist (no silent CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds on the GPU unless "
                           "the caller passes device='cpu'")
    return device


def random_bundle(*, tiny: bool = True, dtype=torch.float32, device="cuda",
                  generator: Optional[torch.Generator] = None,
                  family: str = "sd15",
                  controlnet_names=("sam", "inpaint")) -> ModelBundle:
    """Randomly initialised bundle with the named ControlNets (default "sam"
    and "inpaint"; "tile" for tile refinement), for smoke runs: tiny=True at test widths (SD1.5's those of the JAX package's
    ``random_bundle``, SD2.1's those of its tests/test_sd21.py), tiny=False
    at the published widths, with the tiny test tokenizer. `family`: "sd15",
    "sd15_inpaint" (the 9-channel inpainting UNet) or "sd21" (UNet, OpenCLIP
    ViT-H text tower and a v-prediction schedule on the bundle). Built on
    the GPU unless `device` says otherwise (raises when there is none).
    `generator` lives on `device` (default: seed 0 there). Unlike a fresh
    ControlNet, whose zero convs start at zero, every conv is drawn, so the
    ControlNet residuals reach the UNet. The ControlNets are drawn in the
    order named, after the UNet, VAE and text tower, so names appended to
    the default leave the weights of the first ones as they were."""
    device = _target(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    ucfg, vcfg, tcfg, cn_ucfg = _configs(tiny, family)
    unet = init_weights_(_empty(UNet2DConditionModel, ucfg, device, dtype),
                         generator)
    vae = init_weights_(_empty(AutoencoderKL, vcfg, device, dtype), generator)
    text = init_weights_(_empty(CLIPTextModel, tcfg, device, dtype), generator)
    cns = {}
    for name in controlnet_names:
        cn_cfg = C.ControlNetConfig(unet=cn_ucfg)
        cns[name] = (cn_cfg, init_weights_(
            _empty(ControlNetModel, cn_cfg, device, dtype), generator))
    schedule = (make_schedule(prediction_type="v_prediction")
                if family == "sd21" else None)
    return ModelBundle(unet_cfg=ucfg, vae_cfg=vcfg, text_cfg=tcfg, unet=unet,
                       vae=vae, text=text,
                       tokenizer=tiny_tokenizer(
                           context_length=tcfg.max_position_embeddings),
                       controlnets=cns, dtype=dtype, schedule=schedule)


def module_from_tree(cls, cfg, tree: Mapping) -> nn.Module:
    """Build `cls(cfg)` in fp32 on the CPU and load a JAX-package parameter
    tree into it (strict: every parameter present, nothing left over)."""
    module = _empty(cls, cfg, torch.device("cpu"), torch.float32)
    module.load_state_dict(state_dict_from_tree(tree), strict=True)
    return module


@torch.no_grad()
def random_sam(cfg: SAMConfig, *, device="cuda", dtype=torch.float32,
               generator: Optional[torch.Generator] = None) -> Sam:
    """A SAM with random weights, built on `device` (the GPU unless the
    caller asks otherwise; raises when there is none) in `dtype`, every
    parameter drawn nonzero from `generator` (on `device`; default: seed 0
    there): zero rel-pos tables or biases would hide gather-order and bias
    bugs (tests/test_sam_parity.py:39-43). Linear and conv weights are
    uniform in +-1/sqrt(fan_in) (a transposed conv's fan-in is its input
    channels), their biases uniform in the same range, norm scales
    1 + U(-0.1, 0.1) and shifts U(-0.1, 0.1), embeddings and the Fourier
    matrix N(0, 1), ``pos_embed`` N(0, 0.02) and the rel-pos tables
    N(0, 0.05)."""
    device = _target(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    sam = _empty(Sam, cfg, device, dtype)

    def uniform(t, bound):
        t.uniform_(-bound, bound, generator=generator)
    for m in sam.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            fan_in = (m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0].numel())
            uniform(m.weight, fan_in ** -0.5)
            if m.bias is not None:
                uniform(m.bias, fan_in ** -0.5)
        elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
            uniform(m.weight, 0.1)
            m.weight.add_(1.0)
            uniform(m.bias, 0.1)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
    enc = sam.image_encoder
    enc.pos_embed.normal_(0.0, 0.02, generator=generator)
    for blk in enc.blocks:
        blk.attn.rel_pos_h.normal_(0.0, 0.05, generator=generator)
        blk.attn.rel_pos_w.normal_(0.0, 0.05, generator=generator)
    sam.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.normal_(
        0.0, 1.0, generator=generator)
    return sam
