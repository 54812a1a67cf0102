"""ModelBundle: the configs and modules one edit needs, with named
ControlNets and an optional safety checker.

Counterpart of ``editanything_tpu/pipelines/bundle.py``. Modules are built
on the meta device and materialised once on their target device: drawn
there (``random_bundle``, ``random_sam``, ``random_blip2``,
``random_groundingdino``, ``random_vlpart``; every random draw takes
an explicit ``torch.Generator`` on that device), or filled from checkpoint
files with ``load_state_dict(..., assign=True)`` (``load_bundle``,
``load_sam``, ``load_blip2``, ``load_groundingdino``, ``load_vlpart``,
checkpoints/ldm.py's
``load_ldm_bundle``),
each tensor read
straight onto the device and cast there, so a full-width file is read once.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from editanything_tpu_torch.checkpoints.convert import (
    blip2_state_dict, clip_text_state_dict, dino_state_dict,
    load_torch_state_dict, safety_checker_state_dict, state_dict_from_tree,
    vlpart_state_dict)
from editanything_tpu_torch.core import layers as L
from editanything_tpu_torch.models import config as C
from editanything_tpu_torch.models.blip2 import BLIP2, BLIP2Config
from editanything_tpu_torch.models.clip_text import CLIPTextModel
from editanything_tpu_torch.models.controlnet import ControlNetModel
from editanything_tpu_torch.models.groundingdino import (DINOConfig,
                                                         GroundingDINO)
from editanything_tpu_torch.models.layout import lay_out_
from editanything_tpu_torch.models.safety import (CLIPVisionConfig,
                                                  SafetyChecker,
                                                  SafetyCheckerModel)
from editanything_tpu_torch.models.sam import LayerNorm2d, Sam, SAMConfig
from editanything_tpu_torch.models.unet import UNet2DConditionModel
from editanything_tpu_torch.models.vlpart import VLPart, VLPartConfig
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
    # models.safety.SafetyChecker; None (the reference's own operating
    # point, safety_checker=None at editany_lora.py:369-411) passes through
    safety: Any = None
    # (path, multiplier, {"merged", "skipped"}) of each LoRA merged at load
    lora_counts: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.lay_out()

    def lay_out(self) -> None:
        """Every conv weight of the UNet, the VAE and the ControlNets
        channels-last where it is half precision on the GPU, else NCHW, in
        its own storage (models/layout.py): done where the bundle is built
        and wherever it moves."""
        for m in [self.unet, self.vae] + [
                net for _, net in self.controlnets.values()]:
            lay_out_(m)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def noise_schedule(self):
        if self.schedule is None:
            self.schedule = make_schedule()
        return self.schedule

    def run_safety(self, images_uint8: np.ndarray):
        """uint8 images -> (images with the flagged ones blacked out, per-image
        flags); (images, None) when no checker is loaded
        (run_safety_checker, utils/stable_diffusion_controlnet.py:643-653)."""
        if self.safety is None:
            return images_uint8, None
        return self.safety(images_uint8)

    def controlnet_cfgs(self, names) -> Tuple[C.ControlNetConfig, ...]:
        return tuple(self.controlnets[n][0] for n in names)

    def controlnet_modules(self, names):
        return [self.controlnets[n][1] for n in names]

    @torch.no_grad()
    def swap_controlnet(self, name: str, state_dict: Mapping) -> None:
        """Load a ControlNet checkpoint of the same architecture into the
        named module in place (strict; cast to its device and dtype), so
        every pipeline holding the module runs the new weights: the
        reference rebuilds its pipeline instead (editany_lora.py:677-693)."""
        self.controlnets[name][1].load_state_dict(state_dict, strict=True)

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "ModelBundle":
        """Move every module to `device`, and cast it to `dtype` when one is
        given (in place); returns self."""
        for m in [self.unet, self.vae, self.text] + [
                net for _, net in self.controlnets.values()] + (
                [] if self.safety is None else [self.safety.model]):
            m.to(device=device, dtype=dtype)
        if dtype is not None:
            self.dtype = dtype
        self.lay_out()
        return self


def replicate_bundle(bundle: ModelBundle, group) -> ModelBundle:
    """Every model's weights broadcast from `group`'s first rank to all of
    its ranks, in place (nothing for one rank). Returns the bundle."""
    from editanything_tpu_torch.parallel.sharding import replicate
    for m in [bundle.unet, bundle.vae, bundle.text] + [
            net for _, net in bundle.controlnets.values()] + (
            [] if bundle.safety is None else [bundle.safety.model]):
        replicate(m, group)
    return bundle


def place_on_mesh(bundle: ModelBundle, mesh) -> ModelBundle:
    """The bundle replicated over every rank of `mesh` (JAX's
    ``place_on_mesh``): inference splits the samples over "data" and holds
    the weights whole on every rank. Returns the bundle."""
    import torch.distributed as dist
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span the default group")
    return replicate_bundle(bundle, dist.group.WORLD)


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


def module_from_state_dict(cls, cfg, state_dict: Mapping, *, device,
                          dtype: torch.dtype) -> nn.Module:
    """`cls(cfg)` built on the meta device and filled from `state_dict`
    (strict) by assignment, each floating tensor moved to `device` and cast
    to `dtype` first (a no-op for those already there)."""
    with torch.device("meta"):
        module = cls(cfg)
    sd = {k: v.to(device=device,
                  dtype=dtype if v.is_floating_point() else None)
          for k, v in state_dict.items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval()


def load_safety_checker(path: str, cfg: Optional[CLIPVisionConfig] = None,
                        *, device="cuda", dtype: torch.dtype = torch.bfloat16
                        ) -> SafetyChecker:
    """A StableDiffusionSafetyChecker file (HF layout) -> ``SafetyChecker``
    on `device` (the GPU unless the caller asks otherwise) in `dtype`."""
    device = _target(device)
    sd = safety_checker_state_dict(load_torch_state_dict(
        path, device=device, dtype=dtype))
    return SafetyChecker(module_from_state_dict(
        SafetyCheckerModel, cfg or CLIPVisionConfig(), sd, device=device,
        dtype=dtype))


def load_sam(path: str, cfg: SAMConfig, *, device="cuda",
             dtype: torch.dtype = torch.float32) -> Sam:
    """An official SAM checkpoint (``sam_vit_*.pth``, whose names are the
    port's) -> ``Sam`` on `device` (the GPU unless the caller asks
    otherwise) in `dtype`; the JAX package's apps/cli.py:66-71."""
    device = _target(device)
    return module_from_state_dict(
        Sam, cfg, load_torch_state_dict(path, device=device, dtype=dtype),
        device=device, dtype=dtype)


def load_blip2(path: str, cfg: BLIP2Config, *, device="cuda",
               dtype: torch.dtype = torch.bfloat16) -> BLIP2:
    """A BLIP-2 file, HF Blip2ForConditionalGeneration's layout or the
    port's (``checkpoints/convert.py::blip2_state_dict``), -> ``BLIP2`` on
    `device` (the GPU unless the caller asks otherwise) in `dtype`, every
    parameter present and nothing left over."""
    device = _target(device)
    sd = blip2_state_dict(load_torch_state_dict(path, device=device,
                                                dtype=dtype))
    return module_from_state_dict(BLIP2, cfg, sd, device=device, dtype=dtype)


@torch.no_grad()
def random_blip2(cfg: BLIP2Config, *, device="cuda", dtype=torch.float32,
                 seed: int = 0) -> BLIP2:
    """A BLIP-2 with random weights drawn on `device` (the GPU unless the
    caller asks otherwise) from a generator seeded with `seed` there, as
    the JAX package's ``init_blip2`` draws them: linear and conv weights
    uniform in +-1/sqrt(fan_in) with zero biases, norms at identity, the
    CLS token, position embeddings, queries and both OPT embeddings
    N(0, 0.02). At the published widths (3.74 B parameters) drawing on the
    card takes a fraction of a second where the host would take tens."""
    device = _target(device)
    generator = torch.Generator(device).manual_seed(seed)
    model = init_weights_(_empty(BLIP2, cfg, device, dtype), generator)
    for t in (model.vision_model.cls_token, model.vision_model.pos_embed,
              model.qformer.query_tokens):
        t.normal_(0.0, 0.02, generator=generator)
    return model


def load_groundingdino(path_or_state_dict, cfg: Optional[DINOConfig] = None,
                       *, device="cuda", dtype: torch.dtype = torch.bfloat16
                       ) -> GroundingDINO:
    """An official GroundingDINO file (``groundingdino_swint_ogc.pth``: its
    ``{"model": ...}`` is unwrapped) or state dict, in its layout or the
    port's (``checkpoints/convert.py::dino_state_dict``), -> ``GroundingDINO``
    (`cfg` default ``DINOConfig()``, SwinT-OGC) on `device` (the GPU unless
    the caller asks otherwise) in `dtype`, every parameter present and
    nothing left over."""
    device = _target(device)
    sd = path_or_state_dict
    if not isinstance(sd, Mapping):
        sd = load_torch_state_dict(sd, device=device, dtype=dtype)
    return module_from_state_dict(GroundingDINO, cfg or DINOConfig(),
                                  dino_state_dict(sd), device=device,
                                  dtype=dtype)


def _msdeform_grid_(m: nn.Module, heads: int, levels: int, points: int):
    """MSDeformAttn's published initial offsets: zero weights, each head's
    bias pointing its points 1..P steps out along one of `heads` directions
    round the circle."""
    theta = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid.view(heads, 1, 1, 2).repeat(1, levels, points, 1)
    grid *= torch.arange(1, points + 1, dtype=torch.float32).view(1, 1, -1, 1)
    m.sampling_offsets.weight.zero_()
    m.sampling_offsets.bias.copy_(grid.reshape(-1))
    m.attention_weights.weight.zero_()
    m.attention_weights.bias.zero_()


@torch.no_grad()
def random_groundingdino(cfg: DINOConfig, *, device="cuda",
                         dtype=torch.float32, seed: int = 0) -> GroundingDINO:
    """A GroundingDINO with random weights drawn on `device` (the GPU unless
    the caller asks otherwise) from a generator seeded with `seed` there, as
    the JAX package's ``init_dino`` draws them: linear and conv weights
    uniform in +-1/sqrt(fan_in) (q, k and v of a packed projection each its
    own) with zero biases, norms at identity, embeddings, the level
    embedding and the relative-position tables N(0, 0.02), the fusion
    gammas 1e-4, the box MLPs' last layers zero. The deformable attentions
    take MSDeformAttn's published initial offsets, so their samples spread
    round the reference as a fresh model's do."""
    device = _target(device)
    generator = torch.Generator(device).manual_seed(seed)
    model = init_weights_(_empty(GroundingDINO, cfg, device, dtype),
                          generator)
    for m in model.modules():
        if isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif hasattr(m, "in_proj_weight"):
            d = m.in_proj_weight.shape[1]
            m.in_proj_weight.uniform_(-d ** -0.5, d ** -0.5,
                                      generator=generator)
            m.in_proj_bias.zero_()
        elif hasattr(m, "relative_position_bias_table"):
            m.relative_position_bias_table.normal_(0.0, 0.02,
                                                   generator=generator)
        elif hasattr(m, "gamma_v"):
            m.gamma_v.fill_(1e-4)
            m.gamma_l.fill_(1e-4)
        elif hasattr(m, "sampling_offsets"):
            _msdeform_grid_(m, cfg.nheads, cfg.num_feature_levels,
                            cfg.n_points)
    tp = model.transformer
    tp.level_embed.normal_(0.0, 0.02, generator=generator)
    for mlp in (model.bbox_embed, tp.enc_out_bbox_embed):
        mlp.layers[-1].weight.zero_()
        mlp.layers[-1].bias.zero_()
    return model


def load_vlpart(path_or_state_dict, cfg: Optional[VLPartConfig] = None, *,
                device="cuda", dtype: torch.dtype = torch.bfloat16) -> VLPart:
    """VLPart's detectron2 file (``swinbase_part_0a0000.pth``) or state dict,
    in its layout or the port's (``checkpoints/convert.py::
    vlpart_state_dict``), -> ``VLPart`` (`cfg` default ``VLPartConfig()``,
    Swin-B) on `device` (the GPU unless the caller asks otherwise) in
    `dtype`, every parameter present and nothing left over."""
    device = _target(device)
    sd = path_or_state_dict
    if not isinstance(sd, Mapping):
        sd = load_torch_state_dict(sd, device=device, dtype=dtype)
    return module_from_state_dict(VLPart, cfg or VLPartConfig(),
                                  vlpart_state_dict(sd), device=device,
                                  dtype=dtype)


@torch.no_grad()
def random_vlpart(cfg: VLPartConfig, *, device="cuda", dtype=torch.float32,
                  seed: int = 0) -> VLPart:
    """A VLPart with random weights drawn on `device` (the GPU unless the
    caller asks otherwise) from a generator seeded with `seed` there, as
    the JAX package's ``init_vlpart`` draws them: ``init_weights_`` for the
    convs, linears, norms and the CLIP embeddings, the relative-position
    tables N(0, 0.02), the text projection N(0, 1/width)."""
    device = _target(device)
    generator = torch.Generator(device).manual_seed(seed)
    model = init_weights_(_empty(VLPart, cfg, device, dtype), generator)
    for m in model.modules():
        if hasattr(m, "relative_position_bias_table"):
            m.relative_position_bias_table.normal_(0.0, 0.02,
                                                   generator=generator)
    model.text_encoder.text_projection.normal_(
        0.0, cfg.text.hidden_size ** -0.5, generator=generator)
    return model


def _merge_lora_specs(unet: nn.Module, text: nn.Module, lora_specs) -> list:
    """Merge kohya LoRA files, each a path or (path, multiplier), in order;
    returns (path, multiplier, counts) of each and warns for a file that
    merged into no target, as the JAX package does."""
    from editanything_tpu_torch.checkpoints.lora import merge_kohya_lora
    done = []
    for spec in lora_specs:
        path, mult = spec if isinstance(spec, (tuple, list)) else (spec, 1.0)
        counts = merge_kohya_lora({"unet": unet, "text_encoder": text},
                                  load_torch_state_dict(path),
                                  multiplier=float(mult))
        if counts["merged"] == 0:
            warnings.warn(f"LoRA {path}: no targets merged "
                          f"(skipped {counts['skipped']})")
        done.append((path, float(mult), counts))
    return done


def assemble_bundle(*, unet_cfg: C.UNetConfig, vae_cfg: C.VAEConfig,
                    text_cfg: C.CLIPTextConfig,
                    controlnet_cfg: C.ControlNetConfig, unet: Mapping,
                    vae: Mapping, text: Mapping,
                    controlnets: Mapping[str, Mapping], tokenizer,
                    dtype: torch.dtype, device, safety_path=None,
                    safety_cfg=None, lora_specs=(), schedule=None
                    ) -> ModelBundle:
    """A bundle from the port's state dicts of each module, the LoRA files
    merged and the safety checker loaded."""
    def build(cls, cfg, sd):
        return module_from_state_dict(cls, cfg, sd, device=device,
                                      dtype=dtype)
    unet_m = build(UNet2DConditionModel, unet_cfg, unet)
    text_m = build(CLIPTextModel, text_cfg, text)
    lora_counts = _merge_lora_specs(unet_m, text_m, lora_specs)
    return ModelBundle(
        unet_cfg=unet_cfg, vae_cfg=vae_cfg, text_cfg=text_cfg, unet=unet_m,
        vae=build(AutoencoderKL, vae_cfg, vae), text=text_m,
        tokenizer=tokenizer,
        controlnets={name: (controlnet_cfg,
                            build(ControlNetModel, controlnet_cfg, sd))
                     for name, sd in controlnets.items()},
        dtype=dtype, schedule=schedule, lora_counts=lora_counts,
        safety=(None if not safety_path else load_safety_checker(
            safety_path, safety_cfg, device=device, dtype=dtype)))


def load_bundle(*, unet_path: str, vae_path: str, text_path: str, tokenizer,
                controlnet_paths: Mapping[str, str],
                unet_cfg: Optional[C.UNetConfig] = None,
                vae_cfg: Optional[C.VAEConfig] = None,
                text_cfg: Optional[C.CLIPTextConfig] = None,
                controlnet_cfg: Optional[C.ControlNetConfig] = None,
                safety_path: Optional[str] = None,
                safety_cfg: Optional[CLIPVisionConfig] = None,
                lora_specs=(), dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> ModelBundle:
    """A bundle from diffusers/HF-layout checkpoint files (UNet, VAE, CLIP
    text tower, named ControlNets; optional safety checker), the JAX
    package's ``load_bundle`` (:135-190). `lora_specs`: kohya LoRA files,
    each a path or (path, multiplier), merged into the UNet and text tower
    at load (editany_lora.py:197-329). Configs default to SD1.5's (the text
    tower's to OpenCLIP-H where the UNet's context is not 768). Built on
    `device` (the GPU unless the caller asks otherwise) in `dtype`."""
    device = _target(device)
    ucfg = unet_cfg or C.sd15_unet()
    tcfg = text_cfg or (C.clip_vit_l() if ucfg.cross_attention_dim == 768
                        else C.openclip_vit_h())

    def read(path):
        return load_torch_state_dict(path, device=device, dtype=dtype)
    return assemble_bundle(
        unet_cfg=ucfg, vae_cfg=vae_cfg or C.VAEConfig(), text_cfg=tcfg,
        controlnet_cfg=controlnet_cfg or C.ControlNetConfig(unet=ucfg),
        unet=read(unet_path), vae=read(vae_path),
        text=clip_text_state_dict(read(text_path)),
        controlnets={n: read(p) for n, p in controlnet_paths.items()},
        tokenizer=tokenizer, dtype=dtype, device=device,
        safety_path=safety_path, safety_cfg=safety_cfg,
        lora_specs=lora_specs)


def module_from_tree(cls, cfg, tree: Mapping) -> nn.Module:
    """Build `cls(cfg)` in fp32 on the CPU and load a JAX-package parameter
    tree into it (strict: every parameter present, nothing left over)."""
    module = _empty(cls, cfg, torch.device("cpu"), torch.float32)
    module.load_state_dict(state_dict_from_tree(tree), strict=True)
    return module


@torch.no_grad()
def random_safety_checker(cfg: CLIPVisionConfig, *, device="cuda",
                          dtype=torch.float32,
                          generator: Optional[torch.Generator] = None
                          ) -> SafetyChecker:
    """A safety checker with random weights on `device` (the GPU unless the
    caller asks otherwise), drawn as the JAX package's
    ``init_safety_checker``: the tower by ``init_weights_``, the class
    embedding N(0, 0.02), the concept and special-care embeddings N(0, 1),
    every threshold 0.2. `generator` lives on `device` (default: seed 0
    there)."""
    device = _target(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    model = init_weights_(_empty(SafetyCheckerModel, cfg, device, dtype),
                          generator)
    model.vision_model.embeddings.class_embedding.normal_(
        0.0, 0.02, generator=generator)
    model.concept_embeds.normal_(0.0, 1.0, generator=generator)
    model.special_care_embeds.normal_(0.0, 1.0, generator=generator)
    model.concept_embeds_weights.fill_(0.2)
    model.special_care_embeds_weights.fill_(0.2)
    return SafetyChecker(model)


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
