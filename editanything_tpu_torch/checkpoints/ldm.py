"""ldm/cldm-layout checkpoints (the reference's training-side weight format)
and the file-level surgery built on them.

Counterpart of ``editanything_tpu/checkpoints/ldm.py``, whose key maps are
copied here under the same names (the port imports nothing of that
package). An ldm/cldm state dict holds ``model.diffusion_model.*``,
``control_model.*``, ``first_stage_model.*`` and
``cond_stage_model.(model|transformer).*`` (cldm/model.py:12-28). Each
section maps to diffusers/HF key names as a pure string transform, and
those are the port's module names, so the result loads into the port's
modules as it is. Three maps also touch values: the VAE attention's 1x1
convs become linears and back (``_vae_attn``), and the open_clip text
tower's fused ``in_proj`` splits into q/k/v and merges back, its last
resblock dropped (the penultimate-layer semantics of
ldm/modules/encoders/modules.py:134-193). Values are torch tensors; the
maps that only rename keys take numpy arrays as well.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import torch

from editanything_tpu_torch.checkpoints.convert import (clip_text_state_dict,
                                                        load_torch_state_dict)

# ---------------------------------------------------------------------------
# UNet: model.diffusion_model.*  <->  diffusers UNet2DConditionModel keys
# ---------------------------------------------------------------------------

# ResBlock submodule renames (openaimodel.py:200-236 <-> diffusers resnets)
_RES_LDM2HF = {
    "in_layers.0": "norm1", "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2", "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}
_RES_HF2LDM = {v: k for k, v in _RES_LDM2HF.items()}


def _map_res(rest: str, table: Mapping[str, str]) -> str:
    for old, new in table.items():
        if rest.startswith(old + "."):
            return new + rest[len(old):]
    return rest


def _detect_layers_per_block(keys) -> Optional[int]:
    """Downsample ops sit at input_blocks indices (b+1)*(L+1); the smallest
    one pins L (openaimodel.py input_blocks construction)."""
    ds = [int(m.group(1)) for k in keys
          for m in [re.match(r"input_blocks\.(\d+)\.0\.op\.", k)] if m]
    return min(ds) - 1 if ds else None


def ldm_unet_to_diffusers(sd: Mapping, layers_per_block: int = 2) -> Dict:
    """ldm UNet keys (prefix already stripped) -> diffusers UNet keys."""
    L = _detect_layers_per_block(sd.keys()) or layers_per_block
    out: Dict = {}
    for k, v in sd.items():
        out_k = _ldm_unet_key(k, L)
        if out_k is not None:
            out[out_k] = v
    return out


def _ldm_unet_key(k: str, L: int) -> Optional[str]:
    if k.startswith("time_embed.0."):
        return "time_embedding.linear_1." + k.split(".", 2)[2]
    if k.startswith("time_embed.2."):
        return "time_embedding.linear_2." + k.split(".", 2)[2]
    if k.startswith("out.0."):
        return "conv_norm_out." + k.split(".", 2)[2]
    if k.startswith("out.2."):
        return "conv_out." + k.split(".", 2)[2]

    m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)$", k)
    if m:
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        if i == 0:
            return f"conv_in.{rest}" if j == 0 else None
        b, layer = (i - 1) // (L + 1), (i - 1) % (L + 1)
        if layer == L:          # Downsample (op -> conv)
            if not rest.startswith("op."):
                raise KeyError(f"unmapped ldm UNet key: {k}")
            return f"down_blocks.{b}.downsamplers.0.conv." + rest[3:]
        if j == 0:
            return (f"down_blocks.{b}.resnets.{layer}."
                    + _map_res(rest, _RES_LDM2HF))
        return f"down_blocks.{b}.attentions.{layer}.{rest}"

    m = re.match(r"middle_block\.(\d)\.(.*)$", k)
    if m:
        j, rest = int(m.group(1)), m.group(2)
        if j == 1:
            return f"mid_block.attentions.0.{rest}"
        return (f"mid_block.resnets.{0 if j == 0 else 1}."
                + _map_res(rest, _RES_LDM2HF))

    m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)$", k)
    if m:
        # up levels carry L+1 resnets each (openaimodel.py output_blocks:
        # range(num_res_blocks + 1)), the upsample riding the level's last
        i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        b, layer = i // (L + 1), i % (L + 1)
        if j == 0:
            return (f"up_blocks.{b}.resnets.{layer}."
                    + _map_res(rest, _RES_LDM2HF))
        if rest.startswith("conv."):   # Upsample (attention never has .conv)
            return f"up_blocks.{b}.upsamplers.0." + rest
        return f"up_blocks.{b}.attentions.{layer}.{rest}"
    return None   # non-module keys (none inside the diffusion section)


def diffusers_unet_to_ldm(sd: Mapping, layers_per_block: int = 2) -> Dict:
    """Inverse of ldm_unet_to_diffusers (for writing ldm checkpoints)."""
    L = layers_per_block
    out: Dict = {}
    for k, v in sd.items():
        out[_diffusers_unet_key_to_ldm(k, L)] = v
    return _fix_upsample_index(out)


def _diffusers_unet_key_to_ldm(k: str, L: int) -> str:
    if k.startswith("time_embedding.linear_1."):
        return "time_embed.0." + k.rsplit(".", 1)[1]
    if k.startswith("time_embedding.linear_2."):
        return "time_embed.2." + k.rsplit(".", 1)[1]
    if k.startswith("conv_in."):
        return "input_blocks.0.0." + k.split(".", 1)[1]
    if k.startswith("conv_norm_out."):
        return "out.0." + k.split(".", 1)[1]
    if k.startswith("conv_out."):
        return "out.2." + k.split(".", 1)[1]

    m = re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)$", k)
    if m:
        b, l, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return (f"input_blocks.{1 + b * (L + 1) + l}.0."
                + _map_res(rest, _RES_HF2LDM))
    m = re.match(r"down_blocks\.(\d+)\.attentions\.(\d+)\.(.*)$", k)
    if m:
        b, l, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return f"input_blocks.{1 + b * (L + 1) + l}.1.{rest}"
    m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)$", k)
    if m:
        b, rest = int(m.group(1)), m.group(2)
        return f"input_blocks.{(b + 1) * (L + 1)}.0.op.{rest}"

    m = re.match(r"mid_block\.resnets\.(\d)\.(.*)$", k)
    if m:
        j = 0 if m.group(1) == "0" else 2
        return f"middle_block.{j}." + _map_res(m.group(2), _RES_HF2LDM)
    m = re.match(r"mid_block\.attentions\.0\.(.*)$", k)
    if m:
        return f"middle_block.1.{m.group(1)}"

    m = re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)$", k)
    if m:
        b, l, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return (f"output_blocks.{b * (L + 1) + l}.0."
                + _map_res(rest, _RES_HF2LDM))
    m = re.match(r"up_blocks\.(\d+)\.attentions\.(\d+)\.(.*)$", k)
    if m:
        b, l, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        return f"output_blocks.{b * (L + 1) + l}.1.{rest}"
    m = re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)$", k)
    if m:
        b, rest = int(m.group(1)), m.group(2)
        # the upsample rides the LAST output block of level b; its module
        # index is 2 when that block carries an attention, else 1, resolved
        # once the whole section is mapped (_fix_upsample_index)
        return f"output_blocks.{b * (L + 1) + L}.__UP__.conv.{rest}"
    raise KeyError(f"unmapped diffusers UNet key: {k}")


def _fix_upsample_index(sd: Dict) -> Dict:
    """Resolve the __UP__ placeholder: index 2 when the same output block
    has an attention (module 1), else 1 (openaimodel.py output_blocks).
    Looks at sibling keys, so it takes a whole section."""
    out = {}
    for k, v in sd.items():
        if ".__UP__." in k:
            blk = k.split(".__UP__.")[0]
            has_attn = any(kk.startswith(blk + ".1.") for kk in sd)
            k = k.replace(".__UP__.", ".2." if has_attn else ".1.")
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# ControlNet: control_model.*  <->  diffusers ControlNetModel keys
# ---------------------------------------------------------------------------

# input_hint_block conv positions (cldm/cldm.py:147-163) <-> diffusers
# controlnet_cond_embedding {conv_in, blocks.0-5, conv_out}
_HINT_LDM2HF = {0: "conv_in", 2: "blocks.0", 4: "blocks.1", 6: "blocks.2",
                8: "blocks.3", 10: "blocks.4", 12: "blocks.5",
                14: "conv_out"}
_HINT_HF2LDM = {v: k for k, v in _HINT_LDM2HF.items()}


def ldm_controlnet_to_diffusers(sd: Mapping, layers_per_block: int = 2
                                ) -> Dict:
    """cldm ControlNet keys (control_model. stripped) -> diffusers keys."""
    L = _detect_layers_per_block(sd.keys()) or layers_per_block
    out: Dict = {}
    for k, v in sd.items():
        m = re.match(r"input_hint_block\.(\d+)\.(.*)$", k)
        if m:
            pos = _HINT_LDM2HF[int(m.group(1))]
            out[f"controlnet_cond_embedding.{pos}.{m.group(2)}"] = v
            continue
        m = re.match(r"zero_convs\.(\d+)\.0\.(.*)$", k)
        if m:
            out[f"controlnet_down_blocks.{m.group(1)}.{m.group(2)}"] = v
            continue
        m = re.match(r"middle_block_out\.0\.(.*)$", k)
        if m:
            out[f"controlnet_mid_block.{m.group(1)}"] = v
            continue
        if k.startswith("label_emb."):
            continue
        mapped = _ldm_unet_key(k, L)
        if mapped is not None:
            out[mapped] = v
    return out


def diffusers_controlnet_to_ldm(sd: Mapping, layers_per_block: int = 2
                                ) -> Dict:
    out: Dict = {}
    for k, v in sd.items():
        m = re.match(r"controlnet_cond_embedding\.(conv_in|conv_out"
                     r"|blocks\.\d)\.(.*)$", k)
        if m:
            out[f"input_hint_block.{_HINT_HF2LDM[m.group(1)]}.{m.group(2)}"] \
                = v
            continue
        m = re.match(r"controlnet_down_blocks\.(\d+)\.(.*)$", k)
        if m:
            out[f"zero_convs.{m.group(1)}.0.{m.group(2)}"] = v
            continue
        m = re.match(r"controlnet_mid_block\.(.*)$", k)
        if m:
            out[f"middle_block_out.0.{m.group(1)}"] = v
            continue
        out[_diffusers_unet_key_to_ldm(k, layers_per_block)] = v
    return _fix_upsample_index(out)


# ---------------------------------------------------------------------------
# VAE: first_stage_model.*  <->  diffusers AutoencoderKL keys
# ---------------------------------------------------------------------------

_VAE_RES_LDM2HF = {"nin_shortcut": "conv_shortcut"}
_VAE_RES_HF2LDM = {"conv_shortcut": "nin_shortcut"}
# ldm AttnBlock 1x1 convs (diffusionmodules/model.py:152-177) <-> diffusers
# linear attention; 4-D (C,C,1,1) weights squeeze to (C,C)
_VAE_ATTN_LDM2HF = {"norm": "group_norm", "q": "to_q", "k": "to_k",
                    "v": "to_v", "proj_out": "to_out.0"}
_VAE_ATTN_HF2LDM = {v: k for k, v in _VAE_ATTN_LDM2HF.items()}


def _vae_attn(rest: str, table, squeeze: bool, v):
    mod, leaf = rest.rsplit(".", 1)
    new = table.get(mod, mod)
    if leaf == "weight" and v.ndim == 4 and squeeze:
        v = v[:, :, 0, 0]
    elif leaf == "weight" and v.ndim == 2 and not squeeze:
        v = v[:, :, None, None]
    return f"{new}.{leaf}", v


def ldm_vae_to_diffusers(sd: Mapping) -> Dict:
    """first_stage_model keys (prefix stripped) -> diffusers VAE keys."""
    n_up = 1 + max([int(m.group(1)) for k in sd
                    for m in [re.match(r"decoder\.up\.(\d+)\.", k)] if m],
                   default=-1)
    out: Dict = {}
    for k, v in sd.items():
        if k.startswith("loss."):
            continue
        if k.startswith(("quant_conv.", "post_quant_conv.")):
            out[k] = v
            continue
        side, rest = k.split(".", 1)
        if side not in ("encoder", "decoder"):
            continue
        m = re.match(r"down\.(\d+)\.block\.(\d+)\.(.*)$", rest)
        if m:
            out[f"{side}.down_blocks.{m.group(1)}.resnets.{m.group(2)}."
                + _map_res(m.group(3), _VAE_RES_LDM2HF)] = v
            continue
        m = re.match(r"down\.(\d+)\.downsample\.conv\.(.*)$", rest)
        if m:
            out[f"{side}.down_blocks.{m.group(1)}.downsamplers.0.conv."
                + m.group(2)] = v
            continue
        m = re.match(r"up\.(\d+)\.block\.(\d+)\.(.*)$", rest)
        if m:
            b = n_up - 1 - int(m.group(1))   # ldm decoder stores up reversed
            out[f"{side}.up_blocks.{b}.resnets.{m.group(2)}."
                + _map_res(m.group(3), _VAE_RES_LDM2HF)] = v
            continue
        m = re.match(r"up\.(\d+)\.upsample\.conv\.(.*)$", rest)
        if m:
            b = n_up - 1 - int(m.group(1))
            out[f"{side}.up_blocks.{b}.upsamplers.0.conv.{m.group(2)}"] = v
            continue
        m = re.match(r"mid\.block_([12])\.(.*)$", rest)
        if m:
            out[f"{side}.mid_block.resnets.{int(m.group(1)) - 1}."
                + _map_res(m.group(2), _VAE_RES_LDM2HF)] = v
            continue
        m = re.match(r"mid\.attn_1\.(.*)$", rest)
        if m:
            nk, a = _vae_attn(m.group(1), _VAE_ATTN_LDM2HF, True, v)
            out[f"{side}.mid_block.attentions.0.{nk}"] = a
            continue
        if rest.startswith("norm_out."):
            out[f"{side}.conv_norm_out." + rest.split(".", 1)[1]] = v
            continue
        if rest.startswith(("conv_in.", "conv_out.")):
            out[k] = v
            continue
        raise KeyError(f"unmapped ldm VAE key: {k}")
    return out


def diffusers_vae_to_ldm(sd: Mapping) -> Dict:
    n_up = 1 + max([int(m.group(1)) for k in sd
                    for m in [re.match(r"decoder\.up_blocks\.(\d+)\.", k)]
                    if m], default=-1)
    out: Dict = {}
    for k, v in sd.items():
        if k.startswith(("quant_conv.", "post_quant_conv.")):
            out[k] = v
            continue
        side, rest = k.split(".", 1)
        m = re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.*)$", rest)
        if m:
            out[f"{side}.down.{m.group(1)}.block.{m.group(2)}."
                + _map_res(m.group(3), _VAE_RES_HF2LDM)] = v
            continue
        m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)$",
                     rest)
        if m:
            out[f"{side}.down.{m.group(1)}.downsample.conv.{m.group(2)}"] = v
            continue
        m = re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.(.*)$", rest)
        if m:
            b = n_up - 1 - int(m.group(1))
            out[f"{side}.up.{b}.block.{m.group(2)}."
                + _map_res(m.group(3), _VAE_RES_HF2LDM)] = v
            continue
        m = re.match(r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)$", rest)
        if m:
            b = n_up - 1 - int(m.group(1))
            out[f"{side}.up.{b}.upsample.conv.{m.group(2)}"] = v
            continue
        m = re.match(r"mid_block\.resnets\.([01])\.(.*)$", rest)
        if m:
            out[f"{side}.mid.block_{int(m.group(1)) + 1}."
                + _map_res(m.group(2), _VAE_RES_HF2LDM)] = v
            continue
        m = re.match(r"mid_block\.attentions\.0\.(.*)$", rest)
        if m:
            nk, a = _vae_attn(m.group(1), _VAE_ATTN_HF2LDM, False, v)
            out[f"{side}.mid.attn_1.{nk}"] = a
            continue
        if rest.startswith("conv_norm_out."):
            out[f"{side}.norm_out." + rest.split(".", 1)[1]] = v
            continue
        if rest.startswith(("conv_in.", "conv_out.")):
            out[k] = v
            continue
        raise KeyError(f"unmapped diffusers VAE key: {k}")
    return out


# ---------------------------------------------------------------------------
# Text towers
# ---------------------------------------------------------------------------

def openclip_text_to_hf(sd: Mapping, num_layers: int = 23) -> Dict:
    """open_clip text tower (cond_stage_model.model. stripped) -> HF
    CLIPTextModel keys without ``text_model.`` (the port's names).

    - resblocks >= num_layers are DROPPED: the reference reads the
      penultimate layer (modules.py:176-189), equivalently a 23-layer stack
      for OpenCLIP-H, which is what config.openclip_vit_h builds.
    - fused attn.in_proj_{weight,bias} split into q/k/v projections.
    """
    out: Dict = {}
    for k, v in sd.items():
        if k in ("text_projection", "logit_scale", "attn_mask",
                 "positional_embedding", "token_embedding.weight") \
                or k.startswith(("ln_final.",)):
            continue   # handled below / dropped
        m = re.match(r"transformer\.resblocks\.(\d+)\.(.*)$", k)
        if not m:
            continue
        i, rest = int(m.group(1)), m.group(2)
        if i >= num_layers:
            continue
        pre = f"encoder.layers.{i}"
        if rest.startswith("attn.in_proj_"):
            leaf = "weight" if rest.endswith("weight") else "bias"
            d = v.shape[0] // 3
            for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
                out[f"{pre}.self_attn.{name}.{leaf}"] = v[j * d:(j + 1) * d]
        elif rest.startswith("attn.out_proj."):
            out[f"{pre}.self_attn.out_proj." + rest.rsplit(".", 1)[1]] = v
        elif rest.startswith("ln_1."):
            out[f"{pre}.layer_norm1." + rest.split(".", 1)[1]] = v
        elif rest.startswith("ln_2."):
            out[f"{pre}.layer_norm2." + rest.split(".", 1)[1]] = v
        elif rest.startswith("mlp.c_fc."):
            out[f"{pre}.mlp.fc1." + rest.rsplit(".", 1)[1]] = v
        elif rest.startswith("mlp.c_proj."):
            out[f"{pre}.mlp.fc2." + rest.rsplit(".", 1)[1]] = v
        else:
            raise KeyError(f"unmapped open_clip key: {k}")
    if "token_embedding.weight" in sd:
        out["embeddings.token_embedding.weight"] = \
            sd["token_embedding.weight"]
    if "positional_embedding" in sd:
        out["embeddings.position_embedding.weight"] = \
            sd["positional_embedding"]
    for leaf in ("weight", "bias"):
        if f"ln_final.{leaf}" in sd:
            out[f"final_layer_norm.{leaf}"] = sd[f"ln_final.{leaf}"]
    return out


def hf_text_to_openclip(sd: Mapping) -> Dict:
    """Inverse (merging q/k/v back into in_proj). Layers beyond those
    present are NOT reconstructed: a tower written this way is the
    truncated penultimate stack."""
    out: Dict = {}
    fused: Dict[Tuple[int, str], dict] = {}
    for k, v in sd.items():
        k = k.replace("text_model.", "")
        if k == "embeddings.token_embedding.weight":
            out["token_embedding.weight"] = v
            continue
        if k == "embeddings.position_embedding.weight":
            out["positional_embedding"] = v
            continue
        m = re.match(r"final_layer_norm\.(\w+)$", k)
        if m:
            out[f"ln_final.{m.group(1)}"] = v
            continue
        m = re.match(r"encoder\.layers\.(\d+)\.(.*)$", k)
        if not m:
            continue
        i, rest = int(m.group(1)), m.group(2)
        pre = f"transformer.resblocks.{i}"
        m2 = re.match(r"self_attn\.([qkv])_proj\.(\w+)$", rest)
        if m2:
            fused.setdefault((i, m2.group(2)), {})[m2.group(1)] = v
            continue
        if rest.startswith("self_attn.out_proj."):
            out[f"{pre}.attn.out_proj." + rest.rsplit(".", 1)[1]] = v
        elif rest.startswith("layer_norm1."):
            out[f"{pre}.ln_1." + rest.split(".", 1)[1]] = v
        elif rest.startswith("layer_norm2."):
            out[f"{pre}.ln_2." + rest.split(".", 1)[1]] = v
        elif rest.startswith("mlp.fc1."):
            out[f"{pre}.mlp.c_fc." + rest.rsplit(".", 1)[1]] = v
        elif rest.startswith("mlp.fc2."):
            out[f"{pre}.mlp.c_proj." + rest.rsplit(".", 1)[1]] = v
    for (i, leaf), parts in fused.items():
        out[f"transformer.resblocks.{i}.attn.in_proj_{leaf}"] = \
            torch.cat([parts["q"], parts["k"], parts["v"]], dim=0)
    return out


# ---------------------------------------------------------------------------
# Whole-checkpoint ingestion
# ---------------------------------------------------------------------------

_PREFIXES = {
    "unet": "model.diffusion_model.",
    "controlnet": "control_model.",
    "vae": "first_stage_model.",
    "text_openclip": "cond_stage_model.model.",
    "text_hf": "cond_stage_model.transformer.",
}


def _section(sd: Mapping, prefix: str) -> Dict:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def _extract_ema_section(sd: Mapping) -> Dict:
    """EMA shadow of the diffusion UNet: LitEma buffers live under
    model_ema.* with DOTS REMOVED from the wrapped parameter name
    (ldm/modules/ema.py:5-30, name.replace('.',''))."""
    out = {}
    for k in sd:
        if not k.startswith("model.diffusion_model."):
            continue
        flat = k[len("model."):].replace(".", "")
        ek = "model_ema." + flat
        if ek in sd:
            out[k[len("model.diffusion_model."):]] = sd[ek]
    return out


def ldm_to_state_dicts(sd_or_path, *, device=None,
                       dtype: Optional[torch.dtype] = None,
                       layers_per_block: int = 2,
                       text_layers: Optional[int] = None,
                       extract_ema: bool = False) -> Dict:
    """One ldm/cldm checkpoint (a path, read through
    ``load_torch_state_dict`` onto `device` in `dtype`, or a state dict) ->
    {"unet", "controlnet", "vae", "text"}: the port's state dict of each
    section (None where absent), plus "text_layout" in {"openclip", "hf",
    None}. `text_layers` truncates the open_clip tower (default: all but
    the last, the penultimate semantics). The counterpart of the JAX
    package's ``ldm_to_tree``."""
    sd = (load_torch_state_dict(sd_or_path, device=device, dtype=dtype)
          if isinstance(sd_or_path, str) else dict(sd_or_path))
    out: Dict = {"unet": None, "controlnet": None, "vae": None,
                 "text": None, "text_layout": None}
    usec = (_extract_ema_section(sd) if extract_ema
            else _section(sd, _PREFIXES["unet"]))
    if usec:
        out["unet"] = ldm_unet_to_diffusers(usec, layers_per_block)
    csec = _section(sd, _PREFIXES["controlnet"])
    if csec:
        out["controlnet"] = ldm_controlnet_to_diffusers(csec,
                                                        layers_per_block)
    vsec = _section(sd, _PREFIXES["vae"])
    if vsec:
        out["vae"] = ldm_vae_to_diffusers(vsec)
    tsec = _section(sd, _PREFIXES["text_openclip"])
    if tsec:
        n_res = 1 + max(int(m.group(1)) for k in tsec
                        for m in [re.match(r"transformer\.resblocks\.(\d+)\.",
                                           k)] if m)
        nl = text_layers if text_layers is not None else n_res - 1
        out["text"] = openclip_text_to_hf(tsec, nl)
        out["text_layout"] = "openclip"
    else:
        tsec = _section(sd, _PREFIXES["text_hf"])
        if tsec:
            out["text"] = clip_text_state_dict(tsec)
            out["text_layout"] = "hf"
    return out


def state_dicts_to_ldm(*, unet: Mapping, vae: Mapping, text: Mapping,
                       controlnet: Optional[Mapping] = None,
                       text_layout: str = "hf",
                       layers_per_block: int = 2) -> Dict:
    """The port's state dicts -> one ldm/cldm checkpoint's state dict, the
    inverse of ``ldm_to_state_dicts``: the text tower under
    ``cond_stage_model.transformer.text_model.`` (SD1.x, "hf") or in
    open_clip's layout under ``cond_stage_model.model.`` ("openclip")."""
    out: Dict = {}
    for k, v in diffusers_unet_to_ldm(unet, layers_per_block).items():
        out[_PREFIXES["unet"] + k] = v
    if controlnet is not None:
        for k, v in diffusers_controlnet_to_ldm(controlnet,
                                                layers_per_block).items():
            out[_PREFIXES["controlnet"] + k] = v
    for k, v in diffusers_vae_to_ldm(vae).items():
        out[_PREFIXES["vae"] + k] = v
    if text_layout == "hf":
        for k, v in text.items():
            out[_PREFIXES["text_hf"] + "text_model." + k] = v
    elif text_layout == "openclip":
        for k, v in hf_text_to_openclip(text).items():
            out[_PREFIXES["text_openclip"] + k] = v
    else:
        raise ValueError(f"text_layout {text_layout!r}: 'hf' or 'openclip'")
    return out


def load_ldm_bundle(config, ckpt_path: str, *, tokenizer,
                    control_name: str = "sam",
                    dtype: torch.dtype = torch.bfloat16, device="cuda",
                    extract_ema: bool = False,
                    overrides: Optional[Dict] = None,
                    controlnet_paths: Optional[Mapping[str, str]] = None,
                    safety_path: Optional[str] = None, safety_cfg=None,
                    lora_specs=()):
    """cldm config + ldm/cldm checkpoint -> (ModelBundle, configs).

    Mirrors create_model(yaml) + load_state_dict(ckpt) (cldm/model.py:12-28).
    `config` is a YAML path or the parsed dict (``configs_from_cldm_yaml``);
    `overrides` replaces configs by name. The checkpoint must carry the
    unet, vae and text sections (each missing one raises); a control
    branch lands under `control_name`. `controlnet_paths`, `safety_path`
    and `lora_specs` are those of ``load_bundle``. Built on `device` (the
    GPU unless the caller asks otherwise) in `dtype`, each tensor converted
    as it is read."""
    from editanything_tpu_torch.checkpoints.legacy import \
        configs_from_cldm_yaml
    from editanything_tpu_torch.pipelines.bundle import (_target,
                                                         assemble_bundle)
    device = _target(device)
    cfgs = configs_from_cldm_yaml(config)
    cfgs.update(overrides or {})
    sds = ldm_to_state_dicts(ckpt_path, device=device, dtype=dtype,
                             extract_ema=extract_ema)
    for part in ("unet", "vae", "text"):
        if sds[part] is None:
            raise ValueError(f"checkpoint {ckpt_path} has no {part} section")
    controlnets = {}
    if sds["controlnet"] is not None:
        controlnets[control_name] = sds["controlnet"]
    for name, path in (controlnet_paths or {}).items():
        controlnets[name] = load_torch_state_dict(path, device=device,
                                                  dtype=dtype)
    bundle = assemble_bundle(
        unet_cfg=cfgs["unet"], vae_cfg=cfgs["vae"], text_cfg=cfgs["text"],
        controlnet_cfg=cfgs["controlnet"], unet=sds["unet"], vae=sds["vae"],
        text=sds["text"], controlnets=controlnets, tokenizer=tokenizer,
        dtype=dtype, device=device, safety_path=safety_path,
        safety_cfg=safety_cfg, lora_specs=lora_specs,
        schedule=cfgs["schedule"])
    return bundle, cfgs


# ---------------------------------------------------------------------------
# File-level surgery (the reference's tools/ scripts)
# ---------------------------------------------------------------------------

def add_control(sd: Mapping, *, seed: int = 0, hint_channels: int = 3
                ) -> Dict:
    """SD checkpoint -> cldm checkpoint with a grafted control branch
    (tool_add_control_sd{15,21}.py:27-50): every control_model key that
    exists as model.diffusion_model.* is COPIED from it; the new keys
    (input_hint_block, zero_convs, middle_block_out) come from a fresh
    ControlNet drawn on the CPU from `seed`: the zero convs and the hint
    stack's last conv zero, its other convs drawn, as a new ControlNet
    starts. The UNet configuration is read off the checkpoint's shapes."""
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models.controlnet import ControlNetModel
    from editanything_tpu_torch.pipelines.bundle import _empty, init_weights_

    usec = _section(sd, _PREFIXES["unet"])
    if not usec:
        raise ValueError("checkpoint has no model.diffusion_model section")
    L = _detect_layers_per_block(usec.keys()) or 2
    block_out, b = [], 0
    while f"input_blocks.{1 + b * (L + 1)}.0.out_layers.3.weight" in usec:
        block_out.append(
            usec[f"input_blocks.{1 + b * (L + 1)}.0.out_layers.3.weight"]
            .shape[0])
        b += 1
    ctx = None
    for k, v in usec.items():
        if k.endswith("attn2.to_k.weight"):
            ctx = v.shape[1]
            break
    n = len(block_out)
    ucfg = C.UNetConfig(
        in_channels=usec["input_blocks.0.0.weight"].shape[1],
        block_out_channels=tuple(block_out), layers_per_block=L,
        cross_attention_dim=ctx or 768,
        attention_head_dim=tuple(max(1, c // 64) for c in block_out),
        down_block_types=tuple(["CrossAttnDownBlock2D"] * (n - 1)
                               + ["DownBlock2D"]),
        up_block_types=tuple(["UpBlock2D"]
                             + ["CrossAttnUpBlock2D"] * (n - 1)))
    cn_cfg = C.ControlNetConfig(unet=ucfg,
                                conditioning_channels=hint_channels)
    fresh = init_weights_(
        _empty(ControlNetModel, cn_cfg, torch.device("cpu"), torch.float32),
        torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for conv in ([fresh.controlnet_cond_embedding.conv_out,
                      fresh.controlnet_mid_block]
                     + list(fresh.controlnet_down_blocks)):
            conv.weight.zero_()
            conv.bias.zero_()
    scratch_sd = diffusers_controlnet_to_ldm(fresh.state_dict(),
                                             layers_per_block=L)
    out = dict(sd)
    for k, v in scratch_sd.items():
        out["control_model." + k] = sd.get("model.diffusion_model." + k, v)
    return out


def transfer_control(base_sd: Mapping, base_with_control_sd: Mapping,
                     new_base_sd: Mapping) -> Dict:
    """Offset-transfer a trained control to another base model:
    new = control + (new_base - base) per key, first/cond stages taken from
    the new base (tool_transfer_control.py:35-58)."""
    out: Dict = {}
    for k, p in base_with_control_sd.items():
        if k.startswith(("first_stage_model", "cond_stage_model")):
            out[k] = new_base_sd[k]
            continue
        src = ("model.diffusion_" + k[len("control_"):]
               if k.startswith("control_") else k)
        if src in new_base_sd and src in base_sd:
            out[k] = (p.double() + new_base_sd[src].double()
                      - base_sd[src].double()).to(p.dtype)
        else:
            out[k] = p
    return out


def cldm_controlnet_to_diffusers_sd(sd_or_path, *, extract_ema: bool = False
                                    ) -> Dict:
    """Trained cldm checkpoint -> diffusers-layout ControlNet state dict
    (tools/convert_controlnet_to_diffusers.py:80-91's output), ready for
    ``safetensors_io.save_file``."""
    sd = (load_torch_state_dict(sd_or_path)
          if isinstance(sd_or_path, str) else dict(sd_or_path))
    csec = _section(sd, _PREFIXES["controlnet"])
    if not csec:
        raise ValueError("checkpoint has no control_model section")
    return ldm_controlnet_to_diffusers(csec)
