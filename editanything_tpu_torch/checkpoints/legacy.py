"""cldm YAML configs -> the port's typed configs.

Counterpart of ``editanything_tpu/checkpoints/legacy.py`` (:31-101): the
reference builds its training-side model from an OmegaConf YAML
(``create_model`` at cldm/model.py:24-28, config models/cldm_v21.yaml);
here its fields map onto models/config.py. The config is a path or the
already-parsed dict: ``yaml`` is imported only to read a path, so a caller
that passes the dict needs no ``yaml`` package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

from editanything_tpu_torch.models import config as C
from editanything_tpu_torch.samplers.schedule import make_schedule


def _get(d: Mapping, path: str, default=None):
    node = d
    for k in path.split("."):
        if not isinstance(node, Mapping) or k not in node:
            return default
        node = node[k]
    return node


def _read_yaml(path: str) -> Dict:
    """A YAML file -> dict; raises ImportError, naming the way round it,
    where the ``yaml`` package is missing."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs the yaml package, which is not installed; "
            "parse the config elsewhere and pass the dict instead") from e
    with open(path) as f:
        return yaml.safe_load(f)


def configs_from_cldm_yaml(config: Union[str, Mapping]) -> Dict:
    """cldm_v21.yaml-style config (a path or the parsed dict) ->
    {"unet": UNetConfig, "controlnet": ControlNetConfig, "vae": VAEConfig,
    "text": CLIPTextConfig, "schedule": NoiseSchedule, "sd_locked": bool,
    "control_scales": int}."""
    cfg = _read_yaml(config) if isinstance(config, str) else config
    mp = _get(cfg, "model.params", {})

    u = _get(mp, "unet_config.params", {})
    ch = u.get("model_channels", 320)
    mult = tuple(u.get("channel_mult", [1, 2, 4, 4]))
    block_out = tuple(ch * m for m in mult)
    context = u.get("context_dim", 1024)
    heads = u.get("num_heads")
    head_ch = u.get("num_head_channels")
    if head_ch:                      # SD2.x: fixed 64-wide heads
        attn_heads = tuple(c // head_ch for c in block_out)
    else:
        attn_heads = tuple([heads or 8] * len(block_out))
    n = len(block_out)
    unet = C.UNetConfig(
        in_channels=u.get("in_channels", 4),
        out_channels=u.get("out_channels", 4),
        block_out_channels=block_out,
        layers_per_block=u.get("num_res_blocks", 2),
        cross_attention_dim=context,
        attention_head_dim=attn_heads,
        use_linear_projection=u.get("use_linear_in_transformer", False),
        down_block_types=tuple(
            ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"]),
        up_block_types=tuple(
            ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * (n - 1)),
    )

    v = _get(mp, "first_stage_config.params.ddconfig", {})
    vae = C.VAEConfig(
        latent_channels=v.get("z_channels", 4),
        block_out_channels=tuple(
            v.get("ch", 128) * m for m in v.get("ch_mult", [1, 2, 4, 4])),
        layers_per_block=v.get("num_res_blocks", 2),
        scaling_factor=mp.get("scale_factor", 0.18215),
    )

    cond_target = _get(mp, "cond_stage_config.target", "") or ""
    if "OpenCLIP" in cond_target or context == 1024:
        text = C.openclip_vit_h()
    else:
        text = C.clip_vit_l()

    schedule = make_schedule(
        num_train_timesteps=mp.get("timesteps", 1000),
        beta_start=mp.get("linear_start", 0.00085),
        beta_end=mp.get("linear_end", 0.012),
        prediction_type=("v_prediction"
                         if mp.get("parameterization") == "v" else "epsilon"),
    )

    return {
        "unet": unet,
        "controlnet": C.ControlNetConfig(unet=unet),
        "vae": vae,
        "text": text,
        "schedule": schedule,
        "sd_locked": bool(mp.get("sd_locked", True)),
        "control_scales": 13,
    }
