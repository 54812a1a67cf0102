"""A ControlNet (``controlnet`` of a configuration's ``models``): its own
fields and, under ``unet``, those of the UNet it copies."""


def reference(fields):
    from port_bench.reference import sd as RD
    return RD.ControlNet, RD.from_dict(RD.ControlNetConfig, fields)


def port(fields):
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models.controlnet import ControlNetModel

    from port_bench.build import fields_of
    rest = {k: v for k, v in fields.items() if k != "unet"}
    unet = C.UNetConfig(**fields_of(C.UNetConfig, fields["unet"]))
    return ControlNetModel, C.ControlNetConfig(
        unet=unet, **fields_of(C.ControlNetConfig, rest))
