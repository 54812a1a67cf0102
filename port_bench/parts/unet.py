"""SD's UNet (``unet`` of a configuration's ``models``)."""


def reference(fields):
    from port_bench.reference import sd as RD
    return RD.UNet, RD.from_dict(RD.UNetConfig, fields)


def port(fields):
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models.unet import UNet2DConditionModel

    from port_bench.build import fields_of
    return UNet2DConditionModel, C.UNetConfig(**fields_of(C.UNetConfig,
                                                          fields))
