"""CLIP's text encoder (``text`` of a configuration's ``models``)."""


def reference(fields):
    from port_bench.reference import sd as RD
    return RD.CLIPText, RD.from_dict(RD.CLIPTextConfig, fields)


def port(fields):
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models.clip_text import CLIPTextModel

    from port_bench.build import fields_of
    return CLIPTextModel, C.CLIPTextConfig(**fields_of(C.CLIPTextConfig,
                                                       fields))
