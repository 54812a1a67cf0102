"""SAM (``sam`` of a configuration's ``models``): the image encoder,
prompt encoder and mask decoder."""


def reference(fields):
    from port_bench.reference import sam as RS
    from port_bench.reference import sd as RD
    return RS.Sam, RD.from_dict(RS.SAMConfig, fields)


def port(fields):
    from editanything_tpu_torch.models import sam as PS

    from port_bench.build import fields_of
    return PS.Sam, PS.SAMConfig(**fields_of(PS.SAMConfig, fields))
