"""SD's VAE (``vae`` of a configuration's ``models``)."""


def reference(fields):
    from port_bench.reference import sd as RD
    return RD.VAE, RD.from_dict(RD.VAEConfig, fields)


def port(fields):
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models.vae import AutoencoderKL

    from port_bench.build import fields_of
    return AutoencoderKL, C.VAEConfig(**fields_of(C.VAEConfig, fields))
