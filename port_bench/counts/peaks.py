"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W limit): the yardstick of every
roofline share and MFU of this benchmark."""

BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores
TF32_FLOPS = 495e12          # TF32 tensor cores
# fp32 products kept at fp32 accuracy on the tensor cores take three TF32
# passes (3xTF32: hi*hi + hi*lo + lo*hi), kernel B's fp32 path
FP32_3XTF32_FLOPS = TF32_FLOPS / 3
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # 80 GB of HBM3


def model_peak(config: dict) -> float:
    """The peak that a configuration's MFU is taken against: bf16 or fp16
    on the tensor cores; fp32 at TF32 where the configuration allows TF32,
    else at fp32 accuracy on the tensor cores (3xTF32)."""
    if config["dtype"] in ("bfloat16", "float16"):
        return BF16_FLOPS
    return TF32_FLOPS if config.get("tf32", False) else FP32_3XTF32_FLOPS
