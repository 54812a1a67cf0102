"""EditAnything on PyTorch and CUDA (NVIDIA Hopper).

The second implementation of the system beside the JAX package
``editanything_tpu``, which stays the reference. Module names follow that
package, so each module's counterpart has the same path:

    core/        primitives and the hand-written Hopper kernels
    csrc/        CUDA C++ sources of the kernels, built at first use
    models/      UNet, ControlNet, VAE, CLIP text tower, SAM, the safety
                 checker, BLIP-2 (nn.Modules named after the published ones
                 or the JAX package's trees)
    samplers/    noise schedule and UniPC
    text/        the CLIP and GPT-2 BPE tokenizers
    engine/      prompt embedding and the denoise loop
    pipelines/   the dual-ControlNet inpaint edit, the editor, the captioner
    checkpoints/ checkpoint files (.safetensors, torch, ldm/cldm), kohya
                 LoRA, textual inversion; JAX parameter trees -> state dicts
    utils/       host-side image helpers
    apps/        the semantic-label overlay (the port's one use of PIL)

Activations are NCHW with OIHW conv weights; the pipelines take and return
the JAX package's numpy HWC uint8 images. Nothing here imports jax.
"""

__version__ = "0.1.0"
