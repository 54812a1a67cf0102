#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (editanything_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA GPU

Phases, each printed on lines of its own; any failure raises and exits
non-zero, and nothing is caught:
  1. device: the card's name and power limit (nvidia-smi); builds every
     kernel from the checkout into build/ (one nvcc per CUDA source, all
     five started together) and prints the build times and what ptxas says
     of each CUDA kernel (registers, spills);
  2. kernels: each kernel against its plain PyTorch twin at the main path's
     shapes, in bf16 and fp32 (TF32 off), with the max error against a
     stated bound, the errors of planted faults that the bound must reject,
     and both times (CUDA events, after warm-up): flash attention at the
     UNet's, the VAE's and SAM's shapes (global and windowed encoder
     layers), SD2.1's (64-wide heads) and the reference read attention's
     (N queries over N + n keys, n the reference tokens inside
     ``ragged_ref_mask`` at each UNet level, no multiple of the key tile),
     the safety checker's ViT-L/14, BLIP-2's (the ViT-g/14's 16 heads of
     88 over 257 tokens, the Q-Former's 32 queries over themselves and over
     the 257 image tokens, at batch 1 and 10) and GroundingDINO's decoder
     (900 queries, 8 heads of 32), each also beside its bound
     (least time for the same work) and PyTorch's
     scaled_dot_product_attention at the same shape and scale, with the
     SDPA backend that ran named at the UNet's 64x64 self and the VAE's
     shapes, GroupNorm+SiLU at UNet and VAE shapes that take
     each of its launch plans (one CTA, a cluster, streamed through L2),
     each with its plan, blocks per SM, bound, host time per call and, where
     there is no SiLU, F.group_norm's time, SAM's two-way transformer at
     the AMG's (256 prompts, 6 tokens) and the click predictor's (1 prompt, 21 tokens)
     shapes, SAM's upscale + hypernetwork at the AMG's 256 prompts and the
     click's 1, with its blocks per SM, and the fused
     resnet block at five UNet and VAE shapes, with its plan, its GN2
     scale and shift against the twin's, its share of the bound, and timed
     against the composed block (cuDNN convs + the GroupNorm kernel) and
     the cuDNN convs alone (NCHW and channels-last); the high-resolution
     shapes of phase 4d: flash attention at 128x128 (UNet self and cross,
     the VAE's D = 512) and 288x288, launched at the full shape with
     HIRES_ROWS query rows held against the twin on those rows (planted
     faults there), beside its bound and SDPA; GroupNorm at 128x128 and
     the VAE decoder's 1024^2 slabs, and once at 2^31 elements (three
     slabs against the twin); the fused resnet block at 128x128;
  3. parity: the tiny edit of tests/test_torch_edit.py (with 64^2 inputs,
     which need no PIL to resize; 2 samples, 4 UniPC steps, CFG 9) with the
     same random weights and noise, in fp32 on the GPU (kernels) against
     fp32 on the CPU (plain twins), and in bf16 on the GPU against the fp32
     CPU edit, at most twice as far from it as the bf16 CPU edit; the same
     with every resnet fused (EA_RESNET_FUSED=1), and for a tiny txt2img
     with the switch on; three tiny edits of the rest of the edit surface in
     fp32, GPU against CPU, with the same initial and per-step noises: SD2.1
     with DDIM at eta 0.5 and "mix", SD1.5 with a scale map and guess mode,
     and the 9-channel "unet9" edit; a tiny reference-mode edit (the
     attention and AdaIN hooks and the FFT mix) in fp32 and bf16 as the
     tiny edit, and PLMS, DPM-Solver++ order 3, singlestep order 2 and UniPC
     with encoder_interval 2 in fp32, images within 1 level; the
     high-resolution surface in fp32 (tile refinement 64^2 -> 128^2
     through ``tile_refine`` and ``process(enable_tile=True)``, img2img, a
     sketch, txt2img and an edit whose VAE runs in 2 x 2 tiles), images
     within 2 levels; the tiny BLIP-2 captioner (image tokens, queries and
     logits within 1e-4, greedy tokens equal) and a tiny
     ``process(enable_auto_prompt=True)`` (prompts equal, images within 1
     level); then a small SAM with the published
     decoder widths (so the decoder kernels launch): a 4x4-point AMG with
     the quality filters open and one click;
  4. full width, edit only: SD1.5 UNet + three ControlNets (sam, inpaint
     and tile, drawn last; zero convs drawn
     nonzero) + VAE + CLIP-L at published widths, random weights from a
     seed, bf16: one denoise step (batch 4) with the resnets fused and
     composed, each against an fp32 composed step; one warm-up and timed
     512^2 edits with a supplied condition map at the reference UI's
     default point (2 samples, 30 UniPC steps, CFG 9), the switch off and
     on in turns; one txt2img request with the switch on;
  4b. full width, the rest of the edit surface, bf16, random weights from a
     seed: SD2.1 (UNet, two ControlNets, VAE, the 23-layer OpenCLIP-H text
     tower, v-prediction) with one denoise step (batch 4, t = 500) through
     kernel B and through its plain twin, each against the fp32 step, then a
     warm-up and requests through ``EditAnythingEditor.process`` with a
     supplied condition map (512^2, 2 samples, 30 steps, CFG 9), one of
     each: DDIM at eta 0.5 with the scale map and alpha mixing 0.5, and
     UniPC in guess mode with blend; the 9-channel SD1.5 inpainting UNet
     with a warm-up and one "unet9" request through ``EditPipeline``; each
     request with its
     seconds, peak memory, kernel B's and A's launches (from 0 just before
     it), non-finite values (0) and output shape;
  4c. the SD1.5 bundle of phase 4 through ``EditAnythingEditor.process``
     (supplied map, 512^2, 2 samples, 30 steps, CFG 9): reference-mode
     requests (attention + AdaIN, style fidelity 0.5, ref_scale 0.4, the
     ragged reference mask) in turns with edit-only ones, after a warm-up;
     PLMS, DPM-Solver++ and singlestep order 2 once each after a warm-up;
     UniPC at encoder_interval 1, 2, 3 and 5 in turns, with each k's
     images' PSNR against k = 1's; each request as in phase 4b, its kernel
     B launches equal to ``expected_flash_launches`` (the read attention on
     kernel B);
  4d. high resolution, the same bundle: the one-shot hint stack at 4096^2
     (peak memory); ``process(enable_tile=True)`` at the UI's defaults
     (512^2, 2 samples, 30 steps, CFG 9, refined to 1024^2), a warm-up and
     a timed request split into the edit and the tile pass's encode,
     denoise and decode; one request refined to 2304^2 (1 sample, 2
     steps: the VAE in 3 x 3 tiles); one img2img (strength 0.75, the SAM
     ControlNet) and one sketch (its scale map) at 512^2; each with its
     seconds, peak memory, kernel B launches equal to what its path
     predicts, kernel A's, and finite outputs of the expected shapes;
  4e. checkpoints, SD1.5 at published widths in bf16: phase 4's bundle
     ("sam" and "inpaint"), a second "sam" ControlNet, a safety checker
     (ViT-L/14 at 224^2, 17 + 3 concepts) and SAM ViT-H, all random from
     seeds, written into a temporary directory (removed after) as an LDM
     single file in fp16, diffusers/HF-layout ``.safetensors``, SAM's
     official ``.pth``, a rank-4 kohya LoRA over every attention and MLP
     target of the UNet and the text tower and a two-vector TI ``.bin``
     (bytes and free disk printed first); loaded through
     ``load_ldm_bundle`` (a dict config mirroring the public SD1.5
     v1-inference.yaml, the ControlNets, the checker, the LoRA at 0.5) and
     ``load_sam``, each step timed; every loaded tensor equal to the
     written value cast to bf16, the LoRA's counts, five targets' W' - W
     against 0.5 alpha / rank up @ down within bf16 rounding; then a
     warm-up and a timed ``process(condition_image=None)`` (512^2, 2
     samples, 30 steps, CFG 9) with ``condition_model`` the second
     ControlNet's file, the reference image with ``ref_textinv`` and the TI
     file, and its placeholder in the prompt: the swap in place, the TI
     rows, two safety flags, kernel B's launches equal to the request's
     prediction plus SAM's encoder and the checker's 24 layers, C and D
     launched;
  5. the main path: SAM ViT-H (random bf16 weights) and the same bundle in
     ``EditAnythingEditor``; one warm-up and three timed
     ``process(condition_image=None)`` requests (SAM at 1024^2, the AMG,
     the ID map, the 512^2 edit), each with its SAM-phase seconds, then one
     with every resnet fused; the SAM phase split once into encoder,
     decode batches, selection/NMS and ID map; one AMG with the filters
     open (every candidate valid, NMS at its worst) and one click; outputs
     must be finite (2, 512, 512, 3) uint8 and every kernel's launch
     counter must grow during the timed requests;
  4f. the captioner, run after phase 5 on its editor (SD1.5 bundle, SAM
     ViT-H): BLIP-2-OPT-2.7B at the published widths, random bf16 weights
     drawn on the card, a synthetic 50272-entry GPT-2 vocabulary; the
     vision tower and Q-Former in bf16 through kernel B and through its
     twin, each against fp32 (at most 2x as far as the twin); a warm-up
     and 3 timed 50-token captions of a 512^2 image, split once into
     encode, prefill and decode; ``semantic_labels`` over the top 10
     regions of the AMG with its filters and box NMS open (and
     ``semantic`` where PIL is installed); one
     ``process(enable_auto_prompt=True)`` and one
     ``process(ref_auto_prompt=True)``, each with its seconds, peak memory,
     kernel B's launches equal to its path's plus 57 per captioner call,
     and the caption in the returned prompt.
  4g. text-grounded edits, after phase 4f on the same editor: the tiny
     GroundingDINO and VLPart in fp32 on CUDA against the CPU; then
     GroundingDINO SwinT-OGC and VLPart Swin-B at the published widths,
     random bf16 weights drawn on the card, BERT's a synthetic
     30522-entry WordPiece vocabulary, VLPart's the bundle's CLIP
     tokenizer; each detects on a 512^2 and a 640 x 480 image (resized to
     800 on the short side) with every part synchronised and timed
     (GroundingDINO: host prepare, BERT, backbone, encoder, selection and
     decoder, host; VLPart: host prepare, text, backbone + FPN, RPN,
     cascade + NMS, host); GroundingDINO's decoder in bf16 through kernel
     B and through its twin against fp32 on the same inputs (at most 2x
     as far as the twin); ``prompt2mask`` at the reference UI's thresholds
     and with them open; one ``TextGuidedEditPipeline`` request per
     detector at the UI's defaults and one with GroundingDINO's
     thresholds open, each with its seconds, peak memory and launches of
     kernels B, D and C equal to the prediction (detection B 6 or 0, SAM's
     encoder 32 where a box passes, D and C one call a box, then
     ``process``'s 1834, 4 and 4).
  5t. training, last: ``train_staged_textinv`` for one step on the main
     path's bf16 editor; kernels B, A and E through their autograd Functions
     at UNet shapes in fp32 and bf16 (forward within the kernel's bound of
     the twin, gradients the twin's own, the backward being a recompute
     through it); B in fp32 at the training step's shapes (batch 2, no
     CFG), each beside its bound at 67 TFLOP/s and SDPA in fp32; one step
     of the tiny ControlNet in fp32 on the card against the CPU, with the
     resnets composed and fused (every ControlNet tensor's gradient nonzero
     on the card); ``train()`` at the published SD1.5 widths in fp32 with
     random weights (zero convs drawn) on an SA-1B-layout folder the phase
     writes (PNG targets, RLE JSONs): batch 2 at 512^2, remat "dots", EMA,
     3 steps with DDIM grids at step 2 (2 steps), a checkpoint, an export,
     then a resume to step 4; each iteration timed whole and in its parts
     (batch fetch, preprocessor, step), each step's B and A launches
     equal to the prediction (each attention and GroupNorm of the UNet and
     ControlNet twice: forward and recompute), the peak memory, finite
     losses, every ControlNet tensor changed and the UNet's checksum
     unchanged; then the editor on that bundle stages a reference crop,
     ``train_staged_textinv`` learns its 10 rows (3 steps, batch 1; only
     they change) and ``process(ref_textinv=True, ref_textinv_path=...)``
     runs on the learned file.
  6. DreamBooth, data parallelism and the apps, after 5t has freed its
     state: ``generate_class_images`` (the 9-channel SD1.5 inpaint UNet at
     published widths, bf16, random weights: 2 images of 512^2, 30 steps);
     the DreamBooth ``train()`` in fp32 (batch 1 instance + 1 class image
     at 512^2, AdamW): the full finetune for 3 steps and a resume, then
     LoRA of rank 4 for 3 steps, each iteration timed whole and in parts
     (batch, preprocessor, step) with the step's and the preprocessor's B
     and A launches equal to the prediction, the peak memory, and the
     frozen UNet bit-unchanged after LoRA; a one-rank nccl process group
     around one DreamBooth step and one ControlNet ``train()`` step, each
     equal to the step without the group to the bit (cuDNN deterministic);
     the command line in-process: ``edit`` with no mask from a spec of
     full-width files the phase writes (the SD1.5 bundle in fp16, two
     ControlNets, SAM ViT-H's fp32 ``.pth``), its B launches as predicted
     and D and C launched; ``train-dreambooth --bundle-spec`` on tiny
     files; ``add-control`` on a tiny written SD checkpoint.
The last two lines are the kernels' JSON summary and the result line.
Nothing here imports jax or the JAX package (editanything_tpu); the run
checks that no module of either was loaded.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

FLASH_SOURCE = "editanything_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "editanything_tpu/core/flash_attention.py:64"
GN_SOURCE = "editanything_tpu_torch/csrc/group_norm.cu"
GN_REPLACES = "editanything_tpu/core/kernels.py:37"
TWOWAY_SOURCE = "editanything_tpu_torch/csrc/sam_twoway.cu"
TWOWAY_REPLACES = "editanything_tpu/core/kernels.py:347"
UPSCALE_SOURCE = "editanything_tpu_torch/csrc/sam_upscale.cu"
UPSCALE_REPLACES = "editanything_tpu/core/kernels.py:209"
RESNET_SOURCE = "editanything_tpu_torch/csrc/resnet_fused.cu"
RESNET_REPLACES = "editanything_tpu/core/kernels.py:604"
CUDA_LIBRARIES = ("flash_attention", "group_norm", "sam_twoway", "sam_upscale",
                  "resnet_fused")
# the card's published peaks (H100 SXM data sheet, dense): bf16 tensor
# cores, fp32 outside them, device memory; a kernel's bound is the larger of
# its operations over the peak and its bytes (each input read once, each
# output written once) over the memory rate
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# (label, B, H, N, M, Dqk, Dv, scale): UNet/ControlNet attention at 512^2
# with 2 samples under CFG (B = 4), per resolution level; the VAE decoder's
# single-head mid attention (B = 2); SAM ViT-H's encoder at 1024^2 with the
# rel-pos bias folded into q/k (scale 1): a global layer and the 25 14x14
# windows of a windowed layer, whose 108 q/k columns the model pads to 112
# (16-byte rows), also unpadded for comparison (None: 1/sqrt(Dqk)); SD2.1's
# UNet and ControlNets at 512^2 with 2 samples under CFG: 64-wide heads, 5 /
# 10 / 20 / 20 per level, cross-attention over the 77 tokens of its context
ATTN_SHAPES = [
    ("unet 64x64 self", 4, 8, 4096, 4096, 40, 40, None),
    ("unet 64x64 cross", 4, 8, 4096, 77, 40, 40, None),
    ("unet 32x32 self", 4, 8, 1024, 1024, 80, 80, None),
    ("unet 32x32 cross", 4, 8, 1024, 77, 80, 80, None),
    ("unet 16x16 self", 4, 8, 256, 256, 160, 160, None),
    ("unet 16x16 cross", 4, 8, 256, 77, 160, 160, None),
    ("unet 8x8 self", 4, 8, 64, 64, 160, 160, None),
    ("unet 8x8 cross", 4, 8, 64, 77, 160, 160, None),
    ("vae mid 64x64", 2, 1, 4096, 4096, 512, 512, None),
    ("sam global 64x64", 1, 16, 4096, 4096, 208, 80, 1.0),
    ("sam window 14x14", 25, 16, 196, 196, 112, 80, 1.0),
    ("sam window 14x14 unpadded", 25, 16, 196, 196, 108, 80, 1.0),
    ("sd21 64x64 self", 4, 5, 4096, 4096, 64, 64, None),
    ("sd21 64x64 cross", 4, 5, 4096, 77, 64, 64, None),
    ("sd21 32x32 self", 4, 10, 1024, 1024, 64, 64, None),
    ("sd21 16x16 self", 4, 20, 256, 256, 64, 64, None),
    ("sd21 8x8 self", 4, 20, 64, 64, 64, 64, None),
    # the safety checker's ViT-L/14 at 224^2 over the 2 samples: 256
    # patches + CLS, a ragged last key tile (phase 4e)
    ("safety vit-l/14 224", 2, 16, 257, 257, 64, 64, None),
    # BLIP-2 (phase 4f): the EVA ViT-g/14 at 224^2, 16 heads of 88 (padded
    # to 96 in the kernel) over 257 tokens, and the Q-Former's 32 queries,
    # 12 heads of 64, over themselves and over the 257 image tokens; batch 1
    # for a caption, 10 for semantic's crops
    ("blip2 vit-g/14 224", 1, 16, 257, 257, 88, 88, None),
    ("blip2 vit-g/14 224, 10 crops", 10, 16, 257, 257, 88, 88, None),
    ("blip2 qformer self", 1, 12, 32, 32, 64, 64, None),
    ("blip2 qformer self, 10 crops", 10, 12, 32, 32, 64, 64, None),
    ("blip2 qformer cross", 1, 12, 32, 257, 64, 64, None),
    ("blip2 qformer cross, 10 crops", 10, 12, 32, 257, 64, 64, None),
    # GroundingDINO (phase 4g): the decoder's query self-attention, 900
    # queries, 8 heads of 32, unmasked, 6 a detection
    ("groundingdino decoder self", 1, 8, 900, 900, 32, 32, None),
]
# kernel B at the high-resolution path's shapes (phase 4d), bf16 only (the
# path's dtype): tile refinement at 1024^2, 2 samples under CFG (the UNet's
# and the tile ControlNet's 128x128 level; the one-shot VAE decode's mid
# attention at batch 2, as each 1024^2 tile of a tiled one at batch 1) and
# at 2304^2, 1 sample (the 288x288 level). Their fp32 logits do not fit the
# plain twin (34 GB at 128x128 self; 82944^2 not at all), so the kernel
# runs at the full shape and HIRES_ROWS of its query rows, the first and the
# last half, are held against the twin run on those rows alone: rows are
# independent in attention, so the slice is the same function
HIRES_ATTN_SHAPES = [
    ("unet 128x128 self", 4, 8, 16384, 16384, 40, 40, None),
    ("unet 128x128 cross", 4, 8, 16384, 77, 40, 40, None),
    ("vae mid 128x128", 2, 1, 16384, 16384, 512, 512, None),
    ("unet 288x288 self", 2, 8, 82944, 82944, 40, 40, None),
]
HIRES_ROWS = 512
# phase 4d: the one-shot ControlNet hint stack at 4096^2 (2 samples); the
# edit's side, the UI's default refine side and one above the one-shot
# VAE bound (3 x 3 tiles of 1024^2 each way)
HINT_STACK_SHAPE = (2, 3, 4096, 4096)
HIRES_SIDES = (512, 1024, 2304)
HIRES_BIG_VAE_TILES = 9
# (label, NCHW shape, eps, SiLU): in bf16 one CTA per slab at most UNet
# shapes, clusters of 2 (UNet 64x64x960), 8 and 16 CTAs (the VAE) holding
# their shares on chip, and the VAE decoder's 4 MB slabs held in part and
# streamed through L2 (core/kernels.py::group_norm_plan)
GN_SHAPES = [
    ("unet resnet 64x64x320", (4, 320, 64, 64), 1e-5, True),
    ("unet resnet 64x64x960", (4, 960, 64, 64), 1e-5, True),
    ("unet resnet 32x32x1920", (4, 1920, 32, 32), 1e-5, True),
    ("unet resnet 8x8x1280", (4, 1280, 8, 8), 1e-5, True),
    ("unet resnet 8x8x2560", (4, 2560, 8, 8), 1e-5, True),
    ("transformer norm 64x64x320", (4, 320, 64, 64), 1e-6, False),
    ("transformer norm 8x8x1280", (4, 1280, 8, 8), 1e-6, False),
    ("vae decoder 128x128x512", (2, 512, 128, 128), 1e-6, True),
    ("vae decoder 512x512x128", (2, 128, 512, 512), 1e-6, True),
    ("vae encoder 512x512x128", (1, 128, 512, 512), 1e-6, True),
    ("vae decoder 512x512x256", (2, 256, 512, 512), 1e-6, True),
    # tile refinement at 1024^2 (phase 4d): the UNet's 128x128 level and the
    # VAE decoder's 16 and 8 MB slabs, streamed several times over
    ("unet resnet 128x128x320", (4, 320, 128, 128), 1e-5, True),
    ("vae decoder 1024x1024x256", (2, 256, 1024, 1024), 1e-6, True),
    ("vae decoder 1024x1024x128", (2, 128, 1024, 1024), 1e-6, True),
]
# a one-shot 2048^2 decode of 2 samples: its 256-channel activation holds
# 2^31 elements, and image 1 starts 2^31 bytes in (kernel A's slab bases
# are 64-bit, its offsets inside a slab 32-bit)
GN_OFFSET_SHAPE = (2, 256, 2048, 2048)
# bounds on the max abs error against the plain twin, with their reasons:
#  attention fp32 1e-4: exact fp32 products, sums and exp in other orders;
#  attention bf16 2^-6 * max|twin's output|: both sides hold fp32 sums and
#    round the output to bf16 once, so they differ by an ulp of the output
#    (two at most, from P rounded to bf16 unnormalised in the kernel and
#    normalised in the twin); two ulps of the largest output are at most
#    2^-6 of it. At 64x64 self-attention that is ~2e-3 on outputs <~0.14;
#  GroupNorm fp32 1e-4: fp32 statistics summed in other orders;
#  GroupNorm bf16 6.25e-2: one bf16 ulp at outputs below 16.
# Each bound must also reject planted faults, computed with the plain twin
# at the same shape (see attention_faults, group_norm_faults).
ATTN_F32_BOUND = 1e-4
ATTN_BF16_REL_BOUND = 2.0 ** -6
GN_BOUNDS = {torch.float32: 1e-4, torch.bfloat16: 6.25e-2}
# the shapes at which phase 2 names the SDPA backend that ran
SDPA_BACKEND_SHAPES = ("unet 64x64 self", "vae mid 64x64")
# phase 4f: new tokens per caption (the reference's auto prompt,
# editany_lora.py:512-520), timed captions after a warm-up, and the regions
# semantic labels (sam2semantic.py's top 10)
CAPTION_NEW_TOKENS = 50
CAPTION_REQUESTS = 3
SEMANTIC_TOP_K = 10
# phase 4g: the captions and vocabularies of the text-grounded edits, the
# images detected (a square one and a non-square one, each resized to 800
# on the short side), and the reference UI's thresholds (GroundingDINO 0.25
# with its top 2 boxes, sam2groundingdino_edit.py:130; VLPart 0.7,
# sam2vlpart_edit.py:119-178)
DINO_CAPTION = "dog head. sofa"
VLPART_VOCABULARY = "dog head.dog nose"
GROUNDING_IMAGES = ((512, 512), (480, 640))
DINO_UI = dict(score_thresh=0.25, max_boxes=2)
VLPART_UI = dict(score_thresh=0.7)
# the same flows with every threshold open, so that boxes reach SAM
GROUNDING_OPEN = dict(score_thresh=0.0, union_score_thresh=0.0, max_boxes=2)
# tiny detectors in fp32, CUDA (kernel B, the GPU's sums) against the CPU
# (plain twins): logits, scores and normalised boxes of magnitude ~0.1-10,
# fp32 sums in other orders (TF32 off); boxes in pixels of a 64-96 px image
TINY_DETECT_TOL = 1e-4
TINY_DETECT_BOX_PX_TOL = 1e-2
HEADLINE = {"flash_attention": "unet 64x64 self",
            "group_norm_silu": "vae decoder 512x512x256",
            "sam_twoway": "amg batch", "sam_upscale_hyper": "amg batch",
            "resnet_fused": "unet 64x64 320->320"}
# SAM decoder kernels: (label, prompts, tokens) for the two-way transformer
# (the AMG's batch of 256 grid points with 5 + 1 tokens; the click
# predictor's 1 prompt with 5 + 16 tokens) and prompts for the upscale
TWOWAY_SHAPES = [("amg batch", 256, 6), ("click", 1, 21)]
UPSCALE_SHAPES = [("amg batch", 256), ("click", 1)]
# bounds of the SAM decoder kernels against their twins:
#  fp32 1e-4: exact fp32 products summed in other orders (outputs ~1-10);
#  two-way bf16, both of: max abs error 2^-5 * max|twin's output| (4-8 bf16
#    ulps of the largest output) and relative RMS error (||got - want|| /
#    ||want||, the larger over the two outputs) 5e-3. Both sides round the
#    same intermediates to bf16 at the same points (projections,
#    probabilities, per 64-row tile for token->image attention, keys between
#    layers), so they differ where a sum taken in another order (the tensor
#    cores' accumulation) flips a rounding: single ulps, spread thin. The
#    RMS bound is what rejects the logits x1.05 fault, whose largest change
#    is about one ulp of the largest output. The decoder's attention q/k
#    projections are drawn at twice the default range (SHARPEN): at the
#    default, attention over 4096 random keys is so flat that x1.05 moves
#    the outputs less than bf16 itself does (relative RMS 2.9e-3 against
#    6.5e-3 for bf16 against fp32, CPU twin); at 2x, 1.5e-2 against 7.4e-3;
#  upscale bf16 2^-6 * max|twin's output|: one rounding of y and z each and
#    of the output, as the twin; two ulps of the largest output.
SAM_F32_BOUND = 1e-4
TWOWAY_BF16_REL_BOUND = 2.0 ** -5
TWOWAY_BF16_RMS_BOUND = 5e-3
SHARPEN = 2.0
UPSCALE_BF16_REL_BOUND = 2.0 ** -6
# a small SAM with the published decoder widths, so that the decoder
# kernels launch: 128^2 input, 8x8 embedding, a 2-block 64-wide encoder
SMALL_SAM = dict(img_size=128, patch_size=16, embed_dim=64, depth=2,
                 num_heads=2, global_attn_indexes=(1,), window_size=4)
# its fp32 parity bound, CUDA (kernels) vs CPU (twins), on candidate logits
# and IoUs of magnitude ~1-10: fp32 through the encoder and decoder summed
# in other orders (TF32 off)
SMALL_SAM_F32_TOL = 1e-3
# tiny fp32 CUDA-vs-CPU edit: the bounds of the JAX-vs-port test
# (test_torch_edit)
TINY_LATENT_TOL = 1e-3
TINY_IMAGE_LEVELS = 2
# tiny bf16 edit on CUDA (kernels) against the fp32 CPU edit: at most twice
# as far as the same bf16 edit on the CPU (plain twins) lies from it. bf16
# rounding alone moves the tiny edit's latents by ~1 and its images by ~12
# levels, so the bound is stated against that distance, measured in the run.
TINY_BF16_RATIO = 2
# the rest of the edit surface at tiny widths, held as the tiny edit is in
# fp32: (family of random_bundle, inpaint mode, EditPipeline arguments)
TINY_MODE_CASES = {
    "sd21 ddim eta 0.5, mix": ("sd21", "mix", dict(sampler="ddim", eta=0.5,
                                                   alpha_weight=0.5,
                                                   alignment_ratio=0.75)),
    "sd15 scale map, guess mode": ("sd15", "blend", dict(
        scale_map=np.linspace(0.0, 1.0, 64 * 64, dtype=np.float32)
        .reshape(64, 64), guess_mode=True, alignment_ratio=0.75)),
    "sd15 unet9": ("sd15_inpaint", "unet9", {}),
}


def ragged_ref_mask(size: int) -> np.ndarray:
    """uint8 (size, size) reference region: an ellipse with a notch cut out.
    At 512^2 it leaves 1189 / 301 / 77 / 21 reference tokens at the UNet's
    64 / 32 / 16 / 8 levels, none a multiple of kernel B's key tile."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    m = ((yy - 0.45) ** 2 / 0.3 ** 2 + (xx - 0.52) ** 2 / 0.36 ** 2) <= 1.0
    m &= ~((yy > 0.5) & (xx > 0.6))
    return (m * 255).astype(np.uint8)


def _tiny_reference() -> dict:
    """The reference arguments of the golden ``refctrl`` case (attention,
    AdaIN and the FFT mix; tests/test_golden_regression.py) at 64^2."""
    return dict(ref_image=_checker_image(64, 64)[:, ::-1],
                ref_mask=ragged_ref_mask(64), ref_prompt="a blue cat",
                reference_attn=True, reference_adain=True,
                style_fidelity=0.5, ref_scale=0.4)


# the denoise surface of reference-only control, PLMS, DPM-Solver and
# encoder caching at tiny widths, fp32 GPU against CPU (SD1.5, blend, 5
# steps: PLMS reaches its 4th order, DPM++ its 3rd, singlestep order 2
# runs blocks [2, 2, 1]); images within 1 level
# (the reference edit runs in tiny_parity, which also holds its bf16 run)
TINY_DENOISE_CASES = {
    "sd15 plms": ("sd15", "blend", dict(sampler="plms", alignment_ratio=0.75)),
    "sd15 dpm3": ("sd15", "blend", dict(sampler="dpm3", alignment_ratio=0.75)),
    "sd15 dpms2": ("sd15", "blend", dict(sampler="dpms2",
                                         alignment_ratio=0.75)),
    "sd15 unipc encoder_interval 2": ("sd15", "blend", dict(
        encoder_interval=2, alignment_ratio=0.75)),
}
TINY_DENOISE_STEPS = 5
TINY_DENOISE_IMAGE_LEVELS = 1
# the tiny captioner (models/blip2.py's tiny_blip2_config) in fp32, CUDA
# (kernels) vs CPU (plain twins): image tokens, queries and logits of
# magnitude ~1-5, fp32 sums in other orders (TF32 off); tokens equal
TINY_CAPTION_TOL = 1e-4
TINY_CAPTION_TOKENS = 6
# the fused resnet block: (label, N, Cin, Cout, time embedding, H = W, eps)
# at 512^2 with 2 samples under CFG (UNet batch 4) and the VAE at batch 2
RESNET_SHAPES = [
    ("unet 64x64 320->320", 4, 320, 320, True, 64, 1e-5),
    ("unet 64x64 640->320", 4, 640, 320, True, 64, 1e-5),
    ("unet 8x8 2560->1280", 4, 2560, 1280, True, 8, 1e-5),
    ("vae 512x512 128->128", 2, 128, 128, False, 512, 1e-6),
    ("vae 512x512 256->128", 2, 256, 128, False, 512, 1e-6),
    ("unet 128x128 320->320", 4, 320, 320, True, 128, 1e-5),
]
# its bounds against the twin: fp32 1e-4 (exact fp32 products summed in
# other orders; outputs ~10); bf16 both of: max abs error 2^-6 x max|twin's
# output| (two ulps of the largest output: both sides round xn, hn and the
# output at the same points, so they differ by single ulps where a sum taken
# in another order flips a rounding) and relative RMS error 2e-3, which
# rejects faults whose largest change is near one ulp
RESNET_F32_BOUND = 1e-4
RESNET_BF16_REL_BOUND = 2.0 ** -6
RESNET_BF16_RMS_BOUND = 2e-3
# GN2's per-channel scale and shift, read from kernel E's scratch, against
# the twin's direct statistics of its own h, in both dtypes: max abs error
# at most 1e-5 x max|twin's scale or shift|. Both are fp32 statistics of the
# same h (the convs' fp32 sums in other orders, a rare ulp of xn flipped by
# GN1's statistics): on the CPU the tiled and direct routes differ by
# 2e-7-6e-7 of it at these shapes. This bound is what rejects the
# "gn2_tile_dropped" fault where one tile is a small share of an image (a
# 128-pixel tile of a 64x64 image moves the output less than bf16 does;
# on the CPU the affine moves by 8e-5-2e-3 of its largest value)
RESNET_GN2_STATS_BOUND = 1e-5
# one full-width denoise step in bf16 with the resnets fused may lie at most
# this many times as far from the fp32 composed step as the bf16 composed
# step does
STEP_RATIO = 2
FULL_WIDTH_REQUESTS = 2     # edit-only requests per switch setting (phase 4)
MAIN_PATH_REQUESTS = 3      # SAM + edit requests (phase 5)
FUSED_MAIN_PATH_REQUESTS = 1   # the same with every resnet fused (phase 5)
MODE_REQUESTS = 1           # timed requests of each case of phase 4b
REF_REQUESTS = 2            # of each case of phase 4c run in turns
ENCODER_INTERVALS = (1, 2, 3, 5)    # UniPC's encoder caching in phase 4c


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def rel_rms(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def attention_bound(dtype, want) -> float:
    if dtype == torch.bfloat16:
        return ATTN_BF16_REL_BOUND * want.float().abs().max().item()
    return ATTN_F32_BOUND


def key_tile(dqk: int, dv: int) -> int:
    """Keys per tile of csrc/flash_attention.cu's bf16 kernels at these
    depths (dispatch_bf16, by_depth): 32 in the wide kernel (Dv > 160) and
    where Dv <= 128 meets Dqk > 128, else 64."""
    def pad(d):
        return -(-d // 16) * 16
    return 32 if pad(dv) > 160 or (pad(dv) <= 128 and pad(dqk) > 128) else 64


def reference_read_shapes():
    """ATTN_SHAPES-style entries of the reference read attention at 512^2
    with 2 samples under CFG: each hooked block's queries attend over its
    own tokens and the n reference tokens inside ``ragged_ref_mask(512)`` at
    that level (64x64, 32x32, 16x16 and the 8x8 mid block), n counted by the
    port's own ``RefMasks`` from the mask as the edit pipeline makes it."""
    from editanything_tpu_torch.engine.refctrl import RefMasks
    from editanything_tpu_torch.utils.image import resize_nearest
    m = torch.from_numpy(ragged_ref_mask(512).astype(np.float32) / 255.0)
    lat = (resize_nearest(m[None, None], (64, 64)) >= 0.5).float()
    masks = RefMasks(lat, lat)
    shapes = []
    for side, d in ((64, 40), (32, 80), (16, 160), (8, 160)):
        n = int(masks.valid_tokens(side, side).numel())
        check(0 < n and n % key_tile(d, d),
              f"reference mask leaves {n} tokens at {side}x{side}")
        shapes.append((f"ref read {side}x{side} (+{n} reference keys)", 4, 8,
                       side * side, side * side + n, d, d, None))
    return shapes


def attention_faults(q, k, v, want, scale) -> dict:
    """Max errors against `want` of two planted faults, made with the plain
    twin: the last key tile dropped (the last half of the keys when one tile
    holds them all; at M = 77 that is the ragged tail) and the logits
    scaled by 1.05."""
    from editanything_tpu_torch.core.flash_attention import \
        flash_attention_reference as plain
    m, tile = k.shape[2], key_tile(q.shape[-1], v.shape[-1])
    keep = (m - 1) // tile * tile if m > tile else m // 2
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return {"last key tile dropped": max_err(
                plain(q, k[:, :, :keep], v[:, :, :keep], scale=scale), want),
            "logits x1.05": max_err(plain(q, k, v, scale=1.05 * scale), want)}


def sdpa_call(q, k, v, scale):
    """PyTorch's fused attention at the kernel's scale: the yardstick of
    kernel B (``library_ms``), timed here and called nowhere in the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=scale)


def print_sdpa_backends(q, k, v, scale, reps: int) -> None:
    """Which SDPA backend runs by default at this shape (the device kernels
    torch.profiler records for one call), and each backend's time where it
    takes the shape (under ``sdpa_kernel``; a backend that refuses the
    shape raises RuntimeError, recorded as "refuses")."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    sdpa_call(q, k, v, scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa_call(q, k, v, scale)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    print(f"[kernel]   SDPA's default ran: {names or 'no device events traced'}")
    times = []
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]):
                ms = cuda_ms(lambda: sdpa_call(q, k, v, scale), reps)
            times.append(f"{name} {ms:.4f} ms")
        except RuntimeError:
            times.append(f"{name} refuses")
    print(f"[kernel]   SDPA by backend: {', '.join(times)}")


def group_norm_inputs(g, dtype, shape):
    """x with per-channel offsets and scales, as activations have them (so
    that the shares of a slab differ), scale ~1 +- 0.3 and bias ~0.3, on
    the card."""
    c = shape[1]
    x = (torch.randn(shape, generator=g, device="cuda")
         * (0.5 + 2 * torch.rand(1, c, 1, 1, generator=g, device="cuda"))
         + 2 * torch.randn(1, c, 1, 1, generator=g, device="cuda")).to(dtype)
    w = (1 + 0.3 * torch.randn(c, generator=g, device="cuda")).to(dtype)
    b = (0.3 * torch.randn(c, generator=g, device="cuda")).to(dtype)
    return x, w, b


def group_norm_faults(x, w, b, eps, silu, want, plan) -> dict:
    """Max errors against `want` of planted faults, made with the plain
    twin: the variance 5% off; and, where a cluster shares each slab
    (plan.k > 1), rank 0's share of every slab (its first 1/k of whole
    16-byte vectors, as csrc/group_norm.cu splits it) left out of the
    statistics."""
    from editanything_tpu_torch.core.kernels import group_norm_silu_reference
    faults = {"variance x1.05": max_err(group_norm_silu_reference(
        x, w / 1.05 ** 0.5, b, eps=eps, apply_silu=silu), want)}
    if plan.k > 1:
        n, c, h, wd = x.shape
        vec = 16 // x.element_size() if (h * wd) % (16 // x.element_size()) == 0 else 1
        xf = x.float().reshape(n, 32, -1)
        first = xf.shape[-1] // vec // plan.k * vec
        rest = xf[..., first:]
        mean = rest.mean(-1, keepdim=True)
        var = rest.var(-1, correction=0, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
        y = y * w.float()[:, None, None] + b.float()[:, None, None]
        if silu:
            y = y * torch.sigmoid(y)
        faults["rank 0's share left out of the statistics"] = max_err(
            y.to(x.dtype), want)
        del xf, rest, y
    return faults


def group_norm_occupancy(plan):
    """(blocks per SM, clusters of plan.k at once) of kernel A's kernel for
    this plan, bf16 (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    cudaOccupancyMaxActiveClusters)."""
    import ctypes
    from editanything_tpu_torch.core import kernels as K
    out = (ctypes.c_int * 2)()
    err = K._gn_library().ea_group_norm_occupancy(
        plan.k, plan.threads, plan.smem_bytes, out)
    check(err == 0, f"ea_group_norm_occupancy failed ({err})")
    return out[0], out[1]


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds per call of fn (the launch path: checks, plan,
    allocation, the launch), the device synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * host / calls


def check_faults(faults: dict, bound: float, what: str) -> None:
    """Print the planted faults' errors; fail unless `bound` rejects each."""
    print("[kernel]   planted faults: "
          + ", ".join(f"{name} {err:.3e}" for name, err in faults.items()))
    for name, err in faults.items():
        check(err > bound, f"{what}: the bound {bound:.3e} would pass a "
                           f"planted fault ({name}: {err:.3e})")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_device():
    from editanything_tpu_torch.core import build, flash_attention, kernels
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    build.build_libraries(CUDA_LIBRARIES)
    flash_attention.build()
    kernels.build()
    kernels.build_sam()
    kernels.build_resnet()
    print(f"[build] every kernel ready in {time.perf_counter() - t0:.1f} s "
          f"(build dir {os.path.relpath(build.BUILD_DIR, REPO)}; one nvcc per "
          f"CUDA source, in parallel)")
    for name in CUDA_LIBRARIES:
        info = build.BUILD_LOG[name]
        print(f"[build] nvcc csrc/{name}.cu: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build]   {line.strip()}")
    return smi


def phase_kernels():
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.core import kernels as K
    g = torch.Generator("cuda").manual_seed(0)
    headline = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for label, b, h, n, m, dqk, dv, scale in (ATTN_SHAPES
                                                  + reference_read_shapes()):
            q = torch.randn(b, h, n, dqk, generator=g, device="cuda").to(dtype)
            k = torch.randn(b, h, m, dqk, generator=g, device="cuda").to(dtype)
            v = torch.randn(b, h, m, dv, generator=g, device="cuda").to(dtype)
            got = FA.flash_attention(q, k, v, scale=scale)
            want = FA.flash_attention_reference(q, k, v, scale=scale)
            torch.cuda.synchronize()
            err = max_err(got, want)
            bound = attention_bound(dtype, want)
            faults = attention_faults(q, k, v, want, scale)
            reps = 10 if dtype == torch.bfloat16 else 3
            ms = cuda_ms(lambda: FA.flash_attention(q, k, v, scale=scale), reps)
            plain = cuda_ms(lambda: FA.flash_attention_reference(
                q, k, v, scale=scale), reps)
            # the library's yardstick, which the port never calls
            sdpa = cuda_ms(lambda: sdpa_call(q, k, v, scale), reps)
            least, by = bound_ms(*attention_work(b, h, n, m, dqk, dv,
                                                 q.element_size()),
                                 PEAK_BF16 if dtype == torch.bfloat16
                                 else PEAK_FP32)
            print(f"[kernel] flash_attention {tag} {label} "
                  f"{(b, h, n, m, dqk, dv)} scale={scale}: max_abs_err {err:.3e} <= "
                  f"{bound:.3e} (max|out| {want.float().abs().max().item():.3e}); "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{least:.4f} ms ({by}), SDPA {sdpa:.4f} ms")
            what = f"flash_attention {tag} {label}"
            check_faults(faults, bound, what)
            check(err <= bound, f"{what}: {err} > {bound}")
            if dtype == torch.bfloat16 and label in SDPA_BACKEND_SHAPES:
                print_sdpa_backends(q, k, v, scale, reps)
            if dtype == torch.bfloat16 and label.startswith("sam"):
                headline[f"flash_attention {label}"] = (err, ms, plain, label)
            if dtype == torch.bfloat16 and label.startswith("safety"):
                headline["flash_attention safety"] = {
                    "shape": [b, h, n, m, dqk, dv], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain, "bound_ms": least,
                    "bound_by": by, "library_ms": sdpa}
            if dtype == torch.bfloat16 and label.startswith("blip2"):
                headline.setdefault("flash_attention blip2", {})[label] = {
                    "shape": [b, h, n, m, dqk, dv], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain, "bound_ms": least,
                    "bound_by": by, "library_ms": sdpa}
            if dtype == torch.bfloat16 and label.startswith("groundingdino"):
                headline["flash_attention groundingdino"] = {
                    "shape": [b, h, n, m, dqk, dv], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain, "bound_ms": least,
                    "bound_by": by, "library_ms": sdpa}
            if dtype == torch.bfloat16 and label == HEADLINE["flash_attention"]:
                headline["flash_attention"] = (err, ms, plain, label)
                headline["flash_attention work"] = attention_work(
                    b, h, n, m, dqk, dv)
                headline["flash_attention library"] = sdpa
            del q, k, v, got, want
        for label, shape, eps, silu in GN_SHAPES:
            x, w, bias = group_norm_inputs(g, dtype, shape)
            plan = K.group_norm_plan(*shape, 32, x.element_size())
            run = lambda: K.group_norm_silu(x, w, bias, eps=eps, apply_silu=silu)
            plain_fn = lambda: K.group_norm_silu_reference(
                x, w, bias, eps=eps, apply_silu=silu)
            got, want = run(), plain_fn()
            torch.cuda.synchronize()
            err = max_err(got, want)
            bound = GN_BOUNDS[dtype]
            faults = group_norm_faults(x, w, bias, eps, silu, want, plan)
            ms, plain = cuda_ms(run, 10), cuda_ms(plain_fn, 10)
            host = host_us(run)
            least, by = bound_ms(*group_norm_work(shape, x.element_size()),
                                 PEAK_FP32)
            # the library's yardstick where one call computes the same
            # function (no SiLU), which the port never calls
            library = None if silu else cuda_ms(
                lambda: F.group_norm(x, 32, w, bias, eps), 10)
            blocks, clusters = group_norm_occupancy(plan)
            print(f"[kernel] group_norm_silu {tag} {label} {shape} eps={eps:g} "
                  f"silu={silu}: max_abs_err {err:.3e} <= {bound:g} "
                  f"(max|out| {want.float().abs().max().item():.3e}); "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{least:.4f} ms ({by})"
                  + ("" if library is None else f", F.group_norm {library:.4f} ms")
                  + f"; host {host:.1f} us per call; plan {plan.path}, "
                  f"k {plan.k}, {plan.ctas} CTAs, {plan.share_bytes} B share, "
                  f"{blocks} blocks per SM, {clusters} clusters at once")
            what = f"group_norm_silu {tag} {label}"
            check_faults(faults, bound, what)
            check(err <= bound, f"{what}: {err} > {bound}")
            if dtype == torch.bfloat16 and label == HEADLINE["group_norm_silu"]:
                headline["group_norm_silu"] = (err, ms, plain, label)
                headline["group_norm_silu work"] = group_norm_work(shape)
                headline["group_norm_silu library"] = library
            del x, got, want
    torch.cuda.empty_cache()
    return headline


def hires_rows(n: int) -> torch.Tensor:
    """The query rows held against the twin: the first and last halves of
    HIRES_ROWS (all of them where n is no larger)."""
    half = min(HIRES_ROWS, n) // 2
    return torch.cat([torch.arange(half), torch.arange(n - half, n)]).cuda()


def phase_hires_kernels():
    """Kernel B at HIRES_ATTN_SHAPES, launched at the full shape, HIRES_ROWS
    of its rows against the twin on those rows, with the planted faults
    there (and, past 2^16 keys, the keys beyond 2^16 dropped, as a 16-bit
    key index would), timed beside SDPA and its bound; then kernel A at
    GN_OFFSET_SHAPE against the twin on three slabs."""
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.core import kernels as K
    plain = FA.flash_attention_reference
    g = torch.Generator("cuda").manual_seed(21)
    for label, b, h, n, m, dqk, dv, scale in HIRES_ATTN_SHAPES:
        q = torch.randn(b, h, n, dqk, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, h, m, dqk, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, h, m, dv, generator=g, device="cuda").bfloat16()
        got = FA.flash_attention(q, k, v, scale=scale)
        rows = hires_rows(n)
        q_rows = q[:, :, rows].contiguous()
        want = plain(q_rows, k, v, scale=scale)
        torch.cuda.synchronize()
        err = max_err(got[:, :, rows], want)
        bound = attention_bound(torch.bfloat16, want)
        faults = attention_faults(q_rows, k, v, want, scale)
        if m > 2 ** 16:
            faults["keys past 2^16 dropped"] = max_err(plain(
                q_rows, k[:, :, :2 ** 16], v[:, :, :2 ** 16], scale=scale), want)
        reps = 10 if m <= 16384 else 3
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, scale=scale), reps,
                     warmup=1)
        plain_rows = cuda_ms(lambda: plain(q_rows, k, v, scale=scale), 3,
                             warmup=1)
        sdpa = cuda_ms(lambda: sdpa_call(q, k, v, scale), reps, warmup=1)
        least, by = bound_ms(*attention_work(b, h, n, m, dqk, dv))
        print(f"[kernel] flash_attention bf16 {label} {(b, h, n, m, dqk, dv)}: "
              f"{len(rows)} of {n} rows against the twin: max_abs_err "
              f"{err:.3e} <= {bound:.3e} (max|out| "
              f"{want.float().abs().max().item():.3e}); kernel {ms:.4f} ms, "
              f"plain on those rows {plain_rows:.4f} ms, bound {least:.4f} ms "
              f"({by}, {100 * least / ms:.1f}% of it), SDPA {sdpa:.4f} ms")
        check_faults(faults, bound, f"flash_attention bf16 {label}")
        check(err <= bound, f"flash_attention bf16 {label}: {err} > {bound}")
        del q, k, v, got, q_rows, want
        torch.cuda.empty_cache()

    # kernel A where image 1 starts 2^31 bytes in
    n, c, hh, ww = GN_OFFSET_SHAPE
    x = torch.empty(GN_OFFSET_SHAPE, dtype=torch.bfloat16, device="cuda")
    for i in range(n):
        x[i] = (torch.randn(c, hh, ww, generator=g, device="cuda")
                * (0.5 + 2 * torch.rand(c, 1, 1, generator=g, device="cuda"))
                + 2 * torch.randn(c, 1, 1, generator=g, device="cuda"))
    w = (1 + 0.3 * torch.randn(c, generator=g, device="cuda")).bfloat16()
    bias = (0.3 * torch.randn(c, generator=g, device="cuda")).bfloat16()
    y = K.group_norm_silu(x, w, bias, eps=1e-6, apply_silu=True)
    cpg = c // 32
    errs, faults = {}, {}
    for img, grp in ((0, 0), (1, 0), (1, 31)):
        ch = slice(grp * cpg, (grp + 1) * cpg)
        want = K.group_norm_silu_reference(x[img:img + 1, ch], w[ch], bias[ch],
                                           num_groups=1, eps=1e-6)
        errs[img, grp] = max_err(y[img:img + 1, ch], want)
        if img == 1:
            # a 32-bit byte offset would have read image 0's slab
            faults[f"slab ({img}, {grp}) read from image 0"] = max_err(
                K.group_norm_silu_reference(x[0:1, ch], w[ch], bias[ch],
                                            num_groups=1, eps=1e-6), want)
        if (img, grp) == (1, 31):
            faults["variance x1.05"] = max_err(K.group_norm_silu_reference(
                x[img:img + 1, ch], w[ch] / 1.05 ** 0.5, bias[ch],
                num_groups=1, eps=1e-6), want)
    ms = cuda_ms(lambda: K.group_norm_silu(x, w, bias, eps=1e-6), 3, warmup=1)
    least, by = bound_ms(*group_norm_work(GN_OFFSET_SHAPE), PEAK_FP32)
    plan = K.group_norm_plan(n, c, hh, ww, 32, 2)
    bound = GN_BOUNDS[torch.bfloat16]
    print(f"[kernel] group_norm_silu bf16 {GN_OFFSET_SHAPE} (2^31 elements; "
          f"image 1 at byte 2^31), slabs (image, group) against the twin on "
          f"each: " + ", ".join(f"{key} {e:.3e}" for key, e in errs.items())
          + f" <= {bound:g}; kernel {ms:.4f} ms, bound {least:.4f} ms ({by}); "
          f"plan {plan.path}, k {plan.k}, {plan.share_bytes} B share")
    check_faults(faults, bound, "group_norm_silu bf16 2^31 elements")
    check(max(errs.values()) <= bound,
          f"group_norm_silu at {GN_OFFSET_SHAPE}: {errs} > {bound}")
    del x, y
    torch.cuda.empty_cache()


def sam_bound(dtype, want_max: float, rel: float) -> float:
    return rel * want_max if dtype == torch.bfloat16 else SAM_F32_BOUND


def sharpen_attention(transformer, factor: float = SHARPEN):
    """Scale the q and k projections of every attention of a two-way
    transformer (random weights) in place, so that its attention is not
    near-uniform."""
    with torch.no_grad():
        for mod in transformer.modules():
            if hasattr(mod, "q_proj"):
                mod.q_proj.weight.mul_(factor)
                mod.k_proj.weight.mul_(factor)
    return transformer


def twoway_errors(got, want):
    """(max abs error, relative RMS error), each the larger over the
    (queries, keys) outputs."""
    return (max(max_err(g, w) for g, w in zip(got, want)),
            max(rel_rms(g, w) for g, w in zip(got, want)))


# planted faults of kernel D that both of its bf16 bounds must reject, each
# alone: layer 0's token->image keys are computed once for all prompts, so
# a hoist that lost pe would pass a check of the relative RMS alone
TWOWAY_FAULTS_BOTH_BOUNDS = ("layer 0 keys without pe",)


def twoway_faults(packed, src, pe, tokens, want) -> dict:
    """twoway_errors against the twin's (queries, keys) of four planted
    faults, made with the plain twin: layer 0's self-attention with a
    residual instead of the replacement; the pad tokens (zeros up to the
    Pallas kernel's multiple of 8) attended as if they were tokens; the
    logits of every token<->image attention x1.05 (their q projections
    scaled); layer 0's token->image keys projected from the image rows
    without pe."""
    from editanything_tpu_torch.core import kernels as K
    faults = {"layer 0 residual": twoway_errors(K.sam_twoway_reference(
        packed, src, pe, tokens, first_layer_replaces=False), want)}
    faults["layer 0 keys without pe"] = twoway_errors(K.sam_twoway_reference(
        packed, src, pe, tokens, first_keys_with_pe=False), want)
    b, t, d = tokens.shape
    padded = torch.cat([tokens, tokens.new_zeros(b, -(-t // 8) * 8 - t, d)], 1)
    q, k = K.sam_twoway_reference(packed, src, pe, padded)
    faults["pad tokens unmasked"] = twoway_errors((q[:, :t], k), want)
    scaled = packed.clone()
    for name in packed.mats:
        if name.endswith("_to_image.q_proj") or name.endswith("_to_token.q_proj"):
            scaled.mat(name).mul_(1.05)
            scaled.vec(name + ".bias").mul_(1.05)
    faults["cross logits x1.05"] = twoway_errors(K.sam_twoway_reference(
        scaled, src, pe, tokens), want)
    return faults


def upscale_grid() -> int:
    """Blocks of kernel C's persistent bf16 grid on device 0: SMs x blocks
    per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return (torch.cuda.get_device_properties(0).multi_processor_count
            * upscale_occupancy()[0])


def upscale_occupancy():
    """Blocks per SM of kernel C's bf16 persistent kernel and of its fp32
    kernel."""
    import ctypes
    from editanything_tpu_torch.core import kernels as K
    out = (ctypes.c_int * 2)()
    err = K._sam_library("sam_upscale").ea_sam_upscale_occupancy(out)
    check(err == 0, f"ea_sam_upscale_occupancy failed ({err})")
    return out[0], out[1]


def upscale_faults(src, hyper, args, want) -> dict:
    """Max errors against `want` of planted faults, made with the plain
    twin: the taps of both transposed convs flipped (JAX conv_transpose's
    convention, PARITY.md); the LayerNorm2d variance 5% off; and, where a
    block of the persistent grid takes three or more 64-pixel items, one
    source tile read one ring slot stale: block 0's third item (item 2G of
    a grid of G blocks) computed from the tile its ring slot held before,
    item 0's."""
    from editanything_tpu_torch.core import kernels as K
    w1, b1, lnw, lnb, w2, b2 = args
    faults = {
        "taps flipped": max_err(K.sam_upscale_hyper_reference(
            src, hyper, w1.flip(2, 3), b1, lnw, lnb, w2.flip(2, 3), b2), want),
        "variance x1.05": max_err(K.sam_upscale_hyper_reference(
            src, hyper, w1, b1, lnw / 1.05 ** 0.5, lnb, w2, b2), want)}
    tiles = -(-src.shape[1] // 64)
    item = 2 * upscale_grid()
    if item < src.shape[0] * tiles:
        b, t = divmod(item, tiles)
        stale = src.clone()
        stale[b, 64 * t:64 * t + 64] = src[0, :64]
        faults["a source tile one ring slot stale"] = max_err(
            K.sam_upscale_hyper_reference(stale, hyper, *args), want)
    return faults


def phase_sam_kernels(headline: dict):
    """SAM's decoder kernels against their twins at the main path's shapes
    (random decoder weights at the published widths, random inputs)."""
    from editanything_tpu_torch.core import kernels as K
    from editanything_tpu_torch.models.sam import SAMConfig
    from editanything_tpu_torch.pipelines.bundle import random_sam
    g = torch.Generator("cuda").manual_seed(5)
    m = 4096                                   # ViT-H's 64x64 embedding
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        reps = 5 if dtype == torch.bfloat16 else 1
        dec = random_sam(SAMConfig(**SMALL_SAM), device="cuda", dtype=dtype,
                         generator=g).mask_decoder
        packed = K.pack_twoway(sharpen_attention(dec.transformer))
        src = torch.randn(1, m, 256, generator=g, device="cuda").to(dtype)
        pe = torch.randn(m, 256, generator=g, device="cuda")
        for label, b, t in TWOWAY_SHAPES:
            tokens = torch.randn(b, t, 256, generator=g, device="cuda")
            run = lambda: K.sam_twoway(packed, src, pe, tokens)
            plain = lambda: K.sam_twoway_reference(packed, src, pe, tokens)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err, rms = twoway_errors(got, want)
            top = max(x.float().abs().max().item() for x in want)
            bound = sam_bound(dtype, top, TWOWAY_BF16_REL_BOUND)
            rms_bound = (TWOWAY_BF16_RMS_BOUND if dtype == torch.bfloat16
                         else float("inf"))
            faults = twoway_faults(packed, src, pe, tokens, want)
            ms = cuda_ms(run, reps, warmup=1)
            plain_ms = cuda_ms(plain, reps, warmup=1)
            print(f"[kernel] sam_twoway {tag} {label} (B={b}, T={t}, M={m}): "
                  f"max_abs_err {err:.3e} <= {bound:.3e} (max|out| {top:.3e}), "
                  f"rel_rms {rms:.3e} <= {rms_bound:.3e}; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
            what = f"sam_twoway {tag} {label}"
            print("[kernel]   planted faults (max abs / rel rms): " + ", ".join(
                f"{name} {e:.3e} / {r:.3e}" for name, (e, r) in faults.items()))
            for name, (e, r) in faults.items():
                check(e > bound or r > rms_bound,
                      f"{what}: the bounds would pass a planted fault ({name}: "
                      f"{e:.3e} / {r:.3e})")
                if name in TWOWAY_FAULTS_BOTH_BOUNDS:
                    check(e > bound and (r > rms_bound or dtype == torch.float32),
                          f"{what}: a bound would pass a planted fault alone "
                          f"({name}: {e:.3e} / {r:.3e})")
            check(err <= bound and rms <= rms_bound,
                  f"{what}: {err} > {bound} or {rms} > {rms_bound}")
            if dtype == torch.bfloat16 and label == HEADLINE["sam_twoway"]:
                headline["sam_twoway"] = (err, ms, plain_ms,
                                          f"{label} B={b} T={t}")
                headline["sam_twoway work"] = twoway_work(packed, b, t, m)
            del got, want, tokens
        up = dec.output_upscaling
        args = (up[0].weight, up[0].bias, up[1].weight, up[1].bias,
                up[3].weight, up[3].bias)
        for label, b in UPSCALE_SHAPES:
            keys = torch.randn(b, m, 256, generator=g, device="cuda").to(dtype)
            hyper = torch.randn(b, 4, 32, generator=g, device="cuda").to(dtype)
            run = lambda: K.sam_upscale_hyper(keys, hyper, *args)
            plain = lambda: K.sam_upscale_hyper_reference(keys, hyper, *args)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = max_err(got, want)
            top = want.float().abs().max().item()
            bound = sam_bound(dtype, top, UPSCALE_BF16_REL_BOUND)
            faults = upscale_faults(keys, hyper, args, want)
            ms = cuda_ms(run, reps, warmup=1)
            plain_ms = cuda_ms(plain, reps, warmup=1)
            least, by = bound_ms(*upscale_work(b, 64, keys.element_size()),
                                 PEAK_BF16 if dtype == torch.bfloat16
                                 else PEAK_FP32)
            per_sm = upscale_occupancy()[0 if dtype == torch.bfloat16 else 1]
            print(f"[kernel] sam_upscale_hyper {tag} {label} (B={b}, 64x64 -> "
                  f"256x256): max_abs_err {err:.3e} <= {bound:.3e} (max|out| "
                  f"{top:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {least:.4f} ms ({by}); {per_sm} blocks per SM")
            what = f"sam_upscale_hyper {tag} {label}"
            check_faults(faults, bound, what)
            check(err <= bound, f"{what}: {err} > {bound}")
            if dtype == torch.bfloat16 and label == HEADLINE["sam_upscale_hyper"]:
                headline["sam_upscale_hyper"] = (err, ms, plain_ms, f"{label} B={b}")
                headline["sam_upscale_hyper work"] = upscale_work(b, 64)
            del got, want, keys
        del dec, packed, src
        torch.cuda.empty_cache()


def bound_ms(ops: float, nbytes: float, peak: float = PEAK_BF16):
    """(least time in ms, what bounds it) for work of `ops` operations at
    `peak` and `nbytes` of device memory traffic."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_work(b, h, n, m, dqk, dv, itemsize=2):
    """(FLOPs, bytes) of softmax(q k^T) v: both products; q, k, v read and
    the output written once."""
    return (2.0 * b * h * n * m * (dqk + dv),
            itemsize * b * h * (n * dqk + m * dqk + m * dv + n * dv))


def group_norm_work(shape, itemsize=2):
    """(fp32 operations, bytes): ~10 per element (two statistics, the
    affine and SiLU), one read and one write of the activation."""
    numel = float(np.prod(shape))
    return 10.0 * numel, 2.0 * itemsize * numel


def twoway_work(packed, b, t, m, itemsize=2):
    """(FLOPs, bytes) of SAM's two-way transformer for b prompts over one
    image: every projection of the m image rows per prompt (layer 0's
    token->image k/v projections of the shared keys once), both attention
    products each way, the token-side projections and MLP; bytes: the keys
    and pe read, the tokens and the weights read once, keys and queries
    written."""
    from editanything_tpu_torch.core.kernels import TWOWAY_WIDTH as d
    di = d // 2
    mlp = packed.mats["layers.0.mlp.lin1"][1][0]
    macs = 0.0
    for layer in range(packed.n_layers):
        shared = 1 if layer == 0 else b
        macs += 2 * m * d * di * shared            # t2i k, v projections
        macs += 2 * m * d * di * b                 # i2t q, out projections
        macs += 4 * t * m * di * b                 # t2i and i2t products
        macs += b * (4 * t * d * d + 2 * t * t * d   # token self-attention
                     + 4 * t * d * di              # t2i q/out, i2t k/v
                     + 2 * t * d * mlp)            # MLP
    macs += b * (2 * m * d * di + 2 * t * m * di + 2 * t * d * di)   # final
    nbytes = (m * d * (itemsize + 4) + b * t * d * 4
              + packed.w.numel() * itemsize + packed.v.numel() * 4
              + b * (m + t) * d * itemsize)
    return 2.0 * macs, float(nbytes)


def upscale_work(b, e, itemsize=2):
    """(FLOPs, bytes) of kernel C: per input pixel 4 taps 256->64, per
    first-stage pixel 4 taps 64->32, the 4 hypernetwork products of the 16
    output pixels; keys read, logits written."""
    macs = b * e * e * (4 * 256 * 64 + 16 * 64 * 32 + 16 * 4 * 32)
    return 2.0 * macs, float(itemsize * b * (e * e * 256 + 4 * 16 * e * e))


def resnet_work(n, cin, cout, hw, temb, itemsize=2):
    """(FLOPs, bytes) of one resnet block: both 3x3 convs and the 1x1
    shortcut where Cin != Cout; x, weights (and trow) read once, the output
    written once."""
    sc = cin != cout
    macs = n * hw * cout * (9 * cin + 9 * cout + (cin if sc else 0))
    nbytes = itemsize * (n * hw * (cin + cout) + 9 * cin * cout
                         + 9 * cout * cout + (cin * cout if sc else 0)
                         + (n * cout if temb else 0))
    return 2.0 * macs, float(nbytes)


def resnet_inputs(g, dtype, n, cin, cout, temb, hw_side):
    """x with per-channel offsets and scales, a block's parameters drawn
    away from their init (norm scales ~1 +- 0.2, biases ~0.5, so channels
    and groups differ) and trow, on the card."""
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale
                + shift).to(dtype)
    x = (torch.randn(n, cin, hw_side, hw_side, generator=g, device="cuda")
         * (1 + torch.rand(1, cin, 1, 1, generator=g, device="cuda"))
         + torch.randn(1, cin, 1, 1, generator=g, device="cuda")).to(dtype)
    sc = cin != cout
    args = (rnd(cin, scale=0.2, shift=1.0), rnd(cin, scale=0.5),
            rnd(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), rnd(cout, scale=0.5),
            rnd(n, cout) if temb else None,
            rnd(cout, scale=0.2, shift=1.0), rnd(cout, scale=0.5),
            rnd(cout, cout, 3, 3, scale=(9 * cout) ** -0.5), rnd(cout, scale=0.5),
            rnd(cout, cin, 1, 1, scale=cin ** -0.5) if sc else None,
            rnd(cout, scale=0.5) if sc else None)
    return x, args


def resnet_faults(x, args, eps, want) -> dict:
    """(max abs, relative RMS) errors against `want` of six planted faults,
    made with the plain twin: padding with SiLU(shift) instead of 0, the
    trow of another image (where there is one), GN2's groups shifted by one
    channel, GN2's partials of one tile left out of the merge, the shortcut
    dropped, the conv taps flipped. A non-finite output counts as an
    infinite error."""
    from editanything_tpu_torch.core import kernels as K

    def errs(out):
        if not bool(torch.isfinite(out).all()):
            return float("inf"), float("inf")
        return max_err(out, want), rel_rms(out, want)
    faults = {name: errs(K.resnet_fused_reference(x, *args, eps=eps,
                                                  fault=fault))
              for name, fault in (("pad SiLU(shift)", "pad_silu_shift"),
                                  ("GN2 groups shifted", "gn2_groups_shifted"),
                                  ("GN2 tile dropped", "gn2_tile_dropped"),
                                  ("shortcut dropped", "no_shortcut"))}
    if args[4] is not None:
        wrong = args[:4] + (args[4].roll(1, 0),) + args[5:]
        faults["trow of another image"] = errs(K.resnet_fused_reference(
            x, *wrong, eps=eps))
    flipped = list(args)
    flipped[2], flipped[7] = args[2].flip(2, 3), args[7].flip(2, 3)
    faults["taps flipped"] = errs(K.resnet_fused_reference(x, *flipped, eps=eps))
    return faults


def resnet_gn2_check(x, args, eps):
    """(error, fault's error, bound) of GN2's scale and shift: kernel E's
    (its ss2 scratch) and the twin's with one tile's partials dropped,
    each against the twin's direct statistics, as max abs error over
    max|twin's|."""
    from editanything_tpu_torch.core import kernels as K
    n, cout = x.shape[0], args[2].shape[0]
    _, _, scratch = K._resnet_launch(K._resnet_library(), x.contiguous(),
                                     args, 32, eps)
    got = scratch("ss2").view(n, cout, 2).permute(2, 0, 1)
    head = args[:7]
    want = K.resnet_gn2_affine_reference(x, *head, eps=eps)
    dropped = K.resnet_gn2_affine_reference(x, *head, eps=eps,
                                            fault="gn2_tile_dropped")
    top = want.abs().max().item()

    def err(a):
        d = (a - want).abs().max().item()
        return d / top if np.isfinite(d) else float("inf")
    return err(got), err(dropped), RESNET_GN2_STATS_BOUND


def cudnn_convs(x, args, channels_last: bool):
    """The block's convs alone through cuDNN (conv1, conv2 and the 1x1
    shortcut, in x's dtype, TF32 off): the GEMM yardstick, which the port
    never calls."""
    w1, w2, wsc = args[2], args[7], args[9]
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    xc = x.contiguous(memory_format=fmt)
    ws = [None if w is None else w.contiguous(memory_format=fmt)
          for w in (w1, w2, wsc)]
    h = torch.empty((x.shape[0], w1.shape[0]) + x.shape[2:], dtype=x.dtype,
                    device=x.device).normal_().contiguous(memory_format=fmt)

    def run():
        F.conv2d(xc, ws[0], padding=1)
        F.conv2d(h, ws[1], padding=1)
        if ws[2] is not None:
            F.conv2d(xc, ws[2])
    return run


def composed_block(args, temb: bool, dtype):
    """A ResnetBlock2D on the card holding `args` (its time_emb_proj
    random), and a time embedding for it: the composed path's yardstick."""
    from editanything_tpu_torch.models.blocks import ResnetBlock2D
    cout, cin = args[2].shape[:2]
    blk = ResnetBlock2D(cin, cout, 1280 if temb else None).to("cuda", dtype)
    names = ("norm1.weight", "norm1.bias", "conv1.weight", "conv1.bias", None,
             "norm2.weight", "norm2.bias", "conv2.weight", "conv2.bias",
             "conv_shortcut.weight", "conv_shortcut.bias")
    params = dict(blk.named_parameters())
    with torch.no_grad():
        for name, value in zip(names, args):
            if name is not None and value is not None:
                params[name].copy_(value)
    return blk


def with_fused_resnets(on: bool):
    os.environ["EA_RESNET_FUSED"] = "1" if on else "0"


def phase_resnet_kernel(headline: dict):
    """Kernel E against its twin at the main path's UNet and VAE shapes,
    with planted faults, and timed against the twin and the composed
    block."""
    from editanything_tpu_torch.core import kernels as K
    g = torch.Generator("cuda").manual_seed(11)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        reps = 5 if dtype == torch.bfloat16 else 1
        for label, n, cin, cout, temb, side, eps in RESNET_SHAPES:
            x, args = resnet_inputs(g, dtype, n, cin, cout, temb, side)
            run = lambda: K.resnet_fused(x, *args, eps=eps)
            plain = lambda: K.resnet_fused_reference(x, *args, eps=eps)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err, rms = max_err(got, want), rel_rms(got, want)
            top = want.float().abs().max().item()
            bf16 = dtype == torch.bfloat16
            bound = RESNET_BF16_REL_BOUND * top if bf16 else RESNET_F32_BOUND
            rms_bound = RESNET_BF16_RMS_BOUND if bf16 else float("inf")
            faults = resnet_faults(x, args, eps, want)
            del got
            plan = K.resnet_plan(n, cin, cout, side, side, 32, cin != cout,
                                 K._sm_count(0))
            ctas, smem = K.resnet_occupancy(plan.bn, dtype)
            stats_err, stats_fault, stats_bound = resnet_gn2_check(x, args, eps)
            ms, plain_ms = cuda_ms(run, reps, warmup=1), cuda_ms(plain, reps, warmup=1)
            least, by = bound_ms(*resnet_work(n, cin, cout, side * side, temb,
                                              x.element_size()),
                                 PEAK_BF16 if bf16 else PEAK_FP32)
            composed = ""
            if bf16:
                blk = composed_block(args, temb, dtype)
                t = (torch.randn(n, 1280, generator=g, device="cuda").to(dtype)
                     if temb else None)
                with torch.no_grad():
                    with_fused_resnets(False)
                    comp_ms = cuda_ms(lambda: blk(x, t), reps, warmup=1)
                    with_fused_resnets(True)
                    block_ms = cuda_ms(lambda: blk(x, t), reps, warmup=1)
                    with_fused_resnets(False)
                peaks = []
                for fn in (run, lambda: blk(x, t)):
                    with torch.no_grad():
                        torch.cuda.synchronize()
                        base = torch.cuda.memory_allocated()
                        torch.cuda.reset_peak_memory_stats()
                        fn()
                        torch.cuda.synchronize()
                        peaks.append((torch.cuda.max_memory_allocated() - base)
                                     / 2**20)
                conv_ms = cuda_ms(cudnn_convs(x, args, False), reps,
                                  warmup=1)
                conv_cl_ms = cuda_ms(cudnn_convs(x, args, True), reps,
                                     warmup=1)
                composed = (f", composed block {comp_ms:.4f} ms (the block "
                            f"through kernel E {block_ms:.4f} ms), cuDNN "
                            f"convs alone {conv_ms:.4f} ms NCHW, "
                            f"{conv_cl_ms:.4f} ms channels-last; memory a "
                            f"call allocates at its peak {peaks[0]:.0f} MiB "
                            f"(kernel E) / {peaks[1]:.0f} MiB (composed)")
                del blk
            print(f"[kernel] resnet_fused {tag} {label} (N={n}, {side}x{side}, "
                  f"eps={eps:g}): max_abs_err {err:.3e} <= {bound:.3e} (max|out| "
                  f"{top:.3e}), rel_rms {rms:.3e} <= {rms_bound:.3e}; GN2 "
                  f"scale/shift err {stats_err:.3e} <= {stats_bound:.0e}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {least:.4f} ms "
                  f"({by}, {100 * least / ms:.1f}% of it){composed}")
            print(f"[kernel]   plan: channel tile {plan.bn}, {plan.mtiles} x "
                  f"{plan.ntiles} tiles of {K.RESNET_BM} pixels, splits over K "
                  f"{plan.split1} / {plan.split2}, channels padded to "
                  f"{plan.cp_in} / {plan.cp_out}, GN2 partials {plan.slots} "
                  f"image slots x {plan.segs} group segments a tile, "
                  f"{plan.launches} device launches; conv {ctas} CTAs per SM, "
                  f"{smem} B shared memory")
            what = f"resnet_fused {tag} {label}"
            print("[kernel]   planted faults (max abs / rel rms): " + ", ".join(
                f"{name} {e:.3e} / {r:.3e}" for name, (e, r) in faults.items())
                + f"; GN2 tile dropped, scale/shift err {stats_fault:.3e}")
            for name, (e, r) in faults.items():
                rejected = e > bound or r > rms_bound
                if name == "GN2 tile dropped":   # or by the statistics bound
                    rejected = rejected or stats_fault > stats_bound
                check(rejected, f"{what}: the bounds would pass a planted "
                                f"fault ({name}: {e:.3e} / {r:.3e})")
                if name in TWOWAY_FAULTS_BOTH_BOUNDS:
                    check(e > bound and (r > rms_bound or dtype == torch.float32),
                          f"{what}: a bound would pass a planted fault alone "
                          f"({name}: {e:.3e} / {r:.3e})")
            check(err <= bound and rms <= rms_bound,
                  f"{what}: {err} > {bound} or {rms} > {rms_bound}")
            check(stats_err <= stats_bound,
                  f"{what}: GN2 scale/shift {stats_err} > {stats_bound}")
            if bf16 and label == HEADLINE["resnet_fused"]:
                headline["resnet_fused"] = (err, ms, plain_ms, label)
                headline["resnet_fused composed"] = comp_ms
                headline["resnet_fused cudnn convs"] = (conv_ms, conv_cl_ms)
                headline["resnet_fused work"] = resnet_work(n, cin, cout,
                                                            side * side, temb)
            del x, args, want
            torch.cuda.empty_cache()


def _checker_image(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)),
                    (yy * 255 // max(h - 1, 1)),
                    ((xx // 8 + yy // 8) % 2) * 200], axis=-1)
    return img.astype(np.uint8)


def _id_map(h, w, seed):
    """A SAM-style ID condition map: one random colour per 32^2 region."""
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (h // 32, w // 32, 3), dtype=np.uint8)
    return np.repeat(np.repeat(colours, 32, axis=0), 32, axis=1)


def _square_mask(size, lo, hi):
    mask = np.zeros((size, size), np.uint8)
    mask[lo:hi, lo:hi] = 255
    return mask


def phase_tiny_parity():
    """The tiny edit with the composed and the fused resnets, a tiny
    txt2img with the fused resnets and a tiny reference-mode edit: CUDA
    against the CPU in fp32, and in bf16 against the fp32 CPU run, at most
    TINY_BF16_RATIO times as far as the bf16 CPU run; then the rest of the
    edit and denoise surface in fp32."""
    for kind, fused in (("edit", False), ("edit", True), ("txt2img", True),
                        ("reference edit", False)):
        tiny_parity(kind, fused)
    for case, spec in TINY_MODE_CASES.items():
        tiny_mode_parity(case, *spec, 4, TINY_IMAGE_LEVELS)
    for case, spec in TINY_DENOISE_CASES.items():
        tiny_mode_parity(case, *spec, TINY_DENOISE_STEPS,
                         TINY_DENOISE_IMAGE_LEVELS)
    phase_tiny_hires_parity()
    phase_tiny_captioner_parity()


def tiny_caption_run(device: str):
    """The tiny captioner (random weights, seed 4, fp32) on `device`: image
    tokens, queries, OPT's logits over [queries; prompt], greedy tokens of
    two 48x40 images, and kernel B's launches."""
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.models import blip2 as TB
    from editanything_tpu_torch.pipelines.bundle import random_blip2
    from editanything_tpu_torch.pipelines.captioner import Captioner, preprocess
    from editanything_tpu_torch.text.tokenizer import tiny_gpt2_tokenizer
    cfg = TB.tiny_blip2_config()
    model = random_blip2(cfg, device="cpu", seed=4).to(device)
    cap = Captioner(model, tiny_gpt2_tokenizer(), prompt="Q:",
                    max_new_tokens=TINY_CAPTION_TOKENS)
    imgs = np.random.default_rng(12).integers(0, 256, (2, 48, 40, 3), np.uint8)
    before = FA.flash_attention.launches
    with torch.inference_mode():
        px = preprocess(imgs, cfg.image_size, device)
        img = TB.vision_encoder(model, px)
        queries = TB.qformer(model, img)
        prompt = torch.tensor(cap.prompt_ids, device=device)[None].expand(2, -1)
        emb = torch.cat([model.language_projection(queries),
                         model.language_model.embed_tokens(prompt)], dim=1)
        logits, _ = TB.opt_forward(model, emb)
        toks = cap.tokens(imgs)
    outs = [t.float().cpu().numpy() for t in (img, queries, logits)]
    return outs, toks, cap(imgs), FA.flash_attention.launches - before


def phase_tiny_captioner_parity():
    """The tiny BLIP-2 captioner in fp32 on the GPU (kernel B) against the
    CPU (plain twins): image tokens, queries and logits within
    TINY_CAPTION_TOL, greedy tokens and captions equal; then a tiny
    ``process(enable_auto_prompt=True)`` (a supplied condition map) on both,
    prompts equal and images within TINY_DENOISE_IMAGE_LEVELS."""
    from editanything_tpu_torch.models.blip2 import tiny_blip2_config
    from editanything_tpu_torch.pipelines.bundle import (random_blip2,
                                                         random_bundle)
    from editanything_tpu_torch.pipelines.captioner import Captioner
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    from editanything_tpu_torch.text.tokenizer import tiny_gpt2_tokenizer
    (cpu, cpu_toks, cpu_caps, _) = tiny_caption_run("cpu")
    (gpu, gpu_toks, gpu_caps, launched) = tiny_caption_run("cuda")
    errs = [float(np.abs(a - b).max()) for a, b in zip(gpu, cpu)]
    print(f"[parity] tiny captioner fp32, CUDA (kernels) vs CPU (plain "
          f"twins): image tokens {errs[0]:.3e}, queries {errs[1]:.3e}, logits "
          f"{errs[2]:.3e} <= {TINY_CAPTION_TOL:g}; tokens "
          f"{'equal' if np.array_equal(gpu_toks, cpu_toks) else 'DIFFER'} "
          f"{gpu_toks.tolist()}; {launched} flash_attention launches")
    check(max(errs) <= TINY_CAPTION_TOL, "tiny captioner fp32 parity")
    check(np.array_equal(gpu_toks, cpu_toks) and gpu_caps == cpu_caps,
          "tiny captioner tokens differ")
    check(launched > 0, "the tiny captioner did not launch flash_attention")

    args = dict(image=_checker_image(64, 64), mask=_square_mask(64, 16, 48),
                prompt="a red cat", a_prompt="best", n_prompt="blurry",
                condition_image=_checker_image(64, 64)[::-1], num_samples=2,
                image_resolution=64, detect_resolution=64, ddim_steps=4,
                scale=9.0, control_scale=0.5, alignment_ratio=0.75,
                enable_auto_prompt=True,
                noise=np.random.default_rng(7).standard_normal(
                    (2, 8, 8, 4)).astype(np.float32))
    outs = {}
    for device in ("cpu", "cuda"):
        b = random_bundle(tiny=True, device="cpu",
                          generator=torch.Generator().manual_seed(1)).to(device)
        cap = Captioner(random_blip2(tiny_blip2_config(), device="cpu",
                                     seed=4).to(device),
                        tiny_gpt2_tokenizer(), max_new_tokens=TINY_CAPTION_TOKENS)
        _, images, _, prompt = EditAnythingEditor(b, captioner=cap).process(**args)
        outs[device] = (np.stack(images), prompt)
    img_err = int(np.abs(outs["cuda"][0].astype(np.int32)
                         - outs["cpu"][0].astype(np.int32)).max())
    print(f"[parity] tiny process(enable_auto_prompt=True), fp32, CUDA vs CPU: "
          f"prompts {outs['cuda'][1]!r} / {outs['cpu'][1]!r}; images max diff "
          f"{img_err} <= {TINY_DENOISE_IMAGE_LEVELS} levels")
    check(outs["cuda"][1] == outs["cpu"][1]
          and outs["cuda"][1].endswith(", a red cat, best"),
          "tiny auto-prompt requests' prompts differ")
    check(img_err <= TINY_DENOISE_IMAGE_LEVELS,
          f"tiny auto-prompt request: images differ by {img_err}")


def tiny_parity(kind: str, fused: bool):
    from editanything_tpu_torch.core import kernels as K
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.pipelines.edit import EditPipeline
    from editanything_tpu_torch.pipelines.generate import GenerationPipeline

    def bundle():   # same seed on the CPU twice -> identical weights
        return random_bundle(tiny=True, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    args = dict(prompt="a red cat", condition_image=_checker_image(64, 64),
                negative_prompt="blurry", num_samples=2, image_resolution=64,
                num_steps=4, guidance_scale=9.0,
                noise=np.random.default_rng(7).standard_normal(
                    (2, 8, 8, 4)).astype(np.float32))
    if kind != "txt2img":
        args.update(image=_checker_image(64, 64), mask=_square_mask(64, 16, 48),
                    control_scale=0.5, alignment_ratio=0.75)
    if kind == "reference edit":
        args.update(_tiny_reference())
    levels = (TINY_DENOISE_IMAGE_LEVELS if kind == "reference edit"
              else TINY_IMAGE_LEVELS)
    with_fused_resnets(fused)
    before = K.resnet_fused.launches
    outs = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                          ("cpu", torch.bfloat16), ("cuda", torch.bfloat16)):
        b = bundle().to(device, dtype)
        pipe = GenerationPipeline(b, controlnet="sam") if kind == "txt2img" \
            else EditPipeline(b)
        outs[device, dtype] = (pipe(**args, return_latents=True), pipe(**args))
    with_fused_resnets(False)
    check((K.resnet_fused.launches > before) == fused,
          f"tiny {kind}: resnet_fused launched {K.resnet_fused.launches - before}"
          f" times with the switch {'on' if fused else 'off'}")
    what = f"tiny {kind}, resnets {'fused' if fused else 'composed'}"

    def dist(a, b):     # (latents max abs diff, images max diff in levels)
        (la, ia), (lb, ib) = outs[a], outs[b]
        return (float(np.abs(la - lb).max()),
                int(np.abs(ia.astype(np.int32) - ib.astype(np.int32)).max()))
    ref = ("cpu", torch.float32)
    lat_err, img_err = dist(("cuda", torch.float32), ref)
    print(f"[parity] {what}, fp32, CUDA (kernels) vs CPU (plain twins): "
          f"latents max_abs_err {lat_err:.3e} <= {TINY_LATENT_TOL:g} "
          f"(|latents| <= {float(np.abs(outs[ref][0]).max()):.2f}); "
          f"images max diff {img_err} <= {levels} levels")
    check(lat_err <= TINY_LATENT_TOL, f"{what}: latents differ by {lat_err}")
    check(img_err <= levels, f"{what}: images differ by {img_err}")
    lat_k, img_k = dist(("cuda", torch.bfloat16), ref)
    lat_p, img_p = dist(("cpu", torch.bfloat16), ref)
    print(f"[parity] {what}, bf16 against the fp32 CPU run: CUDA (kernels) "
          f"latents {lat_k:.3e}, images {img_k} levels; CPU (plain twins) "
          f"latents {lat_p:.3e}, images {img_p} levels; bound "
          f"{TINY_BF16_RATIO:g}x the CPU's")
    check(lat_k <= TINY_BF16_RATIO * lat_p,
          f"{what} bf16 latents: {lat_k} > {TINY_BF16_RATIO} x {lat_p}")
    check(img_k <= TINY_BF16_RATIO * img_p,
          f"{what} bf16 images: {img_k} > {TINY_BF16_RATIO} x {img_p} levels")


def tiny_mode_parity(case: str, family: str, mode: str, kw: dict, steps: int,
                     levels: int):
    """One edit of the rest of the edit and denoise surface on a tiny
    bundle of its family, fp32 on the GPU (kernels) against fp32 on the CPU
    (plain twins), with the same weights and the same initial, "mix" and eta
    noises; images within `levels`."""
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.pipelines.edit import EditPipeline
    rng = np.random.default_rng(8)
    args = dict(image=_checker_image(64, 64), mask=_square_mask(64, 16, 48),
                prompt="a red cat", condition_image=_checker_image(64, 64),
                negative_prompt="blurry", num_samples=2, image_resolution=64,
                num_steps=steps, guidance_scale=9.0, control_scale=0.5,
                noise=rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
                mix_noise=rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
                step_noise=rng.standard_normal((steps, 2, 4, 8, 8)).astype(np.float32),
                eta_noise=rng.standard_normal((steps, 2, 4, 8, 8)).astype(np.float32),
                **kw)
    outs = {}
    for device in ("cpu", "cuda"):
        b = random_bundle(tiny=True, device="cpu", family=family,
                          generator=torch.Generator().manual_seed(1)).to(device)
        pipe = EditPipeline(b, inpaint_mode=mode)
        before = FA.flash_attention.launches
        outs[device] = (pipe(**args, return_latents=True), pipe(**args))
        launched = FA.flash_attention.launches - before
    check(launched > 0, f"tiny {case}: flash_attention was not launched")
    lat_err = float(np.abs(outs["cuda"][0] - outs["cpu"][0]).max())
    img_err = int(np.abs(outs["cuda"][1].astype(np.int32)
                         - outs["cpu"][1].astype(np.int32)).max())
    print(f"[parity] tiny {case}, fp32, CUDA (kernels) vs CPU (plain twins): "
          f"latents max_abs_err {lat_err:.3e} <= {TINY_LATENT_TOL:g} "
          f"(|latents| <= {float(np.abs(outs['cpu'][0]).max()):.2f}); images "
          f"max diff {img_err} <= {levels} levels; {launched} "
          f"flash_attention launches")
    check(lat_err <= TINY_LATENT_TOL, f"tiny {case}: latents differ by {lat_err}")
    check(img_err <= levels, f"tiny {case}: images differ by {img_err}")


def palette_sketch(size: int, seed: int) -> np.ndarray:
    """A sketch on white drawn with numpy: rectangles and discs of four
    random colours."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 255, np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    for i, colour in enumerate(rng.integers(0, 200, (4, 3), dtype=np.uint8)):
        y0, x0 = rng.integers(0, 3 * size // 4, 2)
        r = size // 8
        if i % 2:
            img[(yy - y0 - r) ** 2 + (xx - x0 - r) ** 2 < r * r] = colour
        else:
            img[y0:y0 + 2 * r, x0:x0 + 3 * r] = colour
    return img


def tiny_hires_cases() -> dict:
    """The high-resolution surface at tiny widths, each a function of a
    bundle with the "tile" ControlNet -> uint8 images: tile refinement
    (64^2 -> 128^2, 2 samples) through ``EditPipeline.tile_refine`` and
    through ``process(enable_tile=True)``, img2img (strength 0.6, 5 steps:
    3 run), a sketch with its scale map, and txt2img and an edit whose VAE
    encodes and decodes 64^2 images in 2 x 2 tiles (``vae_oneshot_max_px``
    lowered to 32). The noises are drawn here, so both devices get the
    same."""
    from editanything_tpu_torch.pipelines.edit import EditPipeline
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    from editanything_tpu_torch.pipelines.generate import GenerationPipeline
    from editanything_tpu_torch.pipelines.img2img import Img2ImgPipeline
    from editanything_tpu_torch.pipelines.sketch import SketchPipeline
    rng = np.random.default_rng(9)
    noise = {shape: rng.standard_normal(shape).astype(np.float32)
             for shape in ((2, 8, 8, 4), (2, 16, 16, 4))}
    image, cond = _checker_image(64, 64), _checker_image(64, 64)[::-1]
    mask = _square_mask(64, 16, 48)
    common = dict(prompt="a red cat", num_samples=2, image_resolution=64,
                  num_steps=4, guidance_scale=9.0, noise=noise[2, 8, 8, 4])

    def tiled(pipe):
        pipe.vae_oneshot_max_px, pipe.vae_tile_latent = 32, 4
        pipe.vae_tile_overlap = 2
        return pipe

    def process(b):
        tiles, results, _, _ = EditAnythingEditor(b).process(
            image=image, mask=mask, condition_image=cond, prompt="a red cat",
            num_samples=2, image_resolution=64, ddim_steps=4, scale=9.0,
            alignment_ratio=0.75, enable_tile=True,
            refine_image_resolution=128, noise=noise[2, 8, 8, 4],
            tile_noise=noise[2, 16, 16, 4])
        check(len(tiles) == 2 and tiles[0].shape == (128, 128, 3),
              "process(enable_tile=True) returned no 128^2 tile results")
        return np.concatenate([np.stack(tiles).ravel(),
                               np.stack(results).ravel()])
    return {
        "tile_refine 64^2 -> 128^2": lambda b: np.stack(
            EditPipeline(b).tile_refine(
                np.stack([image, cond]), mask, "sharp detail", num_steps=4,
                refine_image_resolution=128, guidance_scale=7.0,
                alignment_ratio=0.9, noise=noise[2, 16, 16, 4])),
        "process(enable_tile=True)": process,
        "img2img": lambda b: Img2ImgPipeline(b)(
            image=image, condition_image=cond, strength=0.6,
            **dict(common, num_steps=5)),
        "sketch": lambda b: SketchPipeline(b)(
            sketch=palette_sketch(64, 3), **common),
        "txt2img, tiled VAE": lambda b: tiled(GenerationPipeline(b))(
            condition_image=cond, **common),
        "edit, tiled VAE": lambda b: tiled(EditPipeline(b))(
            image=image, mask=mask, condition_image=cond,
            alignment_ratio=0.75, **common),
    }


def phase_tiny_hires_parity():
    """Each of ``tiny_hires_cases`` in fp32 on the GPU (kernels) against
    the CPU (plain twins), the same weights and noises; images within
    TINY_IMAGE_LEVELS, and kernels B and A launched on the GPU."""
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.core import kernels as K
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    for case, fn in tiny_hires_cases().items():
        outs = {}
        for device in ("cpu", "cuda"):
            b = random_bundle(tiny=True, device="cpu",
                              controlnet_names=("sam", "inpaint", "tile"),
                              generator=torch.Generator().manual_seed(1))
            before = FA.flash_attention.launches, K.group_norm_silu.launches
            outs[device] = fn(b.to(device))
            launched = (FA.flash_attention.launches - before[0],
                        K.group_norm_silu.launches - before[1])
        err = int(np.abs(outs["cuda"].astype(np.int32)
                         - outs["cpu"].astype(np.int32)).max())
        print(f"[parity] tiny {case}, fp32, CUDA (kernels) vs CPU (plain "
              f"twins): output {outs['cuda'].shape}, images max diff {err} <= "
              f"{TINY_IMAGE_LEVELS} levels; flash_attention {launched[0]}, "
              f"group_norm_silu {launched[1]} launches")
        check(outs["cuda"].dtype == np.uint8, f"tiny {case}: not uint8")
        check(err <= TINY_IMAGE_LEVELS, f"tiny {case}: images differ by {err}")
        check(min(launched) > 0, f"tiny {case}: launches {launched}")


def phase_sam_parity():
    """A small SAM with the published decoder widths (random weights, seed
    2) on a 128^2 image: the 4x4-point AMG with the filters open and one
    click, in fp32 on the GPU (kernels) against the CPU (plain twins), and
    in bf16 on the GPU at most twice as far from the fp32 CPU run as the
    bf16 CPU run is."""
    from editanything_tpu_torch.core import kernels as K
    from editanything_tpu_torch.models.sam import SAMConfig, preprocess
    from editanything_tpu_torch.perception import amg as A
    from editanything_tpu_torch.perception.predictor import SamPredictor
    from editanything_tpu_torch.pipelines.bundle import random_sam
    cfg = SAMConfig(**SMALL_SAM)
    amg_cfg = A.AMGConfig(points_per_side=4, points_per_batch=16,
                          pred_iou_thresh=-10.0, stability_score_thresh=-1.0,
                          max_masks=16)
    img = np.random.default_rng(9).integers(0, 256, (128, 128, 3), np.uint8)

    def run(device, dtype):
        sam = random_sam(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(2))
        sam = sam.to(device=device, dtype=dtype).eval()
        with torch.inference_mode():
            x = preprocess(torch.from_numpy(img).to(device), cfg).to(dtype)
            emb = sam.image_encoder(x)
            pts = torch.from_numpy(A._grid_points(amg_cfg, 128, 128)).to(device)
            logits, iou = A.decode_candidates(sam, amg_cfg, emb, pts)
            keep = A.select_candidates(logits, iou, amg_cfg)["valid"]
        pred = SamPredictor(sam, cfg)
        pred.set_image(img)
        mask, _, low = pred.predict(point_coords=[[40, 70]], point_labels=[1],
                                    multimask_output=False)
        return (logits.float().cpu().numpy(), iou.float().cpu().numpy(),
                keep.cpu().numpy(), low, mask)

    before = (K.sam_twoway.launches, K.sam_upscale_hyper.launches)
    runs = {"cpu fp32": ("cpu", torch.float32), "gpu fp32": ("cuda", torch.float32),
            "cpu bf16": ("cpu", torch.bfloat16), "gpu bf16": ("cuda", torch.bfloat16)}
    outs = {name: run(*key) for name, key in runs.items()}
    check(K.sam_twoway.launches > before[0]
          and K.sam_upscale_hyper.launches > before[1],
          "the small SAM did not launch the decoder kernels")

    def dist(a, b):   # candidate logits, IoUs, click logits: max abs diff
        return tuple(float(np.abs(outs[a][i] - outs[b][i]).max())
                     for i in (0, 1, 3))
    lg, io, cl = dist("gpu fp32", "cpu fp32")
    scale = float(np.abs(outs["cpu fp32"][0]).max())
    same_keep = bool((outs["cpu fp32"][2] == outs["gpu fp32"][2]).all())
    print(f"[parity] small SAM fp32, CUDA (kernels) vs CPU (plain twins): "
          f"candidate logits {lg:.3e}, IoUs {io:.3e}, click logits {cl:.3e} "
          f"<= {SMALL_SAM_F32_TOL:g} (|logits| <= {scale:.2f}); keep flags "
          f"{'equal' if same_keep else 'DIFFER'}")
    check(max(lg, io, cl) <= SMALL_SAM_F32_TOL, "small SAM fp32 parity")
    check(same_keep, "small SAM keep flags differ")
    near = np.abs(outs["cpu fp32"][3]) <= SMALL_SAM_F32_TOL
    differ = outs["cpu fp32"][4] != outs["gpu fp32"][4]
    check(not (differ & ~near).any(), "click masks differ away from the threshold")
    k = dist("gpu bf16", "cpu fp32")
    c = dist("cpu bf16", "cpu fp32")
    print(f"[parity] small SAM bf16 against the fp32 CPU run: CUDA (kernels) "
          f"logits {k[0]:.3e}, IoUs {k[1]:.3e}, click {k[2]:.3e}; CPU (plain "
          f"twins) {c[0]:.3e}, {c[1]:.3e}, {c[2]:.3e}; bound "
          f"{TINY_BF16_RATIO:g}x the CPU's")
    for name, a, b in zip(("logits", "IoUs", "click logits"), k, c):
        check(a <= TINY_BF16_RATIO * b,
              f"small SAM bf16 {name}: {a} > {TINY_BF16_RATIO} x {b}")


def reference_args() -> dict:
    """The reference-only arguments of phase 4c's reference requests
    (``EditPipeline`` and ``process`` take the same names): the attention
    and AdaIN hooks, style fidelity 0.5, the FFT mix at 0.4, the ragged
    reference mask over another ID map."""
    return dict(ref_image=_id_map(512, 512, 5)[:, ::-1],
                ref_mask=ragged_ref_mask(512), ref_prompt="a blue cat",
                reference_attn=True, reference_adain=True,
                style_fidelity=0.5, ref_scale=0.4)


def full_width_request() -> dict:
    """EditPipeline arguments of a 512^2 request at the reference UI's
    default point (2 samples, 30 UniPC steps, CFG 9)."""
    return dict(image=_checker_image(512, 512),
                mask=_square_mask(512, 128, 384),
                prompt="a red cat sitting on a sofa",
                condition_image=_id_map(512, 512, 3),
                negative_prompt="blurry, low quality", num_samples=2,
                image_resolution=512, num_steps=30, guidance_scale=9.0,
                control_scale=0.5)


def launch_counters():
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.core import kernels as K
    return (FA.flash_attention, K.group_norm_silu, K.sam_twoway,
            K.sam_upscale_hyper, K.resnet_fused)


def step_inputs(context_dim: int, seed: int):
    """Inputs of one full-width denoise step at 512^2 with 2 samples under
    CFG: latents (4, 4, 64, 64), t = 500, a 77-token context and both
    ControlNets' conditions."""
    g = torch.Generator("cuda").manual_seed(seed)
    lat = torch.randn(4, 4, 64, 64, generator=g, device="cuda")
    ctx = torch.randn(4, 77, context_dim, generator=g, device="cuda")
    conds = [torch.rand(4, 3, 512, 512, generator=g, device="cuda")
             for _ in range(2)]
    t = torch.full((4,), 500, dtype=torch.int32, device="cuda")
    return lat, t, ctx, conds


def denoise_step(unet, cns, inputs, dtype):
    """Both ControlNets (scales 0.5, 1.0) and the UNet at one timestep;
    the model output in fp32."""
    from editanything_tpu_torch.models import controlnet as CN
    lat, t, ctx, conds = inputs
    with torch.inference_mode():
        down, mid = CN.multi_controlnet_apply(
            cns, lat.to(dtype), t, ctx.to(dtype),
            [c.to(dtype) for c in conds], [0.5, 1.0])
        return unet(lat.to(dtype), t, ctx.to(dtype),
                    down_block_residuals=down,
                    mid_block_residual=mid).float()


def fp32_step(bundle, inputs):
    """The same step with fp32 copies of the bundle's bf16 weights."""
    import copy
    cns = bundle.controlnet_modules(("sam", "inpaint"))
    unet32 = copy.deepcopy(bundle.unet).float()
    want = denoise_step(unet32, [copy.deepcopy(c).float() for c in cns],
                        inputs, torch.float32)
    del unet32
    torch.cuda.empty_cache()
    return want


def denoise_step_check(bundle):
    """One full-width denoise step (both ControlNets + the UNet, batch 4 =
    2 samples x CFG, t = 500) in bf16 with the resnets composed and fused,
    each against the same step in fp32 (the same bf16 weights, composed)."""
    inputs = step_inputs(768, 21)
    cns = bundle.controlnet_modules(("sam", "inpaint"))
    composed = denoise_step(bundle.unet, cns, inputs, torch.bfloat16)
    with_fused_resnets(True)
    fused = denoise_step(bundle.unet, cns, inputs, torch.bfloat16)
    with_fused_resnets(False)
    want = fp32_step(bundle, inputs)
    d_comp, d_fused = max_err(composed, want), max_err(fused, want)
    print(f"[full] one denoise step (UNet + 2 ControlNets, batch 4, bf16) "
          f"against the fp32 composed step: composed resnets max_abs_err "
          f"{d_comp:.3e}, fused {d_fused:.3e} <= {STEP_RATIO}x "
          f"(|eps| <= {want.abs().max().item():.2f})")
    check(d_fused <= STEP_RATIO * d_comp,
          f"fused step {d_fused} > {STEP_RATIO} x composed {d_comp}")


def phase_full_width():
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.pipelines.edit import EditPipeline
    from editanything_tpu_torch.pipelines.generate import GenerationPipeline

    t0 = time.perf_counter()
    # "tile" (phase 4d) is drawn last: the other weights are as without it
    bundle = random_bundle(tiny=False, dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0),
                           controlnet_names=("sam", "inpaint", "tile"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in [bundle.unet, bundle.vae, bundle.text]
                   + [net for _, net in bundle.controlnets.values()]
                   for p in m.parameters())
    print(f"[full] SD1.5 UNet + 3 ControlNets (sam, inpaint, tile) + VAE + "
          f"CLIP-L, bf16, random "
          f"weights (seed 0): {n_params / 1e9:.3f} B parameters, "
          f"built in {time.perf_counter() - t0:.1f} s")
    denoise_step_check(bundle)
    pipe = EditPipeline(bundle, controls=("sam", "inpaint"), inpaint_mode="blend")
    request = full_width_request()
    counters = launch_counters()

    def one(seed, fused):
        """(seconds, peak bytes, launches) of one request."""
        with_fused_resnets(fused)
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = pipe(**request, generator=torch.Generator("cuda").manual_seed(seed))
        seconds = time.perf_counter() - t          # the result is on the host
        with_fused_resnets(False)
        check(out.shape == (2, 512, 512, 3) and out.dtype == np.uint8,
              f"edit returned {out.shape} {out.dtype}")
        check(pipe.last_nonfinite == 0,
              f"{pipe.last_nonfinite} non-finite values before the uint8 cast")
        return (seconds, torch.cuda.max_memory_allocated(),
                {fn.__name__: fn.launches for fn in counters})

    for fused in (False, True):
        print(f"[full] warm-up request, resnets "
              f"{'fused' if fused else 'composed'}: {one(100, fused)[0]:.3f} s")
    runs = {False: [], True: []}
    for r in range(FULL_WIDTH_REQUESTS):
        for fused in (False, True):        # in turns
            runs[fused].append(one(101 + r, fused))
    for fused, results in runs.items():
        mode = "fused (EA_RESNET_FUSED=1)" if fused else "composed"
        times = [x[0] for x in results]
        launches = results[0][2]
        print(f"[full] edit-only requests, resnets {mode}: "
              + " / ".join(f"{t:.3f}" for t in times)
              + f" s (512^2, supplied condition map, 2 samples, 30 steps, CFG "
              f"9); mean {sum(times) / len(times):.3f} s; peak memory "
              f"{max(x[1] for x in results) / 2**30:.2f} GiB "
              f"(torch.cuda.max_memory_allocated); launches per request "
              f"{launches}")
        check(all(x[2] == launches for x in results),
              "launch counts differ between requests")
        for name in ("flash_attention", "group_norm_silu"):
            check(launches[name] > 0, f"{name} was not launched on the edit path")
        check((launches["resnet_fused"] > 0) == fused,
              f"resnet_fused launched {launches['resnet_fused']} times, "
              f"resnets {mode}")

    gen = GenerationPipeline(bundle, controlnet="sam")
    with_fused_resnets(True)
    before = counters[-1].launches
    out, seconds = _synced(gen, prompt="a red cat sitting on a sofa",
                           condition_image=_id_map(512, 512, 3),
                           negative_prompt="blurry, low quality",
                           num_samples=2, image_resolution=512, num_steps=30,
                           guidance_scale=9.0,
                           generator=torch.Generator("cuda").manual_seed(300))
    with_fused_resnets(False)
    n_resnet = counters[-1].launches - before
    print(f"[full] txt2img request, resnets fused (512^2, 1 ControlNet, 2 "
          f"samples, 30 steps, CFG 9): {seconds:.3f} s; {n_resnet} resnet_fused "
          f"launches")
    check(out.shape == (2, 512, 512, 3) and out.dtype == np.uint8
          and gen.last_nonfinite == 0, f"txt2img returned {out.shape} "
          f"{out.dtype}, {gen.last_nonfinite} non-finite values")
    check(n_resnet > 0, "txt2img did not launch resnet_fused")
    return bundle


@contextlib.contextmanager
def plain_attention():
    """Every unmasked ``layers.attention`` call through kernel B's plain
    twin while the block runs: the baseline of the SD2.1 step check. The
    port itself has no such switch; the launch counter shows that the
    kernel did not run."""
    from editanything_tpu_torch.core import layers as L
    kernel_route = L.attention
    L.attention = lambda q, k, v, *, scale=None, mask=None: \
        L.attention_reference(q, k, v, scale=scale, mask=mask)
    try:
        yield
    finally:
        L.attention = kernel_route


def sd21_step_check(bundle):
    """One SD2.1 denoise step at published widths (both ControlNets + the
    UNet, batch 4 = 2 samples x CFG, t = 500, context 1024, 64-wide heads)
    in bf16 through kernel B and through its plain twin, each against the
    same step in fp32."""
    from editanything_tpu_torch.core import flash_attention as FA
    inputs = step_inputs(1024, 23)
    cns = bundle.controlnet_modules(("sam", "inpaint"))
    before = FA.flash_attention.launches
    kernel = denoise_step(bundle.unet, cns, inputs, torch.bfloat16)
    launched = FA.flash_attention.launches - before
    with plain_attention():
        twin = denoise_step(bundle.unet, cns, inputs, torch.bfloat16)
    check(FA.flash_attention.launches == before + launched,
          "kernel B ran in the plain-twin step")
    want = fp32_step(bundle, inputs)
    d_kernel, d_twin = max_err(kernel, want), max_err(twin, want)
    print(f"[sd21] one denoise step (UNet + 2 ControlNets, batch 4, bf16, "
          f"{launched} flash_attention launches) against the fp32 step: "
          f"kernel B max_abs_err {d_kernel:.3e}, plain attention twin "
          f"{d_twin:.3e}; bound {STEP_RATIO}x the twin's (|v| <= "
          f"{want.abs().max().item():.2f})")
    check(launched > 0, "the SD2.1 step did not launch flash_attention")
    check(d_kernel <= STEP_RATIO * d_twin,
          f"SD2.1 step with kernel B {d_kernel} > {STEP_RATIO} x twin {d_twin}")


def timed_request(tag: str, what: str, owner, fn, **kwargs):
    """(uint8 images, launches) of one request ``fn(**kwargs)`` on the host
    clock, the device synchronised, every launch counter set to 0 just
    before it; prints seconds, peak memory, the launches of kernels B and
    A, the non-finite values before the uint8 cast (``owner``'s
    ``last_nonfinite``) and the output's shape, and fails unless there are
    none and the output is (2, 512, 512, 3) uint8."""
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out, seconds = _synced(fn, **kwargs)
    launches = {c.__name__: c.launches for c in counters}
    if isinstance(out, tuple):                 # EditAnythingEditor.process
        out = np.stack(out[1])
    nonfinite = owner.last_nonfinite
    print(f"[{tag}] {what}: {seconds:.3f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"flash_attention {launches['flash_attention']}, group_norm_silu "
          f"{launches['group_norm_silu']}; {nonfinite} non-finite values; "
          f"output {out.shape} {out.dtype}")
    check(out.shape == (2, 512, 512, 3) and out.dtype == np.uint8,
          f"{what}: returned {out.shape} {out.dtype}")
    check(nonfinite == 0, f"{what}: {nonfinite} non-finite values")
    for name in ("flash_attention", "group_norm_silu"):
        check(launches[name] > 0, f"{what}: {name} was not launched")
    return out, launches


def phase_full_width_modes() -> dict:
    """The rest of the edit surface at published widths, bf16, random
    weights from seed 0: SD2.1 (one denoise step against fp32, then two
    requests through ``EditAnythingEditor.process`` with a supplied
    condition map) and the 9-channel SD1.5 inpainting UNet (one request
    through ``EditPipeline``), each after a warm-up request, MODE_REQUESTS
    timed requests of each case in turns. Returns each case's launches per
    request."""
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.pipelines.edit import EditPipeline
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor

    def build(family, what):
        t0 = time.perf_counter()
        b = random_bundle(tiny=False, dtype=torch.bfloat16, device="cuda",
                          family=family,
                          generator=torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        n = sum(p.numel() for m in [b.unet, b.vae, b.text]
                + [net for _, net in b.controlnets.values()]
                for p in m.parameters())
        print(f"[{family}] {what}, bf16, random weights (seed 0): "
              f"{n / 1e9:.3f} B parameters, built in "
              f"{time.perf_counter() - t0:.1f} s")
        return b

    launches = {}
    b21 = build("sd21", "SD2.1 UNet + 2 ControlNets + VAE + OpenCLIP-H text "
                "tower (23 layers), v-prediction")
    sd21_step_check(b21)
    editor = EditAnythingEditor(b21)
    request = dict(image=_checker_image(512, 512),
                   mask=_square_mask(512, 128, 384),
                   prompt="a red cat sitting on a sofa", a_prompt="best quality",
                   n_prompt="blurry, low quality",
                   condition_image=_id_map(512, 512, 3), num_samples=2,
                   image_resolution=512, ddim_steps=30, scale=9.0,
                   control_scale=0.5)
    cases = [("sd21 ddim eta 0.5, scale map, alpha mixing 0.5",
              dict(sampler="ddim", eta=0.5, use_scale_map=True,
                   use_alpha_mixing=True, alpha_weight=0.5)),
             ("sd21 unipc, guess mode, blend", dict(guess_mode=True))]
    seconds = _synced(editor.process, **request, **cases[0][1], seed=400,
                      generator=torch.Generator("cuda").manual_seed(400))[1]
    print(f"[sd21] warm-up request: {seconds:.3f} s")
    for r in range(MODE_REQUESTS):
        for c, (what, kw) in enumerate(cases):          # in turns
            seed = 401 + 2 * r + c
            counts = timed_request(
                "sd21", f"{what}, process, 512^2, 2 samples, 30 steps, CFG 9",
                editor, editor.process, **request, **kw, seed=seed,
                generator=torch.Generator("cuda").manual_seed(seed))[1]
            check(launches.setdefault(what, counts) == counts,
                  f"{what}: launch counts differ between requests")
    del editor, b21
    torch.cuda.empty_cache()

    b9 = build("sd15_inpaint", "SD1.5 inpainting UNet (9 input channels) + "
               "2 ControlNets + VAE + CLIP-L")
    pipe = EditPipeline(b9, controls=("sam", "inpaint"), inpaint_mode="unet9")
    edit = full_width_request()
    seconds = _synced(pipe, **edit,
                      generator=torch.Generator("cuda").manual_seed(410))[1]
    print(f"[sd15_inpaint] warm-up request: {seconds:.3f} s")
    what = "sd15 unet9"
    for r in range(MODE_REQUESTS):
        counts = timed_request(
            "sd15_inpaint", f"{what}, EditPipeline, 512^2, 2 samples, 30 "
            "UniPC steps, CFG 9", pipe, pipe, **edit,
            generator=torch.Generator("cuda").manual_seed(411 + r))[1]
        check(launches.setdefault(what, counts) == counts,
              f"{what}: launch counts differ between requests")
    del pipe, b9
    torch.cuda.empty_cache()
    return launches


def transformer_blocks(cfg) -> tuple:
    """(UNet encoder + mid, UNet decoder, one ControlNet) transformer blocks
    of a UNetConfig: each launches kernel B twice a pass (self, cross)."""
    down = sum(cfg.layers_per_block for t in cfg.down_block_types
               if t == "CrossAttnDownBlock2D")
    up = sum(cfg.layers_per_block + 1 for t in cfg.up_block_types
             if t == "CrossAttnUpBlock2D")
    return down + 1, up, down + 1


def expected_flash_launches(cfg, steps: int, *, sampler: str = "unipc",
                            encoder_interval: int = 1,
                            reference: bool = False, sam_layers: int = 0,
                            checker_layers: int = 0) -> int:
    """Kernel B's launches in one 2-ControlNet edit request: per model
    evaluation 2 per transformer block of the UNet and both ControlNets (the
    UNet's encoder half and the ControlNets on key steps only under encoder
    caching), PLMS one evaluation more; under reference control each step
    adds the write pass (the same blocks again) and one launch per hooked
    block of the UNet and the last ControlNet (the style-fidelity recompute
    beside the read attention); the VAE's mid attention once per encode and
    decode (the image, the reference, the result); where SAM builds the ID
    map, one per encoder layer (`sam_layers`, the windows batched); where
    the bundle has a safety checker, one per tower layer
    (`checker_layers`) for the decoded batch."""
    enc, dec, cn = transformer_blocks(cfg)
    evals = steps + (sampler == "plms")
    keys = evals if encoder_interval == 1 else -(-steps // encoder_interval)
    per_pass = 2 * (enc + dec + 2 * cn)
    n = evals * 2 * dec + keys * 2 * (enc + 2 * cn)
    if reference:
        n += steps * (per_pass + enc + dec + cn)
    return n + (3 if reference else 2) + sam_layers + checker_layers


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def phase_reference_and_samplers(bundle) -> dict:
    """Phase 4c: the SD1.5 bundle at published widths (bf16) through
    ``EditAnythingEditor.process`` with a supplied condition map, 512^2, 2
    samples, 30 steps, CFG 9: reference-mode requests (attention and AdaIN,
    style fidelity 0.5, ref_scale 0.4, the ragged reference mask) in turns
    with the edit-only request; PLMS, DPM-Solver++ and singlestep order 2,
    one each after a warm-up; UniPC at encoder_interval 1, 2, 3 and 5 in
    turns, each k's images against k = 1's from the same seed (PSNR;
    random weights, so informational). Each request's kernel B launches
    must be ``expected_flash_launches``: the read attention runs on B.
    Returns each case's launches per request."""
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    editor = EditAnythingEditor(bundle)
    cfg = bundle.unet_cfg
    request = dict(image=_checker_image(512, 512),
                   mask=_square_mask(512, 128, 384),
                   prompt="a red cat sitting on a sofa", a_prompt="best quality",
                   n_prompt="blurry, low quality",
                   condition_image=_id_map(512, 512, 3), num_samples=2,
                   image_resolution=512, ddim_steps=30, scale=9.0,
                   control_scale=0.5)
    reference = reference_args()
    launches = {}

    def run(what, kw, seed, expected):
        counts = timed_request(
            "ref", f"{what}, process, 512^2, 2 samples, 30 steps, CFG 9",
            editor, editor.process, **request, **kw, seed=seed,
            generator=torch.Generator("cuda").manual_seed(seed))
        b_count = counts[1]["flash_attention"]
        print(f"[ref]   kernel B launches {b_count}, expected {expected}")
        check(b_count == expected, f"{what}: {b_count} kernel B launches, "
                                   f"expected {expected}")
        check(launches.setdefault(what, counts[1]) == counts[1],
              f"{what}: launch counts differ between requests")
        return counts[0]

    warm = _synced(editor.process, **request, **reference, seed=500,
                   generator=torch.Generator("cuda").manual_seed(500))[1]
    print(f"[ref] warm-up reference request: {warm:.3f} s")
    for r in range(REF_REQUESTS):                        # in turns
        run("reference attn + AdaIN", reference, 501 + r,
            expected_flash_launches(cfg, 30, reference=True))
        run("edit only", {}, 501 + r, expected_flash_launches(cfg, 30))

    warm = _synced(editor.process, **request, sampler="plms", seed=510,
                   generator=torch.Generator("cuda").manual_seed(510))[1]
    print(f"[ref] warm-up PLMS request: {warm:.3f} s")
    for sampler in ("plms", "dpm", "dpms2"):
        run(f"sampler {sampler}", dict(sampler=sampler), 511,
            expected_flash_launches(cfg, 30, sampler=sampler))

    images = {}
    for r in range(REF_REQUESTS):                        # in turns
        for k in ENCODER_INTERVALS:
            images[k] = run(f"unipc encoder_interval {k}",
                            dict(encoder_interval=k), 520,
                            expected_flash_launches(cfg, 30,
                                                    encoder_interval=k))
    for k in ENCODER_INTERVALS[1:]:
        print(f"[ref] encoder_interval {k}: images against k = 1 from the "
              f"same seed, PSNR {psnr(images[k], images[1]):.2f} dB "
              f"(random weights: informational)")
    del editor
    torch.cuda.empty_cache()
    return launches


def expected_pass_launches(cfg, steps: int, vae_calls: int) -> int:
    """Kernel B's launches in a one-ControlNet denoise (tile refinement,
    img2img, txt2img, sketch): 2 per transformer block of the UNet and the
    ControlNet a step, plus the VAE's mid attention once per encode and
    decode, each tile of a tiled one counted."""
    enc, dec, cn = transformer_blocks(cfg)
    return steps * 2 * (enc + dec + cn) + vae_calls


@contextlib.contextmanager
def split_timers(pipe):
    """Times each call of `pipe`'s tile pass, VAE encode, decode and
    denoise (``build_denoiser``'s loops in pipelines/edit.py), each
    synchronised, into a list of (in the tile pass?, name, seconds); the
    tile pass also records its own peak memory (GiB)."""
    from editanything_tpu_torch.pipelines import edit as E
    log, state = [], {"tile": False}

    def timed(name, fn):
        def run(*args, **kwargs):
            tile = name == "tile pass"
            if tile:
                state["tile"] = True
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            out, seconds = _synced(fn, *args, **kwargs)
            if tile:
                state["tile"] = False
                log.append((True, "tile pass peak GiB",
                            torch.cuda.max_memory_allocated() / 2**30))
            log.append((state["tile"] or tile, name, seconds))
            return out
        return run
    build = E.build_denoiser
    E.build_denoiser = lambda *a, **kw: timed("denoise", build(*a, **kw))
    pipe.tile_refine = timed("tile pass", pipe.tile_refine)
    pipe._encode = timed("encode", pipe._encode)
    pipe.decode = timed("decode", pipe.decode)
    try:
        yield log
    finally:
        E.build_denoiser = build
        for name in ("tile_refine", "_encode", "decode"):
            delattr(pipe, name)


def phase_high_resolution(bundle) -> dict:
    """Phase 4d: the SD1.5 bundle (with its "tile" ControlNet) at published
    widths through the high-resolution entry points: the one-shot hint
    stack at 4096^2 (peak memory); ``process(enable_tile=True)`` at the
    UI's defaults (512^2, 2 samples, 30 UniPC steps, CFG 9, refine to
    1024^2 at alignment 0.95), a warm-up and a timed request split into the
    edit and the tile pass's encode, denoise and decode; one request
    refined to 2304^2 (1 sample, 2 steps), above the one-shot bound, so its
    encode and decode run in 3 x 3 tiles; one img2img (strength 0.75, 22
    of 30 steps, the SAM ControlNet) and one sketch (its scale map) at
    512^2. Each request's kernel B launches must be what its path
    predicts. Returns each case's launches per request."""
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    from editanything_tpu_torch.pipelines.img2img import Img2ImgPipeline
    from editanything_tpu_torch.pipelines.sketch import SketchPipeline
    cfg = bundle.unet_cfg
    launches = {}

    # the tiled hint stack is ported only if the one-shot one cannot take
    # 4096^2 (2 samples) on this card
    net = bundle.controlnets["tile"][1]
    g = torch.Generator("cuda").manual_seed(40)
    hint_in = torch.rand(HINT_STACK_SHAPE, generator=g,
                         device="cuda").to(bundle.dtype)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        emb, seconds = _synced(net.hint_embedding, hint_in)
    print(f"[hires] one-shot hint stack {HINT_STACK_SHAPE} {bundle.dtype} -> "
          f"{tuple(emb.shape)}: {seconds:.4f} s; peak memory above its input "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    n, _, hh, ww = HINT_STACK_SHAPE
    want = (n, cfg.block_out_channels[0], hh // 8, ww // 8)
    check(tuple(emb.shape) == want and bool(torch.isfinite(emb).all()),
          f"hint stack returned {tuple(emb.shape)}")
    del hint_in, emb
    torch.cuda.empty_cache()

    editor = EditAnythingEditor(bundle)
    check(editor.tile_control == "tile", "the editor found no tile ControlNet")
    pipe = editor.pipe
    side, refine, big = HIRES_SIDES
    request = dict(image=_checker_image(side, side),
                   mask=_square_mask(side, side // 4, 3 * side // 4),
                   prompt="a red cat sitting on a sofa", a_prompt="best quality",
                   n_prompt="blurry, low quality",
                   condition_image=_id_map(side, side, 3), num_samples=2,
                   image_resolution=side, ddim_steps=30, scale=9.0,
                   control_scale=0.5, enable_tile=True,
                   refine_image_resolution=refine, refine_alignment_ratio=0.95)

    def tile_request(what, kw, seed, tile_side, samples, steps, vae_tiles):
        counters = launch_counters()
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with split_timers(pipe) as log:
            (tiles, results, _, _), seconds = _synced(
                editor.process, **dict(request, **kw), seed=seed,
                generator=torch.Generator("cuda").manual_seed(seed))
        counts = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        tiles, results = np.stack(tiles), np.stack(results)
        parts = {}
        for in_tile, name, value in log:
            key = ("tile " if in_tile else "edit ") + name
            parts[key] = parts.get(key, 0.0) + value
        expected = (expected_flash_launches(cfg, steps)
                    + expected_pass_launches(cfg, steps, 2 * vae_tiles))
        rest = parts["tile tile pass"] - sum(
            parts[f"tile {name}"] for name in ("encode", "denoise", "decode"))
        print(f"[hires] {what}: {seconds:.3f} s, of which the edit "
              f"{seconds - parts['tile tile pass']:.3f} s (encode "
              f"{parts['edit encode']:.3f}, denoise {parts['edit denoise']:.3f}, "
              f"decode {parts['edit decode']:.3f}) and the tile pass "
              f"{parts['tile tile pass']:.3f} s (encode {parts['tile encode']:.3f}"
              f", denoise {parts['tile denoise']:.3f}, decode "
              f"{parts['tile decode']:.3f}, the rest {rest:.3f}: the upscale, "
              f"prompts, conditions); peak memory {peak:.2f} GiB, of the tile pass "
              f"{parts['tile tile pass peak GiB']:.2f} GiB; launches "
              f"flash_attention {counts['flash_attention']} (expected "
              f"{expected}), group_norm_silu {counts['group_norm_silu']}; "
              f"{editor.last_nonfinite} non-finite values; outputs "
              f"{tiles.shape} {tiles.dtype} and {results.shape}")
        check(tiles.shape == (samples, tile_side, tile_side, 3)
              and tiles.dtype == np.uint8,
              f"{what}: tile results {tiles.shape} {tiles.dtype}")
        check(results.shape == (samples, side, side, 3),
              f"{what}: results {results.shape}")
        check(editor.last_nonfinite == 0,
              f"{what}: {editor.last_nonfinite} non-finite values")
        check(counts["flash_attention"] == expected,
              f"{what}: {counts['flash_attention']} kernel B launches, "
              f"expected {expected}")
        check(counts["group_norm_silu"] > 0, f"{what}: kernel A not launched")
        launches[what] = counts
        return seconds

    what = (f"tile refinement {refine}^2, process, {side}^2, 2 samples, 30 "
            f"steps, CFG 9")
    check(pipe._decode_tile_spec(refine, refine) is None,
          f"{refine}^2 decodes tiled")
    print(f"[hires] warm-up request: "
          f"{tile_request(what, {}, 600, refine, 2, 30, 1):.3f} s")
    tile_request(what, {}, 601, refine, 2, 30, 1)
    what = f"tile refinement {big}^2, process, 1 sample, 2 steps"
    check(pipe._decode_tile_spec(big, big) == (128, 32),
          f"{big}^2 does not decode tiled")
    tile_request(what, dict(num_samples=1, ddim_steps=2,
                            refine_image_resolution=big), 602, big, 1, 2,
                 HIRES_BIG_VAE_TILES)
    del editor, pipe
    torch.cuda.empty_cache()

    img2img = Img2ImgPipeline(bundle, controlnet="sam")
    what = "img2img, strength 0.75 (22 of 30 steps), SAM ControlNet"
    counts = timed_request(
        "hires", f"{what}, {side}^2, 2 samples, CFG 9", img2img, img2img,
        image=_checker_image(side, side), prompt="a red cat sitting on a sofa",
        strength=0.75, condition_image=_id_map(side, side, 3),
        negative_prompt="blurry, low quality", num_samples=2,
        image_resolution=side, num_steps=30, guidance_scale=9.0,
        control_scale=0.5, generator=torch.Generator("cuda").manual_seed(610))[1]
    check(counts["flash_attention"] == expected_pass_launches(cfg, 22, 2),
          f"{what}: {counts['flash_attention']} kernel B launches")
    launches[what] = counts

    sketch = SketchPipeline(bundle, controlnet="sam")
    what = "sketch, scale map, 30 steps"
    counts = timed_request(
        "hires", f"{what}, {side}^2, 2 samples, CFG 9", sketch.gen, sketch,
        sketch=palette_sketch(side, 4), prompt="a garden with a pond",
        negative_prompt="blurry, low quality", num_samples=2,
        image_resolution=side, num_steps=30, guidance_scale=9.0,
        generator=torch.Generator("cuda").manual_seed(620))[1]
    check(counts["flash_attention"] == expected_pass_launches(cfg, 30, 1),
          f"{what}: {counts['flash_attention']} kernel B launches")
    launches[what] = counts
    torch.cuda.empty_cache()
    return launches


# phase 4e: the public SD1.5 v1-inference.yaml (CompVis stable-diffusion,
# configs/stable-diffusion/v1-inference.yaml), the fields it sets, as the
# dict its parse gives, so that the card needs no yaml package
SD15_V1_INFERENCE = {"model": {
    "base_learning_rate": 1.0e-04,
    "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
    "params": {
        "linear_start": 0.00085, "linear_end": 0.0120,
        "num_timesteps_cond": 1, "log_every_t": 200, "timesteps": 1000,
        "first_stage_key": "jpg", "cond_stage_key": "txt",
        "image_size": 64, "channels": 4, "cond_stage_trainable": False,
        "conditioning_key": "crossattn", "monitor": "val/loss_simple_ema",
        "scale_factor": 0.18215, "use_ema": False,
        "unet_config": {
            "target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
            "params": {"image_size": 32, "in_channels": 4, "out_channels": 4,
                       "model_channels": 320,
                       "attention_resolutions": [4, 2, 1],
                       "num_res_blocks": 2, "channel_mult": [1, 2, 4, 4],
                       "num_heads": 8, "use_spatial_transformer": True,
                       "transformer_depth": 1, "context_dim": 768,
                       "use_checkpoint": True, "legacy": False}},
        "first_stage_config": {
            "target": "ldm.models.autoencoder.AutoencoderKL",
            "params": {"embed_dim": 4, "monitor": "val/rec_loss",
                       "ddconfig": {"double_z": True, "z_channels": 4,
                                    "resolution": 256, "in_channels": 3,
                                    "out_ch": 3, "ch": 128,
                                    "ch_mult": [1, 2, 4, 4],
                                    "num_res_blocks": 2,
                                    "attn_resolutions": [], "dropout": 0.0},
                       "lossconfig": {"target": "torch.nn.Identity"}}},
        "cond_stage_config": {
            "target": "ldm.modules.encoders.modules.FrozenCLIPEmbedder"}}}}
CKPT_LORA_RANK = 4
CKPT_LORA_ALPHA = 2.0
CKPT_LORA_MULTIPLIER = 0.5
CKPT_LORA_SAMPLES = 5
CKPT_TI_VECTORS = 2
# free disk beyond the bytes to write
CKPT_DISK_MARGIN = 2 ** 30


def lora_targets(unet, text) -> list:
    """(kohya name, weight shape) of every target of the reference's LoRAs:
    each Linear and 1x1 conv of the UNet's transformer blocks (kohya's
    Transformer2DModel targets: proj_in/out, attn1/attn2 q/k/v/out, the
    FFN) and of the text tower's CLIPAttention and CLIPMLP."""
    out = []
    for name, m in unet.named_modules():
        if ".attentions." in name and isinstance(m, (torch.nn.Linear,
                                                     torch.nn.Conv2d)):
            out.append(("lora_unet_" + name.replace(".", "_"),
                        tuple(m.weight.shape)))
    for name, m in text.named_modules():
        if isinstance(m, torch.nn.Linear) and (".self_attn." in name
                                                or ".mlp." in name):
            out.append(("lora_te_text_model_" + name.replace(".", "_"),
                        tuple(m.weight.shape)))
    return out


def kohya_lora(targets, g) -> dict:
    """A rank-CKPT_LORA_RANK kohya state dict in fp16 over `targets`: down
    N(0, 1/in), up N(0, 0.05^2), alpha CKPT_LORA_ALPHA; conv targets take
    (r, in, 1, 1) and (out, r, 1, 1) factors."""
    sd = {}
    r = CKPT_LORA_RANK
    for name, shape in targets:
        tail = (1, 1) if len(shape) == 4 else ()
        down = torch.randn((r, shape[1]) + tail, generator=g, device="cuda")
        sd[f"{name}.lora_down.weight"] = (down / shape[1] ** 0.5).half()
        sd[f"{name}.lora_up.weight"] = (0.05 * torch.randn(
            (shape[0], r) + tail, generator=g, device="cuda")).half()
        sd[f"{name}.alpha"] = torch.tensor(CKPT_LORA_ALPHA,
                                           dtype=torch.float16)
    return sd


def loaded_mismatches(module, source: dict, cast, skip=()) -> list:
    """Names whose loaded tensor differs from `cast(source tensor)`."""
    return [k for k, v in module.state_dict().items()
            if k not in skip and not torch.equal(v, cast(source[k]))]


def phase_checkpoints(bundle) -> dict:
    """Phase 4e: the SD1.5 bundle's UNet, VAE and text tower written as an
    LDM single file (fp16), its "sam" and "inpaint" ControlNets, a second
    "sam" ControlNet and a safety checker as diffusers/HF ``.safetensors``
    (fp16), SAM ViT-H as its official ``.pth`` (fp32), a kohya LoRA and a
    TI embedding, all into a temporary directory removed at the end; the
    bundle loaded back in bf16 through ``load_ldm_bundle`` and SAM through
    ``load_sam``; every loaded tensor held against what was written; then
    a warm-up and a timed ``process`` that swaps the condition model,
    loads the TI embedding and passes the safety checker. Returns the
    request's launches."""
    import importlib.util
    import shutil
    import tempfile
    from editanything_tpu_torch.checkpoints import ldm as LDM
    from editanything_tpu_torch.checkpoints.lora import (lora_delta,
                                                         resolve_lora_target)
    from editanything_tpu_torch.checkpoints.safetensors_io import save_file
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models import sam as SAM
    from editanything_tpu_torch.models.controlnet import ControlNetModel
    from editanything_tpu_torch.models.safety import CLIPVisionConfig
    from editanything_tpu_torch.pipelines.bundle import (_empty, init_weights_,
                                                         load_sam,
                                                         random_safety_checker,
                                                         random_sam)
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    from editanything_tpu_torch.text.tokenizer import tiny_tokenizer

    t_phase = time.perf_counter()
    found = {name: importlib.util.find_spec(name) is not None
             for name in ("yaml", "safetensors", "PIL")}
    print(f"[ckpt] importable on this machine (not imported): {found}")
    bf16, fp16 = torch.bfloat16, torch.float16
    half = lambda t: t.to(fp16)
    as_loaded = lambda t: t.to(fp16).to(bf16)
    g = torch.Generator("cuda").manual_seed(40)
    t0 = time.perf_counter()
    swap = init_weights_(_empty(ControlNetModel, C.ControlNetConfig(
        unet=bundle.unet_cfg), torch.device("cuda"), bf16), g)
    safety_cfg = CLIPVisionConfig()
    checker = random_safety_checker(safety_cfg, device="cuda", dtype=bf16,
                                    generator=g).model
    sam_cfg = SAM.sam_vit_h()
    sam = random_sam(sam_cfg, device="cuda", dtype=torch.float32,
                     generator=g)
    targets = lora_targets(bundle.unet, bundle.text)
    lora = kohya_lora(targets, g)
    ti = torch.randn(CKPT_TI_VECTORS, bundle.text_cfg.hidden_size,
                     generator=g, device="cuda").cpu()
    torch.cuda.synchronize()
    print(f"[ckpt] drew a second SAM ControlNet, the safety checker "
          f"(ViT-L/14, {safety_cfg.num_concepts} + {safety_cfg.num_special} "
          f"concepts), SAM ViT-H (fp32), a rank-{CKPT_LORA_RANK} LoRA over "
          f"{len(targets)} targets and a {CKPT_TI_VECTORS}-vector TI "
          f"embedding in {time.perf_counter() - t0:.1f} s")

    ldm = LDM.state_dicts_to_ldm(
        unet={k: half(v) for k, v in bundle.unet.state_dict().items()},
        vae={k: half(v) for k, v in bundle.vae.state_dict().items()},
        text={k: half(v) for k, v in bundle.text.state_dict().items()})
    ldm["cond_stage_model.transformer.text_model.embeddings.position_ids"] = \
        torch.arange(bundle.text_cfg.max_position_embeddings)[None]
    cns = {name: bundle.controlnets[name][1] for name in ("sam", "inpaint")}
    cns["swap"] = swap
    files = {
        "sd15 ldm .safetensors": ("v1-5-pruned-emaonly.safetensors", ldm),
        **{f"controlnet {name}": (f"controlnet_{name}.safetensors",
                                  {k: half(v) for k, v in
                                   net.state_dict().items()})
           for name, net in cns.items()},
        "safety checker": ("safety_checker.safetensors", {
            ("vision_model." + k if k.startswith("vision_model.") else k):
                half(v) for k, v in checker.state_dict().items()}),
        "lora": ("kohya_lora.safetensors", lora),
    }
    sam_sd = {k: v.cpu() for k, v in sam.state_dict().items()}
    need = (sum(t.numel() * t.element_size() for _, sd in files.values()
                for t in sd.values())
            + sum(t.numel() * t.element_size() for t in sam_sd.values()))
    tmp = tempfile.mkdtemp(prefix="ea_ckpt_")
    try:
        usage = shutil.disk_usage(tmp)
        print(f"[ckpt] {need / 2**30:.2f} GiB to write into {tmp}; disk "
              f"total {usage.total / 2**30:.1f} GiB, free "
              f"{usage.free / 2**30:.1f} GiB")
        check(usage.free > need + CKPT_DISK_MARGIN,
              f"{usage.free} bytes free, {need} to write")
        paths = {}
        t0 = time.perf_counter()
        for what, (name, sd) in files.items():
            paths[what] = os.path.join(tmp, name)
            save_file(sd, paths[what])
        paths["sam"] = os.path.join(tmp, "sam_vit_h_4b8939.pth")
        torch.save(sam_sd, paths["sam"])
        paths["ti"] = os.path.join(tmp, "learned_embeds.bin")
        torch.save({"<new-obj>": ti}, paths["ti"])
        written = sum(os.path.getsize(p) for p in paths.values())
        print(f"[ckpt] wrote {written} bytes ({written / 2**30:.2f} GiB) in "
              f"{time.perf_counter() - t0:.1f} s: "
              + ", ".join(f"{os.path.basename(p)} {os.path.getsize(p)}"
                          for p in paths.values()))
        del ldm, files, sam_sd

        (lb, cfgs), seconds = _synced(
            LDM.load_ldm_bundle, SD15_V1_INFERENCE,
            paths["sd15 ldm .safetensors"],
            tokenizer=tiny_tokenizer(
                context_length=bundle.text_cfg.max_position_embeddings),
            dtype=bf16, device="cuda",
            controlnet_paths={"sam": paths["controlnet sam"],
                              "inpaint": paths["controlnet inpaint"]},
            safety_path=paths["safety checker"], safety_cfg=safety_cfg,
            lora_specs=[(paths["lora"], CKPT_LORA_MULTIPLIER)])
        print(f"[ckpt] load_ldm_bundle (the LDM file, 2 ControlNets, the "
              f"safety checker, the LoRA merged at {CKPT_LORA_MULTIPLIER}): "
              f"{seconds:.1f} s")
        loaded_sam, seconds = _synced(load_sam, paths["sam"], sam_cfg,
                                      device="cuda", dtype=bf16)
        print(f"[ckpt] load_sam (ViT-H, fp32 file -> bf16): {seconds:.1f} s")
        for name in ("unet", "vae", "text"):
            check(cfgs[name] == getattr(bundle, f"{name}_cfg"),
                  f"v1-inference.yaml's {name} config differs from SD1.5's")

        # what loaded: every tensor the written one cast to bf16
        counts = lb.lora_counts[0][2]
        print(f"[ckpt] LoRA: {counts} of {len(targets)} targets written")
        check(counts == {"merged": len(targets), "skipped": 0},
              f"LoRA merged {counts}, {len(targets)} targets written")
        modules = {"unet": lb.unet, "text_encoder": lb.text}
        lora_weights = {
            "unet": {n[len("lora_unet_"):] for n, _ in targets
                     if n.startswith("lora_unet_")},
            "text": {n for n, _ in targets if n.startswith("lora_te_")}}
        skip_unet = {k for k in lb.unet.state_dict()
                     if k.endswith(".weight")
                     and k[:-7].replace(".", "_") in lora_weights["unet"]}
        skip_text = {k for k in lb.text.state_dict()
                     if k.endswith(".weight") and "lora_te_text_model_"
                     + k[:-7].replace(".", "_") in lora_weights["text"]}
        check(len(skip_unet) + len(skip_text) == len(targets),
              "LoRA targets not found among the loaded weights")
        bad = {
            "unet": loaded_mismatches(lb.unet, bundle.unet.state_dict(),
                                      as_loaded, skip_unet),
            "vae": loaded_mismatches(lb.vae, bundle.vae.state_dict(),
                                     as_loaded),
            "text": loaded_mismatches(lb.text, bundle.text.state_dict(),
                                      as_loaded, skip_text),
            "safety": loaded_mismatches(lb.safety.model, checker.state_dict(),
                                        as_loaded),
            "sam": loaded_mismatches(loaded_sam, sam.state_dict(),
                                     lambda t: t.to(bf16))}
        for name in ("sam", "inpaint"):
            bad[f"controlnet {name}"] = loaded_mismatches(
                lb.controlnets[name][1], cns[name].state_dict(), as_loaded)
        n_checked = sum(len(m.state_dict()) for m in (
            lb.unet, lb.vae, lb.text, lb.safety.model, loaded_sam,
            lb.controlnets["sam"][1], lb.controlnets["inpaint"][1]))
        print(f"[ckpt] {n_checked} loaded tensors against the written ones "
              f"cast to bf16 ({len(targets)} LoRA targets apart): mismatches "
              f"{ {k: len(v) for k, v in bad.items()} }")
        check(not any(bad.values()), f"loaded tensors differ: "
              f"{ {k: v[:3] for k, v in bad.items() if v} }")
        step = max(1, len(targets) // CKPT_LORA_SAMPLES)
        for name, _ in targets[::step][:CKPT_LORA_SAMPLES]:
            grp = {"up": lora[f"{name}.lora_up.weight"].float().cpu().numpy(),
                   "down": lora[f"{name}.lora_down.weight"].float().cpu()
                   .numpy(), "alpha": np.float32(CKPT_LORA_ALPHA)}
            layer = resolve_lora_target(modules, name)
            src = resolve_lora_target({"unet": bundle.unet,
                                       "text_encoder": bundle.text}, name)
            delta, scale = lora_delta(grp, layer.weight.ndim,
                                      CKPT_LORA_MULTIPLIER)
            want = scale * torch.from_numpy(delta).cuda()
            w = layer.weight.float()
            got = w - as_loaded(src.weight).float()
            err = (got - want).abs()
            # three bf16 roundings: the product, its scaling, the sum
            bound = 2.0 ** -7 * (w.abs() + want.abs())
            print(f"[ckpt]   LoRA {name} {tuple(w.shape)}: |W' - W - "
                  f"{CKPT_LORA_MULTIPLIER} alpha/rank up@down| max "
                  f"{err.max().item():.3e}, bound max "
                  f"{bound.max().item():.3e}; |delta| max "
                  f"{want.abs().max().item():.3e}")
            check(bool((err <= bound).all()),
                  f"LoRA {name}: W' - W off by more than bf16 rounding")

        # the request
        editor = EditAnythingEditor(lb, sam=(sam_cfg, loaded_sam))
        v0 = bundle.text_cfg.vocab_size
        request = dict(
            image=_checker_image(512, 512), mask=_square_mask(512, 128, 384),
            prompt="a photo of <new-obj> on a sofa", a_prompt="best quality",
            n_prompt="blurry, low quality", num_samples=2,
            image_resolution=512, detect_resolution=512, ddim_steps=30,
            scale=9.0, control_scale=0.5,
            condition_model=paths["controlnet swap"],
            ref_image=_id_map(512, 512, 5)[:, ::-1],
            ref_mask=ragged_ref_mask(512), ref_textinv=True,
            ref_textinv_path=paths["ti"])
        expected = expected_flash_launches(
            lb.unet_cfg, 30, reference=True, sam_layers=sam_cfg.depth,
            checker_layers=safety_cfg.num_layers)
        results = {}
        for tag, seed in (("warm-up", 600), ("timed", 601)):
            _, counts = timed_request(
                "ckpt", f"{tag} request, process from the loaded files "
                f"(SAM ID map, condition-model swap, TI, reference, safety "
                f"checker; 512^2, 2 samples, 30 steps, CFG 9)", editor,
                editor.process, **request, seed=seed,
                generator=torch.Generator("cuda").manual_seed(seed))
            nsfw = editor.pipe.last_nsfw
            print(f"[ckpt]   kernel B launches {counts['flash_attention']}, "
                  f"expected {expected}; sam_twoway {counts['sam_twoway']}, "
                  f"sam_upscale_hyper {counts['sam_upscale_hyper']}; "
                  f"safety flags {nsfw}")
            check(counts["flash_attention"] == expected,
                  f"{tag}: {counts['flash_attention']} kernel B launches, "
                  f"expected {expected}")
            check(counts["sam_twoway"] > 0 and counts["sam_upscale_hyper"] > 0,
                  f"{tag}: the SAM decoder kernels did not launch")
            check(nsfw is not None and nsfw.dtype == bool
                  and nsfw.shape == (2,), f"{tag}: safety flags {nsfw}")
            results[tag] = counts
            if tag == "warm-up":
                # the swap in place, "inpaint" untouched, the TI rows
                check(editor.current_condition_model
                      == paths["controlnet swap"], "no condition-model swap")
                swapped = loaded_mismatches(
                    lb.controlnets["sam"][1], swap.state_dict(), as_loaded)
                kept = loaded_mismatches(
                    lb.controlnets["inpaint"][1],
                    cns["inpaint"].state_dict(), as_loaded)
                rows = lb.text.embeddings.token_embedding.weight[
                    v0:v0 + CKPT_TI_VECTORS]
                ids = lb.tokenizer.encode(request["prompt"])
                print(f"[ckpt]   after the swap: sam ControlNet mismatches "
                      f"against the second file {len(swapped)}, inpaint "
                      f"against its own {len(kept)}; TI rows {v0}.."
                      f"{v0 + CKPT_TI_VECTORS - 1} equal the file's: "
                      f"{torch.equal(rows, ti.cuda().to(bf16))}; prompt ids "
                      f"{ids}")
                check(not swapped and not kept, "swap or inpaint wrong")
                check(torch.equal(rows, ti.cuda().to(bf16)),
                      "TI rows differ from the file's")
                check(v0 in ids and v0 + 1 in ids,
                      "the placeholder did not resolve to the TI rows")
        check(results["warm-up"] == results["timed"],
              "launch counts differ between the requests")
    finally:
        shutil.rmtree(tmp)
    del lb, editor, loaded_sam, sam, swap, checker
    torch.cuda.empty_cache()
    print(f"[ckpt] phase 4e: {time.perf_counter() - t_phase:.1f} s")
    return {"checkpoints request": results["timed"]}


def _synced(fn, *args, **kwargs):
    """(result, seconds) of fn on the host clock, the device synchronised."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_main_path(bundle) -> dict:
    """SAM ViT-H + the SD1.5 bundle in the editor: the main path as a user
    calls it, ``process`` with no condition map."""
    from editanything_tpu_torch.models import sam as SAM
    from editanything_tpu_torch.perception import amg as A
    from editanything_tpu_torch.pipelines.bundle import random_sam
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor

    t0 = time.perf_counter()
    cfg = SAM.sam_vit_h()
    sam = random_sam(cfg, device="cuda", dtype=torch.bfloat16,
                     generator=torch.Generator("cuda").manual_seed(7)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sam.parameters())
    print(f"[main] SAM ViT-H (1280 wide, 32 deep, global 7/15/23/31), bf16, "
          f"random weights (seed 7): {n_params / 1e6:.1f} M parameters, built "
          f"in {time.perf_counter() - t0:.1f} s")
    amg_cfg = A.AMGConfig()
    editor = EditAnythingEditor(bundle, sam=(cfg, sam), amg_config=amg_cfg)
    sam_seconds = []
    get_sam_control = editor.get_sam_control

    def timed_sam_control(image):
        out, seconds = _synced(get_sam_control, image)
        sam_seconds.append(seconds)
        return out
    editor.get_sam_control = timed_sam_control
    image = _checker_image(512, 512)
    request = dict(image=image, mask=_square_mask(512, 128, 384),
                   prompt="a red cat sitting on a sofa", a_prompt="best quality",
                   n_prompt="blurry, low quality", num_samples=2,
                   image_resolution=512, detect_resolution=512, ddim_steps=30,
                   scale=9.0, control_scale=0.5)

    def one(seed):
        (_, results, (cond, _), _), seconds = _synced(
            editor.process, **request, seed=seed,
            generator=torch.Generator("cuda").manual_seed(seed))
        out = np.stack(results)
        check(out.shape == (2, 512, 512, 3) and out.dtype == np.uint8,
              f"process returned {out.shape} {out.dtype}")
        check(editor.pipe.last_nonfinite == 0,
              f"{editor.pipe.last_nonfinite} non-finite values before the uint8 cast")
        check(cond.shape == (512, 512, 3) and cond.dtype == np.uint8,
              f"SAM condition map {cond.shape} {cond.dtype}")
        return seconds

    print(f"[main] warm-up request: {one(200):.3f} s (SAM phase "
          f"{sam_seconds[-1]:.3f} s)")
    all_counters = launch_counters()
    counters = all_counters[:4]       # resnet_fused runs under the switch only
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    sam_seconds.clear()
    times = [one(201 + r) for r in range(MAIN_PATH_REQUESTS)]
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    for r, (total, sam_s) in enumerate(zip(times, sam_seconds)):
        print(f"[main] request {r}: {total:.3f} s, of which SAM phase "
              f"{sam_s:.3f} s (512^2 image -> SAM 1024^2 -> 32x32-point AMG "
              f"-> ID map -> 512^2 edit, 2 samples, 30 steps, CFG 9)")
    print(f"[main] mean {sum(times) / len(times):.3f} s/request, SAM phase "
          f"{sum(sam_seconds) / len(sam_seconds):.3f} s; peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    print(f"[main] kernel launches in the {len(times)} timed requests: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    # the main path with every resnet fused
    with_fused_resnets(True)
    for fn in all_counters:
        fn.launches = 0
    sam_seconds.clear()
    torch.cuda.reset_peak_memory_stats()
    fused_times = [one(211 + r) for r in range(FUSED_MAIN_PATH_REQUESTS)]
    fused_peak = torch.cuda.max_memory_allocated()
    fused_launches = {fn.__name__: fn.launches for fn in all_counters}
    with_fused_resnets(False)
    for r, (total, sam_s) in enumerate(zip(fused_times, sam_seconds)):
        print(f"[main] request {r} with every resnet fused (EA_RESNET_FUSED=1): "
              f"{total:.3f} s, of which SAM phase {sam_s:.3f} s")
    print(f"[main] fused requests' peak memory {fused_peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated; composed {peak / 2**30:.2f} GiB)")
    print(f"[main] kernel launches in the {len(fused_times)} fused requests: "
          f"{fused_launches}")
    for name, count in fused_launches.items():
        check(count > 0, f"{name} was not launched on the fused main path")
    launches["resnet_fused"] = fused_launches["resnet_fused"]

    # the SAM phase once more, split (each part synchronised)
    with torch.inference_mode():
        x, (nh, nw) = SAM.prepare_image(image, cfg, "cuda")
        emb, t_enc = _synced(sam.image_encoder, x.to(torch.bfloat16))
        pts = torch.from_numpy(A._grid_points(amg_cfg, nh, nw)).cuda()
        (logits, iou), t_dec = _synced(A.decode_candidates, sam, amg_cfg, emb, pts)
        sel, t_sel = _synced(A.select_candidates, logits, iou, amg_cfg)
        _, t_map = _synced(A.encode_id_map, sel["logits"], sel["valid"],
                           out_hw=(512, 512))
        stab, areas, _ = A._mask_stats(logits, amg_cfg.mask_threshold,
                                       amg_cfg.stability_score_offset)
        passing = int(((iou > amg_cfg.pred_iou_thresh)
                       & (stab > amg_cfg.stability_score_thresh)
                       & (areas > 0)).sum())
        kept = int(sel["valid"].sum())
        print(f"[main] SAM phase split: encoder {t_enc:.4f} s, decode "
              f"({amg_cfg.num_points // amg_cfg.points_per_batch} batches of "
              f"{amg_cfg.points_per_batch} points) {t_dec:.4f} s, selection/NMS "
              f"{t_sel:.4f} s, ID map {t_map:.4f} s; {passing} of "
              f"{logits.shape[0]} candidates pass the filters, {kept} masks kept")
        open_cfg = A.AMGConfig(pred_iou_thresh=-1e9, stability_score_thresh=-1.0)
        _, open_gen = A.build_amg(cfg, open_cfg)
        out, t_open = _synced(open_gen, sam, emb, pts)
        stab_all = int((areas > 0).sum())
        print(f"[main] AMG with the filters open: {t_open:.4f} s (decode + "
              f"selection; {stab_all} of {logits.shape[0]} candidates valid, "
              f"{int(out['valid'].sum())} masks kept)")
    editor.clear_clicks()
    (overlay, mask), t_click = _synced(editor.process_image_click, image, 256,
                                       256, True, detect_resolution=512)
    check(mask.shape == (512, 512) and overlay.shape == (512, 512, 3),
          f"click returned {mask.shape} / {overlay.shape}")
    print(f"[main] process_image_click (512^2, encode + one click): "
          f"{t_click:.4f} s; mask covers {float((mask > 0).mean()):.3f}")
    del editor.get_sam_control     # the untimed method again
    return launches, editor


def synthetic_gpt2_tokenizer(vocab_size: int):
    """GPT-2/OPT's id layout (<s> 0, <pad> 1, </s> 2, <unk> 3, then the 256
    byte symbols) filled to `vocab_size` with made-up space-led words
    ("Ġw<id>", which decode to " w<id>") and no merges: no vocab.json or
    merges.txt is in the repository, and the weights are random anyway."""
    from editanything_tpu_torch.text.tokenizer import (GPT2Tokenizer,
                                                       bytes_to_unicode)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for sym in bytes_to_unicode().values():
        vocab[sym] = len(vocab)
    while len(vocab) < vocab_size:
        vocab[f"\u0120w{len(vocab)}"] = len(vocab)
    return GPT2Tokenizer(vocab, [])


def captioner_flash_launches(cfg) -> int:
    """Kernel B's launches per captioner call, whatever its batch: one per
    vision layer, one per Q-Former layer (self) and one per cross-attention
    layer; OPT's masked attention is the plain twin."""
    return (cfg.vision_layers + cfg.qformer_layers
            + len(range(0, cfg.qformer_layers, cfg.cross_attention_frequency)))


def phase_captioner(editor) -> dict:
    """Phase 4f: BLIP-2-OPT-2.7B at the published widths, random bf16
    weights drawn on the card (seed 13), with a synthetic 50272-entry GPT-2
    vocabulary, behind phase 5's editor (SD1.5 bundle, SAM ViT-H): the
    vision tower and Q-Former in bf16 through kernel B and through its
    twin, each against fp32; a warm-up and CAPTION_REQUESTS timed captions
    of a 512^2 image; semantic_labels over the top SEMANTIC_TOP_K regions
    of the AMG with its filters and box NMS open (and ``semantic`` itself
    where PIL is installed); one ``process(enable_auto_prompt=True)`` and one
    ``process(ref_auto_prompt=True)``, kernel B's launches equal to their
    paths' prediction plus captioner_flash_launches per captioner call, the
    caption in the returned prompt."""
    import copy
    import importlib.util
    import types
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.models import blip2 as TB
    from editanything_tpu_torch.perception import amg as A
    from editanything_tpu_torch.pipelines.bundle import random_blip2
    from editanything_tpu_torch.pipelines.captioner import (Captioner,
                                                            preprocess,
                                                            semantic_labels)
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    cfg = TB.BLIP2Config()
    model, t_build = _synced(random_blip2, cfg, device="cuda", dtype=bf16,
                             seed=13)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[caption] BLIP-2-OPT-2.7B (ViT-g/14 1408 x 39, Q-Former 768 x 12, "
          f"OPT 2560 x 32), bf16, random weights (seed 13): "
          f"{n_params / 1e9:.3f} B parameters, "
          f"{n_params * 2 / 2**30:.2f} GiB, drawn on the card in {t_build:.2f} s")
    tok = synthetic_gpt2_tokenizer(cfg.vocab_size)
    captioner = Captioner(model, tok, max_new_tokens=CAPTION_NEW_TOKENS)
    per_call = captioner_flash_launches(cfg)
    image = _checker_image(512, 512)

    # the vision tower and the Q-Former: bf16 through B and through the
    # twin, each against fp32 (the twin, TF32 off)
    px = preprocess(image[None], cfg.image_size, "cuda")
    ref = types.SimpleNamespace(cfg=cfg,
                                vision_model=copy.deepcopy(model.vision_model).float(),
                                qformer=copy.deepcopy(model.qformer).float())
    with torch.inference_mode():
        with plain_attention():
            img32 = TB.vision_encoder(ref, px)
            q32 = TB.qformer(ref, img32)
        FA.flash_attention.launches = 0
        img_k = TB.vision_encoder(model, px.to(bf16))
        q_k = TB.qformer(model, img_k)
        launched = FA.flash_attention.launches
        with plain_attention():
            img_t = TB.vision_encoder(model, px.to(bf16))
            q_t = TB.qformer(model, img_t)
    del ref
    torch.cuda.empty_cache()
    for name, k, t, want in (("image tokens", img_k, img_t, img32),
                             ("queries", q_k, q_t, q32)):
        ek, et = max_err(k, want), max_err(t, want)
        print(f"[caption] bf16 {name} {tuple(want.shape)} against fp32: "
              f"through kernel B {ek:.3e}, through its twin {et:.3e} (bound "
              f"{TINY_BF16_RATIO:g}x the twin's; |fp32| <= "
              f"{want.abs().max().item():.2f})")
        check(ek <= TINY_BF16_RATIO * et, f"BLIP-2 bf16 {name}: {ek} > "
              f"{TINY_BF16_RATIO} x {et}")
    check(launched == per_call, f"vision + Q-Former launched kernel B "
          f"{launched} times, expected {per_call}")
    check(bool(torch.isfinite(q_k).all()), "non-finite queries")

    # captions: a warm-up and timed ones, split once into their parts
    editor.captioner = captioner
    captions = []
    get_text = editor.get_blip2_text

    def recorded(img):
        captions.append(get_text(img))
        return captions[-1]
    editor.get_blip2_text = recorded
    torch.cuda.reset_peak_memory_stats()
    _, t_warm = _synced(editor.get_blip2_text, image)
    times = []
    for _ in range(CAPTION_REQUESTS):
        FA.flash_attention.launches = 0
        _, seconds = _synced(editor.get_blip2_text, image)
        times.append(seconds)
        check(FA.flash_attention.launches == per_call,
              f"a caption launched kernel B {FA.flash_attention.launches} "
              f"times, expected {per_call}")
    toks = captioner.tokens(image[None])
    n_new = int((toks != cfg.eos_token_id).sum())
    with torch.inference_mode():
        qemb, t_enc = _synced(lambda: model.language_projection(
            TB.qformer(model, TB.vision_encoder(model, px.to(bf16)))))
        emb = torch.cat([qemb, model.language_model.embed_tokens(
            torch.tensor([captioner.prompt_ids], device="cuda"))], dim=1)
        (logits, _), t_prefill = _synced(
            TB._prefill_caches, model, emb, emb.shape[1] + CAPTION_NEW_TOKENS)
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    mean = sum(times) / len(times)
    print(f"[caption] warm-up caption {t_warm:.3f} s; {len(times)} timed "
          f"captions of a 512^2 image: {', '.join(f'{t:.3f}' for t in times)} "
          f"s (mean {mean:.3f}); {n_new} of {CAPTION_NEW_TOKENS} new tokens "
          f"before eos; split once: vision + Q-Former + projection "
          f"{t_enc:.4f} s, prefill ({emb.shape[1]} tokens) {t_prefill:.4f} s, "
          f"so the {CAPTION_NEW_TOKENS - 1} decode steps ~"
          f"{mean - t_enc - t_prefill:.3f} s "
          f"({(mean - t_enc - t_prefill) / (CAPTION_NEW_TOKENS - 1) * 1e3:.2f} "
          f"ms a token); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel B "
          f"{per_call} launches a caption; caption {captions[-1][:60]!r}...")
    check(isinstance(captions[-1], str) and captions[-1],
          "the caption is empty")

    # region labels over the open-filter AMG's top regions: with random
    # weights every candidate covers most of the image, so box NMS is off
    # too (IoU threshold 1), or it would keep one mask
    open_cfg = A.AMGConfig(pred_iou_thresh=-1e9, stability_score_thresh=-1.0,
                           box_nms_thresh=1.0)
    saved = editor.amg_cfg, editor._amg_encode, editor._amg_generate
    editor.amg_cfg = open_cfg
    editor._amg_encode, editor._amg_generate = A.build_amg(editor.sam[0],
                                                           open_cfg)
    _, logits, valid = editor.top_regions(image, SEMANTIC_TOP_K)
    masks = logits > open_cfg.mask_threshold
    areas = masks.reshape(len(masks), -1).sum(-1)
    FA.flash_attention.launches = 0
    labels, t_labels = _synced(semantic_labels, image, masks, valid, areas,
                               captioner, top_k=SEMANTIC_TOP_K)
    label_launches = FA.flash_attention.launches
    print(f"[caption] semantic_labels over the open AMG's (filters and NMS) top "
          f"{SEMANTIC_TOP_K} regions ({len(labels)} crops, one captioner "
          f"call): {t_labels:.3f} s ({t_labels / mean:.2f}x one caption); "
          f"kernel B {label_launches} launches; labels "
          f"{[(i, lab[:20]) for i, lab in labels[:3]]}...")
    check(len(labels) == SEMANTIC_TOP_K and all(lab for _, lab in labels),
          f"semantic_labels returned {len(labels)} labels")
    check(label_launches == per_call, f"semantic_labels launched kernel B "
          f"{label_launches} times, expected {per_call}")
    if importlib.util.find_spec("PIL") is None:
        print("[caption] PIL is not installed here: semantic's overlay "
              "cannot be drawn, so semantic itself does not run")
    else:
        (sem_labels, overlay), t_sem = _synced(
            editor.semantic, image, top_k=SEMANTIC_TOP_K, detect_resolution=512)
        print(f"[caption] semantic (AMG, {SEMANTIC_TOP_K} masks upscaled, "
              f"labels, overlay): {t_sem:.3f} s; {len(sem_labels)} labels; "
              f"overlay {overlay.shape} {overlay.dtype}")
        check(len(sem_labels) == SEMANTIC_TOP_K and overlay.shape == (512, 512, 3)
              and overlay.dtype == np.uint8, "semantic's output")
    editor.amg_cfg, editor._amg_encode, editor._amg_generate = saved

    # the two auto-prompt requests through process
    sam_layers = editor.sam[0].depth
    request = dict(image=image, mask=_square_mask(512, 128, 384),
                   prompt="a red cat sitting on a sofa", a_prompt="best quality",
                   n_prompt="blurry, low quality", num_samples=2,
                   image_resolution=512, detect_resolution=512, ddim_steps=30,
                   scale=9.0, control_scale=0.5)
    results = {}
    for tag, extra, expected in (
            ("auto prompt", dict(enable_auto_prompt=True),
             expected_flash_launches(editor.bundle.unet_cfg, 30,
                                     sam_layers=sam_layers) + per_call),
            ("reference auto prompt", dict(reference_args(),
                                           ref_auto_prompt=True),
             expected_flash_launches(editor.bundle.unet_cfg, 30, reference=True,
                                     sam_layers=sam_layers) + per_call)):
        returned = {}

        def run(**kwargs):
            out = editor.process(**kwargs)
            returned["prompt"] = out[3]
            return out
        captions.clear()
        _, counts = timed_request(
            "caption", f"process({', '.join(k for k in extra if 'auto' in k)}"
            f"=True) (SAM ID map, the caption, 512^2, 2 samples, 30 steps, "
            f"CFG 9)", editor, run, **request, **extra, seed=700,
            generator=torch.Generator("cuda").manual_seed(700))
        print(f"[caption]   kernel B launches {counts['flash_attention']}, "
              f"expected {expected} (the path's plus {per_call}); caption "
              f"{captions[-1][:40]!r}... in the prompt: "
              f"{captions[-1] in returned['prompt']}")
        check(len(captions) == 1 and captions[0] in returned["prompt"],
              f"{tag}: the caption is not in the returned prompt")
        check(counts["flash_attention"] == expected,
              f"{tag}: {counts['flash_attention']} kernel B launches, "
              f"expected {expected}")
        results[f"{tag} request"] = counts
    del editor.get_blip2_text      # the method again
    editor.captioner = None
    del model, captioner, img32, q32, img_k, q_k, img_t, q_t, logits
    torch.cuda.empty_cache()
    print(f"[caption] phase 4f: {time.perf_counter() - t_phase:.1f} s")
    return results


def synthetic_bert_tokenizer(vocab_size: int):
    """bert-base-uncased's id layout ([PAD] 0, [unused*], [UNK] 100, [CLS]
    101, [SEP] 102, [MASK] 103, "." 1012, "?" 1029) with the letters and
    their "##" forms, a few words, and made-up words ("w<id>") filling it to
    `vocab_size`: no vocab.txt is in the repository, and the weights are
    random anyway."""
    from editanything_tpu_torch.text.tokenizer import BertTokenizer
    vocab = {}

    def add(tok):
        vocab.setdefault(tok, len(vocab))

    def fill(upto):
        while len(vocab) < upto:
            add(f"[unused{len(vocab)}]")
    add("[PAD]")
    fill(100)
    for tok in ("[UNK]", "[CLS]", "[SEP]", "[MASK]"):
        add(tok)
    for ch in "abcdefghijklmnopqrstuvwxyz":
        add(ch)
        add("##" + ch)
    fill(1012)
    add(".")
    fill(1029)
    add("?")
    for word in ("a", "the", "dog", "head", "nose", "sofa", "cat", "red"):
        add(word)
    while len(vocab) < vocab_size:
        add(f"w{len(vocab)}")
    return BertTokenizer(vocab)


def tiny_detector_parity():
    """The tiny GroundingDINO and VLPart in fp32, CUDA (kernel B where the
    model reaches it) against the CPU (plain twins), the same weights: the
    forward's logits and boxes and the detectors' boxes, scores and labels
    within TINY_DETECT_TOL / TINY_DETECT_BOX_PX_TOL."""
    import copy
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.models import groundingdino as G
    from editanything_tpu_torch.models import vlpart as V
    from editanything_tpu_torch.pipelines.bundle import (random_groundingdino,
                                                         random_vlpart)
    from editanything_tpu_torch.text.tokenizer import (tiny_bert_tokenizer,
                                                       tiny_tokenizer)
    image = _checker_image(70, 96)
    cpu = random_groundingdino(G.tiny_dino_config(), device="cpu", seed=3)
    outs = {}
    for device, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).cuda())):
        det = G.GroundingDINODetector(model, tiny_bert_tokenizer(),
                                      box_threshold=-1.0, short_side=64,
                                      max_side=96)
        inp = det.prepare(image, "a dog head. sofa")
        FA.flash_attention.launches = 0
        out = G.dino_forward(model, inp["pixels"], inp["text_ids"],
                             inp["text_mask"], inp["text_self_mask"],
                             inp["position_ids"])
        launched = FA.flash_attention.launches
        mask = inp["text_mask"][0].cpu().numpy()
        outs[device] = (out["logits"].cpu().numpy()[:, mask],
                        out["boxes"].cpu().numpy(),
                        det(image, "a dog head. sofa"), launched)
    (cl, cb, (cbox, cs, cp), _), (gl, gb, (gbox, gs, gp), launched) = \
        outs["cpu"], outs["cuda"]
    errs = (float(np.abs(gl - cl).max()), float(np.abs(gb - cb).max()),
            float(np.abs(gs - cs).max()))
    box_px = float(np.abs(gbox - cbox).max())
    print(f"[grounding] tiny GroundingDINO fp32, CUDA vs CPU: logits "
          f"{errs[0]:.3e}, boxes {errs[1]:.3e}, scores {errs[2]:.3e} <= "
          f"{TINY_DETECT_TOL:g}; detector boxes {box_px:.3e} px <= "
          f"{TINY_DETECT_BOX_PX_TOL:g}; phrases equal {gp == cp}; "
          f"{launched} flash_attention launches")
    check(max(errs) <= TINY_DETECT_TOL and box_px <= TINY_DETECT_BOX_PX_TOL
          and gp == cp, "tiny GroundingDINO CUDA vs CPU")
    check(launched == G.tiny_dino_config().dec_layers,
          f"tiny GroundingDINO launched kernel B {launched} times")

    cpu = random_vlpart(V.tiny_vlpart_config(), device="cpu", seed=3)
    outs = {}
    for device, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).cuda())):
        det = V.VLPartDetector(model, tiny_tokenizer(context_length=16),
                               short_side=72, max_side=120)
        FA.flash_attention.launches = 0
        outs[device] = det(image, VLPART_VOCABULARY) + (
            FA.flash_attention.launches,)
    (cbox, cs, cl, _), (gbox, gs, gl, launched) = outs["cpu"], outs["cuda"]
    same = len(cs) == len(gs) and cl == gl
    err = float(np.abs(gs - cs).max()) if same and len(cs) else 0.0
    box_px = float(np.abs(gbox - cbox).max()) if same and len(cs) else 0.0
    print(f"[grounding] tiny VLPart fp32, CUDA vs CPU: {len(gs)} / {len(cs)} "
          f"detections, labels equal {cl == gl}; scores {err:.3e} <= "
          f"{TINY_DETECT_TOL:g}; boxes {box_px:.3e} px <= "
          f"{TINY_DETECT_BOX_PX_TOL:g}; {launched} flash_attention launches")
    check(same and len(cs) > 0 and err <= TINY_DETECT_TOL
          and box_px <= TINY_DETECT_BOX_PX_TOL, "tiny VLPart CUDA vs CPU")
    check(launched == 0, f"VLPart launched kernel B {launched} times")


def _counts():
    return {c.__name__: c.launches for c in launch_counters()}


def _zero_counts():
    for c in launch_counters():
        c.launches = 0


def dino_detection(det, image, caption) -> dict:
    """One GroundingDINO detection, each part synchronised: host prepare,
    BERT, backbone + input_proj, the fusion encoder, query selection +
    decoder, host post-processing -> seconds, peak memory, launches and the
    outputs."""
    from editanything_tpu_torch.models import groundingdino as G
    model = det.model
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with torch.inference_mode():
        inp, t_prep = _synced(det.prepare, image, caption)
        txt, t_bert = _synced(G.text_features, model, inp["text_ids"],
                              inp["text_self_mask"], inp["position_ids"])
        srcs, t_bb = _synced(G.image_features, model, inp["pixels"])
        (img, txt, shapes), t_enc = _synced(
            G.encoder_forward, model, srcs, txt, inp["text_mask"],
            inp["text_self_mask"], inp["position_ids"])
        before = flash_launches()

        def decode():
            _, boxes = G.select_queries(model, img, txt, inp["text_mask"],
                                        shapes)
            return G.decoder_forward(model, img, txt, inp["text_mask"],
                                     shapes, boxes)
        out, t_dec = _synced(decode)
        dec_launches = flash_launches() - before
    (boxes, scores, phrases), t_post = _synced(det.postprocess, out,
                                               inp["tokens"], inp["hw"])
    total = t_prep + t_bert + t_bb + t_enc + t_dec + t_post
    return dict(seconds=total, prep=t_prep, bert=t_bert, backbone=t_bb,
                encoder=t_enc, decoder=t_dec, post=t_post, out=out,
                boxes=boxes, scores=scores, phrases=phrases,
                tokens=sum(h * w for h, w in shapes),
                pixels=tuple(inp["pixels"].shape[-2:]),
                peak=torch.cuda.max_memory_allocated(), launches=_counts(),
                dec_launches=dec_launches)


def flash_launches() -> int:
    from editanything_tpu_torch.core import flash_attention as FA
    return FA.flash_attention.launches


def vlpart_detection(det, image, vocabulary) -> dict:
    """One VLPart detection, each part synchronised: host prepare, the text
    embeddings, backbone + FPN, the RPN, the cascade and NMS, and the
    host's crop to the valid slab."""
    from editanything_tpu_torch.models import vlpart as V
    model = det.model
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with torch.inference_mode():
        (px, scale), t_prep = _synced(det.prepare, image)
        emb, t_text = _synced(V.encode_vocabulary, model, det.tokenizer,
                              vocabulary)
        hw = tuple(px.shape[-2:])
        fpn, t_bb = _synced(V.backbone_forward, model, px)
        (props, valid), t_rpn = _synced(V.rpn_proposals, model, fpn, hw)
        out, t_heads = _synced(V.cascade_forward, model, fpn, props, valid,
                               emb, hw)
    host, t_post = _synced(lambda: {k: v.cpu().numpy() for k, v in out.items()})
    keep = host["valid"]
    return dict(seconds=t_prep + t_text + t_bb + t_rpn + t_heads + t_post,
                prep=t_prep, text=t_text, backbone=t_bb, rpn=t_rpn,
                heads=t_heads, post=t_post,
                proposals=int(valid.sum()), detections=int(keep.sum()),
                scores=host["scores"][keep], pixels=tuple(px.shape[-2:]),
                peak=torch.cuda.max_memory_allocated(), launches=_counts())


def boxes_to_sam(scores, flow: dict) -> int:
    """How many of a detection's boxes prompt2mask hands SAM under `flow`:
    those at or above score_thresh, the best max_boxes of them, those at or
    above union_score_thresh (default 0.5)."""
    scores = np.sort(np.asarray(scores))[::-1]
    scores = scores[scores >= flow["score_thresh"]][:flow.get("max_boxes")]
    return int((scores >= flow.get("union_score_thresh", 0.5)).sum())


def grounding_masks(tag, detector, editor, image, text, flow, expected_b_det):
    """prompt2mask with `flow`'s thresholds: seconds, the boxes that reach
    SAM, launches against the prediction (kernel B: the detection's plus
    SAM's encoder once where a box passes; D and C one call a box)."""
    from editanything_tpu_torch.perception.grounding import prompt2mask
    _, scores, _ = detector(image, text)
    n_sam = boxes_to_sam(scores, flow)
    sam_layers = editor.sam[0].depth
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    mask, seconds = _synced(prompt2mask, detector, editor.sam_predictor,
                            image, text, **flow)
    counts = _counts()
    want = {"flash_attention": expected_b_det + (sam_layers if n_sam else 0),
            "sam_twoway": n_sam, "sam_upscale_hyper": n_sam}
    print(f"[grounding] {tag} prompt2mask({flow}): {seconds:.3f} s; "
          f"{len(scores)} boxes from the detector, "
          f"{int((np.asarray(scores) >= flow['score_thresh']).sum())} at or "
          f"above {flow['score_thresh']}, {n_sam} to SAM; mask covers "
          f"{float((mask[..., 0] > 0).mean()):.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"B {counts['flash_attention']}, D {counts['sam_twoway']}, C "
          f"{counts['sam_upscale_hyper']} (predicted {want})")
    check(mask.shape == image.shape and mask.dtype == np.uint8,
          f"{tag}: mask {mask.shape} {mask.dtype}")
    for name, n in want.items():
        check(counts[name] == n, f"{tag} prompt2mask: {name} launched "
              f"{counts[name]} times, predicted {n}")
    return n_sam


def phase_grounding(editor) -> dict:
    """Phase 4g: text-grounded edits behind phase 5's editor (SD1.5 bundle,
    SAM ViT-H). The tiny detectors CUDA vs CPU; GroundingDINO SwinT-OGC
    and VLPart Swin-B at the published widths, random bf16 weights drawn
    on the card (seeds 14 and 15), BERT's a synthetic 30522-entry WordPiece
    vocabulary, VLPart's the bundle's CLIP tokenizer: each detects on
    GROUNDING_IMAGES with every part timed; GroundingDINO's decoder in bf16
    through kernel B and through its twin against fp32 on the same inputs;
    prompt2mask at the UI's thresholds and with them open; one
    ``TextGuidedEditPipeline`` request per detector at the UI's defaults
    and one with GroundingDINO's thresholds open, each request's launches
    of kernels B, D and C equal to the prediction."""
    import copy
    from editanything_tpu_torch.models import groundingdino as G
    from editanything_tpu_torch.models import vlpart as V
    from editanything_tpu_torch.perception.grounding import \
        TextGuidedEditPipeline
    from editanything_tpu_torch.pipelines.bundle import (random_groundingdino,
                                                         random_vlpart)
    t_phase = time.perf_counter()
    tiny_detector_parity()
    bf16 = torch.bfloat16
    cfg = G.DINOConfig()
    model, t_build = _synced(random_groundingdino, cfg, device="cuda",
                             dtype=bf16, seed=14)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[grounding] GroundingDINO SwinT-OGC (Swin-T, BERT-base, 6 + 6 "
          f"layers, 900 queries), bf16, random weights (seed 14): "
          f"{n_params / 1e6:.1f} M parameters, drawn on the card in "
          f"{t_build:.2f} s")
    tok = synthetic_bert_tokenizer(cfg.bert.vocab_size)
    check(tuple(tok.vocab[t] for t in ("[CLS]", "[SEP]", ".", "?"))
          == G.BERT_SPECIAL_IDS, "synthetic BERT vocabulary's special ids")
    # a fresh model's box MLPs end in a zero layer, so its decoder would
    # leave every box where the selection put it: drawn small here, the
    # refinement moves them and the bf16 check below sees the boxes
    g = torch.Generator("cuda").manual_seed(14)
    with torch.no_grad():
        for mlp in (model.bbox_embed, model.transformer.enc_out_bbox_embed):
            mlp.layers[-1].weight.normal_(0.0, 0.01, generator=g)
    det = G.GroundingDINODetector(model, tok)
    dino_b = cfg.dec_layers
    results = {}
    for hw in GROUNDING_IMAGES:
        image = _checker_image(*hw)
        dino_detection(det, image, DINO_CAPTION)      # warm-up at this size
        r = dino_detection(det, image, DINO_CAPTION)
        print(f"[grounding] GroundingDINO on {hw[0]}x{hw[1]} -> "
              f"{r['pixels'][0]}x{r['pixels'][1]} ({r['tokens']} image tokens, "
              f"{cfg.num_queries} queries): {r['seconds']:.4f} s = host "
              f"prepare {r['prep']:.4f} + BERT {r['bert']:.4f} + backbone "
              f"{r['backbone']:.4f} + encoder {r['encoder']:.4f} + selection "
              f"and decoder {r['decoder']:.4f} + host post {r['post']:.4f}; "
              f"{len(r['scores'])} boxes above {det.box_threshold}; peak "
              f"memory {r['peak'] / 2**30:.2f} GiB; kernel B "
              f"{r['launches']['flash_attention']} launches (decoder "
              f"{r['dec_launches']}), predicted {dino_b}")
        check(bool(torch.isfinite(r["out"]["boxes"]).all()),
              "GroundingDINO boxes not finite")
        real = r["out"]["logits"][:, torch.isfinite(r["out"]["logits"][0])]
        check(real.shape[1] > 0 and bool(torch.isfinite(real).all()),
              "GroundingDINO logits not finite at the caption's tokens")
        check(r["launches"]["flash_attention"] == dino_b
              and r["dec_launches"] == dino_b,
              f"a detection launched kernel B {r['launches']['flash_attention']}"
              f" times, predicted {dino_b}")

    # the decoder in bf16 through B and through its twin, against fp32 on
    # the same inputs (the fp32 encoder's outputs and selection, TF32 off)
    ref = copy.deepcopy(model).float()
    inp = det.prepare(_checker_image(512, 512), DINO_CAPTION)
    tmask = inp["text_mask"]
    with torch.inference_mode():
        with plain_attention():
            txt = G.text_features(ref, inp["text_ids"], inp["text_self_mask"],
                                  inp["position_ids"])
            img, txt, shapes = G.encoder_forward(
                ref, G.image_features(ref, inp["pixels"]), txt, tmask,
                inp["text_self_mask"], inp["position_ids"])
            _, boxes = G.select_queries(ref, img, txt, tmask, shapes)
            want = G.decoder_forward(ref, img, txt, tmask, shapes, boxes)
        before = flash_launches()
        got_k = G.decoder_forward(model, img.to(bf16), txt.to(bf16), tmask,
                                  shapes, boxes)
        dec_launches = flash_launches() - before
        with plain_attention():
            got_t = G.decoder_forward(model, img.to(bf16), txt.to(bf16), tmask,
                                      shapes, boxes)
    real = tmask[0]
    for name, pick in (("logits", lambda o: o["logits"][:, real]),
                       ("boxes", lambda o: o["boxes"])):
        ek = max_err(pick(got_k), pick(want))
        et = max_err(pick(got_t), pick(want))
        print(f"[grounding] bf16 decoder {name} {tuple(pick(want).shape)} "
              f"against fp32: through kernel B {ek:.3e}, through its twin "
              f"{et:.3e} (bound {TINY_BF16_RATIO:g}x the twin's; |fp32| <= "
              f"{pick(want).abs().max().item():.3f})")
        check(ek <= TINY_BF16_RATIO * et, f"GroundingDINO bf16 decoder {name}: "
              f"{ek} > {TINY_BF16_RATIO} x {et}")
    check(dec_launches == dino_b, f"the decoder launched kernel B "
          f"{dec_launches} times")
    del ref, img, txt, want, got_k, got_t
    torch.cuda.empty_cache()

    # VLPart
    vcfg = V.VLPartConfig()
    vmodel, t_build = _synced(random_vlpart, vcfg, device="cuda", dtype=bf16,
                              seed=15)
    n_params = sum(p.numel() for p in vmodel.parameters())
    print(f"[grounding] VLPart (Swin-B + FPN, RPN, 3-stage cascade, CLIP-RN50 "
          f"text), bf16, random weights (seed 15): {n_params / 1e6:.1f} M "
          f"parameters, drawn on the card in {t_build:.2f} s")
    vdet = V.VLPartDetector(vmodel, editor.bundle.tokenizer)
    for hw in GROUNDING_IMAGES:
        image = _checker_image(*hw)
        vlpart_detection(vdet, image, VLPART_VOCABULARY)   # warm-up
        r = vlpart_detection(vdet, image, VLPART_VOCABULARY)
        print(f"[grounding] VLPart on {hw[0]}x{hw[1]} -> {r['pixels'][0]}x"
              f"{r['pixels'][1]}: {r['seconds']:.4f} s = host prepare "
              f"{r['prep']:.4f} + text {r['text']:.4f} + detect (backbone + "
              f"FPN {r['backbone']:.4f}, RPN {r['rpn']:.4f}, cascade + NMS "
              f"{r['heads']:.4f}) + host {r['post']:.4f}; {r['proposals']} "
              f"proposals, {r['detections']} detections (best "
              f"{float(r['scores'].max()) if len(r['scores']) else 0:.3f}); "
              f"peak memory {r['peak'] / 2**30:.2f} GiB; kernel B "
              f"{r['launches']['flash_attention']} launches, predicted 0")
        check(r["detections"] > 0 and bool(np.isfinite(r["scores"]).all()),
              "VLPart found no finite detection")
        check(r["launches"]["flash_attention"] == 0,
              "VLPart launched kernel B")

    # prompt2mask and the requests, at the UI's thresholds and open
    image = _checker_image(512, 512)
    dino_open = G.GroundingDINODetector(model, tok, box_threshold=0.0)
    grounding_masks("GroundingDINO (UI)", det, editor, image, DINO_CAPTION,
                    DINO_UI, dino_b)
    grounding_masks("GroundingDINO (open)", dino_open, editor, image,
                    DINO_CAPTION, GROUNDING_OPEN, dino_b)
    grounding_masks("VLPart (UI)", vdet, editor, image, VLPART_VOCABULARY,
                    VLPART_UI, 0)
    grounding_masks("VLPart (open)", vdet, editor, image, VLPART_VOCABULARY,
                    GROUNDING_OPEN, 0)
    sam_layers = editor.sam[0].depth
    request = dict(image=image, prompt="a red cat sitting on a sofa",
                   a_prompt="best quality", n_prompt="blurry, low quality",
                   num_samples=2, image_resolution=512, detect_resolution=512,
                   ddim_steps=30, scale=9.0, control_scale=0.5)
    edit_b = expected_flash_launches(editor.bundle.unet_cfg, 30,
                                     sam_layers=sam_layers)
    amg = editor.amg_cfg
    amg_calls = -(-amg.num_points // amg.points_per_batch)
    for tag, detector, text, flow, det_b in (
            ("GroundingDINO (UI)", det, DINO_CAPTION, DINO_UI, dino_b),
            ("GroundingDINO (open)", dino_open, DINO_CAPTION, GROUNDING_OPEN,
             dino_b),
            ("VLPart (UI)", vdet, VLPART_VOCABULARY, VLPART_UI, 0)):
        n_sam = boxes_to_sam(detector(image, text)[1], flow)
        pipe = TextGuidedEditPipeline(editor, detector, **flow)
        _, counts = timed_request(
            "grounding", f"TextGuidedEditPipeline, {tag}, "
            f"{text!r} (detect, {n_sam} boxes to SAM, the SAM ID map, 512^2, 2 "
            f"samples, 30 steps, CFG 9)", editor, pipe, mask_prompt=text,
            **request, seed=800, generator=torch.Generator("cuda").manual_seed(800))
        want = {"flash_attention": det_b + (sam_layers if n_sam else 0) + edit_b,
                "sam_twoway": n_sam + amg_calls,
                "sam_upscale_hyper": n_sam + amg_calls}
        print(f"[grounding]   launches B {counts['flash_attention']}, D "
              f"{counts['sam_twoway']}, C {counts['sam_upscale_hyper']}; "
              f"predicted {want}")
        for name, n in want.items():
            check(counts[name] == n, f"{tag} request: {name} launched "
                  f"{counts[name]} times, predicted {n}")
        results[f"text edit {tag}"] = counts
    del model, vmodel, det, vdet, dino_open
    torch.cuda.empty_cache()
    print(f"[grounding] phase 4g: {time.perf_counter() - t_phase:.1f} s")
    return results


# phase 5t: training. B's fp32 kernel at the shapes a ControlNet training
# step at 512^2 with batch 2 gives it (no CFG): (label, B, H, N, M, Dqk, Dv),
# the UNet's and ControlNet's self and cross attention per level and the
# preprocessor's VAE encoder mid attention
TRAIN_ATTN_SHAPES = [
    ("train unet 64x64 self", 2, 8, 4096, 4096, 40, 40),
    ("train unet 64x64 cross", 2, 8, 4096, 77, 40, 40),
    ("train unet 32x32 self", 2, 8, 1024, 1024, 80, 80),
    ("train unet 16x16 self", 2, 8, 256, 256, 160, 160),
    ("train unet 8x8 self", 2, 8, 64, 64, 160, 160),
    ("train vae encoder mid 64x64", 2, 1, 4096, 4096, 512, 512),
]
# the gradient checks' shapes: B at UNet levels (batch 2), A at UNet
# activations (eps 1e-5 with SiLU, the transformer norm's 1e-6 without),
# E at the UNet's 64x64 320->320 and 32x32 320->640 blocks
TRAIN_GRAD_ATTN = [(2, 8, 4096, 4096, 40, 40), (2, 8, 1024, 77, 80, 80),
                   (2, 8, 256, 256, 160, 160)]
TRAIN_GRAD_GN = [((2, 320, 64, 64), 1e-5, True), ((2, 640, 32, 32), 1e-6,
                                                   False)]
TRAIN_GRAD_RESNET = [(2, 320, 320, 64), (2, 320, 640, 32)]
# gradients of the Functions against the twins' autograd on the same
# inputs, cuDNN deterministic: the backward is the twin's, so the two
# should agree to the bit; fp32 and bf16 alike, relative to the largest
# gradient
TRAIN_GRAD_REL = 1e-5
# the tiny ControlNet step, fp32 CUDA against the CPU: the loss 1e-5
# relative, each gradient 1e-4 of its tensor's largest (fp32 through two
# deep stacks and their backward, summed in other orders, TF32 off)
TINY_TRAIN_LOSS_RTOL = 1e-5
TINY_TRAIN_GRAD_REL = 1e-4
# train() at full width: an SA-1B-layout folder of TRAIN_IMAGES PNGs of
# TRAIN_IMAGE_HW with TRAIN_MASKS RLE masks each (three batches of 2)
TRAIN_IMAGES = 6
TRAIN_IMAGE_HW = (768, 1024)
TRAIN_MASKS = 40


def _grad_check(fn, twin, inputs, seed):
    """The Function's output, gradients, and the twin's, for one cotangent;
    returns (forward error, largest gradient error over its scale)."""
    results = []
    for f in (fn, twin):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = f(*leaves)
        check(out.grad_fn is not None, "no grad_fn on a kernel's output")
        g = torch.randn(out.shape, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(seed)).to(out.dtype)
        # cuDNN's default conv backward sums in an order that changes from
        # call to call; its deterministic algorithms make two runs of the
        # same backward comparable
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            results.append((out.detach(),
                            torch.autograd.grad(out, leaves, g)))
    (out, got), (ref, want) = results
    worst = max(max_err(a, b) / max(b.float().abs().max().item(), 1e-30)
                for a, b in zip(got, want))
    return out, ref, worst


def train_kernel_gradients():
    """B, A and E through their Functions on the card, fp32 and bf16, at
    UNet shapes: outputs within the kernels' bounds of the twins,
    gradients the twins' own."""
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.core import kernels as K
    g = torch.Generator("cuda").manual_seed(21)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for b, h, n, m, dqk, dv in TRAIN_GRAD_ATTN:
            q, k, v = (torch.randn(b, h, x, d, generator=g, device="cuda"
                                   ).to(dtype)
                       for x, d in ((n, dqk), (m, dqk), (m, dv)))
            out, ref, worst = _grad_check(FA.flash_attention,
                                          FA.flash_attention_reference,
                                          (q, k, v), 1)
            err, bound = max_err(out, ref), attention_bound(dtype, ref)
            print(f"[train] flash_attention {tag} {(b, h, n, m, dqk, dv)}: "
                  f"forward {err:.3e} <= {bound:.3e}, gradients dq/dk/dv "
                  f"within {worst:.3e} of the twin's (<= {TRAIN_GRAD_REL})")
            check(err <= bound and worst <= TRAIN_GRAD_REL,
                  f"flash_attention {tag} gradients {(b, h, n, m, dqk, dv)}")
        for shape, eps, silu in TRAIN_GRAD_GN:
            x, w, bias = group_norm_inputs(g, dtype, shape)
            out, ref, worst = _grad_check(
                lambda x, w, b: K.group_norm_silu(x, w, b, eps=eps,
                                                  apply_silu=silu),
                lambda x, w, b: K.group_norm_silu_reference(
                    x, w, b, eps=eps, apply_silu=silu), (x, w, bias), 2)
            err = max_err(out, ref)
            print(f"[train] group_norm_silu {tag} {shape} eps={eps:g} "
                  f"silu={silu}: forward {err:.3e} <= {GN_BOUNDS[dtype]:g}, "
                  f"gradients dx/dscale/dbias within {worst:.3e}")
            check(err <= GN_BOUNDS[dtype] and worst <= TRAIN_GRAD_REL,
                  f"group_norm_silu {tag} gradients {shape}")
        for n, cin, cout, side in TRAIN_GRAD_RESNET:
            x, args = resnet_inputs(g, dtype, n, cin, cout, True, side)
            present = [i for i, a in enumerate(args) if a is not None]

            def spread(rest):
                full = [None] * len(args)
                for i, t in zip(present, rest):
                    full[i] = t
                return full
            out, ref, worst = _grad_check(
                lambda x, *r: K.resnet_fused(x, *spread(r)),
                lambda x, *r: K.resnet_fused_reference(x, *spread(r)),
                [x] + [args[i] for i in present], 3)
            err = max_err(out, ref)
            bound = (RESNET_BF16_REL_BOUND * ref.float().abs().max().item()
                     if dtype == torch.bfloat16 else RESNET_F32_BOUND)
            print(f"[train] resnet_fused {tag} {n}x{cin}->{cout} at "
                  f"{side}x{side}: forward {err:.3e} <= {bound:.3e}, "
                  f"gradients of x, trow and 10 parameters within "
                  f"{worst:.3e}")
            check(err <= bound and worst <= TRAIN_GRAD_REL,
                  f"resnet_fused {tag} gradients {(n, cin, cout, side)}")
        torch.cuda.empty_cache()


def train_attention_rows() -> dict:
    """Kernel B in fp32 at the training step's shapes: error against the
    twin, kernel, twin and SDPA fp32 times, and the bound at 67 TFLOP/s."""
    from editanything_tpu_torch.core import flash_attention as FA
    g = torch.Generator("cuda").manual_seed(22)
    rows = {}
    for label, b, h, n, m, dqk, dv in TRAIN_ATTN_SHAPES:
        q, k, v = (torch.randn(b, h, x, d, generator=g, device="cuda")
                   for x, d in ((n, dqk), (m, dqk), (m, dv)))
        err = max_err(FA.flash_attention(q, k, v),
                      FA.flash_attention_reference(q, k, v))
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v), 3)
        plain = cuda_ms(lambda: FA.flash_attention_reference(q, k, v), 3)
        sdpa = cuda_ms(lambda: sdpa_call(q, k, v, dqk ** -0.5), 3)
        least, by = bound_ms(*attention_work(b, h, n, m, dqk, dv, 4),
                             PEAK_FP32)
        print(f"[train] flash_attention fp32 {label} {(b, h, n, m, dqk, dv)}: "
              f"max_abs_err {err:.3e} <= {ATTN_F32_BOUND:g}; kernel {ms:.4f} "
              f"ms, plain {plain:.4f} ms, bound {least:.4f} ms ({by}, 67 "
              f"TFLOP/s fp32), SDPA fp32 {sdpa:.4f} ms")
        check(err <= ATTN_F32_BOUND, f"flash_attention fp32 {label}: {err}")
        rows[label] = {"shape": [b, h, n, m, dqk, dv], "dtype": "fp32",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain,
                       "bound_ms": least, "bound_by": by, "library_ms": sdpa}
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def tiny_train_parity(fused: bool):
    """One step of the tiny ControlNet (remat "dots") in fp32 on the card
    (the kernels forward, the twins backward) against the CPU (twins
    only), the zero convs drawn: every ControlNet tensor's gradient nonzero
    on the card and within TINY_TRAIN_GRAD_REL of the CPU's."""
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.samplers.schedule import make_schedule
    from editanything_tpu_torch.train import controlnet_train as T
    g = torch.Generator().manual_seed(0)
    batch = {"latents": torch.randn(2, 4, 8, 8, generator=g),
             "hint": torch.rand(2, 3, 64, 64, generator=g),
             "context": torch.randn(2, 8, 32, generator=g)}
    t, noise = torch.tensor([17, 640]), torch.randn(2, 4, 8, 8, generator=g)
    losses, grads, counts = [], [], None
    with_fused_resnets(fused)
    for device in ("cpu", "cuda"):
        tb = random_bundle(tiny=True, device="cpu", controlnet_names=("sam",),
                           generator=torch.Generator().manual_seed(3))
        tb.to(device)
        tb.unet.requires_grad_(False)
        cn = tb.controlnets["sam"][1]
        state = T.init_train_state(cn, lambda p: torch.optim.SGD(p, lr=1.0))
        _zero_counts()
        _, m = T.make_train_step(make_schedule(), remat=True)(
            state, tb.unet, {k: v.to(device) for k, v in batch.items()},
            t=t, noise=noise)
        counts = _counts()
        losses.append(float(m["loss"]))
        grads.append({k: p.grad.cpu() for k, p in
                      state.controlnet.named_parameters()})
    with_fused_resnets(False)
    worst = max(max_err(grads[1][k], w) / w.abs().max().item()
                for k, w in grads[0].items())
    zero = [k for k, v in grads[1].items() if v.abs().max().item() == 0]
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    print(f"[train] tiny ControlNet step{' (resnets fused)' if fused else ''}"
          f", fp32 CUDA vs CPU: loss {losses[1]:.6f} vs {losses[0]:.6f} (rel "
          f"{rel:.2e}), gradients within {worst:.3e} of each tensor's largest "
          f"over {len(grads[0])} tensors, {len(zero)} zero on the card; "
          f"launches {counts}")
    check(rel <= TINY_TRAIN_LOSS_RTOL, f"tiny train loss {losses}")
    check(worst <= TINY_TRAIN_GRAD_REL, f"tiny train gradients {worst}")
    check(not zero, f"ControlNet tensors without a gradient on the card: {zero}")
    check(counts["flash_attention"] > 0 and counts["group_norm_silu"] > 0
          and (counts["resnet_fused"] > 0) == fused,
          f"tiny train step launches {counts}")


def write_sa1b_folder(d: str) -> None:
    """An SA-1B-layout folder: PNG targets, annotation JSONs whose masks are
    COCO RLE (rectangles and discs, overlapping), data.txt of dict
    literals."""
    from editanything_tpu_torch.ops import rle
    from editanything_tpu_torch.utils.image import write_png
    rng = np.random.RandomState(23)
    h, w = TRAIN_IMAGE_HW
    yy, xx = np.mgrid[0:h, 0:w]
    lines = []
    for i in range(TRAIN_IMAGES):
        img = _checker_image(h, w)
        img[..., 2] = rng.randint(0, 256, (h, w))
        write_png(os.path.join(d, f"sa_{i}.png"), img)
        anns = []
        for j in range(TRAIN_MASKS):
            cy, cx = rng.randint(0, h), rng.randint(0, w)
            r = rng.randint(20, 200)
            m = (((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r) if j % 2 else
                 ((abs(yy - cy) <= r) & (abs(xx - cx) <= r // 2)))
            anns.append({"segmentation": rle.encode(m.astype(np.uint8))})
        with open(os.path.join(d, f"sa_{i}.json"), "w") as f:
            json.dump({"image": {"height": h, "width": w},
                       "annotations": anns}, f)
        lines.append(repr({"target": f"sa_{i}.png", "source": f"sa_{i}.json",
                           "prompt": f"a photo of a cat on a sofa {i}"}))
    with open(os.path.join(d, "data.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


@contextlib.contextmanager
def timed_train_steps(records: list):
    """Every iteration of ``train()``'s loop timed: the batch fetch (the
    dataset on the host), the preprocessor (VAE encode and CLIP) and the
    step through train_controlnet's ``make_train_step``, each
    synchronised, and the whole iteration from the fetch to the step's
    end. Each step appends {"step_s", "counts" (its B and A launches),
    "loss", "fetch_s", "pre_s", "iteration_s"}."""
    from editanything_tpu_torch import data as D
    from editanything_tpu_torch.train import train_controlnet as TC
    made_step, made_pre = TC.make_train_step, TC.make_preprocessor
    made_batcher = D.make_batcher
    cur = {}

    def batcher(*args, **kwargs):
        batches = iter(made_batcher(*args, **kwargs))
        while True:
            torch.cuda.synchronize()
            cur["start"] = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            cur["fetch_s"] = time.perf_counter() - cur["start"]
            yield batch

    def make_pre(*args, **kwargs):
        pre = made_pre(*args, **kwargs)

        def timed(*a, **kw):
            out, cur["pre_s"] = _synced(pre, *a, **kw)
            return out
        return timed

    def make_step(*args, **kwargs):
        step = made_step(*args, **kwargs)

        def timed(*a, **kw):
            _zero_counts()
            out, seconds = _synced(step, *a, **kw)
            records.append({"step_s": seconds, "counts": _counts(),
                            "loss": float(out[1]["loss"]),
                            "fetch_s": cur["fetch_s"], "pre_s": cur["pre_s"],
                            "iteration_s": time.perf_counter() - cur["start"]})
            return out
        return timed
    TC.make_train_step, TC.make_preprocessor = make_step, make_pre
    D.make_batcher = batcher
    try:
        yield
    finally:
        TC.make_train_step, TC.make_preprocessor = made_step, made_pre
        D.make_batcher = made_batcher


def predicted_train_launches(unet, controlnet) -> dict:
    """B and A launches of one training step under remat "dots": every
    attention and every GroupNorm of the ControlNet and the UNet once in
    the forward and once more in its recompute; the backwards (the twins)
    launch none."""
    from editanything_tpu_torch.core.layers import GroupNorm
    from editanything_tpu_torch.models.blocks import Attention

    def count(cls):
        return sum(isinstance(m, cls) for net in (unet, controlnet)
                   for m in net.modules())
    return {"flash_attention": 2 * count(Attention),
            "group_norm_silu": 2 * count(GroupNorm)}


def _checksum(module) -> float:
    return float(sum(p.detach().double().sum().item()
                     for p in module.parameters()))


def textinv_on_the_main_editor(editor) -> dict:
    """``train_staged_textinv`` on the main path's editor, whose bundle is
    bf16 as ``load_bundle`` gives it: one step of batch 1 at 512^2 on a
    staged crop through kernels B and A; the learned rows finite, only the
    10 placeholder rows changed, the table still bf16."""
    import tempfile
    from editanything_tpu_torch.utils.image import write_png
    bundle = editor.bundle
    check(bundle.dtype == torch.bfloat16, f"the main editor is {bundle.dtype}")
    weight = bundle.text.embeddings.token_embedding.weight
    v0, table0 = weight.shape[0], weight.detach().clone()
    with tempfile.TemporaryDirectory(dir=REPO) as d:
        editor.textinv_stage_dir = os.path.join(d, "stage")
        os.makedirs(editor.textinv_stage_dir)
        write_png(os.path.join(editor.textinv_stage_dir, "ref.png"),
                  _checker_image(512, 512))
        path = os.path.join(d, "learned_embeds.npy")
        _zero_counts()
        _, seconds = _synced(editor.train_staged_textinv, path, max_steps=1,
                             batch_size=1, resolution=512)
        counts = _counts()
        learned = np.load(path)
    table = bundle.text.embeddings.token_embedding.weight.detach()
    check(table.dtype == torch.bfloat16 and table.shape[0] == v0 + 10
          and torch.equal(table[:v0], table0),
          "bf16 TI changed rows other than the placeholder's")
    init = table0[bundle.tokenizer.encode("mark")[0]]
    check(np.isfinite(learned).all() and not torch.equal(
        table[v0:], init[None].expand(10, -1)),
        "bf16 TI left the placeholder rows at their initializer")
    check(counts["flash_attention"] > 0 and counts["group_norm_silu"] > 0,
          f"bf16 TI launches {counts}")
    print(f"[train] train_staged_textinv on the main path's editor (SD1.5 "
          f"bf16): 1 step of batch 1 at 512^2 in {seconds:.2f} s, launches "
          f"{counts}; only the 10 placeholder rows changed, finite")
    return counts


def phase_training() -> dict:
    """Phase 5t: the Functions' gradients, the tiny step against the CPU,
    then ``train()`` and ``train_textual_inversion()`` (through the editor's
    ``train_staged_textinv``) at the published SD1.5 widths in fp32, random
    weights, and a ``process`` request on the learned embedding."""
    import tempfile
    from editanything_tpu_torch.checkpoints.safetensors_io import load_file
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    from editanything_tpu_torch.train.train_controlnet import train
    t_phase = time.perf_counter()
    train_kernel_gradients()
    attn_rows = train_attention_rows()
    tiny_train_parity(False)
    tiny_train_parity(True)

    t0 = time.perf_counter()
    bundle = random_bundle(tiny=False, device="cuda", dtype=torch.float32,
                           generator=torch.Generator("cuda").manual_seed(5),
                           controlnet_names=("sam",))
    cn = bundle.controlnets["sam"][1]
    n_unet = sum(p.numel() for p in bundle.unet.parameters())
    n_cn = sum(p.numel() for p in cn.parameters())
    print(f"[train] SD1.5 at published widths, fp32, random weights (seed 5, "
          f"zero convs drawn): UNet {n_unet / 1e6:.1f} M, ControlNet "
          f"{n_cn / 1e6:.1f} M parameters, built in "
          f"{time.perf_counter() - t0:.1f} s")
    unet_sum = _checksum(bundle.unet)
    cn_before = [p.detach().clone() for p in cn.parameters()]
    predicted = predicted_train_launches(bundle.unet, cn)
    records = []
    with tempfile.TemporaryDirectory(dir=REPO) as d:
        data = os.path.join(d, "sa1b")
        os.makedirs(data)
        t0 = time.perf_counter()
        write_sa1b_folder(data)
        print(f"[train] SA-1B-layout folder: {TRAIN_IMAGES} PNGs "
              f"{TRAIN_IMAGE_HW}, {TRAIN_MASKS} RLE masks each, written in "
              f"{time.perf_counter() - t0:.1f} s")
        kw = dict(data_path=data, txt_path=os.path.join(data, "data.txt"),
                  out_dir=os.path.join(d, "run"), bundle=bundle, batch_size=2,
                  resolution=512, remat=True, use_ema=True, log_every=1,
                  ckpt_every=100)
        torch.cuda.reset_peak_memory_stats()
        with timed_train_steps(records):
            t0 = time.perf_counter()
            state, seconds = _synced(
                train, max_steps=3, image_every=2, sample_steps=2,
                export_path=os.path.join(d, "cn.safetensors"), **kw)
            t_train = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            images = sorted(os.listdir(os.path.join(d, "run", "images")))
            exported = load_file(os.path.join(d, "cn.safetensors"))
            ckpt_bytes = os.path.getsize(os.path.join(d, "run", "ckpt",
                                                      "step_3.pt"))
            check(state.step == 3, f"train() stopped at step {state.step}")
            for name in ("input", "hint", "reconstruction", "samples",
                         "samples_ema"):
                check(f"{name}_00000002.png" in images, f"no {name} grid")
            ema = state.ema.state_dict()
            check(sorted(exported) == sorted(ema) and all(
                torch.equal(exported[k], ema[k].cpu()) for k in ema),
                "the exported file is not the EMA ControlNet")
            changed = sum(not torch.equal(a, b) for a, b in
                          zip(cn_before, state.controlnet.parameters()))
            del state, ema, exported
            torch.cuda.empty_cache()
            resumed, t_resume = _synced(train, max_steps=4, image_every=100,
                                        **kw)
            check(resumed.step == 4, f"resume stopped at {resumed.step}")
            del resumed
            torch.cuda.empty_cache()
    check(changed == len(cn_before),
          f"{len(cn_before) - changed} ControlNet tensors did not change")
    check(all(torch.equal(a, b) for a, b in zip(cn_before, cn.parameters())),
          "train() changed the bundle's own ControlNet")
    unet_after = _checksum(bundle.unet)
    check(unet_after == unet_sum, f"the UNet changed: {unet_sum} -> "
                                  f"{unet_after}")
    def listed(key):
        vals = [r[key] for r in records]
        return (f"{', '.join(f'{x:.3f}' for x in vals)} (mean after the "
                f"first {sum(vals[1:]) / len(vals[1:]):.3f})")
    losses = [r["loss"] for r in records]
    print(f"[train] train(): 3 steps of batch 2 at 512^2 (remat dots, EMA, a "
          f"DDIM grid at step 2, checkpoint, export) in {t_train:.1f} s, then "
          f"a resume to step 4 in {t_resume:.1f} s; seconds per iteration "
          f"(batch fetch to the step's end, synchronised) "
          f"{listed('iteration_s')}, of which the batch fetch "
          f"{listed('fetch_s')}, the preprocessor (VAE encode + CLIP) "
          f"{listed('pre_s')} and the step {listed('step_s')}; "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"a checkpoint {ckpt_bytes / 2**30:.2f} GiB; {changed} of "
          f"{len(cn_before)} ControlNet tensors changed, UNet checksum "
          f"{unet_after!r} unchanged")
    print(f"[train] launches per step {[r['counts'] for r in records]}; "
          f"predicted B "
          f"{predicted['flash_attention']} and A "
          f"{predicted['group_norm_silu']} (forward + recompute)")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    for r in records:
        for name, want in predicted.items():
            check(r["counts"][name] == want, f"{name} {r['counts'][name]} launches a "
                                        f"step, predicted {want}")
    del cn_before

    # textual inversion through the editor: stage, learn, load
    editor = EditAnythingEditor(bundle)
    text = bundle.text.embeddings.token_embedding
    v0 = text.num_embeddings
    table0 = text.weight.detach().clone()
    img = _checker_image(512, 512)
    req = dict(image=img, mask=_square_mask(512, 128, 384),
               condition_image=_checker_image(512, 512),
               prompt="a photo of <new-obj> on a sofa", num_samples=1,
               image_resolution=512, detect_resolution=512, ddim_steps=10,
               ref_image=img[::-1].copy(), ref_mask=_square_mask(512, 64, 448),
               ref_textinv=True, seed=3)
    with tempfile.TemporaryDirectory(dir=REPO) as d:
        editor.textinv_stage_dir = os.path.join(d, "stage")
        path = os.path.join(d, "learned_embeds.npy")
        _, t_stage = _synced(editor.process, **req, ref_textinv_path=path)
        check(os.path.exists(os.path.join(d, "stage", "ref.png")),
              "process did not stage the reference crop")
        _zero_counts()
        _, t_ti = _synced(editor.train_staged_textinv, path, max_steps=3,
                          batch_size=1, resolution=512)
        ti_counts = _counts()
        table = bundle.text.embeddings.token_embedding.weight.detach()
        check(table.shape[0] == v0 + 10 and torch.equal(table[:v0], table0),
              "TI changed rows other than the placeholder's")
        init = table0[bundle.tokenizer.encode("mark")[0]]
        check(not torch.equal(table[v0:], init[None].expand(10, -1)),
              "TI left the placeholder rows at their initializer")
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        (_, results, _, _), t_req = _synced(editor.process, **req,
                                            ref_textinv_path=path)
        req_counts = _counts()
        req_peak = torch.cuda.max_memory_allocated()
        out = np.stack(results)
        check(out.shape == (1, 512, 512, 3) and out.dtype == np.uint8
              and editor.pipe.last_nonfinite == 0,
              f"process on the learned embedding: {out.shape}")
        check(bundle.tokenizer.placeholders["<new-obj>"]
              == list(range(v0 + 10, v0 + 20)),
              "the loaded embedding's placeholder")
    print(f"[train] textual inversion through the editor (SD1.5 fp32): the "
          f"crop staged by a process request ({t_stage:.2f} s), "
          f"train_staged_textinv 3 steps of batch 1 at 512^2 in {t_ti:.2f} s "
          f"(launches {ti_counts}), only the 10 placeholder rows changed; "
          f"process(ref_textinv=True, ref_textinv_path=...) {t_req:.2f} s "
          f"(1 sample, 10 steps), peak {req_peak / 2**30:.2f} GiB, launches "
          f"{req_counts}")
    del editor, bundle
    torch.cuda.empty_cache()
    print(f"[train] phase 5t: {time.perf_counter() - t_phase:.1f} s")
    step_counts = dict(records[-1]["counts"])
    return {"controlnet train step": step_counts,
            "textual inversion (3 steps)": ti_counts,
            "process on the learned embedding": req_counts,
            "train attention rows": attn_rows}


# phase 6: DreamBooth-inpaint, its LoRA variant, data parallelism and the
# command line. The class images and the training step at the published
# SD1.5 widths; DreamBooth's batch is 1 instance + 1 class image (prior
# preservation), as the reference's default --train_batch_size 1
DB_CLASS_IMAGES = 2
DB_CLASS_STEPS = 30
DB_STEPS = 3
DB_LORA_RANK = 4
DB_RESOLUTION = 512
DB_LR = 5e-6
# the command line's edit on the files the phase writes: 1 sample, fewer
# steps than the UI's 30 (the edit's time is phases 4 and 5's)
CLI_EDIT_STEPS = 10


def db_predicted_launches(bundle) -> dict:
    """B and A launches of DreamBooth's pieces, by module count: a step
    runs the 9-channel UNet's forward once (no remat; the backwards are the
    twins', which launch nothing); the preprocessor two VAE encodes; a
    class-image batch the UNet at every step (CFG by batch doubling, one
    call), one VAE encode of the blank image and one decode."""
    from editanything_tpu_torch.core.layers import GroupNorm
    from editanything_tpu_torch.models.blocks import Attention, VAEAttention

    def count(module, cls):
        return sum(isinstance(m, cls) for m in module.modules())

    def launches(module):
        # the VAE attention's own norm is plain F.group_norm, not kernel A
        return {"flash_attention": count(module, (Attention, VAEAttention)),
                "group_norm_silu": count(module, GroupNorm)
                - count(module, VAEAttention)}
    unet, enc, dec = (launches(m) for m in (bundle.unet, bundle.vae.encoder,
                                            bundle.vae.decoder))
    return {"step": unet,
            "preprocessor": {k: 2 * v for k, v in enc.items()},
            "class batch": {k: DB_CLASS_STEPS * unet[k] + enc[k] + dec[k]
                            for k in unet}}


@contextlib.contextmanager
def timed_db_steps(records: list):
    """Every iteration of the DreamBooth ``train()``'s loop timed: the
    batch (host), the preprocessor (two VAE encodes and the latent mask)
    and the step (full or LoRA), each synchronised, with the B and A
    launches of the preprocessor and of the step; each step appends
    {"fetch_s", "pre_s", "step_s", "iteration_s", "pre_counts", "counts",
    "loss"}."""
    from editanything_tpu_torch.train import train_dreambooth as TD
    made = (TD.make_preprocessor, TD.make_db_train_step,
            TD.make_db_lora_train_step, TD.DreamBoothBatcher.next)
    cur = {}

    def batch_next(self, batch_size):
        torch.cuda.synchronize()
        cur["start"] = time.perf_counter()
        out = made[3](self, batch_size)
        cur["fetch_s"] = time.perf_counter() - cur["start"]
        return out

    def make_pre(*args, **kwargs):
        pre = made[0](*args, **kwargs)

        def timed(*a, **kw):
            _zero_counts()
            out, cur["pre_s"] = _synced(pre, *a, **kw)
            cur["pre_counts"] = _counts()
            return out
        return timed

    def wrap(make):
        def make_step(*args, **kwargs):
            step = make(*args, **kwargs)

            def timed(*a, **kw):
                _zero_counts()
                out, seconds = _synced(step, *a, **kw)
                records.append({
                    "step_s": seconds, "counts": _counts(),
                    "loss": float(out[1]["loss"]), "fetch_s": cur["fetch_s"],
                    "pre_s": cur["pre_s"], "pre_counts": cur["pre_counts"],
                    "iteration_s": time.perf_counter() - cur["start"]})
                return out
            return timed
        return make_step
    TD.make_preprocessor = make_pre
    TD.make_db_train_step = wrap(made[1])
    TD.make_db_lora_train_step = wrap(made[2])
    TD.DreamBoothBatcher.next = batch_next
    try:
        yield
    finally:
        (TD.make_preprocessor, TD.make_db_train_step,
         TD.make_db_lora_train_step, TD.DreamBoothBatcher.next) = made


def _db_images(d: str, n: int, seed: int) -> None:
    from editanything_tpu_torch.utils.image import write_png
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = _checker_image(DB_RESOLUTION, DB_RESOLUTION)
        img[..., 2] = rng.randint(0, 256, img.shape[:2])
        write_png(os.path.join(d, f"img_{i}.png"), img)


def _db_report(tag: str, records: list, predicted: dict) -> dict:
    """Print the iterations and check each step's launches against the
    prediction; returns the last step's launches."""
    def listed(key):
        return ", ".join(f"{r[key]:.3f}" for r in records)
    print(f"[db] {tag}: seconds per iteration {listed('iteration_s')} "
          f"(batch {listed('fetch_s')}, preprocessor {listed('pre_s')}, step "
          f"{listed('step_s')}); losses "
          f"{', '.join(format(r['loss'], '.4f') for r in records)}; launches per "
          f"step {[r['counts'] for r in records]}, per preprocessor "
          f"{records[-1]['pre_counts']}; predicted step {predicted['step']}, "
          f"preprocessor {predicted['preprocessor']}")
    check(all(np.isfinite(r["loss"]) for r in records), f"{tag}: non-finite "
                                                           f"loss")
    for r in records:
        for name in ("flash_attention", "group_norm_silu"):
            check(r["counts"][name] == predicted["step"][name],
                  f"{tag}: {name} {r['counts'][name]} launches a step, "
                  f"predicted {predicted['step'][name]}")
            check(r["pre_counts"][name] == predicted["preprocessor"][name],
                  f"{tag}: {name} {r['pre_counts'][name]} launches a "
                  f"preprocessor call, predicted "
                  f"{predicted['preprocessor'][name]}")
    return dict(records[-1]["counts"])


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def _open_local_group():
    """A one-rank nccl process group over localhost (the card is one
    device: world size 1)."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    return dist.group.WORLD


def write_bundle_files(bundle, d: str, controlnets, dtype=torch.float16):
    """A bundle as the files a bundle spec names (diffusers / HF layouts,
    `.safetensors` in `dtype`) and its tokenizer's merges; returns the
    spec's file entries."""
    from editanything_tpu_torch.checkpoints.safetensors_io import save_file

    def write(name, sd):
        path = os.path.join(d, name)
        save_file({k: v.detach().to(dtype).contiguous()
                   for k, v in sd.items()}, path)
        return path
    tok = bundle.tokenizer
    merges = os.path.join(d, "merges.txt")
    with open(merges, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(
            " ".join(p) for p in sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)))
    return {"unet": write("unet.safetensors", bundle.unet.state_dict()),
            "vae": write("vae.safetensors", bundle.vae.state_dict()),
            "text": write("text.safetensors", {
                "text_model." + k: v
                for k, v in bundle.text.state_dict().items()}),
            "tokenizer_merges": merges,
            "controlnets": {name: write(f"controlnet_{name}.safetensors",
                                        bundle.controlnets[name][1]
                                        .state_dict())
                            for name in controlnets}}


def db_full_and_lora(bundle, d: str, predicted: dict) -> dict:
    """``train()`` in fp32: the full finetune for DB_STEPS steps and a
    resume, then the LoRA variant over the same data; each iteration timed
    and its launches checked; the LoRA run leaves the UNet bit-unchanged."""
    from editanything_tpu_torch.train.train_dreambooth import train
    kw = dict(instance_data_dir=os.path.join(d, "inst"),
              instance_prompt="a photo of a cat on a sofa", bundle=bundle,
              class_data_dir=os.path.join(d, "class"),
              class_prompt="a photo of a cat", with_prior_preservation=True,
              num_class_images=DB_CLASS_IMAGES, batch_size=1, lr=DB_LR,
              resolution=DB_RESOLUTION, log_every=1, ckpt_every=100)
    out = {}
    records = []
    unet_before = [p.detach().clone() for p in bundle.unet.parameters()]
    torch.cuda.reset_peak_memory_stats()
    with timed_db_steps(records):
        state, t_full = _synced(train, output_dir=os.path.join(d, "full"),
                                max_steps=DB_STEPS, **kw)
        peak = torch.cuda.max_memory_allocated()
        ckpt = os.path.join(d, "full", "ckpt", f"step_{DB_STEPS}.pt")
        ckpt_bytes = os.path.getsize(ckpt)
        changed = sum(not torch.equal(a, b) for a, b in
                      zip(unet_before, state.unet.parameters()))
        check(state.step == DB_STEPS and changed == len(unet_before),
              f"full finetune: step {state.step}, {changed} of "
              f"{len(unet_before)} UNet tensors changed")
        del state
        torch.cuda.empty_cache()
        resumed, t_resume = _synced(train, output_dir=os.path.join(d, "full"),
                                    max_steps=DB_STEPS + 1, **kw)
        check(resumed.step == DB_STEPS + 1, f"resume at {resumed.step}")
        del resumed
        torch.cuda.empty_cache()
    check(all(torch.equal(a, b) for a, b in
              zip(unet_before, bundle.unet.parameters())),
          "the full finetune changed the bundle's own UNet")
    print(f"[db] full finetune (fp32, batch 1 + 1 class image at "
          f"{DB_RESOLUTION}^2, AdamW): {DB_STEPS} steps in {t_full:.1f} s, a "
          f"resume to step {DB_STEPS + 1} in {t_resume:.1f} s; peak "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); a "
          f"checkpoint {ckpt_bytes / 2**30:.2f} GiB; every UNet tensor "
          f"changed, the bundle's own unchanged")
    out["dreambooth step"] = _db_report("full finetune", records, predicted)
    out["dreambooth preprocessor"] = dict(records[-1]["pre_counts"])
    shutil.rmtree(os.path.join(d, "full"), ignore_errors=True)

    records.clear()
    torch.cuda.reset_peak_memory_stats()
    with timed_db_steps(records):
        lora, t_lora = _synced(train, output_dir=os.path.join(d, "lora"),
                               max_steps=DB_STEPS, use_lora=True,
                               lora_rank=DB_LORA_RANK, **kw)
    peak = torch.cuda.max_memory_allocated()
    check(all(torch.equal(a, b) for a, b in
              zip(unet_before, bundle.unet.parameters())),
          "the LoRA run changed the frozen UNet")
    ups = [d_["up"] for d_ in lora.deltas.tree().values()]
    check(lora.step == DB_STEPS and all(bool(u.abs().max() > 0) for u in ups),
          "LoRA: an up stayed zero")
    n = sum(p.numel() for p in lora.deltas.parameters())
    print(f"[db] LoRA rank {DB_LORA_RANK} ({len(ups)} projections, "
          f"{n / 1e6:.2f} M parameters): {DB_STEPS} steps in {t_lora:.1f} s, "
          f"peak {peak / 2**30:.2f} GiB; the frozen UNet bit-unchanged "
          f"(every tensor torch.equal), every up moved")
    out["dreambooth lora step"] = _db_report("LoRA", records, predicted)
    del lora, unet_before
    shutil.rmtree(os.path.join(d, "lora"), ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def db_with_a_group(bundle, d: str, group) -> None:
    """One DreamBooth step (full finetune) with the one-rank group and one
    without, from the same start: equal to the bit (cuDNN deterministic)."""
    from editanything_tpu_torch.train.train_dreambooth import train
    kw = dict(instance_data_dir=os.path.join(d, "inst"),
              instance_prompt="a photo of a cat on a sofa", bundle=bundle,
              class_data_dir=os.path.join(d, "class"),
              class_prompt="a photo of a cat", with_prior_preservation=True,
              num_class_images=DB_CLASS_IMAGES, batch_size=1, lr=DB_LR,
              resolution=DB_RESOLUTION, max_steps=1, ckpt_every=100)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        plain = train(output_dir=os.path.join(d, "plain"), **kw)
        shutil.rmtree(os.path.join(d, "plain"), ignore_errors=True)
        ddp, seconds = _synced(train, output_dir=os.path.join(d, "ddp"),
                               group=group, **kw)
        shutil.rmtree(os.path.join(d, "ddp"), ignore_errors=True)
    check(_params_equal(plain.unet, ddp.unet),
          "DreamBooth: the step in a one-rank group differs from the plain "
          "step")
    print(f"[db] one DreamBooth step (full finetune) in a one-rank nccl group "
          f"({seconds:.2f} s) equals the step without it to the bit")
    del plain, ddp
    torch.cuda.empty_cache()


def controlnet_with_a_group(bundle, d: str, group) -> None:
    """One ControlNet ``train()`` step with the one-rank group and one
    without, from the same start and data: equal to the bit."""
    from editanything_tpu_torch.train.train_controlnet import train
    data = os.path.join(d, "sa1b")
    os.makedirs(data)
    write_sa1b_folder(data)
    kw = dict(data_path=data, txt_path=os.path.join(data, "data.txt"),
              bundle=bundle, batch_size=2, resolution=512, max_steps=1,
              use_ema=False, image_every=100, ckpt_every=100)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        plain = train(out_dir=os.path.join(d, "cn_plain"), **kw)
        shutil.rmtree(os.path.join(d, "cn_plain"), ignore_errors=True)
        ddp, seconds = _synced(train, out_dir=os.path.join(d, "cn_ddp"),
                               group=group, **kw)
        shutil.rmtree(os.path.join(d, "cn_ddp"), ignore_errors=True)
    check(_params_equal(plain.controlnet, ddp.controlnet),
          "ControlNet: the step in a one-rank group differs from the plain "
          "step")
    print(f"[db] one ControlNet train() step in a one-rank nccl group "
          f"({seconds:.2f} s) equals the step without it to the bit")
    del plain, ddp
    torch.cuda.empty_cache()


def cli_edit(bundle, d: str) -> dict:
    """The command line's ``edit`` with no mask (the AMG runs kernels D and
    C) on full-width files: the bundle in fp16 and SAM ViT-H's fp32 ``.pth``,
    written here and loaded by ``_build_editor`` in bf16."""
    from editanything_tpu_torch.apps.cli import main
    from editanything_tpu_torch.models import sam as SAM
    from editanything_tpu_torch.pipelines.bundle import random_sam
    from editanything_tpu_torch.utils.image import read_image, write_png
    t0 = time.perf_counter()
    spec = write_bundle_files(bundle, d, ("sam", "inpaint"))
    sam = random_sam(SAM.sam_vit_h(), device="cuda", dtype=torch.float32,
                     generator=torch.Generator("cuda").manual_seed(41))
    spec["sam"] = os.path.join(d, "sam_vit_h.pth")
    torch.save({k: v.cpu() for k, v in sam.state_dict().items()}, spec["sam"])
    del sam
    nbytes = sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    write_png(os.path.join(d, "image.png"), _checker_image(512, 512))
    print(f"[cli] wrote {nbytes / 2**30:.2f} GiB of full-width files (the "
          f"SD1.5 bundle in fp16, two ControlNets, SAM ViT-H fp32) in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    _, seconds = _synced(main, [
        "edit", "--bundle-spec", os.path.join(d, "spec.json"), "--image",
        os.path.join(d, "image.png"), "--output", os.path.join(d, "out"),
        "--resolution", "512", "--steps", str(CLI_EDIT_STEPS), "--device",
        "cuda"])
    counts, peak = _counts(), torch.cuda.max_memory_allocated()
    img = read_image(os.path.join(d, "out_0.png"))
    predicted = CLI_EDIT_STEPS * 60 + 2 + 32
    print(f"[cli] edit from the spec (load bf16, SAM ViT-H at 1024^2, the AMG, "
          f"the ID map, 1 sample, {CLI_EDIT_STEPS} steps at 512^2): "
          f"{seconds:.2f} s including the load; peak {peak / 2**30:.2f} GiB; "
          f"launches {counts} (B predicted {predicted}: {CLI_EDIT_STEPS} x "
          f"(32 UNet + 2 x 14 ControlNet) + 2 VAE + 32 SAM); output "
          f"{img.shape} {img.dtype}")
    check(img.shape == (512, 512, 3) and img.dtype == np.uint8,
          f"cli edit output {img.shape}")
    check(counts["flash_attention"] == predicted,
          f"cli edit: B {counts['flash_attention']}, predicted {predicted}")
    check(counts["sam_twoway"] > 0 and counts["sam_upscale_hyper"] > 0,
          f"cli edit: D and C did not launch: {counts}")
    return counts


def cli_tiny_tools(d: str) -> None:
    """``train-dreambooth --bundle-spec`` on tiny files and ``add-control``
    on a tiny written SD checkpoint, through the command line in-process."""
    import dataclasses
    from editanything_tpu_torch.apps.cli import main
    from editanything_tpu_torch.checkpoints import ldm as LDM
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    tb = random_bundle(tiny=True, device="cuda", family="sd15_inpaint",
                       controlnet_names=(),
                       generator=torch.Generator("cuda").manual_seed(8))
    # bf16 files and the spec's default dtype (bf16): the trained copy is
    # fp32 all the same, so steps of the default rate (5e-6) move it
    spec = write_bundle_files(tb, d, (), dtype=torch.bfloat16)
    spec.update(configs={
        name: json.loads(json.dumps(dataclasses.asdict(cfg)))
        for name, cfg in (("unet", tb.unet_cfg), ("vae", tb.vae_cfg),
                          ("text", tb.text_cfg))})
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    _db_images(os.path.join(d, "inst"), 2, 9)
    state, seconds = _synced(main, [
        "train-dreambooth", "--bundle-spec", os.path.join(d, "spec.json"),
        "--instance-data-dir", os.path.join(d, "inst"), "--instance-prompt",
        "a photo of a cat", "--output-dir", os.path.join(d, "db"),
        "--max-train-steps", "2", "--resolution", "64", "--device", "cuda"])
    saved = torch.load(os.path.join(d, "db", "unet.pt"), weights_only=True)
    start = {k: v.to(torch.bfloat16).float().cpu()
             for k, v in tb.unet.state_dict().items()}
    moved = (sum(int((saved[k] != v).sum()) for k, v in start.items())
             / sum(v.numel() for v in start.values()))
    check(state.step == 2 and sorted(saved) == sorted(start)
          and all(v.dtype == torch.float32 and torch.isfinite(v).all()
                  for v in saved.values()) and moved > 0.5,
          f"train-dreambooth --bundle-spec (moved {moved:.3f} of the UNet)")
    print(f"[cli] train-dreambooth --bundle-spec (tiny 9-channel bf16 files, "
          f"the default lr 5e-6, 2 steps at 64^2): {seconds:.2f} s, unet.pt "
          f"fp32 and finite, {moved:.4f} of its elements moved")

    sd_path = os.path.join(d, "sd.ckpt")
    cpu = lambda m: {k: v.cpu() for k, v in m.state_dict().items()}
    torch.save({"state_dict": LDM.state_dicts_to_ldm(
        unet=cpu(tb.unet), vae=cpu(tb.vae), text=cpu(tb.text),
        layers_per_block=1)}, sd_path)
    _, seconds = _synced(main, ["add-control", "--input", sd_path, "--output",
                                os.path.join(d, "cldm.ckpt")])
    out = torch.load(os.path.join(d, "cldm.ckpt"), weights_only=True)[
        "state_dict"]
    src = torch.load(sd_path, weights_only=True)["state_dict"]
    ctrl = [k for k in out if k.startswith("control_model.")]
    copied = [k for k in ctrl
              if "model.diffusion_model." + k[len("control_model."):] in src]
    check(len(copied) > 0 and all(torch.equal(
        out[k], src["model.diffusion_model." + k[len("control_model."):]])
        for k in copied), "add-control: the grafted branch")
    print(f"[cli] add-control on a written tiny SD checkpoint: {len(ctrl)} "
          f"control_model keys, {len(copied)} copied from the UNet, in "
          f"{seconds:.2f} s")
    del tb


def phase_dreambooth_and_apps() -> dict:
    """Phase 6: DreamBooth-inpaint at the published SD1.5 widths (random
    weights): the class images in bf16, the full finetune and LoRA in fp32;
    the one-rank nccl group around a ControlNet and a DreamBooth step; the
    command line in-process. Returns each path's launches."""
    import tempfile
    import torch.distributed as dist
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.train.train_dreambooth import \
        generate_class_images
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(dir=REPO) as d:
        # the class images, bf16, through the 9-channel UNet
        b16 = random_bundle(tiny=False, device="cuda", dtype=torch.bfloat16,
                            family="sd15_inpaint", controlnet_names=(),
                            generator=torch.Generator("cuda").manual_seed(6))
        predicted = db_predicted_launches(b16)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        n, seconds = _synced(
            generate_class_images, b16, class_dir=os.path.join(d, "class"),
            class_prompt="a photo of a cat", num_class_images=DB_CLASS_IMAGES,
            resolution=DB_RESOLUTION, num_steps=DB_CLASS_STEPS,
            batch_size=DB_CLASS_IMAGES)
        counts, peak = _counts(), torch.cuda.max_memory_allocated()
        print(f"[db] generate_class_images (9-channel SD1.5 inpaint, bf16, "
              f"{DB_CLASS_IMAGES} images of {DB_RESOLUTION}^2 in one batch, "
              f"{DB_CLASS_STEPS} UniPC steps, CFG 7.5): {n} JPEGs in "
              f"{seconds:.2f} s; peak {peak / 2**30:.2f} GiB; launches "
              f"{counts}, predicted {predicted['class batch']}")
        check(n == DB_CLASS_IMAGES and len(os.listdir(
            os.path.join(d, "class"))) == DB_CLASS_IMAGES, "class images")
        for name, want in predicted["class batch"].items():
            check(counts[name] == want, f"class images: {name} {counts[name]}"
                                        f", predicted {want}")
        launches["class images (a batch of 2)"] = counts
        del b16
        torch.cuda.empty_cache()

        # the finetunes, fp32
        _db_images(os.path.join(d, "inst"), 2, 5)
        t0 = time.perf_counter()
        bundle = random_bundle(tiny=False, device="cuda", dtype=torch.float32,
                               family="sd15_inpaint", controlnet_names=(),
                               generator=torch.Generator("cuda").manual_seed(6))
        print(f"[db] SD1.5 with the 9-channel inpaint UNet at published "
              f"widths, fp32, random weights (seed 6): UNet "
              f"{sum(p.numel() for p in bundle.unet.parameters()) / 1e6:.1f} M "
              f"parameters, built in {time.perf_counter() - t0:.1f} s")
        launches.update(db_full_and_lora(bundle, d, predicted))

        group = _open_local_group()
        try:
            db_with_a_group(bundle, d, group)
            del bundle
            torch.cuda.empty_cache()
            cn_bundle = random_bundle(
                tiny=False, device="cuda", dtype=torch.float32,
                generator=torch.Generator("cuda").manual_seed(5),
                controlnet_names=("sam", "inpaint"))
            controlnet_with_a_group(cn_bundle, d, group)
        finally:
            dist.destroy_process_group()

        # the command line
        os.makedirs(os.path.join(d, "cli"))
        launches["cli edit (1 sample, 10 steps)"] = cli_edit(
            cn_bundle, os.path.join(d, "cli"))
        del cn_bundle
        torch.cuda.empty_cache()
        os.makedirs(os.path.join(d, "tiny"))
        cli_tiny_tools(os.path.join(d, "tiny"))
    print(f"[db] phase 6: {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the GPU port only",
              file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_device()
    headline = phase_kernels()
    phase_hires_kernels()
    phase_sam_kernels(headline)
    phase_resnet_kernel(headline)
    phase_tiny_parity()
    phase_sam_parity()
    bundle = phase_full_width()
    mode_launches = phase_full_width_modes()
    mode_launches.update(phase_reference_and_samplers(bundle))
    mode_launches.update(phase_high_resolution(bundle))
    mode_launches.update(phase_checkpoints(bundle))
    launches, editor = phase_main_path(bundle)
    mode_launches.update(phase_captioner(editor))
    mode_launches.update(phase_grounding(editor))
    # phase 5t opens on the main path's editor, then frees it
    bf16_ti = textinv_on_the_main_editor(editor)
    del editor
    training = phase_training()
    training["textual inversion bf16 (1 step)"] = bf16_ti
    train_rows = training.pop("train attention rows")
    mode_launches.update(training)
    mode_launches.update(phase_dreambooth_and_apps())
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "editanything_tpu"))
    check(not foreign, f"the port loaded {foreign}")
    rows = []
    for name, route, source, replaces in (
            ("flash_attention", "cuda", FLASH_SOURCE, FLASH_REPLACES),
            ("group_norm_silu", "cuda", GN_SOURCE, GN_REPLACES),
            ("sam_twoway", "cuda", TWOWAY_SOURCE, TWOWAY_REPLACES),
            ("sam_upscale_hyper", "cuda", UPSCALE_SOURCE, UPSCALE_REPLACES),
            ("resnet_fused", "cuda", RESNET_SOURCE, RESNET_REPLACES)):
        err, ms, plain, label = headline[name]
        ops, nbytes = headline[f"{name} work"]
        least, by = bound_ms(ops, nbytes, PEAK_FP32 if name == "group_norm_silu"
                             else PEAK_BF16)
        row = {"name": name, "route": route, "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": least, "bound_by": by,
               "library_ms": headline.get(f"{name} library"),
               "shape": f"{label}, bf16",
               "launches_by_path": {what: counts[name] for what, counts
                                    in mode_launches.items()}}
        if name == "flash_attention":
            row["safety_checker_shape"] = headline["flash_attention safety"]
            row["blip2_shapes"] = headline["flash_attention blip2"]
            row["groundingdino_shape"] = headline[
                "flash_attention groundingdino"]
            row["training_fp32_shapes"] = train_rows
        if name == "resnet_fused":
            row["composed_ms"] = headline["resnet_fused composed"]
            (row["cudnn_convs_ms"],
             row["cudnn_convs_channels_last_ms"]) = headline[
                 "resnet_fused cudnn convs"]
        rows.append(row)
    print(f"[done] every phase passed in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
