"""The pipelines over a model bundle: the dual-ControlNet inpaint edit (and
its tile refinement), txt2img, img2img, sketch-to-image, the BLIP-2
captioner and the editor."""
