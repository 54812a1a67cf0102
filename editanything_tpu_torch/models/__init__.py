"""UNet, ControlNet, VAE, CLIP text tower, SAM, the safety checker and
BLIP-2 as nn.Modules."""
