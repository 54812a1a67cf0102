"""UNet, ControlNet, VAE, CLIP text tower, SAM, the safety checker,
BLIP-2 and the detectors (Swin, GroundingDINO, VLPart) as nn.Modules."""
