"""SAM automatic mask generation, the click predictor and text-grounded
masks (``grounding.py``: detector boxes as SAM box prompts)."""

from editanything_tpu_torch.perception.amg import (
    AMGConfig,
    build_amg,
    encode_id_map,
)
from editanything_tpu_torch.perception.predictor import SamPredictor
