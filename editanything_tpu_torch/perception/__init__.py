"""SAM automatic mask generation and the click predictor."""

from editanything_tpu_torch.perception.amg import (
    AMGConfig,
    build_amg,
    encode_id_map,
)
from editanything_tpu_torch.perception.predictor import SamPredictor
