"""Training: ControlNet training (``train_controlnet.train``) and textual
inversion (``train_ti.train_textual_inversion``); each program module has a
``main`` for the command line."""
from editanything_tpu_torch.train.controlnet_train import (
    TrainState,
    make_train_step,
    init_train_state,
)
from editanything_tpu_torch.data.sam_dataset import SAMDataset, make_batcher
