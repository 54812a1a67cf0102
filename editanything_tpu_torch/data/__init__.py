from editanything_tpu_torch.data.sam_dataset import SAMDataset, make_batcher
