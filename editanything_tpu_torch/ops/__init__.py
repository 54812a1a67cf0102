"""Host-side ops of the port: the RLE codec of the training data."""
