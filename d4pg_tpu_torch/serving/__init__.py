"""serving of the PyTorch port (counterpart of ``d4pg_tpu/serving``)."""
