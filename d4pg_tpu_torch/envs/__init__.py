"""envs of the PyTorch port (counterpart of ``d4pg_tpu/envs``)."""
