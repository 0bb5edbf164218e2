"""parallel of the PyTorch port: walker batching (module names mirror smoqyelphqmc_tpu/parallel)."""
