"""updates of the PyTorch port (module names mirror smoqyelphqmc_tpu/updates)."""
