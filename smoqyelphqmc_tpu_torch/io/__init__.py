"""Simulation output (copies of the JAX package's io modules): data folders
and TOML summaries (`simulation_info`), binned HDF5 measurements and their
statistics (`measurements_io`), correlation ratios (`correlation_ratio`),
checkpoints (`checkpoint`). Import the submodules themselves:
`measurements_io` imports h5py, which the driver's loop, the checkpoints and
`correlation_ratio.composite_ratio_from_bins` do not need."""
