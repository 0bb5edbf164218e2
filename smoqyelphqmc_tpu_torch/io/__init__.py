"""Simulation output (copies of the JAX package's io modules): data folders
and TOML summaries (`simulation_info`), binned HDF5 measurements and their
statistics (`measurements_io`), correlation ratios (`correlation_ratio`),
checkpoints (`checkpoint`). Import the submodules themselves: the two HDF5
modules import h5py, which the driver's loop and checkpoints do not need."""
