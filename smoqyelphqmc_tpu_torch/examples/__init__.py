"""The example drivers of the port, one twin of each script of the JAX
package's examples/ (the reference's tutorials and examples), run as

    python -m smoqyelphqmc_tpu_torch.examples.<name> <positional arguments>

Each twin keeps its script's `run(...)` signature, keyword for keyword and
default for default, adds `device="cuda"` (pass "cpu" to run on the host),
and keeps its positional command line (`main(argv)`). `setup(...)` takes
`run`'s arguments but `device` and returns what `run` hands
`driver.run_simulation` without running it: (simulation info,
tight-binding model, electron-phonon model, measurement set, config).

Twins: holstein_honeycomb, holstein_honeycomb_checkpoint,
holstein_honeycomb_density_tuning, holstein_honeycomb_multiwalker,
holstein_flux_chain, bssh_chain, bssh_square, ossh_chain, ossh_square,
ossh_honeycomb. Their HDF5 output needs h5py; `driver.simulate` runs the
same simulation with the bins in memory where h5py is absent.
"""

TWINS = (
    "holstein_honeycomb",
    "holstein_honeycomb_checkpoint",
    "holstein_honeycomb_density_tuning",
    "holstein_honeycomb_multiwalker",
    "holstein_flux_chain",
    "bssh_chain",
    "bssh_square",
    "ossh_chain",
    "ossh_square",
    "ossh_honeycomb",
)
