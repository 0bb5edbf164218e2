"""The frozen roofline arithmetic against chip_smoke.py's at K1's headline shapes."""

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.references.holstein_honeycomb import build
from benchmark.reference import greedy_colors


@pytest.mark.parametrize("es", [4, 8])
def test_mtm_bound_matches_chip_smoke(es):
    import chip_smoke
    from smoqyelphqmc_tpu_torch.driver import SimulationConfig, _expand
    from smoqyelphqmc_tpu_torch.models.library import holstein_honeycomb_model
    from smoqyelphqmc_tpu_torch.updates.context import initialize_qmc, make_fdm

    _, tbm, em = holstein_honeycomb_model(12, 1.0, 0.6, 0.0)
    cfg = SimulationConfig(beta=12.0, seed=1)
    tbp, elph = _expand(tbm, em, cfg, torch.device("cpu"))
    ctx, state = initialize_qmc(tbp, elph, use_preconditioner=False)
    fdm = make_fdm(ctx, state.x)
    want_ms, _ = chip_smoke.mtm_bound(fdm, 2, es)
    model = build({"L": 12, "Omega": 1.0, "alpha": 0.6})
    got = roofline.mtm_bound(2, 240, 288, es, len(greedy_colors(model.neighbor_table)), model.neighbor_table.shape[1])
    assert got * 1e3 == pytest.approx(want_ms, rel=1e-12)
    nbytes, ops = roofline.mtm_work(2, 240, 288, es, 3, model.neighbor_table.shape[1])
    assert nbytes == es * (2 * 2 * 240 * 288 + 240 * 288) + chip_smoke.table_bytes(fdm, es)
    assert ops == 2 * 240 * 288 * (2 * chip_smoke.b_flops(3, True) + 4)
    assert np.isclose(got, nbytes / roofline.HBM_BYTES_S)  # bytes bound it
