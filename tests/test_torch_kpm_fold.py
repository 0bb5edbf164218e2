"""The host side of the redesigned K6 / K7 (ops/kpm_mf.py): the stage tables
that fold Bbar / half into a few gathers, the plan's cut into a cluster part
and a one-CTA part, and the 16-bit partner tables. CPU only, honeycomb L=2-3
on the regular lattice and with its site labels permuted.

Tolerances: the folded tables against `AveragedPropagator.apply` 1e-12 in
float64 and 2e-6 in float32 relative to max|B u| (the same products, the
middle color's two sides and the diagonal multiplied out once); the staged
recurrence (what the kernels compute, with center / half subtracted in the
step) against `kpm_mf_plain` / `kpm_mf_asym_plain` 2e-4 / 5e-4 of max|y|,
the kernels' own tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_common import fdm_pair

from smoqyelphqmc_tpu_torch.ops import kpm_mf
from smoqyelphqmc_tpu_torch.ops.kpm import KPMPreconditioner, averaged_propagator

SYM = [pytest.param(True, id="sym"), pytest.param(False, id="asym")]
LATTICE = [pytest.param(None, id="regular"), pytest.param(5, id="permuted")]


def _fdm(symmetric, perm_seed, L=3):
    return fdm_pair("honeycomb", dict(L=L, beta=1.0, alpha=0.4), x_seed=1, symmetric=symmetric, perm_seed=perm_seed)[1]


def _operands(symmetric, perm_seed, L=3):
    fdm = _fdm(symmetric, perm_seed, L)
    v0 = torch.as_tensor(np.random.default_rng(2).standard_normal(fdm.n_sites))
    pre = KPMPreconditioner.build(fdm, v0, matrix_free=True)
    assert pre.active and pre.orders.max() > 1
    return pre.mf_operands()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-6)], ids=["f64", "f32"])
@pytest.mark.parametrize("perm_seed", LATTICE)
@pytest.mark.parametrize("symmetric", SYM)
def test_stage_tables_reproduce_bbar(symmetric, perm_seed, dtype, tol):
    """(reversed colors without c0) -> fold -> (forward colors without c0), or
    the colors with the diagonal in the last, is Bbar / half."""
    bbar = averaged_propagator(_fdm(symmetric, perm_seed)).to_dtype(dtype)
    n_colors = bbar.cb.n_colors
    inv_half = 0.37
    A, B, P, stages = kpm_mf.build_stage_tables(bbar, inv_half)
    assert stages == ([abs(s - (n_colors - 1)) for s in range(2 * n_colors - 1)] if symmetric
                      else list(range(n_colors)))
    assert A.dtype == B.dtype == dtype and A.shape == B.shape == P.shape == (n_colors, bbar.expV.shape[0])
    # every table pairs the sites: what the kernels' pushed gathers rely on
    for t in range(n_colors):
        assert torch.equal(P[t][P[t]], torch.arange(P.shape[1]))
    u = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 5, bbar.expV.shape[0])), dtype=dtype)
    ref = bbar.apply(u) * inv_half
    got = kpm_mf.apply_stage_tables(A, B, P, stages, u)
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("symmetric", SYM)
def test_stage_tables_without_hops(symmetric):
    """No hopping color at all: Bbar is its diagonal, one stage."""
    bbar = averaged_propagator(_fdm(symmetric, None, L=2))
    cb = dataclasses.replace(bbar.cb, C=bbar.cb.C[:0], S=bbar.cb.S[:0], partner=bbar.cb.partner[:0])
    A, B, P, stages = kpm_mf.build_stage_tables(dataclasses.replace(bbar, cb=cb), 0.5)
    u = torch.as_tensor(np.random.default_rng(4).standard_normal((3, bbar.expV.shape[0])))
    assert stages == [0]
    torch.testing.assert_close(kpm_mf.apply_stage_tables(A, B, P, stages, u), 0.5 * bbar.expV * u)


@pytest.mark.parametrize("perm_seed", LATTICE)
@pytest.mark.parametrize("symmetric", SYM)
def test_staged_recurrence_matches_plain(symmetric, perm_seed):
    """The kernels' arithmetic in plain ops (the operands' f32 stage tables,
    t_k = a ((Bbar / half) t - cih t) - b t_prev, every frequency to its own
    order) against the plain versions."""
    ops = _operands(symmetric, perm_seed)
    F, N = ops.coefs_re.shape[0], ops.n_sites
    n_tables = ops.stage_A.shape[0]
    stages = [abs(s - (n_tables - 1)) for s in range(2 * n_tables - 1)] if symmetric else list(range(n_tables))
    P = kpm_mf.unpack_partner16(ops.stage_P)
    u = torch.as_tensor(np.random.default_rng(6).standard_normal((2, 2, F, N)), dtype=torch.float32)

    def one_pass(t_re, t_im, cim_sign):
        y_re, y_im = torch.zeros_like(t_re), torch.zeros_like(t_im)
        for f in range(F):
            cre = ops.coefs_re[f]
            cim = cim_sign * ops.coefs_im[f]
            tc = torch.stack([t_re[:, f], t_im[:, f]])
            tp = torch.zeros_like(tc)
            for k in range(int(ops.orders_host[f])):
                if k > 0:
                    w = kpm_mf.apply_stage_tables(ops.stage_A, ops.stage_B, P, stages, tc)
                    tc, tp = (1.0 if k == 1 else 2.0) * (w - ops.cih * tc) - (0.0 if k == 1 else 1.0) * tp, tc
                y_re[:, f] += cre[k] * tc[0] - cim[k] * tc[1]
                y_im[:, f] += cre[k] * tc[1] + cim[k] * tc[0]
        return y_re, y_im

    if symmetric:
        got = one_pass(u[0], u[1], 0.0)
        ref, tol = kpm_mf.kpm_mf_plain(ops, u[0], u[1]), 2e-4
    else:
        got = one_pass(*one_pass(u[0], u[1], -1.0), 1.0)
        ref, tol = kpm_mf.kpm_mf_asym_plain(ops, u[0], u[1]), 5e-4
    scale = max(float(r.abs().max()) for r in ref)
    assert max(float((g - r).abs().max()) for g, r in zip(got, ref)) <= tol * scale


def test_operands_carry_stage_tables():
    """build_operands: f32 tables on the operands' device, 16-bit partners
    that unpack to Bbar's, the plan's host copy (complex hoppings: test_torch_kpm_fold_cplx.py)."""
    ops = _operands(True, None)
    n_colors = ops.bbar.cb.n_colors
    assert ops.stage_A.dtype == ops.stage_B.dtype == torch.float32 and ops.stage_P.dtype == torch.int16
    assert ops.stage_A.shape == ops.stage_B.shape == ops.stage_P.shape == (n_colors, ops.n_sites)
    assert ops.stage_A.is_contiguous() and ops.stage_B.is_contiguous() and ops.stage_P.is_contiguous()
    assert torch.equal(kpm_mf.unpack_partner16(ops.stage_P), ops.bbar.cb.partner)
    np.testing.assert_array_equal(ops.perm_host, ops.perm.numpy())
    # colors 1.. are Bbar's own tables; color 0 is the folded block
    torch.testing.assert_close(ops.stage_A[1:], ops.bbar.cb.C[1:])
    torch.testing.assert_close(ops.stage_B[1:], ops.bbar.cb.S[1:])
    assert not torch.allclose(ops.stage_A[0], ops.bbar.cb.C[0])


def test_stage_tables_refuse_unpaired_partners():
    """A partner table that is no pairing of the sites is refused."""
    bbar = averaged_propagator(_fdm(True, None, L=2))
    partner = bbar.cb.partner.clone()
    partner[1] = torch.roll(torch.arange(partner.shape[1]), 1)
    with pytest.raises(ValueError, match="does not pair the sites"):
        kpm_mf.build_stage_tables(dataclasses.replace(bbar, cb=dataclasses.replace(bbar.cb, partner=partner)), 1.0)


ORDER_CASES = {
    "descending": ([9, 7, 7, 4, 2, 1, 1, 1], None),
    "all-one": ([1] * 8, None),
    "all-above": ([6] * 8, None),
    "not-monotone-in-phi": ([1, 9, 1, 5, 2, 1, 7, 1], None),
    "from-phi": (None, 12),
}


@pytest.mark.parametrize("threshold", [0, 1, 4, 8, 100])
@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_split_plan_partitions_the_frequencies(case, threshold):
    """The cut is a partition of the plan into a prefix and the rest, keeps
    the plan's (descending) order, and every frequency with more than
    `threshold` live orders lies in the prefix."""
    orders, n_phi = ORDER_CASES[case]
    if orders is None:
        phi = 2 * np.pi * (np.arange(n_phi) + 0.5) / n_phi
        perm = kpm_mf.build_kpm_mf_plan(phi)
        orders = np.maximum(1, np.round(6.0 / np.minimum(phi, 2 * np.pi - phi))).astype(np.int32)
        assert np.all(np.diff(orders[perm]) <= 0)
    else:
        orders = np.asarray(orders, dtype=np.int32)
        perm = np.argsort(-orders, kind="stable").astype(np.int32) if case != "not-monotone-in-phi" \
            else np.arange(len(orders), dtype=np.int32)
    head, tail = kpm_mf.split_plan(perm, orders, threshold)
    np.testing.assert_array_equal(np.concatenate([head, tail]), perm)
    np.testing.assert_array_equal(np.sort(np.concatenate([head, tail])), np.arange(len(orders)))
    assert np.all(orders[tail] <= threshold)
    assert set(np.flatnonzero(orders > threshold)) <= set(head.tolist())
    if case != "not-monotone-in-phi":
        assert np.all(orders[head] > threshold)
        assert len(head) == int(np.count_nonzero(orders > threshold))
    if case == "all-one":
        assert len(head) == (len(orders) if threshold == 0 else 0)


def test_module_constants_send_every_frequency_to_the_cluster_form():
    """ORDER_THRESHOLD = 0: every frequency has at least one live order."""
    ops = _operands(True, None)
    head, tail = kpm_mf.split_plan(ops.perm_host, ops.orders_host, kpm_mf.ORDER_THRESHOLD)
    assert kpm_mf.ORDER_THRESHOLD == 0 and len(head) == len(ops.orders_host) and len(tail) == 0


@pytest.mark.parametrize("n_sites,k", [(18, 1), (511, 1), (512, 2), (1152, 4), (2047, 4), (2048, 8), (4608, 8),
                                       (16384, 8)])
def test_cluster_size_for(n_sites, k):
    """Smaller lattices take smaller clusters: no slice below 256 sites."""
    assert kpm_mf.cluster_size_for(n_sites) == k


@pytest.mark.parametrize("n_sites", [1, 2, 32767, 32768, 40000, 65535])
def test_partner16_round_trip(n_sites):
    """16-bit partners hold every site index up to 65535 bit for bit."""
    rng = np.random.default_rng(n_sites)
    partner = torch.as_tensor(np.stack([rng.permutation(n_sites), np.arange(n_sites)[::-1].copy()]))
    packed = kpm_mf.pack_partner16(partner)
    assert packed.dtype == torch.int16 and packed.shape == partner.shape and packed.is_contiguous()
    assert torch.equal(kpm_mf.unpack_partner16(packed), partner)
    # the kernels read the words as unsigned
    np.testing.assert_array_equal(packed.numpy().view(np.uint16), partner.numpy().astype(np.uint16))


def test_partner16_refuses_more_than_65535_sites():
    with pytest.raises(ValueError, match="at most 65535 sites, got 65536"):
        kpm_mf.pack_partner16(torch.zeros((1, 65536), dtype=torch.int64))
