"""Kernel K4: the force epilogue (Holstein planes, SSH hop plane), with its
plain PyTorch version.

From the solution psi_raw of [M^T M] psi_raw = Lambda^{-T} Phi, the two
site-product planes P1, P2 (Ltau, N) that `derivatives.holstein_force_from_planes`
contracts into dS_f/dx (the JAX package's ops/pallas_fused.py:934-976,
`FusedForce`):

    psi = roll(x, +1) / Lambda,  lam_psi = roll(Lambda psi, -1)
    w = B roll(lam_psi, +1),  sw = sgn1 w,  A = lam_psi + sw   (= M lam_psi)
    P1 = sum_ch (CB^T A) (CB^{-1} sw)
    P2 = sum_ch roll(M^T A, +1) psi     (zeros unless want_p2)

Symmetric factorization, real hoppings, float32. psi_raw is
(..., 2, Ltau, N) and Lambda (..., Ltau, N); a walker batch carries its
fermion matrix's exp_nV as (W, 1, Ltau, N) (`updates.context.make_fdm`).
`force_planes` is the dispatcher: a CPU tensor takes `force_planes_plain`, a
CUDA tensor launches `csrc/force.cu` or raises. K3 (`ops/pcg_force.py`) runs
the same epilogue after its solve, one row at a time. `fits` is the shape
part of the trajectory's route to K4 (`updates.hmc.force_route`).

K4 takes tau blocks of T rows a CTA with both channels in one stage, on K1's
pair tables (csrc/force.cu, csrc/pair_ops.cuh); `force_blocked_plain` is the
plain model of its block algebra, `tau_block_rows` its choice of T.

With `hops` (SSH couplings) K4 also returns the hop plane H (..., Ltau,
n_colors, P) of the hopping derivative's two color walks, at K4's pair slots
(`mtm.hop_slots` maps hops to them), with U = A, V = sw:

    reverse walk, c = nc-1 .. 0:  H_c += sum_ch (U_b V_a + U_a V_b) over the
                                  pairs (a, b) of color c; U <- K_c U, V <- K_c^{-1} V
    U <- expV U, V <- V / expV, and the forward walk c = 0 .. nc-1 likewise

(0 at self pairs and padding); `derivatives.ssh_force_from_hops` contracts it
into dS_f/dx.
"""

from __future__ import annotations

import torch

from .. import _build
from ..tracing import KernelCounter
from .fermion_det import boundary_sign
from .mtm import (SMEM_MAX, block_form, fewest_rows, mtm_tables, pair_index, pair_sites,  # noqa: F401
                  phase_times, require_real, row_ld, stamp_slots)

FORCE = KernelCounter("force")


def _hop_products(u, v, a, b, ch: int):
    """sum_ch (u_b v_a + u_a v_b) over one color's pair slots (a, b), 0 at
    self pairs: u, v (..., N) with the channel axis at `ch`."""
    pad = torch.zeros(u.shape[:-1] + (1,), dtype=u.dtype, device=u.device)
    u, v = torch.cat([u, pad], -1), torch.cat([v, pad], -1)
    h = torch.sum(u[..., b] * v[..., a] + u[..., a] * v[..., b], dim=ch)
    return h * (a != b)


def planes(fdm32, Lam: torch.Tensor, x: torch.Tensor, want_p2: bool, hops: bool = False):
    """The epilogue's function in plain ops, uncounted (K3's plain version
    calls it too): (P1, P2), and H with `hops`."""
    L, cb = fdm32.Ltau, fdm32.cb
    Lc = Lam.unsqueeze(-3)
    sgn1 = boundary_sign(L, True, x.dtype, x.device)
    psi = torch.roll(x, 1, dims=-2) / Lc
    lam_psi = torch.roll(Lc * psi, -1, dims=-2)
    sw = sgn1 * fdm32.apply_B(torch.roll(lam_psi, 1, dims=-2))
    A = lam_psi + sw
    if hops:
        a, b = pair_sites(fdm32.structure, x.device, 8)
        H = [None] * cb.n_colors
        up, vp = A, sw
        for c in reversed(range(cb.n_colors)):
            H[c] = _hop_products(up, vp, a[c], b[c], -3)
            up, vp = cb.apply_color(up, c), cb.apply_color(vp, c, inverse=True)
        P1 = torch.sum(up * vp, dim=-3)
        up, vp = up * fdm32.exp_nV, vp / fdm32.exp_nV
        for c in range(cb.n_colors):
            H[c] = H[c] + _hop_products(up, vp, a[c], b[c], -3)
            up, vp = cb.apply_color(up, c), cb.apply_color(vp, c, inverse=True)
        hop = (torch.stack(H, dim=-2),)
    else:
        P1 = torch.sum(cb.apply(A, transpose=True) * cb.apply(sw, inverse=True), dim=-3)
        hop = ()
    if not want_p2:
        return (P1, torch.zeros_like(P1)) + hop
    MtA1 = torch.roll(fdm32.mul_Mt(A), 1, dims=-2)
    return (P1, torch.sum(MtA1 * psi, dim=-3)) + hop


def check_operands(fdm32, Lam: torch.Tensor, psi_raw: torch.Tensor) -> int:
    """Validate the operands of K3 / K4; returns the number of walkers."""
    require_real(fdm32, "force kernels (K3 / K4)")
    if psi_raw.dtype != torch.float32 or Lam.dtype != torch.float32 or fdm32.dtype != torch.float32:
        raise TypeError("force kernels: psi_raw, Lambda and the fermion matrix must be float32")
    if not fdm32.symmetric:
        raise ValueError("force kernels: the symmetric factorization only")
    Ltau, N = fdm32.Ltau, fdm32.n_sites
    if psi_raw.shape[-3:] != (2, Ltau, N) or Lam.shape[-2:] != (Ltau, N):
        raise ValueError(f"force kernels: psi_raw {tuple(psi_raw.shape)} or Lambda {tuple(Lam.shape)} "
                         f"is not (..., 2, {Ltau}, {N}) / (..., {Ltau}, {N})")
    W = psi_raw.numel() // (2 * Ltau * N)
    if Lam.numel() != W * Ltau * N or fdm32.exp_nV.numel() != W * Ltau * N:
        raise ValueError("force kernels: Lambda and exp_nV must hold one (Ltau, N) plane per walker")
    if not (psi_raw.device == Lam.device == fdm32.device):
        raise ValueError("force kernels: operands on different devices")
    return W


def force_planes_plain(fdm32, Lam: torch.Tensor, psi_raw: torch.Tensor, want_p2: bool, hops: bool = False):
    """(P1, P2), and H with `hops`, in plain PyTorch ops (the function K4
    computes)."""
    require_real(fdm32, "force (K4)")
    FORCE.plain_calls += 1
    return planes(fdm32, Lam, psi_raw, want_p2, hops)


def force_blocked_plain(fdm32, Lam: torch.Tensor, psi_raw: torch.Tensor, want_p2: bool, T: int,
                        hops: bool = False):
    """(P1, P2) as K4's tau blocks compute them, block by block of T rows in
    plain PyTorch ops: for the rows l0 .. l0+nr-1 of a block, lam_psi on the
    rows l0-2 .., w_l = B_l lam_psi_{l-1} for l = l0-1 .. l0+nr-1 (nr + 1 B
    applications), A_l and sw_l, P1 from CB^T A_l and CB^{-1} sw_l, and
    B_l^T A_l as CB (expV_l (CB^T A_l)), the half sweep of P1 carried on;
    rows taken mod Ltau, both channels together. With `hops`, the SSH form:
    the half sweep color by color with each color's pair products before it,
    then expV on CB^T A_l and expV^{-1} on CB^{-1} sw_l and the forward
    colors on both, their products added. The plain model of the kernel's
    algebra, for tests. Returns (P1, P2, the B applications), and H last
    with `hops`."""
    require_real(fdm32, "force (K4)")
    L, cb = fdm32.Ltau, fdm32.cb
    x = psi_raw
    Lam_c = Lam.unsqueeze(-3)
    E = fdm32.exp_nV if fdm32.exp_nV.dim() == Lam_c.dim() else fdm32.exp_nV.unsqueeze(-3)

    def at(t, j):  # row j (mod L) of (..., L, N)
        return t[..., j % L, :]

    def on_row(fn, u, j):
        """fn (a plane op of the checkerboard) on the row u placed at tau j."""
        plane = torch.zeros(u.shape[:-1] + (L, u.shape[-1]), dtype=u.dtype, device=u.device)
        plane[..., j % L, :] = u
        return fn(plane)[..., j % L, :]

    def lam_psi(j):
        lam1 = at(Lam_c, j + 1)
        return lam1 * (at(x, j) / lam1)

    P1 = torch.empty(x.shape[:-3] + (L, x.shape[-1]), dtype=x.dtype, device=x.device)
    P2 = torch.zeros_like(P1)
    if hops:
        a, b = pair_sites(fdm32.structure, x.device, 8)
        H = torch.zeros(x.shape[:-3] + (L,) + tuple(a.shape), dtype=x.dtype, device=x.device)
    n_apply = 0
    for l0 in range(0, L, T):
        nr = min(T, L - l0)
        A, SW = {}, {}
        for l in range(l0 - 1, l0 + nr):
            w = on_row(fdm32.apply_B, lam_psi(l - 1), l)
            SW[l] = (1.0 if l % L == 0 else -1.0) * w
            A[l] = lam_psi(l) + SW[l]
        n_apply += nr + 1
        for l in range(l0, l0 + nr):
            if hops:
                up, vp = A[l], SW[l]
                for c in reversed(range(cb.n_colors)):
                    H[..., l, c, :] = _hop_products(up, vp, a[c], b[c], -2)
                    up = on_row(lambda t: cb.apply_color(t, c), up, l)
                    vp = on_row(lambda t: cb.apply_color(t, c, inverse=True), vp, l)
            else:
                up = on_row(lambda t: cb.apply(t, transpose=True), A[l], l)
                vp = on_row(lambda t: cb.apply(t, inverse=True), SW[l], l)
            P1[..., l, :] = torch.sum(up * vp, dim=-2)
            if hops:
                fu, fv = at(E, l) * up, vp / at(E, l)
                for c in range(cb.n_colors):
                    H[..., l, c, :] += _hop_products(fu, fv, a[c], b[c], -2)
                    fu = on_row(lambda t: cb.apply_color(t, c), fu, l)
                    fv = on_row(lambda t: cb.apply_color(t, c, inverse=True), fv, l)
            if want_p2:
                BA = on_row(cb.apply, at(E, l) * up, l)
                mta = A[l - 1] + (1.0 if (l - 1) % L == L - 1 else -1.0) * BA
                P2[..., l, :] = torch.sum(mta * (at(x, l - 1) / at(Lam_c, l)), dim=-2)
    return (P1, P2, n_apply) + ((H,) if hops else ())


def force_pair_tables(fdm32):
    """K4's operands of one (walker-batch) fermion matrix, cached on it: K1's
    pair tables ordered for 8-byte values (a site's two channels), each
    pair's cosh and sinh (n_colors, rows, P), and exp(-dtau V) as (W, Ltau,
    ld) rows of the kernel's row stride, 1 in the padding columns. One set of
    hop tables serves every walker: a walker batch with its own (SSH) tables
    takes K4 one walker at a time."""
    tabs = getattr(fdm32, "_force_pairs", None)
    if tabs is None:
        C, S, _, expV = mtm_tables(fdm32)
        if C.dim() != 3:
            raise ValueError("force kernel: a walker batch with its own hop tables; launch K4 a walker at a time")
        ab, gather = pair_index(fdm32.structure, C.device, 8)
        idx = gather[:, None, :].expand(C.shape[0], C.shape[1], gather.shape[1])
        Ltau, N = fdm32.Ltau, fdm32.n_sites
        W = expV.numel() // (Ltau * N)
        E = torch.ones((W, Ltau, row_ld(N, 8)), dtype=C.dtype, device=C.device)
        E[:, :, :N] = expV.reshape(W, Ltau, N)
        tabs = (ab, C.gather(2, idx).contiguous(), S.gather(2, idx).contiguous(), E)
        fdm32._force_pairs = tabs
    return tabs


def smem_bytes(N: int, T: int, staged: bool = True) -> int:
    """K4's dynamic shared memory for tau blocks of T rows
    (csrc/force.cu:smem_bytes): 3T + 1 rows of row_ld(N, 8) 8-byte values,
    and in the staged form the block's x and Lambda, 3T + 6 rows of N
    floats."""
    return (3 * T + 1) * row_ld(N, 8) * 8 + ((3 * T + 6) * N * 4 if staged else 0)


def staged_form(N: int) -> bool:
    """Whether a block of one row fits with x and Lambda staged in shared
    memory (the faster form); above it K4 reads them from device memory."""
    return smem_bytes(N, 1, True) <= SMEM_MAX


def fits(N: int) -> bool:
    """Whether K4 takes N sites: a block of one row fits a CTA's shared
    memory in the memory form (`launch_shape` refuses the rest)."""
    return smem_bytes(N, 1, False) <= SMEM_MAX


def tau_block_rows(n_walkers: int, Ltau: int, N: int, resident, staged: bool = True) -> int:
    """K4's T: the fewest rows whose blocks make one round of the resident
    CTAs, else the most that fit (ops/mtm.py:fewest_rows, as K1's)."""
    return fewest_rows(n_walkers, Ltau, lambda T: smem_bytes(N, T, staged), resident, f"force kernel ({N} sites)")


_LAUNCH: dict = {}


def launch_shape(fdm32, n_walkers: int, tau_rows=None, hops: bool = False) -> dict:
    """How K4 launches for n_walkers on this fermion matrix, cached: T, the
    CTA's threads, the form (K of the register form, 0 the memory form; the
    SSH form, `hops`, is the memory form), whether x and Lambda are staged in
    shared memory, the pair slots a color, the grid, the dynamic shared
    memory in bytes and the CTAs resident at once."""
    ab, C, _, _ = force_pair_tables(fdm32)
    Ltau, N = fdm32.Ltau, fdm32.n_sites
    key = (Ltau, N, C.shape[0], C.shape[1], ab.shape[1], n_walkers, tau_rows, hops, C.device)
    if key in _LAUNCH:
        return _LAUNCH[key]
    threads, K, form = block_form(ab.shape[1], C.shape[0], C.shape[1] > 1)
    form = 0 if hops else form
    staged = staged_form(N)
    lib = _build.load_library()

    def resident(T):
        r = lib.smoqy_force_resident(form, int(staged), int(hops), threads, smem_bytes(N, T, staged))
        if r <= 0:
            raise RuntimeError(f"force kernel: occupancy query failed (CUDA error {-r})")
        return r

    T = tau_block_rows(n_walkers, Ltau, N, resident, staged) if tau_rows is None else int(tau_rows)
    smem = smem_bytes(N, T, staged)
    if not 1 <= T <= Ltau or smem > SMEM_MAX:
        raise ValueError(f"force kernel: tau block of {T} rows (Ltau {Ltau}, N {N}, {smem} bytes)")
    _LAUNCH[key] = dict(tau_block=T, threads=threads, K=K, form=form, staged=staged, P=ab.shape[1],
                        grid=n_walkers * -(-Ltau // T), smem=smem, resident=resident(T))
    return _LAUNCH[key]


def phase_names(n_colors: int, want_p2: bool, hops: bool = False) -> list:
    """The timed instantiation's phases of a tau block, in the order it
    stamps them: the staging of lam_psi, B's color stages (expV rides on
    color 0's first), A and sw, the half sweeps (CB^T A with CB^{-1} sw),
    then P1 and the output, or P1, the forward colors of B A (expV before
    color 0) and P2. The SSH form (`hops`): the half sweeps with their hop
    products, P1, the forward walk's colors (expV on both buffers before
    color 0), then the output or P2."""
    rev, fwd = list(reversed(range(n_colors))), list(range(n_colors))
    b = [f"c{c}+expV" if c == 0 else f"c{c}" for c in rev] + [f"c{c}" for c in fwd] if n_colors else ["expV"]
    names = ["stage"] + [f"B.{k}:{c}" for k, c in enumerate(b)] + ["A"] + [f"H.{k}:c{c}" for k, c in enumerate(rev)]
    f = [f"expV+c{c}" if c == 0 else f"c{c}" for c in fwd] if n_colors else ["expV"]
    forward = [f"F.{k}:{c}" for k, c in enumerate(f)]
    if hops:
        return names + ["P1"] + forward + ["P2" if want_p2 else "out"]
    if not want_p2:
        return names + ["P1+out"]
    return names + ["P1"] + forward + ["P2"]


def force_planes_cuda(fdm32, Lam: torch.Tensor, psi_raw: torch.Tensor, want_p2: bool, stamps=None,
                      tau_rows=None, hops: bool = False):
    """Launch K4 on CUDA tensors: (P1, P2), and with `hops` the SSH form's
    hop plane H (..., Ltau, n_colors, P) last. `tau_rows` overrides T
    (`launch_shape`); `stamps`, a zeroed int64 CUDA tensor of `stamp_slots()`
    entries, selects the timed instantiation (`phase_times` with
    `phase_names`). The path passes neither."""
    W = check_operands(fdm32, Lam, psi_raw)
    Ltau, N = fdm32.Ltau, fdm32.n_sites
    lead = psi_raw.shape[:-3]
    x = psi_raw.reshape(W, 2, Ltau, N).contiguous()
    lam = Lam.reshape(W, Ltau, N).contiguous()
    ab, C, S, E = force_pair_tables(fdm32)
    nc = C.shape[0]
    if hops and nc == 0:
        raise ValueError("force kernel: the SSH form needs a hopping color")
    shape = launch_shape(fdm32, W, tau_rows, hops)
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != x.device
                               or not stamps.is_contiguous() or stamps.numel() < stamp_slots()):
        raise ValueError(f"force kernel: stamps must be a contiguous int64 tensor of {stamp_slots()} on {x.device}")
    P1 = torch.empty((W, Ltau, N), dtype=torch.float32, device=x.device)
    P2 = torch.empty_like(P1)
    H = torch.empty((W, Ltau, nc, shape["P"]), dtype=torch.float32, device=x.device) if hops else None
    rc = _build.load_library().smoqy_force(
        x.data_ptr(), lam.data_ptr(), P1.data_ptr(), P2.data_ptr(), None if H is None else H.data_ptr(),
        ab.data_ptr(), C.data_ptr(), S.data_ptr(), E.data_ptr(), W, Ltau, N, nc, shape["P"],
        int(C.shape[1] > 1), shape["tau_block"], shape["threads"], shape["form"],
        int(shape["staged"]), int(want_p2), int(hops), None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "force kernel launch")
    FORCE.launches += 1
    out = (P1.reshape(lead + (Ltau, N)), P2.reshape(lead + (Ltau, N)))
    return out + ((H.reshape(lead + H.shape[1:]),) if hops else ())


def force_planes(fdm32, Lam: torch.Tensor, psi_raw: torch.Tensor, want_p2: bool, hops: bool = False):
    """K4 dispatcher: plain version for CPU tensors, the kernel for CUDA
    tensors; (P1, P2), and the hop plane H last with `hops`."""
    if psi_raw.device.type == "cpu":
        return force_planes_plain(fdm32, Lam, psi_raw, want_p2, hops)
    if psi_raw.device.type == "cuda":
        return force_planes_cuda(fdm32, Lam, psi_raw, want_p2, hops=hops)
    raise RuntimeError(f"force_planes: no kernel for device {psi_raw.device}")
