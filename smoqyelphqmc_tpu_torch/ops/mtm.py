"""Kernel K1: the M^T M matvec, with its plain PyTorch version.

`mul_MtM(fdm, v)` is the dispatcher: a CPU tensor takes the plain version
(`mtm_plain`, the composition of FermionDetMatrix.mul_M and mul_Mt); a CUDA
tensor launches `csrc/mtm.cu` (f32 or f64, the dtype of the fermion matrix) or
raises. K1 takes real hoppings only: a complex fermion matrix raises here
(its M^dag M is FermionDetMatrix.mul_MtM's plain path). The kernel replaces
`_mtm_kernel_roll` (smoqyelphqmc_tpu/ops/pallas_fused.py:121); its design
note is in the source.
"""

from __future__ import annotations

import torch

from .. import _build


class KernelCounter:
    """Launches of one kernel and calls of its plain version (plain ints)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


# one counter per instantiation of the kernel
MTM = {torch.float32: KernelCounter("mtm_f32"), torch.float64: KernelCounter("mtm_f64")}


def require_real(fdm, what: str) -> None:
    """Raise for a complex fermion matrix: the real-hopping kernels K1-K4 (and
    their plain versions) would drop its S_im planes."""
    if fdm.complex_hops:
        raise ValueError(f"{what}: real hoppings only, the fermion matrix has complex hoppings")


def mtm_tables(fdm):
    """Kernel operands of one fermion matrix, cached on it: C, S
    (n_colors, rows, N) with rows = 1 for tau-independent hoppings, the int32
    partner table and exp(-dtau V)."""
    tabs = getattr(fdm, "_mtm_tables", None)
    if tabs is None:
        C, S = fdm.cb.C, fdm.cb.S
        if fdm.static_hops:
            C, S = C[:, :1], S[:, :1]
        tabs = (
            C.contiguous(),
            S.contiguous(),
            fdm.cb.partner.to(torch.int32).contiguous(),
            fdm.exp_nV.contiguous(),
        )
        fdm._mtm_tables = tabs
    return tabs


def mtm_plain(fdm, v: torch.Tensor) -> torch.Tensor:
    """M^T M v in plain PyTorch ops (the function K1 computes)."""
    require_real(fdm, "mtm (K1)")
    MTM[v.dtype].plain_calls += 1
    return fdm.mul_Mt(fdm.mul_M(v))


def mtm_blocked_plain(fdm, v: torch.Tensor, T: int):
    """M^T M v (symmetric or not) as the tau-blocked rows compute it
    (csrc/row_ops.cuh:mtm_rows_block, K3's matvec phases), block by block of T
    tau rows, one B application at a time: for the rows l0 .. l0+nr-1 of a
    block, m_j = v_j + sgn1_j B_j v_{j-1} for j = l0 .. l0+nr (nr + 1 B) and
    out_j = m_j + sgnL_j B_{j+1}^T m_{j+1} (nr B^T), rows taken mod Ltau.
    The plain model of the kernel's algebra, for tests. Returns (out, the
    number of B and B^T applications)."""
    L = fdm.Ltau
    out = torch.empty_like(v)
    n_apply = 0

    def row_op(op, u, j):
        # op on one row: u placed at tau row j of an otherwise zero plane
        plane = torch.zeros_like(v)
        plane[..., j, :] = u
        return op(plane)[..., j, :]

    for l0 in range(0, L, T):
        nr = min(T, L - l0)
        m = []
        for i in range(nr + 1):
            j = (l0 + i) % L
            m.append(v[..., j, :] + (1.0 if j == 0 else -1.0) * row_op(fdm.apply_B, v[..., j - 1, :], j))
        for i in range(nr):
            j = l0 + i
            out[..., j, :] = m[i] + (1.0 if j == L - 1 else -1.0) * row_op(fdm.apply_Bt, m[i + 1], (j + 1) % L)
        n_apply += 2 * nr + 1
    return out, n_apply


def mtm_cuda(fdm, v: torch.Tensor) -> torch.Tensor:
    """Launch K1 on v (..., Ltau, N), a CUDA tensor of the fermion matrix's dtype."""
    require_real(fdm, "mtm kernel (K1)")
    if v.dtype != fdm.dtype or v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mtm kernel: v is {v.dtype}, the fermion matrix {fdm.dtype}")
    if v.device != fdm.device:
        raise ValueError(f"mtm kernel: v on {v.device}, the fermion matrix on {fdm.device}")
    if fdm.exp_nV.dim() != 2:
        raise ValueError("mtm kernel: one fermion matrix, not a walker batch")
    Ltau, N = fdm.Ltau, fdm.n_sites
    if v.shape[-2:] != (Ltau, N):
        raise ValueError(f"mtm kernel: v has shape {tuple(v.shape)}, expected (..., {Ltau}, {N})")
    vb = v.reshape(-1, Ltau, N).contiguous()
    out = torch.empty_like(vb)
    C, S, partner, expV = mtm_tables(fdm)
    lib = _build.load_library()
    fn = lib.smoqy_mtm_f32 if v.dtype == torch.float32 else lib.smoqy_mtm_f64
    rc = fn(
        vb.data_ptr(), out.data_ptr(), C.data_ptr(), S.data_ptr(), partner.data_ptr(),
        expV.data_ptr(), vb.shape[0], Ltau, N, C.shape[0], C.shape[1], int(fdm.symmetric),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _build.check(rc, "mtm kernel launch")
    MTM[v.dtype].launches += 1
    return out.reshape(v.shape)


def mul_MtM(fdm, v: torch.Tensor) -> torch.Tensor:
    """K1 dispatcher: plain version for CPU tensors, the kernel for CUDA tensors."""
    if v.device.type == "cpu":
        return mtm_plain(fdm, v)
    if v.device.type == "cuda":
        return mtm_cuda(fdm, v)
    raise RuntimeError(f"mul_MtM: no kernel for device {v.device}")
