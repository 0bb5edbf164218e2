"""Kernel K1: the M^T M matvec, with its plain PyTorch version.

`mul_MtM(fdm, v)` is the dispatcher: a CPU tensor takes the plain version
(`mtm_plain`, the composition of FermionDetMatrix.mul_M and mul_Mt); a CUDA
tensor launches `csrc/mtm.cu` (f32 or f64, the dtype of the fermion matrix) or
raises. K1 takes real hoppings only: a complex fermion matrix raises here
(its M^dag M is FermionDetMatrix.mul_MtM's plain path). The kernel replaces
`_mtm_kernel_roll` (the JAX package's ops/pallas_fused.py:121); its design
note is in the source.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..tracing import KernelCounter

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


def mtm_blocked_plain(fdm, v: torch.Tensor, T: int, pairs: bool = False):
    """M^T M v (symmetric or not) as the tau-blocked rows compute it
    (csrc/row_ops.cuh:mtm_rows_block, K3's matvec phases, and csrc/mtm.cu,
    K1), block by block of T tau rows, one B application at a time: for the
    rows l0 .. l0+nr-1 of a block, m_j = v_j + sgn1_j B_j v_{j-1} for j =
    l0 .. l0+nr (nr + 1 B) and out_j = m_j + sgnL_j B_{j+1}^T m_{j+1} (nr
    B^T), rows taken mod Ltau. With `pairs`, each B goes through K1's pair
    tables in its stage order (`pair_B_plain`). The plain model of the
    kernels' algebra, for tests. Returns (out, the number of B and B^T
    applications)."""
    L = fdm.Ltau
    out = torch.empty_like(v)
    n_apply = 0

    def row_op(transpose, u, j):
        if pairs:
            return pair_B_plain(fdm, u, j, transpose)
        # the fermion matrix's B on u placed at tau row j of a zero plane
        plane = torch.zeros_like(v)
        plane[..., j, :] = u
        return (fdm.apply_Bt if transpose else fdm.apply_B)(plane)[..., j, :]

    for l0 in range(0, L, T):
        nr = min(T, L - l0)
        m = []
        for i in range(nr + 1):
            j = (l0 + i) % L
            m.append(v[..., j, :] + (1.0 if j == 0 else -1.0) * row_op(False, v[..., j - 1, :], j))
        for i in range(nr):
            j = l0 + i
            out[..., j, :] = m[i] + (1.0 if j == L - 1 else -1.0) * row_op(True, m[i + 1], (j + 1) % L)
        n_apply += 2 * nr + 1
    return out, n_apply


def pair_B_plain(fdm, u: torch.Tensor, tau: int, transpose: bool) -> torch.Tensor:
    """B_tau u (B_tau^T u with transpose) for rows u (..., N) as K1 applies
    it: each color stage updates every pair (a, b) of the padded pair table
    in place, (u[a], u[b]) <- (C u[a] + S u[b], C u[b] + S u[a]), on a row
    with a spare site N that the padding pairs write; expV rides on color 0
    of the symmetric B's first sweep, after the asymmetric B's last color and
    before the asymmetric B^T's first. The plain model of the kernel's stage
    order, for tests."""
    _, C, S, _ = pair_tables(fdm)
    a_all, b_all = pair_sites(fdm.structure, C.device, C.element_size())
    row = tau if C.shape[1] > 1 else 0
    N, nc = fdm.n_sites, C.shape[0]
    E = torch.cat([fdm.exp_nV[tau], torch.ones(1, dtype=u.dtype, device=u.device)])
    w = torch.cat([u, torch.zeros(u.shape[:-1] + (1,), dtype=u.dtype, device=u.device)], dim=-1)

    def stage(w, c, scale):
        a, b, cv, sv = a_all[c], b_all[c], C[c, row], S[c, row]
        ua, ub = w[..., a], w[..., b]
        if scale == "before":
            ua, ub = ua * E[a], ub * E[b]
        ta, tb = cv * ua + sv * ub, cv * ub + sv * ua
        if scale == "after":
            ta, tb = ta * E[a], tb * E[b]
        w = w.clone()
        w[..., a] = ta
        w[..., b] = tb
        return w

    if nc == 0:
        return u * fdm.exp_nV[tau]
    rev, fwd = list(reversed(range(nc))), list(range(nc))
    if fdm.symmetric:
        seq = [(c, "after" if c == 0 else None) for c in rev] + [(c, None) for c in fwd]
    elif transpose:
        seq = [(c, "before" if c == nc - 1 else None) for c in rev]
    else:
        seq = [(c, "after" if c == nc - 1 else None) for c in fwd]
    for c, scale in seq:
        w = stage(w, c, scale)
    return w[..., :N]


# csrc/mtm.cu's launch constants
MAX_THREADS = 512  # kMaxThreads
REG_COLORS = 3  # kRegColors: colors the register form holds
MAX_K = 5  # kMaxK: pairs a thread a color in the register form
SMEM_MAX = 227 * 1024  # dynamic shared memory a CTA can have on the H100
_PAIR_INDEX: dict = {}


def color_pairs(partner: np.ndarray):
    """The pairs of each color of a partner table (n_colors, N): (first
    sites, second sites) as lists of int arrays. A color is a matching: each
    site n with p[n] > n gives the pair (n, p[n]), each site with p[n] == n
    the pair (n, n) (the kernel applies the color's (cosh, sinh) there too,
    and a site no bond of the color touches has (1, 0)). Raises unless every
    color's partner map is an involution."""
    firsts, seconds = [], []
    for c, p in enumerate(np.asarray(partner, dtype=np.int64)):
        n = np.arange(p.shape[0])
        if p.min(initial=0) < 0 or p.max(initial=0) >= p.shape[0] or not np.array_equal(p[p], n):
            raise ValueError(f"mtm kernel: color {c}'s partner map is not a matching (p[p[n]] != n)")
        a = n[n <= p]
        firsts.append(a)
        seconds.append(p[a])
    return firsts, seconds


def block_form(P0: int, n_colors: int, tau_tabs: bool):
    """(threads, K, form) of a launch with at most P0 pairs a color: threads
    a CTA (a multiple of 32, at most MAX_THREADS), K pairs a thread a color,
    and form = K for the register form (tau-independent tables, at most
    REG_COLORS colors, K <= MAX_K) or 0 for the memory form."""
    threads = min(MAX_THREADS, max(32, -(-P0 // 32) * 32))
    K = max(1, -(-P0 // threads))
    form = K if not tau_tabs and n_colors <= REG_COLORS and K <= MAX_K else 0
    return threads, K, form


def row_ld(N: int, es: int) -> int:
    """The kernel's row stride (csrc/mtm.cu:row_ld): N + 1 sites (the
    padding pairs' spare one) rounded up to 16 bytes."""
    per = 16 // es
    return -(-(N + 1) // per) * per


def pair_index(structure, device, es: int):
    """The kernel's pair table of a checkerboard structure, cached: the int32
    (n_colors, P) sites a | b << 16 and the int64 (n_colors, P) first sites
    (the gather index of each pair's cosh and sinh), P = K * threads
    (block_form) with padding pairs (N, N) on the spare site. Pairs are
    ordered by their first site; in the upper half of each 32 (f32) or 16
    (f64) slots the two sites are swapped, so that the loads of a warp's
    first (second) sites of a regular lattice fall in distinct shared-memory
    banks."""
    key = (id(structure), str(device), es)
    hit = _PAIR_INDEX.get(key)
    if hit is not None and hit[0] is structure:
        return hit[1]
    N = structure.n_sites
    if N >= 0xFFFF:
        raise ValueError(f"mtm kernel: {N} sites, at most 65534 (16-bit pair sites)")
    firsts, seconds = color_pairs(structure.partner)
    nc = len(firsts)
    threads, K, _ = block_form(max([len(a) for a in firsts] + [1]), nc, False)
    P = K * threads
    ab = np.full((nc, P), N | (N << 16), dtype=np.int64)
    gather = np.zeros((nc, P), dtype=np.int64)
    span = 32 if es == 4 else 16
    for c, (a, b) in enumerate(zip(firsts, seconds)):
        swap = (np.arange(len(a)) % span) >= span // 2
        a, b = np.where(swap, b, a), np.where(swap, a, b)
        ab[c, :len(a)] = a | (b << 16)
        gather[c, :len(a)] = a
    out = (torch.as_tensor(ab.astype(np.uint32).view(np.int32), device=device),
           torch.as_tensor(gather, device=device))
    _PAIR_INDEX[key] = (structure, out)
    return out


def pair_sites(structure, device, es: int):
    """`pair_index`'s pairs as (first sites, second sites), each a long
    (n_colors, P) tensor; padding slots hold the spare site N on both
    sides."""
    ab = pair_index(structure, device, es)[0].to(torch.int64) & 0xFFFFFFFF
    return ab & 0xFFFF, ab >> 16


def hop_slots(structure):
    """The slot c * P + q of each hop (n_hops,) in K4's hop plane (..., Ltau,
    n_colors, P) flattened over its last two axes: the pair (a, b) of color c
    whose sites the hop joins (`structure.site_hop`)."""
    a, b = (t.numpy() for t in pair_sites(structure, "cpu", 8))
    nc, P = a.shape
    slots = np.full(structure.n_hops, -1, dtype=np.int64)
    for c in range(nc):
        q = np.nonzero(a[c] != b[c])[0]
        slots[structure.site_hop[c, a[c, q]]] = c * P + q
    if (slots < 0).any():
        raise ValueError("hop_slots: a hop lies in no color's pairs")
    return slots


def pair_tables(fdm):
    """Kernel operands of one fermion matrix, cached on it: the pair sites
    (n_colors, P), each pair's cosh and sinh (n_colors, rows, P) with rows =
    1 for tau-independent hoppings, and exp(-dtau V) with rows of row_ld
    (Ltau, ld), 1 in the padding columns."""
    tabs = getattr(fdm, "_mtm_pairs", None)
    if tabs is None:
        C, S, _, expV = mtm_tables(fdm)
        ab, gather = pair_index(fdm.structure, C.device, C.element_size())
        idx = gather[:, None, :].expand(C.shape[0], C.shape[1], gather.shape[1])
        E = torch.ones((fdm.Ltau, row_ld(fdm.n_sites, C.element_size())), dtype=C.dtype, device=C.device)
        E[:, :fdm.n_sites] = expV
        tabs = (ab, C.gather(2, idx).contiguous(), S.gather(2, idx).contiguous(), E)
        fdm._mtm_pairs = tabs
    return tabs


def smem_bytes(N: int, T: int, es: int) -> int:
    """K1's dynamic shared memory for tau blocks of T rows
    (csrc/mtm.cu:smem_bytes): the 2T + 2 rows X and Y of row_ld values."""
    return (2 * T + 2) * row_ld(N, es) * es


def fewest_rows(n_sys: int, Ltau: int, smem, resident, what: str) -> int:
    """T, the tau rows a CTA takes (K1, K4): the fewest for which the n_sys *
    ceil(Ltau / T) blocks make one round of the resident(T) CTAs the card
    holds at once, else the most whose smem(T) bytes fit a CTA's shared
    memory (fewer B applications a row, fewer rounds)."""
    if smem(1) > SMEM_MAX:
        raise ValueError(f"{what}: a block of one row does not fit a CTA's shared memory")
    fit = 1
    while fit < Ltau and smem(fit + 1) <= SMEM_MAX:
        fit += 1
    for T in range(1, fit + 1):
        if n_sys * -(-Ltau // T) <= resident(T):
            return T
    return fit


def tau_block_rows(n_sys: int, Ltau: int, N: int, es: int, resident) -> int:
    """K1's T (`fewest_rows` with K1's shared memory)."""
    return fewest_rows(n_sys, Ltau, lambda T: smem_bytes(N, T, es), resident, f"mtm kernel ({N} sites)")


def launch_shape(fdm, n_sys: int, tau_rows=None, memory_form: bool = False) -> dict:
    """How K1 launches for n_sys systems on this fermion matrix: T, the
    CTA's threads, the form (K of the register form, 0 the memory form;
    `memory_form` forces the latter), the pair slots a color, the grid, the
    dynamic shared memory in bytes and the CTAs resident at once."""
    ab, C, _, _ = pair_tables(fdm)
    Ltau, N, es = fdm.Ltau, fdm.n_sites, C.element_size()
    P = ab.shape[1]
    threads, K, form = block_form(P, C.shape[0], C.shape[1] > 1)
    form = 0 if memory_form else form
    lib = _build.load_library()

    def resident(T):
        r = lib.smoqy_mtm_resident(int(es == 8), form, threads, smem_bytes(N, T, es))
        if r <= 0:
            raise RuntimeError(f"mtm kernel: occupancy query failed (CUDA error {-r})")
        return r

    T = tau_block_rows(n_sys, Ltau, N, es, resident) if tau_rows is None else int(tau_rows)
    if not 1 <= T <= Ltau or smem_bytes(N, T, es) > SMEM_MAX:
        raise ValueError(f"mtm kernel: tau block of {T} rows (Ltau {Ltau}, {smem_bytes(N, T, es)} bytes)")
    return dict(tau_block=T, threads=threads, K=K, form=form, P=P, grid=n_sys * -(-Ltau // T),
                smem=smem_bytes(N, T, es), resident=resident(T))


def mtm_cuda(fdm, v: torch.Tensor, stamps=None, tau_rows=None, memory_form: bool = False) -> torch.Tensor:
    """Launch K1 on v (..., Ltau, N), a CUDA tensor of the fermion matrix's dtype.

    `tau_rows` overrides T and `memory_form` forces the memory form
    (`launch_shape`). `stamps`, a zeroed int64 CUDA tensor of
    `stamp_slots()` entries, selects the timed instantiation, which records
    per-phase clocks there (`phase_times`). The path passes none of them."""
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
    ab, C, S, expV = pair_tables(fdm)
    shape = _launch_cache(fdm, vb.shape[0], tau_rows, memory_form)
    lib = _build.load_library()
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != v.device
                               or not stamps.is_contiguous() or stamps.numel() < stamp_slots()):
        raise ValueError(f"mtm kernel: stamps must be a contiguous int64 tensor of {stamp_slots()} on {v.device}")
    fn = lib.smoqy_mtm_f32 if v.dtype == torch.float32 else lib.smoqy_mtm_f64
    rc = fn(
        vb.data_ptr(), out.data_ptr(), ab.data_ptr(), C.data_ptr(), S.data_ptr(), expV.data_ptr(),
        vb.shape[0], Ltau, N, C.shape[0], shape["P"], int(C.shape[1] > 1), int(fdm.symmetric),
        shape["tau_block"], shape["threads"], shape["form"],
        None if stamps is None else stamps.data_ptr(), torch.cuda.current_stream(v.device).cuda_stream,
    )
    _build.check(rc, "mtm kernel launch")
    MTM[v.dtype].launches += 1
    return out.reshape(v.shape)


_LAUNCH: dict = {}


def _launch_cache(fdm, n_sys: int, tau_rows, memory_form: bool):
    """launch_shape, cached by everything it depends on (the occupancy query
    is a host call the path should not repeat every launch)."""
    ab, C, _, _ = pair_tables(fdm)
    key = (fdm.Ltau, fdm.n_sites, C.dtype, C.shape[0], C.shape[1], ab.shape[1], n_sys, tau_rows, memory_form,
           C.device)
    shape = _LAUNCH.get(key)
    if shape is None:
        shape = _LAUNCH[key] = launch_shape(fdm, n_sys, tau_rows, memory_form)
    return shape


STAMP_BASE = 10  # csrc/mtm.cu:kStampBase


def stamp_slots() -> int:
    return _build.load_library().smoqy_mtm_stamp_slots()


def phase_names(n_colors: int, symmetric: bool) -> list:
    """The timed instantiation's phases of a tau block, in the order it
    stamps them: the staging of v, B's color stages (expV rides on one), the
    m pass, B^T's color stages and the output pass."""
    rev, fwd = list(reversed(range(n_colors))), list(range(n_colors))
    if n_colors == 0:
        b = bt = ["expV"]
    elif symmetric:
        b = bt = [f"c{c}+expV" if c == 0 else f"c{c}" for c in rev] + [f"c{c}" for c in fwd]
    else:
        b = [f"c{c}+expV" if c == n_colors - 1 else f"c{c}" for c in fwd]
        bt = [f"expV+c{c}" if c == n_colors - 1 else f"c{c}" for c in rev]
    return (["stage"] + [f"B.{k}:{x}" for k, x in enumerate(b)] + ["m"]
            + [f"Bt.{k}:{x}" for k, x in enumerate(bt)] + ["out"])


def phase_names_for(fdm, n_sys: int) -> list:
    """The phases a timed launch on this fermion matrix stamps."""
    return phase_names(fdm.cb.n_colors, fdm.symmetric)


def _group(name: str) -> str:
    """The phase group of a stamp name: stage, B, Bt, m or out."""
    return name.split(".")[0]


def phase_times(stamps: torch.Tensor, names: list) -> dict:
    """Microseconds of each phase of a timed launch, on CTA 0 and on the last
    CTA to finish (`names`: the phases the kernel stamped, in order), their
    sums by group, each CTA's time and the kernel's (CTA 0's start to the
    last CTA's end, by globaltimer), and when the last CTA started."""
    t = stamps.cpu().tolist()
    us_per_cycle = (t[2] - t[0]) / max(t[3] - t[1], 1) / 1e3
    out = {"kernel": (t[6] - t[0]) / 1e3, "last_cta": int(t[9]), "last_start": (t[4] - t[0]) / 1e3}
    last_base = STAMP_BASE + (stamp_slots() - STAMP_BASE) // 2
    for who, head, base in (("cta0", 0, STAMP_BASE), ("last", 4, last_base)):
        chain = [t[head + 1]] + t[base:base + len(names)]
        us = [us_per_cycle * (chain[j + 1] - chain[j]) for j in range(len(names))]
        groups: dict = {}
        for name, u in zip(names, us):
            groups[_group(name)] = groups.get(_group(name), 0.0) + u
        out[who] = {"us": (t[head + 2] - t[head]) / 1e3, "groups": groups, "phases": dict(zip(names, us))}
    return out


def mul_MtM(fdm, v: torch.Tensor) -> torch.Tensor:
    """K1 dispatcher: plain version for CPU tensors, the kernel for CUDA tensors."""
    if v.device.type == "cpu":
        return mtm_plain(fdm, v)
    if v.device.type == "cuda":
        return mtm_cuda(fdm, v)
    raise RuntimeError(f"mul_MtM: no kernel for device {v.device}")
