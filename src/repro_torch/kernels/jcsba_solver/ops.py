"""The JCSBA solver's two kernels behind the plain versions' contracts.

``bmin`` and ``population_objective`` launch the CUDA kernels
(``csrc/jcsba_solver.cu``) on CUDA tensors and run the plain versions
(``ref.py``) on CPU tensors, and nothing else: a build or launch failure,
or a K the kernel cannot take, raises.  ``plan`` picks the population
kernel's block (threads over clients, clients a thread) in Python, so the
choice is testable without a card; the C side checks it again.  Each
wrapper counts its launches (``launch_counts()``).

A solve builds its launches' scalars once (``launch_args``) and hands the
same struct to each of its 23 launches; a wrapper called without one
builds its own.  V is not in the struct: the population kernel reads the
0-d float32 tensor ``data["V"]`` on the card, so a captured solve follows
whatever V is copied into that tensor before a replay.
"""
from __future__ import annotations

import torch

from ...wireless.solver.common import TOL_B, SolverHyper
from ..nvcc import check
from . import ref

#: a block's threads at most, and the clients a thread may hold (the C
#: side's template instances)
MAX_THREADS = 1024
CLIENTS_PER_THREAD = (1, 2, 4, 8)
MAX_K = MAX_THREADS * CLIENTS_PER_THREAD[-1]
#: the grid's x dimension: one block per antibody row
MAX_ROWS = 2 ** 31 - 1

_COUNTS = {"jcsba_bmin_kernel": 0, "jcsba_population_kernel": 0}


def launch_counts() -> dict:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return dict(_COUNTS)


def reset_launch_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def plan(K: int):
    """(threads, clients a thread) of the population kernel's block for K
    clients: the fewest clients a thread that fit 1024 threads, threads a
    multiple of 32.  Raises ValueError past ``MAX_K``."""
    for cpt in CLIENTS_PER_THREAD:
        n = -(-K // cpt)
        if n <= MAX_THREADS:
            return max(32, -(-n // 32) * 32), cpt
    raise ValueError(f"the population kernel takes up to {MAX_K} clients "
                     f"in a block, got K={K}")


def solver_args(K: int, M: int, hp: SolverHyper, B_max: float, p_tx: float,
                N0: float, eta: float = 0.0, rho: float = 0.0):
    """The C side's ``SolverArgs``: the round's fixed scalars (V is read
    from the device, not from here), each rounded to
    float32 where the plain version rounds it (sums and products of two
    Python floats are taken in double first, as torch takes them).  The
    solver's fixed constants are ``constexpr`` on the C side.  The B_min
    kernel reads K, n_bisect_b, B_max, p_tx, N0 and n0ln2 only."""
    from .build import SolverArgs
    return SolverArgs(
        K=K, M=M, n_bisect_b=hp.n_bisect_b, n_bisect_k=hp.n_bisect_k,
        B_max=B_max, bmax_hi=B_max + TOL_B, bmax_lo=B_max - TOL_B,
        p_tx=p_tx, N0=N0, n0ln2=N0 * ref.LN2, er=eta * rho,
        c=(2 * eta - eta ** 2) / 2.0)


def launch_args(data: dict, hp: SolverHyper):
    """One solve's ``SolverArgs`` for ``data`` (``torchsolver.to_device``'s
    dict) on a card; None for CPU data, whose plain versions take none."""
    if not data["Q"].is_cuda:
        return None
    return solver_args(data["Q"].shape[0], data["zeta2"].shape[0], hp,
                       data["B_max"], data["p_tx"], data["N0"], data["eta"],
                       data["rho"])


def _f32(*ts):
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"the CUDA kernel takes float32 tensors, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"the CUDA kernel takes contiguous float32 "
                            f"operands, got {t.dtype} (contiguous: "
                            f"{t.is_contiguous()})")
        if t.device != ts[0].device:
            raise ValueError(f"operands on {t.device} and {ts[0].device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_bmin(gamma, h, tau_rem, B_max, p_tx, N0, hp: SolverHyper,
                 args=None):
    from .build import load
    _f32(gamma, h, tau_rem)
    K = gamma.shape[0]
    if h.shape != (K,) or tau_rem.shape != (K,):
        raise ValueError(f"gamma {tuple(gamma.shape)}, h {tuple(h.shape)}, "
                         f"tau_rem {tuple(tau_rem.shape)}: expected [K] each")
    bm = torch.empty_like(gamma)
    ok = torch.empty(K, dtype=torch.bool, device=gamma.device)
    if K == 0:
        return bm, ok
    if args is None:
        args = solver_args(K, 0, hp, B_max, p_tx, N0)
    elif args.K != K:
        raise ValueError(f"args for K={args.K}, got K={K}")
    with torch.cuda.device(gamma.device):
        rc = load().jcsba_bmin(gamma.data_ptr(), h.data_ptr(),
                               tau_rem.data_ptr(), bm.data_ptr(),
                               ok.data_ptr(), args, _stream(gamma.device))
    check(rc, "jcsba_bmin_kernel")
    _COUNTS["jcsba_bmin_kernel"] += 1
    return bm, ok


def _launch_population(A, bmin_, ok, data, hp: SolverHyper, want_B: bool,
                       args=None):
    from .build import load
    P, K = A.shape
    if A.dtype not in (torch.bool, torch.uint8) or not A.is_contiguous():
        raise TypeError(f"A must be a contiguous bool [P, K], got {A.dtype}")
    vecs = [data[n] for n in ("Q", "gamma", "h", "e_cmp", "D")]
    snap = [data[n] for n in ("zeta2", "delta2", "wbar")]
    has, V = data["has"], data["V"]
    _f32(bmin_, *vecs, *snap, V)
    M = snap[0].shape[0]
    if (any(v.shape != (K,) for v in (bmin_, ok, *vecs))
            or any(t.shape != (M, K) for t in (snap[1], snap[2], has))
            or V.shape != () or has.dtype != torch.bool
            or ok.dtype != torch.bool or A.device != bmin_.device):
        raise ValueError(f"A [P, K] = {tuple(A.shape)}: expected bmin, ok, "
                         f"Q, gamma, h, e_cmp, D [K], delta2, wbar, has "
                         f"[M, K] and a 0-d V on one device (ok and has "
                         f"bool)")
    if P > MAX_ROWS:
        raise ValueError(f"{P} rows: one launch takes up to {MAX_ROWS}")
    threads, cpt = plan(K)
    J = torch.empty(P, dtype=torch.float32, device=A.device)
    feas = torch.empty(P, dtype=torch.bool, device=A.device)
    B = (torch.empty((P, K), dtype=torch.float32, device=A.device)
         if want_B else None)
    if P == 0:
        return J, B, feas
    if args is None:
        args = solver_args(K, M, hp, data["B_max"], data["p_tx"],
                           data["N0"], data["eta"], data["rho"])
    elif (args.K, args.M) != (K, M):
        raise ValueError(f"args for K={args.K}, M={args.M}, got K={K}, "
                         f"M={M}")
    with torch.cuda.device(A.device):
        rc = load().jcsba_population(
            A.data_ptr(), bmin_.data_ptr(), ok.data_ptr(),
            *(v.data_ptr() for v in vecs[:4]),
            *(t.data_ptr() for t in snap), has.data_ptr(),
            vecs[4].data_ptr(), V.data_ptr(), J.data_ptr(), feas.data_ptr(),
            B.data_ptr() if want_B else None, P, threads, cpt, args,
            _stream(A.device))
    check(rc, "jcsba_population_kernel")
    _COUNTS["jcsba_population_kernel"] += 1
    return J, B, feas


def bmin(gamma, h, tau_rem, B_max: float, p_tx: float, N0: float,
         hp: SolverHyper, args=None):
    """Per-client B_min (Eq. 41): (bmin [K] f32, ok [K] bool).  ``args``:
    the solve's ``launch_args`` (a card only)."""
    if gamma.is_cuda:
        return _launch_bmin(gamma, h, tau_rem, B_max, p_tx, N0, hp, args)
    return ref.bmin(gamma, h, tau_rem, B_max, p_tx, N0, hp)


def population_objective(A, bmin_, ok, data, hp: SolverHyper,
                         want_B: bool = False, args=None):
    """(J [P], B [P, K] or None, feasible [P]) for the antibody rows A
    [P, K] bool: the KKT bandwidth split and J₂ of every row.  ``args``:
    the solve's ``launch_args`` (a card only)."""
    if A.is_cuda:
        return _launch_population(A, bmin_, ok, data, hp, want_B, args)
    return ref.population_objective(A, bmin_, ok, data, hp, want_B)
