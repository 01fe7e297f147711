"""Log-domain Sinkhorn duals: the kernel behind
``ot_barycentric_targets(engine="pallas")``.

``sinkhorn_duals(log_a, log_b, Mr)`` returns ``(f, g, err)`` with the
plan ``P = exp(Mr + f[:, None] + g[None, :])``, as
``pallas_sinkhorn_duals`` does (``hyperres/kernels/pallas_ops.py:605``).
``Mr`` is the regularised negative cost ``-M / reg``. One sweep updates f
from the rows of ``Mr + g`` and then g from the column sums of the
row pass's exponentials (see ``csrc/sinkhorn_duals.cu``).

Stopping rule (the reference kernel's, not ``sinkhorn_log``'s): groups
of ``check_every`` sweeps run while ``it < num_itermax`` and
``err > stop_thr``, starting from ``err = inf``; ``err`` is the last
sweep's ROW-marginal violation ``sum_i |sum_j P_ij - a_i|`` of the
iterate before that sweep's f update. ``sinkhorn_log`` checks the column
marginal after the g update instead, so the two engines may stop at
different checks.

On a CUDA tensor the wrapper launches the hand-written kernels (or
raises); the host reads ``err`` once per group. Two routes, chosen by
:func:`sinkhorn_route` from the shape: the one-pass kernel (one read of
``Mr`` per sweep, launch counter ``sinkhorn_duals``) and, for rows too
long for it, the two-read kernels (counter ``sinkhorn_duals_long_rows``).
On a CPU tensor it runs :func:`sinkhorn_duals_reference`, the plain
PyTorch version, with the same update order and the same stopping rule.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import count_launch

KERNEL_NAME = "sinkhorn_duals"
#: launch counter of the long-rows route
LONG_ROWS_NAME = "sinkhorn_duals_long_rows"
ONE_PASS, LONG_ROWS = "one_pass", "long_rows"
#: the one-pass kernel (csrc/sinkhorn_duals.cu): 512 threads, 12 register
#: columns each, at most 2 rows per group, a ring of 4 groups in shared
#: memory
ONE_PASS_COLS = 12 * 512
_ONE_PASS_MAX_ROWS = 2
_ONE_PASS_STAGES = 4
#: the reduction buffers and each group buffer's alignment slack
_ONE_PASS_FIXED_BYTES = 2 * 2 * 16 * 4 + _ONE_PASS_STAGES * 7 * 4
#: the reference's engine budget (``pallas_ops.py:602``): the largest
#: cost matrix, in bytes after padding both sides to 128, that
#: ``engine="pallas"`` hands to the kernel
PALLAS_SINKHORN_VMEM_BUDGET = 5120 * 5120 * 4
#: column-kernel blocks per SM the row chunks are sized for
_COL_BLOCKS_PER_SM = 4
_COL_THREADS = 256


def _check(log_a: torch.Tensor, log_b: torch.Tensor, Mr: torch.Tensor):
    if log_a.dim() != 1 or log_b.dim() != 1 or Mr.dim() != 2:
        raise ValueError(f"log_a and log_b must be 1-D and Mr 2-D, got "
                         f"{tuple(log_a.shape)}, {tuple(log_b.shape)} and "
                         f"{tuple(Mr.shape)}")
    n, m = Mr.shape
    if log_a.shape[0] != n or log_b.shape[0] != m or n == 0 or m == 0:
        raise ValueError(f"Mr {tuple(Mr.shape)} does not match log_a "
                         f"{tuple(log_a.shape)} and log_b "
                         f"{tuple(log_b.shape)}")
    for t in (log_a, log_b, Mr):
        if t.dtype != torch.float32:
            raise TypeError(f"sinkhorn_duals takes float32, got {t.dtype}")
        if t.device != Mr.device:
            raise ValueError(f"operands on {t.device} and {Mr.device}")
    return n, m


def _iterate(run_group, num_itermax: int, stop_thr: float,
             check_every: int, device: torch.device):
    """The reference's loop: groups of ``check_every`` sweeps while
    ``it < num_itermax and err > stop_thr`` (in f32). ``run_group(k)``
    runs k sweeps and returns the last one's err as a 0-d tensor.
    Returns (err, sweeps run)."""
    thr = float(np.float32(stop_thr))
    err = torch.full((), math.inf, dtype=torch.float32, device=device)
    it = 0
    while it < num_itermax and float(err) > thr:
        err = run_group(check_every)
        it += check_every
    return err, it


def sinkhorn_duals_reference(log_a: torch.Tensor, log_b: torch.Tensor,
                             Mr: torch.Tensor, num_itermax: int = 300,
                             stop_thr: float = 1e-6, check_every: int = 10,
                             return_sweeps: bool = False):
    """Plain PyTorch version of the kernel: the same sweep (see the
    module docstring) on whole (n, m) temporaries. Returns
    ``(f, g, err)``, and the number of sweeps if ``return_sweeps``."""
    _check(log_a, log_b, Mr)
    a = torch.exp(log_a)
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_b)

    def run_group(k):
        nonlocal f, g
        for _ in range(k):
            z = Mr + g[None, :]
            rmax = torch.amax(z, dim=1)
            E = torch.exp(z - rmax[:, None])
            rowsum = torch.sum(E, dim=1)
            rlse = rmax + torch.log(rowsum)
            err = torch.sum(torch.abs(torch.exp(f + rlse) - a))
            f = log_a - rlse
            s_col = torch.sum(E * (a / rowsum)[:, None], dim=0)
            g = log_b - torch.log(torch.clamp(s_col, min=1e-37)) + g
        return err

    err, sweeps = _iterate(run_group, num_itermax, stop_thr, check_every,
                           Mr.device)
    return (f, g, err, sweeps) if return_sweeps else (f, g, err)


class Route(NamedTuple):
    """Which kernels run a sweep, and how the one-pass route cuts the
    rows: ``blocks`` blocks of ``rows_per_block`` rows, ``group_rows``
    rows at a time in shared memory."""

    name: str
    blocks: int = 0
    rows_per_block: int = 0
    group_rows: int = 0


def sinkhorn_route(n: int, m: int, sms: int, smem_per_block: int) -> Route:
    """The route for an (n, m) Mr on a card with ``sms`` SMs and
    ``smem_per_block`` bytes of shared memory a block may use.

    One pass when m <= ONE_PASS_COLS (6144: each of 512 threads keeps 12
    columns of g, of the column partials and of each row of a group in
    registers) and a ring of 4 groups of at least 1 row fits in shared
    memory (4 * 4 * m * rows bytes plus 368; 2 rows fit up to m ~7.2k on
    an H100's 232,448 bytes, so the 6144 limit binds there). Its
    ``min(n, sms)`` blocks take ceil(n / blocks) rows each (none empty)
    and hold ``min(2, fit)`` rows per group. Otherwise the long-rows
    route (two reads of Mr per sweep): n <= 128 admits m up to ~200k
    under ``PALLAS_SINKHORN_VMEM_BUDGET``."""
    fit = ((smem_per_block - _ONE_PASS_FIXED_BYTES)
           // (_ONE_PASS_STAGES * 4 * m))
    if m > ONE_PASS_COLS or fit < 1:
        return Route(LONG_ROWS)
    blocks = max(1, min(n, sms))
    rows = -(-n // blocks)
    return Route(ONE_PASS, -(-n // rows), rows, min(_ONE_PASS_MAX_ROWS, fit))


def _chunks(n: int, m: int, device: torch.device) -> int:
    """Row chunks of the column kernel: enough blocks to fill the card,
    no empty chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    col_blocks = -(-m // _COL_THREADS)
    chunks = max(1, min(n, 65535,
                        -(-_COL_BLOCKS_PER_SM * sms // col_blocks)))
    rows = -(-n // chunks)
    return -(-n // rows)


def sinkhorn_duals(log_a: torch.Tensor, log_b: torch.Tensor,
                   Mr: torch.Tensor, num_itermax: int = 300,
                   stop_thr: float = 1e-6, check_every: int = 10,
                   return_sweeps: bool = False):
    """Log-domain Sinkhorn duals (see the module docstring). CUDA
    tensors go through the hand-written kernels
    (``csrc/sinkhorn_duals.cu``) of the :func:`sinkhorn_route` route,
    CPU tensors through :func:`sinkhorn_duals_reference`. Returns ``(f,
    g, err)``, and the number of sweeps if ``return_sweeps``. The route's
    launch counter counts one per group of ``check_every`` sweeps, where
    the group's kernels (two per sweep on the one-pass route, three on
    the long-rows route, and the err sum) are launched."""
    n, m = _check(log_a, log_b, Mr)
    if Mr.device.type == "cpu":
        return sinkhorn_duals_reference(log_a, log_b, Mr, num_itermax,
                                        stop_thr, check_every,
                                        return_sweeps)
    if Mr.device.type != "cuda":
        raise ValueError(f"no Sinkhorn kernel for device {Mr.device}")
    from ._build import load_library

    lib = load_library("sinkhorn_duals")
    dev = Mr.device
    Mr = Mr.contiguous()
    log_a = log_a.contiguous()
    log_b = log_b.contiguous()
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.sinkhorn_device_limits(ctypes.byref(sms), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"sinkhorn_device_limits failed: CUDA error {rc}")
    route = sinkhorn_route(n, m, sms.value, smem.value)
    f = torch.zeros(n, dtype=torch.float32, device=dev)
    g = torch.zeros(m, dtype=torch.float32, device=dev)
    err_row = torch.empty(n, dtype=torch.float32, device=dev)
    if route.name == ONE_PASS:
        fn = lib.sinkhorn_duals_onepass_sweeps
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        partial = torch.empty((route.blocks, m), dtype=torch.float32,
                              device=dev)
        ptrs = (Mr, log_a, log_b, f, g, err_row, partial)
        shape = (n, m, route.blocks, route.rows_per_block, route.group_rows)
        name = KERNEL_NAME
    else:
        fn = lib.sinkhorn_duals_sweeps
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        chunks = _chunks(n, m, dev)
        rmax, u = (torch.empty(n, dtype=torch.float32, device=dev)
                   for _ in range(2))
        partial = torch.empty((chunks, m), dtype=torch.float32, device=dev)
        ptrs = (Mr, log_a, log_b, f, g, rmax, u, err_row, partial)
        shape = (n, m, chunks)
        name = LONG_ROWS_NAME
    fn.restype = ctypes.c_int

    def run_group(k):
        err = torch.empty((), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(t.data_ptr() for t in ptrs), err.data_ptr(), *shape,
                    k, stream)
        if rc != 0:
            raise RuntimeError(f"sinkhorn_duals kernel launch failed: CUDA "
                               f"error {rc}")
        count_launch(name)
        return err

    err, sweeps = _iterate(run_group, num_itermax, stop_thr, check_every,
                           dev)
    return (f, g, err, sweeps) if return_sweeps else (f, g, err)
