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
raises); the host reads ``err`` once per group. On a CPU tensor it runs
:func:`sinkhorn_duals_reference`, the plain PyTorch version, with the
same update order and the same stopping rule.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..device import count_launch

KERNEL_NAME = "sinkhorn_duals"
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
    (``csrc/sinkhorn_duals.cu``), CPU tensors through
    :func:`sinkhorn_duals_reference`. Returns ``(f, g, err)``, and the
    number of sweeps if ``return_sweeps``. The launch counter counts one
    per group of ``check_every`` sweeps, where the group's kernels (three
    per sweep and the err sum) are launched."""
    n, m = _check(log_a, log_b, Mr)
    if Mr.device.type == "cpu":
        return sinkhorn_duals_reference(log_a, log_b, Mr, num_itermax,
                                        stop_thr, check_every,
                                        return_sweeps)
    if Mr.device.type != "cuda":
        raise ValueError(f"no Sinkhorn kernel for device {Mr.device}")
    from ._build import load_library

    lib = load_library("sinkhorn_duals")
    fn = lib.sinkhorn_duals_sweeps
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = Mr.device
    Mr = Mr.contiguous()
    log_a = log_a.contiguous()
    log_b = log_b.contiguous()
    chunks = _chunks(n, m, dev)
    f = torch.zeros(n, dtype=torch.float32, device=dev)
    g = torch.zeros(m, dtype=torch.float32, device=dev)
    rmax, u, err_row = (torch.empty(n, dtype=torch.float32, device=dev)
                        for _ in range(3))
    partial = torch.empty((chunks, m), dtype=torch.float32, device=dev)

    def run_group(k):
        err = torch.empty((), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(Mr.data_ptr(), log_a.data_ptr(), log_b.data_ptr(),
                    f.data_ptr(), g.data_ptr(), rmax.data_ptr(),
                    u.data_ptr(), err_row.data_ptr(), partial.data_ptr(),
                    err.data_ptr(), n, m, chunks, k, stream)
        if rc != 0:
            raise RuntimeError(f"sinkhorn_duals kernel launch failed: CUDA "
                               f"error {rc}")
        count_launch(KERNEL_NAME)
        return err

    err, sweeps = _iterate(run_group, num_itermax, stop_thr, check_every,
                           dev)
    return (f, g, err, sweeps) if return_sweeps else (f, g, err)
