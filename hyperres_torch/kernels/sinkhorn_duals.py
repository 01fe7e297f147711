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
long for it, the sliced kernels (counter ``sinkhorn_duals_long_rows``):
each row is cut into column slices whose (max, sum of exp) pairs are
merged in a fixed order (:func:`merge_slices`), so the grid fills the
card however few the rows (:func:`long_rows_plan`). The earlier
two-read kernels stay in the source as the route ``"two_read"`` (counter
``sinkhorn_duals_two_read``), which the rule never picks: they are timed
beside the others.
On a CPU tensor it runs :func:`sinkhorn_duals_reference`, the plain
PyTorch version, with the same update order and the same stopping rule.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import count_launch, launch_error
from ..utils.profiling import count

KERNEL_NAME = "sinkhorn_duals"
#: launch counter of the long-rows route
LONG_ROWS_NAME = "sinkhorn_duals_long_rows"
#: launch counter of the two-read kernels (timed beside the routes)
TWO_READ_NAME = "sinkhorn_duals_two_read"
ONE_PASS, LONG_ROWS, TWO_READ = "one_pass", "long_rows", "two_read"
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
#: column-kernel blocks per SM the two-read route's row chunks are sized
#: for
_COL_BLOCKS_PER_SM = 4
_COL_THREADS = 256
#: the long-rows route (csrc/sinkhorn_duals.cu: kSliceCols, kSliceMaxRows):
#: a slice-kernel block takes 4096 columns of at most 64 rows; blocks per
#: SM the slice grid (3: one wave of
#: its 4 resident blocks) and the column grid (4, of 128 columns each) are
#: sized for
_SLICE_COLS = 4096
_SLICE_MAX_ROWS = 64
_SLICE_BLOCKS_PER_SM = 3
_SLICED_COL_BLOCKS_PER_SM = 4
_SLICED_COL_COLS = 128


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
    Returns (err, sweeps run), the sweeps also counted as ``ot.sweeps``
    in the innermost open span."""
    thr = float(np.float32(stop_thr))
    err = torch.full((), math.inf, dtype=torch.float32, device=device)
    it = 0
    while it < num_itermax and float(err) > thr:
        err = run_group(check_every)
        it += check_every
    count("ot.sweeps", it)
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


def merge_slices(pmax: torch.Tensor, psum: torch.Tensor):
    """The long-rows route's merge of per-slice pairs (``pmax[..., c]`` =
    the max of a row's slice c, ``psum[..., c]`` = the sum of exp(z - that
    max) over it) into the row's (max, sum of exp(z - max)), slices in
    order (the kernels merge in a fixed order of their own: lanes, then
    a butterfly); ``max + log(sum)`` is the row's logsumexp."""
    mx = pmax.amax(dim=-1)
    total = torch.zeros_like(mx)
    for c in range(pmax.shape[-1]):
        total = total + psum[..., c] * torch.exp(pmax[..., c] - mx)
    return mx, total


class LongRowsPlan(NamedTuple):
    """The long-rows route's grids: ``n_slices`` column slices by
    ceil(n / ``rows_per_block``) blocks for the slice kernel; ``chunks``
    row chunks for the column kernel (1: it updates g itself, two
    launches per sweep; more: the g kernel follows, three)."""

    n_slices: int
    rows_per_block: int
    chunks: int


def long_rows_plan(n: int, m: int, sms: int) -> LongRowsPlan:
    """Cut an (n, m) Mr for the long-rows route on a card with ``sms``
    SMs. Slices of 4096 columns; rows per slice-kernel block so that the
    grid holds ~3 blocks per SM, inside one wave (at most 64 rows a
    block, no block empty). The column kernel's blocks take 128 columns;
    its rows are cut into chunks (no more than n, or 65535) only where
    the columns alone give fewer than 4 blocks per SM."""
    n_slices = -(-m // _SLICE_COLS)
    groups = max(-(-n // _SLICE_MAX_ROWS),
                 min(n, -(-_SLICE_BLOCKS_PER_SM * sms // n_slices)))
    rows_per_block = -(-n // groups)
    col_blocks = -(-m // _SLICED_COL_COLS)
    chunks = max(1, min(n, 65535, -(-_SLICED_COL_BLOCKS_PER_SM * sms
                                    // col_blocks)))
    rows = -(-n // chunks)
    return LongRowsPlan(n_slices, rows_per_block, -(-n // rows))


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
    route (column slices, :func:`long_rows_plan`; two reads of Mr per
    sweep, the second largely from L2): n <= 128 admits m up to ~200k
    under ``PALLAS_SINKHORN_VMEM_BUDGET``."""
    fit = ((smem_per_block - _ONE_PASS_FIXED_BYTES)
           // (_ONE_PASS_STAGES * 4 * m))
    if m > ONE_PASS_COLS or fit < 1:
        return Route(LONG_ROWS)
    blocks = max(1, min(n, sms))
    rows = -(-n // blocks)
    return Route(ONE_PASS, -(-n // rows), rows, min(_ONE_PASS_MAX_ROWS, fit))


def _chunks(n: int, m: int, device: torch.device) -> int:
    """Row chunks of the two-read route's column kernel: enough blocks
    to fill the card, no empty chunk."""
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
    the group's kernels (two per sweep on the one-pass route, two or
    three on the long-rows route, and the err sum) are launched."""
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
        raise launch_error("sinkhorn_device_limits", rc)
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
    elif route.name == LONG_ROWS:
        fn = lib.sinkhorn_duals_sliced_sweeps
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        plan = long_rows_plan(n, m, sms.value)
        pmax, psum = (torch.empty((n, plan.n_slices), dtype=torch.float32,
                                  device=dev) for _ in range(2))
        rmax, u = (torch.empty(n, dtype=torch.float32, device=dev)
                   for _ in range(2))
        # one per group of rows of the slice kernel; it leaves them zero
        counters = torch.zeros(-(-n // plan.rows_per_block),
                               dtype=torch.int32, device=dev)
        partial = torch.empty((plan.chunks if plan.chunks > 1 else 0, m),
                              dtype=torch.float32, device=dev)
        ptrs = (Mr, log_a, log_b, f, g, pmax, psum, rmax, u, err_row,
                counters, partial)
        shape = (n, m, *plan)
        name = LONG_ROWS_NAME
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
        name = TWO_READ_NAME
    fn.restype = ctypes.c_int

    def run_group(k):
        err = torch.empty((), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(t.data_ptr() for t in ptrs), err.data_ptr(), *shape,
                    k, stream)
        if rc != 0:
            raise launch_error("sinkhorn_duals kernel launch", rc)
        count_launch(name)
        return err

    err, sweeps = _iterate(run_group, num_itermax, stop_thr, check_every,
                           dev)
    return (f, g, err, sweeps) if return_sweeps else (f, g, err)
