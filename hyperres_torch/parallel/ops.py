"""Sharded operations on a single-process device mesh
(``hyperres/parallel/ops.py``).

Each op takes global inputs (arrays or tensors) and a :class:`~.mesh.Mesh`,
as the reference's ``shard_map`` ops do, splits them into per-shard
tensors on the shards' devices, runs each shard's body there, and joins
the shards with the collectives of :mod:`.mesh`. A row- or pixel-sharded
result comes back as one global tensor, its blocks concatenated on the
device of the axis's first shard:

- distributed percentiles by histogram refinement, the histograms
  psum-reduced (:func:`sharded_histogram_percentile`);
- a data-parallel ridge spectral-SR fit, the f64 moment and Gram terms
  of the port's own fit psum-reduced, so it equals the single-device
  fit (:func:`data_parallel_ridge_fit`);
- a tile map, ``torch.func.vmap`` over each shard's tiles
  (:func:`sharded_tile_map`);
- the halo exchange of row-sharded rasters (:func:`halo_exchange_rows`);
- band-sharded SRF synthesis, partial products psum-reduced
  (:func:`sharded_srf_synthesize`);
- the fused GLT ortho-warp with destination rows sharded, by the tap
  loop (:func:`sharded_orthowarp`) or by the two-pass scanline kernel,
  one shot or folded over streamed band chunks
  (:func:`sharded_orthowarp_two_pass`, :func:`sharded_streamed_orthowarp`);
- row-sharded SR inference to u16 (:func:`sharded_sr_predict_u16`);
- the two-pass warp and SRF synthesis on a 2-D row x band mesh
  (:func:`sharded_orthowarp_srf_2d`).

On a CUDA shard the two-pass warps run the scanline kernel
(``csrc/scanline_warp.cu``) for both passes of every shard, and
``sharded_sr_predict_u16(engine="pallas")`` the SR kernel
(``csrc/sr_predict.cu``) once per shard.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..core.constants import NO_DATA_VALUE
from ..fusion.ridge_sr import (
    RidgeSpectralSR, sr_predict_u16, standard_deviation, weighted_spread,
    weighted_sums,
)
from ..io.ingest import dequant_slab, stream_cube_fold
from ..kernels.banded import check_precision, scanline_resample
from ..kernels.lstsq import logit
from ..kernels.stats import histogram_counts, refine_histogram_brackets
from ..kernels.warp import (
    _centre_in, _renormalise, orthowarp_src_ext, orthowarp_taploop,
)
from .mesh import Mesh, pmax, pmin, ppermute, psum, replicate, shard


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _join(parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The shards' blocks concatenated on the first shard's device."""
    return torch.cat([p.to(parts[0].device) for p in parts], dim=dim)


# ---------------------------------------------------------------------------
# Distributed percentile (histogram + psum)
# ---------------------------------------------------------------------------

def sharded_histogram_percentile(x, mask, qs: Sequence[float], mesh: Mesh,
                                 axis: str = "data", nbins: int = 2048,
                                 iters: int = 2) -> torch.Tensor:
    """Percentiles of the masked global distribution of ``x`` whose
    leading dim is sharded over ``axis`` (``ops.py:36``): the global
    count, min and max by psum / pmin / pmax, then per percentile
    ``iters`` rounds of :func:`~hyperres_torch.kernels.stats.
    histogram_percentile`'s refinement with the per-shard histograms
    psum-reduced. Equal to the single-device ``histogram_percentile``
    (exact integer counts). Returns (Q,) float32."""
    devs = mesh.axis_devices(axis)
    vals = [xs.reshape(-1)[ms.reshape(-1)]
            for xs, ms in zip(shard(x, devs), shard(mask, devs))]
    n = int(psum([torch.tensor(v.numel(), device=v.device) for v in vals],
                 devs)[0])
    inf = float("inf")
    glo = pmin([v.min() if v.numel() else torch.tensor(inf, device=v.device)
                for v in vals], devs)[0]
    ghi = pmax([v.max() if v.numel() else torch.tensor(-inf, device=v.device)
                for v in vals], devs)[0]

    def counts(lo: float, hi: float):
        parts = [histogram_counts(v, lo, hi, nbins) for v in vals]
        return (psum([p[0] for p in parts], devs)[0],
                psum([p[1] for p in parts], devs)[0])

    out = refine_histogram_brackets(counts, n, float(glo), float(ghi), qs,
                                    nbins, iters)
    return torch.as_tensor(out, device=devs[0])


# ---------------------------------------------------------------------------
# Data-parallel ridge spectral-SR fit
# ---------------------------------------------------------------------------

def data_parallel_ridge_fit(model: RidgeSpectralSR, X, Y, mesh: Mesh,
                            axis: str = "data",
                            weights=None) -> RidgeSpectralSR:
    """One data-parallel fit of the spectral-SR model (``ops.py:87``):
    each shard of X (N, Bx) / Y (N, By) computes its terms of the
    model's own fit (``RidgeSpectralSR.fit``): the f64 weighted sums of
    the standardisation, then the f64 Gram terms of the features; psum
    assembles each, and the centred system is solved once, in f64. The
    sums differ from the single-device fit's only by f64 rounding, so W
    equals the single-device W to f32 rounding. (The reference psums f32
    normal equations, which lose definiteness at full width.) N must
    divide the axis. Sets and returns ``model``."""
    devs = mesh.axis_devices(axis)
    Xs, Ys = shard(_f32(X), devs), shard(_f32(Y), devs)
    ws = ([None] * len(devs) if weights is None
          else shard(_f32(weights), devs))
    sums = [weighted_sums(x, w) for x, w in zip(Xs, ws)]
    n = psum([s[0] for s in sums], devs)
    x_sum = psum([s[1] for s in sums], devs)
    x_mean = [(s / c).float() for s, c in zip(x_sum, n)]
    spread = psum([weighted_spread(x, w, m)
                   for x, w, m in zip(Xs, ws, x_mean)], devs)
    x_std = [standard_deviation(c, s) for c, s in zip(n, spread)]
    terms = [model._gram_terms(x, logit(y, eps=model.cfg.logit_eps), w, m, s)
             for x, y, w, m, s in zip(Xs, Ys, ws, x_mean, x_std)]
    summed = [psum([t[k] for t in terms], devs)[0] for k in range(5)]
    W, intercept = model._solve_from_gram(*summed, model.cfg.alpha)
    dev = model.device
    model.x_mean, model.x_std = x_mean[0].to(dev), x_std[0].to(dev)
    model.W, model.intercept = W.float().to(dev), intercept.float().to(dev)
    return model


# ---------------------------------------------------------------------------
# Sharded tile map
# ---------------------------------------------------------------------------

def sharded_tile_map(fn: Callable, tiles, mesh: Mesh, axis: str = "data"):
    """``fn`` (one tile -> a pytree of tensors) over a (T, ...) tile stack
    sharded across ``axis``, ``torch.func.vmap`` per shard (``ops.py:137``).
    T must divide the axis (pad upstream). Returns the pytree of (T, ...)
    results."""
    outs = [tree_flatten(torch.func.vmap(fn)(t))
            for t in shard(torch.as_tensor(tiles), mesh.axis_devices(axis))]
    leaves = [_join([o[0][k] for o in outs]) for k in range(len(outs[0][0]))]
    return tree_unflatten(leaves, outs[0][1])


# ---------------------------------------------------------------------------
# Halo exchange for row-sharded rasters
# ---------------------------------------------------------------------------

def _tail(t: torch.Tensor, k: int) -> torch.Tensor:
    return t[t.shape[0] - k:]


def halo_exchange_rows(shards: Sequence[torch.Tensor], halo: int,
                       devices: Optional[Sequence[torch.device]] = None
                       ) -> List[torch.Tensor]:
    """Pad each block (h, ...) of a row-sharded raster with ``halo`` rows
    from its neighbours, edge rows replicated at the outer boundaries
    (``ops.py:155``); cubic resampling needs halo=2, bilinear 1. The
    reference's form is called inside ``shard_map`` on one shard; this
    one takes the list of blocks (block i on ``devices[i]``, default its
    own device) and returns the list of padded blocks."""
    n = len(shards)
    devs = list(devices) if devices is not None else [s.device
                                                     for s in shards]
    up = [(j, (j - 1) % n) for j in range(n)]     # send top rows upward
    down = [(j, (j + 1) % n) for j in range(n)]   # send bottom rows down
    from_below = ppermute([s[:halo] for s in shards], up, devs)
    from_above = ppermute([_tail(s, halo) for s in shards], down, devs)
    # outer edges: replicate the own border row
    reps = (halo,) + (1,) * (shards[0].dim() - 1)
    from_above[0] = shards[0][:1].repeat(reps)
    from_below[n - 1] = _tail(shards[n - 1], 1).repeat(reps)
    return [torch.cat([a, s, b]) for a, s, b in zip(from_above, shards,
                                                      from_below)]


# ---------------------------------------------------------------------------
# Band-sharded SRF synthesis
# ---------------------------------------------------------------------------

def sharded_srf_synthesize(cube_hwb, weights_bs, mesh: Mesh,
                           axis: str = "band") -> torch.Tensor:
    """SRF synthesis with the spectral axis sharded (``ops.py:181``): each
    shard multiplies its band slice of the (H, W, B) cube by its rows of
    the (B, S) weights (``torch.matmul``, f32), and psum assembles the
    (H, W, S) synthesis. A plain product, as the reference's ``jnp.dot``:
    no invalid-row fill. B must divide the axis."""
    devs = mesh.axis_devices(axis)
    cubes = shard(_f32(cube_hwb), devs, dim=2)
    h, w = cubes[0].shape[:2]
    parts = [torch.matmul(c.reshape(h * w, -1), wb).reshape(h, w, -1)
             for c, wb in zip(cubes, shard(_f32(weights_bs), devs))]
    return psum(parts, devs)[0]


# ---------------------------------------------------------------------------
# Sharded fused ortho-warps (destination rows data-parallel)
# ---------------------------------------------------------------------------

def sharded_orthowarp(raw, glt_flat_idx, glt_valid, rows, cols, mesh: Mesh,
                      axis: str = "data", method: str = "cubic",
                      fill: float = NO_DATA_VALUE,
                      row_chunks: int = 1) -> torch.Tensor:
    """Fused GLT + warp by the tap loop with the destination fields
    sharded over ``axis`` (``ops.py:205``): each shard runs
    :func:`~hyperres_torch.kernels.warp.orthowarp_taploop` for its block
    of destination rows; the raw cube and the GLT are replicated. The
    destination height must divide the axis."""
    devs = mesh.axis_devices(axis)
    raws = replicate(_f32(raw), devs)
    gfs = replicate(glt_flat_idx, devs)
    gvs = replicate(glt_valid, devs)
    parts = [orthowarp_taploop(r, gf, gv, rs, cs, method=method, fill=fill,
                               row_chunks=row_chunks)
             for r, gf, gv, rs, cs in zip(raws, gfs, gvs,
                                          shard(_f32(rows), devs),
                                          shard(_f32(cols), devs))]
    return _join(parts)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _support(rows_np: np.ndarray, n: int, method: str):
    """Per destination shard, the scanlines [lo, hi] its rows field
    reaches with the kernel's radius."""
    radius = 2.0 if method == "cubic" else 1.0
    hd_l = rows_np.shape[0] // n
    for i in range(n):
        blk = rows_np[i * hd_l:(i + 1) * hd_l]
        yield i, np.floor(blk.min() - radius), np.ceil(blk.max() + radius)


def min_two_pass_halo(rows, ho: int, n: int, method: str = "cubic") -> int:
    """The smallest ``halo`` with which every destination shard's
    scanline support (its rows field +- the kernel's radius) lies in its
    window ``[i * ho / n - halo, (i + 1) * ho / n + halo]``, for an
    n-shard two-pass warp onto ``rows`` (Hd, Wd) from ``ho`` scanlines."""
    ho_l = ho // n
    need = 0.0
    for i, lo, hi in _support(_host(rows), n, method):
        need = max(need, i * ho_l - lo, hi - (i + 1) * ho_l)
    return int(need)


def _check_two_pass(ho: int, rows_np: np.ndarray, n: int, halo: int,
                    method: str, row_axis: Optional[str] = None) -> None:
    """The reference's host checks (``ops.py:229-257``; with
    ``row_axis``, those of the 2-D op, ``ops.py:476-496``): divisibility,
    the halo against a shard, and each destination shard's scanline
    support against its halo window."""
    hd = rows_np.shape[0]
    if ho % n or hd % n:
        where = (f"the mesh axis {n}" if row_axis is None
                 else f"the '{row_axis}' axis {n}")
        raise ValueError(f"source height {ho} and destination height "
                         f"{hd} must divide {where}")
    if halo > ho // n:
        raise ValueError(
            f"halo {halo} exceeds the per-shard scanline count {ho // n}"
            + (" (ppermute exchanges at most one full shard)"
               if row_axis is None else ""))
    ho_l = ho // n
    for i, lo, hi in _support(rows_np, n, method):
        if lo < i * ho_l - halo or hi > (i + 1) * ho_l + halo:
            window = (f" [{i * ho_l - halo}, {(i + 1) * ho_l + halo}]"
                      if row_axis is None else "")
            raise ValueError(
                f"destination shard {i} needs scanlines [{lo}, {hi}] "
                f"outside its halo window{window}; increase halo")


def _two_pass_shards(raws, gfs, gvs, rows_s, cols_s, cstar_s, devs,
                     ho: int, wo: int, halo: int, method: str,
                     fill: float) -> List[torch.Tensor]:
    """The shard bodies of the sharded two-pass warp, shard i on
    ``devs[i]``: the GLT gather and pass 1 of the scanline kernel on the
    shard's own scanlines; the ``ppermute`` of ``halo`` scanlines with
    each neighbour (cyclic, as the reference's); pass 2 at the rows
    field shifted to the halo-extended block, its scanlines outside
    ``[0, ho)`` and the wrapped ones zeroed first (the reference masks
    pass 2's weights instead: the same sum while pass 1 is finite); the
    renormalisation and the centre test. Returns each shard's (Hd / n,
    Wd, B) block."""
    n = len(devs)
    ho_l = ho // n
    b = raws[0].shape[-1]
    h = [scanline_resample(orthowarp_src_ext(r, gf, gv), cs, axis=1,
                           method=method)
         for r, gf, gv, cs in zip(raws, gfs, gvs, cstar_s)]
    fwd = [(j, (j + 1) % n) for j in range(n)]
    bwd = [(j, (j - 1) % n) for j in range(n)]
    from_prev = ppermute([_tail(t, halo) for t in h], fwd, devs)
    from_next = ppermute([t[:halo] for t in h], bwd, devs)
    out = []
    for i in range(n):
        # shard 0 drops the scanlines above the source (all masked), so
        # that no shard's offset is negative: rows - offset is then an
        # integer shift down of positions below 2**12, exact in f32, and
        # each tap's weight is the single-device one
        lead = min(halo, i * ho_l)
        h_ext = torch.cat([_tail(from_prev[i], lead), h[i], from_next[i]])
        offset = i * ho_l - lead
        m = torch.arange(h_ext.shape[0], device=devs[i]) + offset
        keep = ((m >= 0) & (m < ho)
                & (m >= (i - 1) * ho_l) & (m < (i + 2) * ho_l))
        h_ext[~keep] = 0.0
        out_ext = scanline_resample(h_ext, rows_s[i] - float(offset),
                                    axis=0, method=method)
        del h_ext
        out.append(_renormalise(out_ext[..., :b], out_ext[..., b:],
                                _centre_in(rows_s[i], cols_s[i], ho, wo),
                                fill))
    return out


def _row_fields(glt_flat_idx, glt_valid, rows, cols, cstar, devs):
    """The GLT and the index fields sharded by rows over ``devs``."""
    return (shard(torch.as_tensor(glt_flat_idx), devs),
            shard(torch.as_tensor(glt_valid), devs),
            shard(_f32(rows), devs), shard(_f32(cols), devs),
            shard(_f32(cstar), devs))


def sharded_orthowarp_two_pass(raw, glt_flat_idx, glt_valid, rows, cols,
                               cstar, mesh: Mesh, axis: str = "data",
                               method: str = "cubic",
                               fill: float = NO_DATA_VALUE, halo: int = 32,
                               precision: str = "high") -> torch.Tensor:
    """Multi-device two-pass scanline ortho-warp (``ops.py:308``).

    Pass 1 (along each source scanline) is sharded over the source
    scanlines of the (Ho, Wo) GLT grid, pass 2 (along the destination
    columns) over the destination rows: since the rows field is
    monotone, destination shard i needs the scanlines of source shard i
    and at most ``halo`` more on each side, which one ``ppermute`` per
    neighbour brings. Both passes are the scanline kernel on a CUDA
    shard. The raw cube is replicated; the GLT, ``cstar`` (Ho, Wd) and
    the destination fields are sharded by rows.

    Host checks, with the reference's messages: Ho and Hd divisible by
    the axis, ``halo <= Ho / n``, and each destination shard's scanline
    support within its halo window (else "increase halo";
    :func:`min_two_pass_halo` gives the smallest halo that passes).
    ``precision`` ``"high"`` / ``"highest"`` are exact f32. The result
    equals the single-device ``orthowarp_two_pass`` bit for bit."""
    check_precision(precision)
    devs = mesh.axis_devices(axis)
    ho, wo = tuple(glt_flat_idx.shape)
    _check_two_pass(ho, _host(rows), len(devs), halo, method)
    gfs, gvs, rows_s, cols_s, cstar_s = _row_fields(
        glt_flat_idx, glt_valid, rows, cols, cstar, devs)
    return _join(_two_pass_shards(replicate(_f32(raw), devs), gfs, gvs,
                                  rows_s, cols_s, cstar_s, devs, ho, wo,
                                  halo, method, fill))


def sharded_streamed_orthowarp(read_bands, shape_hwb, glt_flat_idx,
                               glt_valid, rows, cols, cstar, mesh: Mesh,
                               axis: str = "data", method: str = "cubic",
                               fill: float = NO_DATA_VALUE, halo: int = 32,
                               precision: str = "high",
                               transfer: str = "u16",
                               chunk_bands: int = 8,
                               depth: int = 2) -> torch.Tensor:
    """The streamed ingest fold under a mesh (``ops.py:336``): band
    chunks are read, quantized (``transfer``) and shipped by
    :func:`~hyperres_torch.io.ingest.stream_cube_fold` in payload mode
    to the axis's first device, and each chunk is dequantized there,
    placed on every shard's device, warped by the sharded two-pass
    shards of :func:`sharded_orthowarp_two_pass` and written into its
    band slice of the row-sharded accumulator, one (Hd / n, Wd, B) tensor
    per shard. Host reads and quantization overlap the device folds as
    on one device. Returns the (Hd, Wd, B) cube."""
    check_precision(precision)
    devs = mesh.axis_devices(axis)
    ho, wo = tuple(glt_flat_idx.shape)
    rows_np = _host(rows)
    _check_two_pass(ho, rows_np, len(devs), halo, method)
    hd, wd = rows_np.shape
    fields = _row_fields(glt_flat_idx, glt_valid, rows, cols, cstar, devs)
    accs = [torch.full((hd // len(devs), wd, shape_hwb[2]), float(fill),
                       dtype=torch.float32, device=d) for d in devs]

    def fold(accs, payload, b0: int):
        x = dequant_slab(payload, transfer, fill)
        parts = _two_pass_shards(replicate(x, devs), *fields, devs, ho, wo,
                                 halo, method, fill)
        for acc, p in zip(accs, parts):
            acc[..., b0:b0 + p.shape[-1]] = p
        return accs

    accs = stream_cube_fold(read_bands, shape_hwb, fold, accs,
                            transfer=transfer, chunk_bands=chunk_bands,
                            depth=depth, nodata=fill, device=devs[0],
                            payload_mode=True)
    return _join(accs)


# ---------------------------------------------------------------------------
# Data-parallel spectral-SR inference
# ---------------------------------------------------------------------------

def sharded_sr_predict_u16(model: RidgeSpectralSR, X, valid, mesh: Mesh,
                           axis: str = "data",
                           engine: str = "xla") -> torch.Tensor:
    """Row-sharded SR inference (``ops.py:387``): each shard runs the
    row-major serving form (:func:`~hyperres_torch.fusion.ridge_sr.
    sr_predict_u16`) on its pixels, with the model replicated to its
    device; no collectives. ``engine="pallas"``: one launch of the SR
    kernel (``csrc/sr_predict.cu``, row-major) per shard;
    ``"xla"``: the port's plain program; no fallback from one to the
    other. X (N, Bx) f32, valid (N,) bool; N must divide the axis.
    Returns (N, By) uint16 (65535 where not valid)."""
    model._require_fitted()
    devs = mesh.axis_devices(axis)
    n, n_dev = X.shape[0], len(devs)
    if n % n_dev:
        raise ValueError(f"N={n} must divide the '{axis}' axis "
                         f"({n_dev}) — pad the pixel rows first")
    models = {model.device: model}
    for d in devs:
        if d not in models:
            models[d] = copy.deepcopy(model).to(d)
    parts = [sr_predict_u16(x, v, models[d], engine)
             for x, v, d in zip(shard(_f32(X), devs),
                                shard(torch.as_tensor(valid), devs), devs)]
    return _join(parts)


# ---------------------------------------------------------------------------
# 2-axis mesh: row-sharded two-pass warp x band-sharded SRF synthesis
# ---------------------------------------------------------------------------

def sharded_orthowarp_srf_2d(raw, glt_flat_idx, glt_valid, rows, cols,
                             cstar, weights_bs, mesh: Mesh,
                             row_axis: str = "row",
                             band_axis: str = "band",
                             method: str = "cubic",
                             fill: float = NO_DATA_VALUE, halo: int = 32,
                             precision: str = "high") -> torch.Tensor:
    """GLT ortho-warp and SRF synthesis on a 2-D (row x band) mesh
    (``ops.py:450``): shard (i, j) warps scanline block i of band slice j
    by the shards of :func:`sharded_orthowarp_two_pass` (the halo
    exchange runs along ``row_axis``) and multiplies its block by band
    slice j of the (B, S) weights; a psum over ``band_axis`` assembles
    each row block of the (Hd, Wd, S) synthesis. B must divide the band
    axis; the spatial fields follow the two-pass op's checks on
    ``row_axis``. Fill pixels carry the product of the fill value, as
    the single-device synthesis of a fill-carrying cube."""
    check_precision(precision)
    n = mesh.shape[row_axis]
    nb = mesh.shape[band_axis]
    ho, wo = tuple(glt_flat_idx.shape)
    b_total = raw.shape[-1]
    _check_two_pass(ho, _host(rows), n, halo, method, row_axis=row_axis)
    if b_total % nb:
        raise ValueError(f"band count {b_total} must divide the "
                         f"'{band_axis}' axis {nb}")
    raw_t, w_t = _f32(raw), _f32(weights_bs)
    bl = b_total // nb
    # prods[j][i]: row block i of band slice j's product, on device (i, j)
    prods = []
    for j in range(nb):
        devs = mesh.axis_devices(row_axis, **{band_axis: j})
        blocks = _two_pass_shards(
            replicate(raw_t[..., j * bl:(j + 1) * bl], devs),
            *_row_fields(glt_flat_idx, glt_valid, rows, cols, cstar, devs),
            devs, ho, wo, halo, method, fill)
        wj = replicate(w_t[j * bl:(j + 1) * bl], devs)
        prods.append([torch.matmul(blk.reshape(-1, bl), w).reshape(
            blk.shape[0], blk.shape[1], -1) for blk, w in zip(blocks, wj)])
    return _join([psum([prods[j][i] for j in range(nb)],
                       mesh.axis_devices(band_axis, **{row_axis: i}))[0]
                  for i in range(n)])
