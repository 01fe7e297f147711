"""The fused granule plans (``hyperres/fusion/fused.py:73-671``).

- :class:`FusedFusionPlan` — the four fusion phases over an EMIT cube
  already on the 60 m grid: SRF synthesis of B2/B3/B4, the 10 m S2 RGB
  box-averaged onto the 60 m grid, the shared 2-98 % stretch, an OT
  (Sinkhorn) + degree-4 polynomial fit per channel, and the bilinear
  60 m -> 10 m upsample with the fit applied.
- :class:`FusedOrthoFusionPlan` — the full raw -> fused granule path:
  GLT gather + two-pass cubic scanline warp onto the S2-anchored UTM
  grid (the hand-written kernel, by its banded route or, with
  ``warp_kernel="pallas"``, its dense route), then the fusion phases.

A plan holds buffers, not parameters: its state is the host precompute
(GLT indices, warp index fields, SRF weights, grid-transfer specs),
built once per grid pair and moved to ``device``. PyTorch runs eagerly,
so there is no compiled program; ``state_dict_numpy``/``from_state``
carry the state across (for instance from the reference's plan).

Ported: ``fusion_method="ot_poly"`` (the bench default) and
``"ot_affine"`` with the ``"srf"`` synthesis. ``linear``, ``histogram``,
the box synthesis and the tap-loop warp raise :class:`FusedUnsupported`
for now.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.config import OTConfig, PolyFusionConfig
from ..core.constants import NO_DATA_VALUE
from ..core.grid import Grid

from ..device import resolve_device
from ..kernels.host import (
    build_srf_weight_matrix, prepare_glt, scanline_cstar,
    separable_fast_spec, separable_index_axes, separable_weight_matrix,
    source_index_field,
)
from ..kernels.lstsq import affine_fit, polyfit, polyval_channels
from ..kernels.sinkhorn import ot_barycentric_targets
from ..kernels.srf import srf_synthesize
from ..kernels.stats import shared_percentile_stretch
from ..kernels.warp import (
    WARP_BACKENDS, orthowarp_two_pass, separable_resample_fast,
    separable_resample_matmul,
)
from ..spectral.srf_tables import builtin_srf
from .sampling import sample_valid_pixels_device

FUSED_METHODS = ("ot_poly", "ot_affine")
DeviceLike = Union[str, torch.device, None]


class FusedUnsupported(ValueError):
    """The port cannot express the requested configuration (yet)."""


@dataclass(frozen=True)
class FusionStatics:
    """Static configuration of the fusion phases."""

    fusion_method: str
    degree: int
    min_pixels: int
    ot: OTConfig
    pmin: float
    pmax: float
    emit_nodata: float
    s2_nodata: Optional[float]
    return_intermediates: bool
    # integer-aligned grid-transfer specs (separable_fast_spec):
    # (row_spec, col_spec), or None -> dense weight matrices
    down_fast: Optional[tuple] = None
    up_fast: Optional[tuple] = None


@dataclass(frozen=True)
class WarpStatics:
    """Static configuration of the orthowarp stage (the two-pass
    scanline warp; the tap loop is not ported yet). ``backend`` is
    ``orthowarp_two_pass``'s, as in the reference's ``WarpStatics``:
    ``"pallas"`` for the dense route, any other for the banded one."""

    resampling: str = "cubic"    # "cubic" | "bilinear"
    backend: str = "auto"        # "auto" | "xla" | "pallas" | "pallas_banded"


def _as_f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def _phase2_s2_60(st: FusionStatics, s2rgb10_hwb, Wr60, Wc60):
    """Phase 2: the real 10 m S2 box-averaged onto the EMIT grid —
    shared by the fusion core and the audit target so both see the same
    values."""
    if st.down_fast is not None:
        return separable_resample_fast(s2rgb10_hwb, *st.down_fast,
                                       nodata=st.s2_nodata, fill=np.nan)
    return separable_resample_matmul(s2rgb10_hwb, Wr60, Wc60,
                                     nodata=st.s2_nodata, fill=np.nan)


def _upsample_10m(st: FusionStatics, x60, valid60, Wr10, Wc10):
    """Phase 4 transfer: valid60-renormalised bilinear 60 m -> 10 m."""
    if st.up_fast is not None:
        return separable_resample_fast(x60, *st.up_fast, fill=np.nan,
                                       valid_mask=valid60)
    return separable_resample_matmul(x60, Wr10, Wc10, fill=np.nan,
                                     valid_mask=valid60)


def _synth_and_valid(st: FusionStatics, cube_hwb, s2rgb10_hwb, Wsrf, Wr60,
                     Wc60):
    """Phases 1-2 and the 60 m validity both programs share."""
    synth = srf_synthesize(cube_hwb, Wsrf)
    valid60 = (torch.isfinite(synth).all(dim=-1)
               & (synth[..., 0] > 0)
               & (cube_hwb[..., 0] != st.emit_nodata))
    s2_60 = _phase2_s2_60(st, s2rgb10_hwb, Wr60, Wc60)
    valid60 = valid60 & torch.isfinite(s2_60).all(dim=-1)
    return synth, s2_60, valid60


def _ot_samples(st: FusionStatics, emit_n, s2_n, valid60,
                generator: torch.Generator):
    """The OT stage's samples of the stretched 60 m pixels and their 0/1
    slot weights: (Xs, wxs, Ys, wys)."""
    zero = torch.zeros((), device=emit_n.device)
    Xs, wxs = sample_valid_pixels_device(emit_n, valid60, st.ot.n_samples,
                                         generator=generator)
    Ys, wys = sample_valid_pixels_device(s2_n, valid60, st.ot.n_samples,
                                         generator=generator)
    # zero the padded (weight-0) slots: with fewer valid pixels than
    # samples they come from invalid pixels and may be NaN, which would
    # poison the weighted fits (NaN * 0 = NaN)
    Xs = torch.where(wxs[:, None] > 0, Xs, zero)
    Ys = torch.where(wys[:, None] > 0, Ys, zero)
    return Xs, wxs, Ys, wys


def _stretch(st: FusionStatics, synth, s2_60, valid60):
    """Phase 3's shared stretch, display order B4, B3, B2."""
    return (shared_percentile_stretch(synth.flip(-1), valid60, st.pmin,
                                      st.pmax),
            shared_percentile_stretch(s2_60.flip(-1), valid60, st.pmin,
                                      st.pmax))


def apply_params(fusion_method: str, params: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """A fitted mapping applied to (..., C): the per-channel polynomial
    of ``ot_poly`` (params (C, deg+1)) or the channel-mixing affine map
    ``x @ A + t`` of ``ot_affine`` (params (C+1, C), t in the last
    row)."""
    if fusion_method == "ot_affine":
        return x @ params[:-1] + params[-1]
    return polyval_channels(params, x)


def _fit_params(st: FusionStatics, Xs, wxs, Ybar, n_valid):
    """The fit on the OT targets, with the reference's fallbacks:
    ``ot_poly`` per-channel degree-``st.degree`` polynomials, identity
    under ``min_pixels`` (poly_regression.py:38-41); ``ot_affine`` the
    weighted affine map (``fused.py:193-200``), identity under 2 valid
    pixels (the where discards the fit, finite or not)."""
    c = Xs.shape[1]
    dev = Xs.device
    if st.fusion_method == "ot_affine":
        zero = torch.zeros((), device=dev)
        A, t = affine_fit(Xs, torch.where(wxs[:, None] > 0, Ybar, zero),
                          wxs)
        ok = n_valid >= 2
        A = torch.where(ok, A, torch.eye(c, dtype=A.dtype, device=dev))
        t = torch.where(ok, t, torch.zeros_like(t))
        return torch.cat([A, t[None, :]], dim=0)
    fit = torch.stack([polyfit(Xs[:, ch], Ybar[:, ch], st.degree, w=wxs)
                       for ch in range(c)])
    ident = torch.zeros((c, st.degree + 1), dtype=torch.float32, device=dev)
    ident[:, -2] = 1.0
    return torch.where(n_valid >= st.min_pixels, fit, ident)


def _fusion_core(st: FusionStatics, cube_hwb, s2rgb10_hwb, Wsrf, Wr60,
                 Wc60, Wr10, Wc10, generator: torch.Generator) -> Dict:
    """The four fusion phases (``fused.py:145``), ``ot_poly`` and
    ``ot_affine`` methods."""
    synth, s2_60, valid60 = _synth_and_valid(st, cube_hwb, s2rgb10_hwb,
                                             Wsrf, Wr60, Wc60)
    n_valid = valid60.sum()
    # Phase 3: shared stretch + OT fit
    emit_n, s2_n = _stretch(st, synth, s2_60, valid60)
    Xs, wxs, Ys, wys = _ot_samples(st, emit_n, s2_n, valid60, generator)
    Ybar = ot_barycentric_targets(
        Xs, Ys, reg=st.ot.reg, num_itermax=st.ot.num_itermax,
        stop_thr=st.ot.stop_thr, wx=wxs, wy=wys,
        debias=st.ot.debias)
    params = _fit_params(st, Xs, wxs, Ybar, n_valid)

    matched60 = torch.clamp(
        torch.where(valid60[..., None],
                    apply_params(st.fusion_method, params, emit_n), emit_n),
        0.0, 1.0)
    # Phase 4: bilinear upsample of the stretched sim bands to 10 m and
    # the same mapping there; invalid 60 m sources contribute nothing,
    # zero valid mass -> NaN -> masked
    sim10 = _upsample_10m(st, emit_n, valid60, Wr10, Wc10)
    mask10 = torch.isfinite(sim10).all(dim=-1)
    mapped10 = torch.clamp(apply_params(st.fusion_method, params,
                                        torch.nan_to_num(sim10)), 0.0, 1.0)
    fused = torch.where(mask10[..., None], mapped10,
                        torch.tensor(float("nan"), device=sim10.device))
    out = {"fused_10m": fused, "matched_60m": matched60,
           "coeffs": params, "n_valid_60m": n_valid}
    if st.return_intermediates:
        out["synth_60m"] = synth
        out["s2_60m"] = s2_60
    return out


def _audit_target_program(st: FusionStatics, cube_hwb, s2rgb10_hwb, Wsrf,
                          Wr60, Wc60, Wr10, Wc10) -> torch.Tensor:
    """Method-ideal 10 m product from the real S2 alone
    (``fused.py:292``): the same phase-2 downsample, the same shared
    stretch over the same valid60 mask, and the same phase-4 upsample.
    ``cube_hwb`` is the (warped) EMIT cube the plan consumed."""
    _, s2_60, valid60 = _synth_and_valid(st, cube_hwb, s2rgb10_hwb, Wsrf,
                                         Wr60, Wc60)
    s2_n = shared_percentile_stretch(s2_60.flip(-1), valid60, st.pmin,
                                     st.pmax)
    return _upsample_10m(st, s2_n, valid60, Wr10, Wc10)


def _fusion_matrices(
    emit_grid: Grid,
    s2_grid: Grid,
    wavelengths: np.ndarray,
    good_mask: Optional[np.ndarray],
    platform: str,
    synth_method: str,
    bands: Sequence[str] = ("B2", "B3", "B4"),
    srf=None,
) -> Dict[str, object]:
    """Host precompute of the fusion phases (``fused.py:341``): the SRF
    weight matrix and the 60 m <-> 10 m transfer specs (dense weight
    matrices only where a grid pair has no integer-aligned spec).
    ``srf`` is an explicit ``{band: (nm, resp)}`` table; without one the
    parametric model is used."""
    if synth_method != "srf":
        raise FusedUnsupported(f"synth_method {synth_method!r} is not "
                               "ported yet (only 'srf')")
    if srf is None:
        warnings.warn(
            "fusion: using the built-in PARAMETRIC Sentinel-2 "
            f"{platform} SRF model, not measured curves (pass srf= to "
            "use measured tables)", UserWarning, stacklevel=3)
        srf = builtin_srf(platform, bands=list(bands))
    Wsrf, _, _ = build_srf_weight_matrix(wavelengths, srf, good_mask)

    sep_down = separable_index_axes(s2_grid, emit_grid)   # s2 -> emit 60 m
    sep_up = separable_index_axes(emit_grid, s2_grid)     # emit -> s2 10 m
    if sep_down is None or sep_up is None:
        raise FusedUnsupported(
            "fused path needs same-CRS axis-aligned grids "
            f"(emit crs {emit_grid.crs}, s2 crs {s2_grid.crs})")

    # f64 index axes for fast-spec detection (the f32 axes carry ~1e-3
    # px rounding at 10 m grid sizes, enough to blur the phase pattern)
    def _axes64(src, dst):
        xs, ys = dst.pixel_center_coords()
        cols, _ = src.colrow_of(xs, src.y0)
        _, rows = src.colrow_of(src.x0, ys)
        return np.asarray(rows, np.float64), np.asarray(cols, np.float64)

    d64 = _axes64(s2_grid, emit_grid)
    u64 = _axes64(emit_grid, s2_grid)
    down = (separable_fast_spec(d64[0], s2_grid.height, "average",
                                scale=emit_grid.dy / s2_grid.dy),
            separable_fast_spec(d64[1], s2_grid.width, "average",
                                scale=emit_grid.dx / s2_grid.dx))
    up = (separable_fast_spec(u64[0], emit_grid.height, "bilinear"),
          separable_fast_spec(u64[1], emit_grid.width, "bilinear"))
    state: Dict[str, object] = {
        "Wsrf": np.asarray(Wsrf, np.float32),
        "down_fast": down if None not in down else None,
        "up_fast": up if None not in up else None,
    }
    if state["down_fast"] is None:
        state["Wr60"] = separable_weight_matrix(
            sep_down[0], s2_grid.height, "average",
            scale=emit_grid.dy / s2_grid.dy)
        state["Wc60"] = separable_weight_matrix(
            sep_down[1], s2_grid.width, "average",
            scale=emit_grid.dx / s2_grid.dx)
    if state["up_fast"] is None:
        state["Wr10"] = separable_weight_matrix(sep_up[0], emit_grid.height,
                                                "bilinear")
        state["Wc10"] = separable_weight_matrix(sep_up[1], emit_grid.width,
                                                "bilinear")
    return state


_FUSION_ARRAYS = ("Wsrf", "Wr60", "Wc60", "Wr10", "Wc10")


class FusedFusionPlan:
    """Phases 1-4 of the fusion over an EMIT cube on the 60 m grid.

    Build once per (grid pair, wavelength grid, config); call per scene
    with the (H60, W60, B) cube and the prepared (H10, W10, 3) S2 RGB.
    """

    def __init__(
        self,
        emit_grid: Grid,
        s2_grid: Grid,
        wavelengths: np.ndarray,
        good_mask: Optional[np.ndarray] = None,
        *,
        platform: str = "S2A",
        synth_method: str = "srf",
        fusion_method: str = "ot_poly",
        config: PolyFusionConfig = PolyFusionConfig(),
        s2_nodata: Optional[float] = None,
        s2_scale: Optional[float] = None,
        return_intermediates: bool = False,
        srf=None,
        device: DeviceLike = None,
    ):
        state = _fusion_matrices(emit_grid, s2_grid,
                                 np.asarray(wavelengths), good_mask,
                                 platform, synth_method, srf=srf)
        nod = s2_nodata
        if nod is not None and s2_scale is not None:
            nod = float(nod) * float(s2_scale)
        statics = FusionStatics(
            fusion_method=fusion_method, degree=config.degree,
            min_pixels=config.min_pixels, ot=config.ot,
            pmin=float(config.stretch_percentiles[0]),
            pmax=float(config.stretch_percentiles[1]),
            emit_nodata=NO_DATA_VALUE,
            s2_nodata=None if nod is None else float(nod),
            return_intermediates=return_intermediates)
        self._load(state, statics, resolve_device(device), s2_scale)

    @classmethod
    def from_state(cls, state: Dict, statics: FusionStatics,
                   device: DeviceLike = None,
                   s2_scale: Optional[float] = None) -> "FusedFusionPlan":
        """A plan from a :meth:`state_dict_numpy` dictionary; the
        state's ``down_fast``/``up_fast`` replace those of ``statics``."""
        plan = cls.__new__(cls)
        plan._load(state, statics, resolve_device(device), s2_scale)
        return plan

    def _load(self, state: Dict, statics: FusionStatics,
              device: torch.device, s2_scale: Optional[float]) -> None:
        if statics.fusion_method not in FUSED_METHODS:
            raise FusedUnsupported(
                f"fusion_method {statics.fusion_method!r} is not ported "
                f"yet (ported: {FUSED_METHODS})")
        self.device = device
        self.s2_scale = s2_scale
        self.statics = dataclasses.replace(
            statics, down_fast=state.get("down_fast"),
            up_fast=state.get("up_fast"))
        for k in _FUSION_ARRAYS:
            v = state.get(k)
            setattr(self, "_" + k, None if v is None else
                    torch.from_numpy(np.asarray(v, np.float32)).to(device))

    def state_dict_numpy(self) -> Dict[str, object]:
        state = {k: getattr(self, "_" + k).cpu().numpy()
                 for k in _FUSION_ARRAYS if getattr(self, "_" + k)
                 is not None}
        state["down_fast"] = self.statics.down_fast
        state["up_fast"] = self.statics.up_fast
        return state

    def generator(self, seed: Optional[int] = None) -> torch.Generator:
        """A generator on the plan's device, seeded with ``seed`` or the
        config's ``ot.seed``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.statics.ot.seed if seed is None else seed)
        return g

    def prepare_s2(self, s2_stack_bhw,
                   rgb_band_idx: Tuple[int, int, int] = (0, 1, 2)
                   ) -> torch.Tensor:
        """(B, H10, W10) stack -> scaled (H10, W10, 3) B2, B3, B4 input
        on the plan's device."""
        rgb = torch.stack([_as_f32(s2_stack_bhw[i], self.device)
                           for i in rgb_band_idx], dim=-1)
        if self.s2_scale is not None:
            rgb = rgb * float(np.float32(self.s2_scale))
        return rgb

    def _matrices(self):
        return (self._Wsrf, self._Wr60, self._Wc60, self._Wr10,
                self._Wc10)

    def __call__(self, emit_cube_hwb, s2_rgb10_hwb,
                 generator: Optional[torch.Generator] = None) -> Dict:
        if generator is None:
            generator = self.generator()
        return _fusion_core(self.statics,
                            _as_f32(emit_cube_hwb, self.device),
                            _as_f32(s2_rgb10_hwb, self.device),
                            *self._matrices(), generator)

    def ot_samples(self, emit_cube_hwb, s2_rgb10_hwb,
                   generator: Optional[torch.Generator] = None):
        """The samples a call with the same inputs and ``generator``
        hands to the OT stage: (Xs, wxs, Ys, wys), the stretched 60 m
        EMIT and S2 pixels (B4, B3, B2) and their 0/1 slot weights."""
        if generator is None:
            generator = self.generator()
        st = self.statics
        synth, s2_60, valid60 = _synth_and_valid(
            st, _as_f32(emit_cube_hwb, self.device),
            _as_f32(s2_rgb10_hwb, self.device), self._Wsrf, self._Wr60,
            self._Wc60)
        emit_n, s2_n = _stretch(st, synth, s2_60, valid60)
        return _ot_samples(st, emit_n, s2_n, valid60, generator)

    def s2_reference_10m(self, emit_cube_hwb, s2_rgb10_hwb) -> torch.Tensor:
        """Accuracy-audit target (see :func:`_audit_target_program`):
        pass the same (warped) EMIT cube and 10 m S2 the plan consumed."""
        return _audit_target_program(self.statics,
                                     _as_f32(emit_cube_hwb, self.device),
                                     _as_f32(s2_rgb10_hwb, self.device),
                                     *self._matrices())


class FusedOrthoFusionPlan:
    """The full granule path: GLT gather + two-pass scanline warp onto
    the S2-anchored UTM grid + the four fusion phases (``fused.py:519``).
    ``__call__(raw, s2_rgb10)`` returns the 285-band UTM cube
    (``"utm_cube"``) and the fused 10 m RGB (``"fused_10m"``), with the
    fit's ``"coeffs"``, ``"matched_60m"`` and ``"n_valid_60m"``."""

    def __init__(
        self,
        ortho_grid: Grid,
        utm_grid: Grid,
        s2_grid: Grid,
        raw_shape_yx: Tuple[int, int],
        glt: np.ndarray,
        wavelengths: np.ndarray,
        good_mask: Optional[np.ndarray] = None,
        *,
        platform: str = "S2A",
        synth_method: str = "srf",
        fusion_method: str = "ot_poly",
        config: PolyFusionConfig = PolyFusionConfig(),
        s2_nodata: Optional[float] = None,
        s2_scale: Optional[float] = None,
        warp_kernel: str = "auto",
        resampling: str = "cubic",
        return_intermediates: bool = False,
        srf=None,
        device: DeviceLike = None,
    ):
        if warp_kernel == "taploop":
            raise FusedUnsupported("warp_kernel 'taploop' is not ported "
                                   "yet; use 'two_pass'")
        # "pallas": the dense scanline route; "pallas_banded", "auto" and
        # "two_pass": the banded one. The kernel needs no window, so the
        # reference's banded feasibility check has no counterpart here.
        backends = {"auto": "auto", "two_pass": "auto", "pallas": "pallas",
                    "pallas_banded": "pallas_banded"}
        if warp_kernel not in backends:
            raise ValueError(f"unknown warp_kernel {warp_kernel!r}")
        dev = resolve_device(device)
        self._fusion = FusedFusionPlan(
            utm_grid, s2_grid, wavelengths, good_mask, platform=platform,
            synth_method=synth_method, fusion_method=fusion_method,
            config=config, s2_nodata=s2_nodata, s2_scale=s2_scale,
            return_intermediates=return_intermediates, srf=srf, device=dev)
        flat_idx, valid = prepare_glt(np.asarray(glt), raw_shape_yx)
        wr, wc = source_index_field(ortho_grid, utm_grid)
        cstar = scanline_cstar(wr, wc, ortho_grid.height)
        self._load_warp({"flat_idx": flat_idx, "valid": valid, "wr": wr,
                         "wc": wc, "cstar": cstar},
                        WarpStatics(resampling, backends[warp_kernel]), dev)

    @classmethod
    def from_state(cls, state: Dict, statics: FusionStatics,
                   device: DeviceLike = None, *,
                   warp_statics: WarpStatics = WarpStatics(),
                   s2_scale: Optional[float] = None
                   ) -> "FusedOrthoFusionPlan":
        """A plan from a :meth:`state_dict_numpy` dictionary: the warp
        arrays ``flat_idx``, ``valid``, ``wr``, ``wc``, ``cstar`` and the
        fusion state (``Wsrf``, ``down_fast``, ``up_fast``, and dense
        transfer matrices where a spec is None). ``warp_statics`` takes
        the reference plan's ``resampling`` and ``backend``."""
        plan = cls.__new__(cls)
        dev = resolve_device(device)
        plan._fusion = FusedFusionPlan.from_state(state, statics, dev,
                                                  s2_scale=s2_scale)
        plan._load_warp(state, warp_statics, dev)
        return plan

    def _load_warp(self, state: Dict, warp_statics: WarpStatics,
                   device: torch.device) -> None:
        if warp_statics.backend not in WARP_BACKENDS:
            raise ValueError(f"unknown warp backend "
                             f"{warp_statics.backend!r}")
        self.device = device
        self.warp_statics = warp_statics
        self._flat_idx = torch.from_numpy(
            np.asarray(state["flat_idx"], np.int64)).to(device)
        self._valid = torch.from_numpy(
            np.asarray(state["valid"], bool)).to(device)
        for k in ("wr", "wc", "cstar"):
            setattr(self, "_" + k, torch.from_numpy(
                np.asarray(state[k], np.float32)).to(device))

    def state_dict_numpy(self) -> Dict[str, object]:
        state = self._fusion.state_dict_numpy()
        state["flat_idx"] = self._flat_idx.cpu().numpy().astype(np.int32)
        for k in ("valid", "wr", "wc", "cstar"):
            state[k] = getattr(self, "_" + k).cpu().numpy()
        return state

    @property
    def statics(self) -> FusionStatics:
        return self._fusion.statics

    def generator(self, seed: Optional[int] = None) -> torch.Generator:
        return self._fusion.generator(seed)

    def prepare_s2(self, s2_stack_bhw,
                   rgb_band_idx: Tuple[int, int, int] = (0, 1, 2)
                   ) -> torch.Tensor:
        return self._fusion.prepare_s2(s2_stack_bhw, rgb_band_idx)

    def warp(self, raw_hwb) -> torch.Tensor:
        """The UTM cube alone: GLT gather + two-pass scanline warp."""
        return orthowarp_two_pass(
            _as_f32(raw_hwb, self.device), self._flat_idx, self._valid,
            self._wr, self._wc, self._cstar,
            method=self.warp_statics.resampling, fill=NO_DATA_VALUE,
            backend=self.warp_statics.backend)

    def ot_samples(self, utm_cube_hwb, s2_rgb10_hwb,
                   generator: Optional[torch.Generator] = None):
        """:meth:`FusedFusionPlan.ot_samples` from a call's
        ``out["utm_cube"]``."""
        return self._fusion.ot_samples(utm_cube_hwb, s2_rgb10_hwb, generator)

    def s2_reference_10m(self, utm_cube_hwb, s2_rgb10_hwb) -> torch.Tensor:
        """Audit target from a call's ``out["utm_cube"]`` and the same
        prepared 10 m S2 input."""
        return self._fusion.s2_reference_10m(utm_cube_hwb, s2_rgb10_hwb)

    def __call__(self, raw_hwb, s2_rgb10_hwb,
                 generator: Optional[torch.Generator] = None) -> Dict:
        utm_cube = self.warp(raw_hwb)
        out = self._fusion(utm_cube, s2_rgb10_hwb, generator=generator)
        out["utm_cube"] = utm_cube
        return out
