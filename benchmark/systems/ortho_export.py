"""System adapter: the EMIT granule ortho export of ``hyperres_torch``
(``ortho/pipeline.py`` ``orthorectify_cube``, the resident core that
``orthorectify_granule`` runs between its reads and its writes).

The configuration's file gives the sizes and the ``OrthoConfig``: set-up
makes the granule on the card (``harness/ortho_scene.py``: the raw cube,
LOC, OBS and the L2A mask's 8 bands), and through the program its
``OrthoGeometry`` and the quality mask of the configuration's flag bands;
request i is one ``orthorectify_cube`` of the resident granule with LOC,
OBS and the quality mask: the DATA, LOC and OBS warps and the four u16
products, all on the card. The products stay there and
are freed before the next request, except the compared ones: request
``k`` (drawn from the seed below ``sample_within``) and the window's
last.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness.compare import worst
from benchmark.harness.ortho_scene import ortho_scene
from benchmark.harness.runner import split
from benchmark.reference import granule as gref
from benchmark.reference import ortho as ref

SPANS = ("export",)


def _grid(g):
    from hyperres_torch.core.crs import CRS
    from hyperres_torch.core.grid import Grid

    crs = (CRS.geographic() if g.crs.kind == "geographic"
           else CRS.utm(g.crs.zone, g.crs.north))
    return Grid(crs, g.x0, g.y0, g.dx, g.dy, g.width, g.height)


def ortho_config(cfg: dict):
    """The program's ``OrthoConfig`` from the configuration's ``ortho``."""
    from hyperres_torch.core.config import OrthoConfig

    o = cfg["ortho"]
    return OrthoConfig(
        resampling=o["resampling"], warp_kernel=o["warp_kernel"],
        fused_orthowarp=o["fused_orthowarp"],
        reflectance_scale=tuple(o["reflectance_scale"]),
        lon_range=tuple(o["lon_range"]), lat_range=tuple(o["lat_range"]),
        elev_range=tuple(o["elev_range"]),
        obs_percentiles=tuple(o["obs_percentiles"]),
        obs_sample_stride=o["obs_sample_stride"],
        quality_bands=tuple(o["quality_bands"]),
        apply_band_mask=o["apply_band_mask"])


def program_products(p) -> dict:
    """The program's ``OrthoProducts`` as the comparison reads them."""
    dec = p.decode["obs"]
    lo = np.asarray(dec["offsets"])
    return {"data": p.data, "loc": p.loc, "obs": p.obs,
            "data_u16": p.data_u16, "diag_u16": p.diag_u16,
            "loc_u16": p.loc_u16, "obs_u16": p.obs_u16, "obs_lo": lo,
            "obs_hi": lo + np.asarray(dec["scales"]) * 65535.0}


class System:
    span_names = SPANS

    def __init__(self, config, traffic, seed, device, log, spans):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.dev, self.log, self.spans = device, log, spans
        rng = np.random.default_rng(self.seed)
        self.keep_ids = {int(rng.integers(1, traffic["sample_within"]))}
        self.kept = {}
        self.last = None
        self._want = None

    def setup(self) -> None:
        # first: a program without the resident core fails here, at once
        from hyperres_torch.ortho.pipeline import (
            OrthoGeometry, orthorectify_cube, quality_flags)

        raw_h, raw_w, nb = self.cfg["sizes"]["raw_hwb"]
        t = time.perf_counter()
        self.scene = ortho_scene(raw_h, raw_w, nb, self.seed, self.dev)
        self._sync()
        t = split(self.log, "scene", t)
        want = self.cfg["sizes"].get("utm_hw")
        if want is not None and list(self.scene["utm60"].shape) != want:
            raise ValueError(f"scene UTM grid {self.scene['utm60'].shape} "
                             f"is not the configuration's {want}")
        self.core = orthorectify_cube
        self.config = ortho_config(self.cfg)
        self.qmask = quality_flags(self.scene["mask"],
                                   self.config.quality_bands)
        self.geometry = OrthoGeometry.build(
            self.scene["glt"], (raw_h, raw_w),
            _grid(self.scene["ortho_grid"]), _grid(self.scene["utm60"]),
            self.dev)
        self._sync()
        t = split(self.log, "geometry", t)
        self.request(-1)
        self.last = None
        split(self.log, "warm-up", t)
        sc = self.scene
        self.log(f"granule: raw {tuple(sc['raw'].shape)}, LOC "
                 f"{tuple(sc['loc'].shape)}, OBS {tuple(sc['obs'].shape)}, "
                 f"mask {tuple(sc['mask'].shape)}; ortho "
                 f"{sc['ortho_grid'].shape}, UTM {sc['utm60'].shape}")

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def request(self, i: int) -> None:
        self.last = None
        sc = self.scene
        with self.spans.span("export", i, device_events=True):
            out = self.core(self.geometry, sc["raw"], loc=sc["loc"],
                            obs=sc["obs"], quality_mask=self.qmask,
                            config=self.config)
            self._sync()
        rec = {"i": i, "out": out}
        if i in self.keep_ids:
            self.kept[i] = rec
        self.last = rec

    def work_per_request(self) -> float:
        return 1.0

    def shapes(self) -> dict:
        sc = self.scene
        return {"raw_hwb": tuple(sc["raw"].shape),
                "loc_bands": sc["loc"].shape[-1],
                "obs_bands": sc["obs"].shape[-1],
                "ortho_hw": sc["ortho_grid"].shape,
                "utm_hw": sc["utm60"].shape}

    def release(self) -> None:
        if self.last is not None:
            self.kept[self.last["i"]] = self.last
        self.last = None
        self.geometry = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: bool = False) -> dict:
        """The plain reference's products of the granule; ``control``:
        one precision lower (TF32 in the warp's products)."""
        sc = self.scene
        if not hasattr(self, "_fields"):
            self._fields = gref.warp_fields(sc["glt"], sc["raw"].shape[:2],
                                            sc["ortho_grid"], sc["utm60"])
        with gref.precision(control):
            return ref.export(sc["raw"], sc["loc"], sc["obs"], sc["mask"],
                              self._fields, self.cfg["ortho"])

    def want(self) -> dict:
        if self._want is None:
            self._want = self.reference()
        return self._want

    def readings(self) -> dict:
        want = self.want()
        return worst(compare(program_products(self.kept.pop(i)["out"]),
                             want, self.cfg["ortho"], self.log)
                     for i in sorted(self.kept))

    def control_readings(self, i: int) -> dict:
        """The readings of the control: the reference in TF32, put in
        the program's place for request ``i`` (every request makes the
        same products)."""
        return compare(self.reference(control=True), self.want(),
                       self.cfg["ortho"])


def _cube_gaps(got: torch.Tensor, want: torch.Tensor, mass: torch.Tensor,
               span=None):
    """Over two UTM cubes: the largest |got - want| x min(1, |mass|)
    where both hold a value (over the band's range ``span`` where given),
    and the count of values present on one side only where the validity
    does not hang on the mass test."""
    gap, one_sided = 0.0, 0
    for s in range(0, want.shape[0], ref.ROWS):
        g = got[s:s + ref.ROWS].to(want.device, torch.float32)
        w = want[s:s + ref.ROWS]
        m = mass[s:s + ref.ROWS]
        vg, vw = ref.valid_of(g), ref.valid_of(w)
        one_sided += int(((vg != vw) & ref.mass_sure(m)[..., None]).sum())
        d = (g.double() - w.double()).abs() * ref.weight(m).double()[..., None]
        if span is not None:
            d = d / torch.clamp(span, min=1e-30)
        both = vg & vw
        if bool(both.any()):
            gap = max(gap, float(d[both].max()))
    return gap, one_sided


def _code_steps(got_q: torch.Tensor, want: dict, key: str, x: torch.Tensor,
                mass: torch.Tensor, lo, hi, spec, big, range_tol=0.0):
    """Over one u16 product: the largest code step where both are valid,
    the codes that differ, the codes valid on one side only, and the
    codes compared, over the codes the reference holds sure."""
    steps, _, _, nodata = spec
    wq = want[key]
    top, ndiff, nmask, n = 0, 0, 0, 0
    for s in range(0, wq.shape[0], ref.ROWS):
        a = got_q[s:s + ref.ROWS].to(wq.device).to(torch.int32)
        b = wq[s:s + ref.ROWS]
        sure = ref.sure(x[s:s + ref.ROWS], mass[s:s + ref.ROWS], lo, hi,
                        steps, big, range_tol)
        va, vb = a != nodata, b != nodata
        nmask += int(((va != vb) & sure).sum())
        d = (a - b).abs()
        both = va & vb & sure
        if bool(both.any()):
            top = max(top, int(d[both].max()))
        ndiff += int(((d != 0) & sure).sum())
        n += int(sure.sum())
    return top, ndiff, nmask, n


def compare(got: dict, want: dict, ortho: dict, log=None) -> dict:
    """Readings of one request's products against the reference's:

    - ``utm_gap``: the DATA cube's largest |difference| x min(1, |mass|);
    - ``aux_gap``: the same over LOC and OBS, over each band's range;
    - ``utm_mask``: values present on one side only, in the three cubes,
      where the validity does not hang on the mass test;
    - ``obs_range_gap``: the OBS ranges' largest |difference| x min(1,
      |mass|) of their samples, over the band's range;
    - ``u16_steps``, ``u16_diff_share``, ``u16_mask``: over the four u16
      products, the largest code step where both are valid, the share of
      codes that differ, and the codes valid on one side only, over the
      codes the reference holds sure (``reference.ortho.sure``); ``log``
      takes the share of each product's codes held sure."""
    dev = want["data"].device
    r = {}
    r["utm_gap"], mask_d = _cube_gaps(got["data"], want["data"],
                                      want["data_mass"])
    gap_l, mask_l = _cube_gaps(got["loc"], want["loc"], want["aux_mass"],
                               want["loc_span"])
    gap_o, mask_o = _cube_gaps(got["obs"], want["obs"], want["aux_mass"],
                               want["obs_span"])
    r["aux_gap"] = max(gap_l, gap_o)
    r["utm_mask"] = float(mask_d + mask_l + mask_o)
    lo_w, hi_w = want["obs_lo"], want["obs_hi"]
    span = hi_w - lo_w
    r["obs_range_gap"] = float(max(
        np.max(np.abs(np.asarray(got["obs_lo"]) - lo_w) * want["obs_w_lo"]
               / span),
        np.max(np.abs(np.asarray(got["obs_hi"]) - hi_w) * want["obs_w_hi"]
               / span)))
    lo, hi = (float(v) for v in ortho["reflectance_scale"])
    d = want["data"].shape[-1] // 2
    obs_lo = torch.as_tensor(lo_w, device=dev)
    obs_hi = torch.as_tensor(hi_w, device=dev)
    w_stat = torch.as_tensor(np.minimum(want["obs_w_lo"], want["obs_w_hi"]),
                             device=dev)
    range_tol = ref.TOL_ULPS * 2.0 ** -24 * (
        want["obs_big"] + torch.maximum(obs_lo.abs(), obs_hi.abs())) / w_stat
    parts = [
        _code_steps(got["data_u16"], want, "data_u16", want["data"],
                    want["data_mass"], lo, hi, ref.DATA_CODES,
                    want["data_big"]),
        _code_steps(got["diag_u16"], want, "diag_u16",
                    want["data"][..., d:d + 1], want["data_mass"], lo, hi,
                    ref.DATA_CODES, want["data_big"][d:d + 1]),
        _code_steps(got["loc_u16"], want, "loc_u16", want["loc"],
                    want["aux_mass"], want["loc_lo"], want["loc_hi"],
                    ref.AUX_CODES, want["loc_big"]),
        _code_steps(got["obs_u16"], want, "obs_u16", want["obs"],
                    want["aux_mass"], obs_lo, obs_hi, ref.AUX_CODES,
                    want["obs_big"], range_tol),
    ]
    if log is not None:
        sizes = [want[k].numel() for k in ("data_u16", "diag_u16",
                                           "loc_u16", "obs_u16")]
        log("sure codes: " + ", ".join(
            f"{k} {p[3] / n!r}" for k, p, n in zip(
                ("data", "diag", "loc", "obs"), parts, sizes)))
    r["u16_steps"] = float(max(p[0] for p in parts))
    r["u16_diff_share"] = sum(p[1] for p in parts) / max(
        1, sum(p[3] for p in parts))
    r["u16_mask"] = float(sum(p[2] for p in parts))
    return r
