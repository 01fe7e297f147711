"""System adapter: S2-to-EMIT local coregistration of ``hyperres_torch``
(``coreg/granule.py`` ``coregister_stack``, the resident core that
``coregister_s2_to_emit`` runs between its file reads and its write).

The configuration's file gives the sizes and the ``CoregConfig``; the
traffic mix's file the number of targets: set-up makes the EMIT band
nearest 842 nm and ``targets`` displaced 10-band u16 S2 stacks on the
card (``harness/coreg_scene.py``), and request i coregisters stack
i mod ``targets`` to the EMIT band: the resample, the window matches,
the filters and the cubic deshift to u16. The product stays on the card
and is freed before the next request, except the compared ones: request
``k`` (drawn from the seed below ``sample_within``) and the window's
last. A request whose coregistration fails raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness.compare import worst
from benchmark.harness.coreg_scene import EMIT_NODATA, S2_NODATA, coreg_scene
from benchmark.harness.runner import split
from benchmark.reference import coreg as ref

SPANS = ("coregister",)


def _grid(g):
    from hyperres_torch.core.crs import CRS
    from hyperres_torch.core.grid import Grid

    return Grid(CRS.utm(g.crs.zone, g.crs.north), g.x0, g.y0, g.dx, g.dy,
                g.width, g.height)


def coreg_config(cfg: dict):
    """The program's ``CoregConfig`` from the configuration's ``coreg``."""
    from hyperres_torch.core.config import CoregConfig

    c = cfg["coreg"]
    return CoregConfig(
        window_size=tuple(c["window_size"]), grid_res=c["grid_res"],
        max_points=c["max_points"], max_shift=c["max_shift"],
        min_reliability=c["min_reliability"],
        tie_point_filter_level=c["tie_point_filter_level"],
        ransac_thresh_px=c["ransac_thresh_px"],
        prefer_bands=tuple(c["prefer_bands"]),
        band_target_nm=tuple((k, v) for k, v in c["band_target_nm"]),
        out_gsd=tuple(c["out_gsd"]), resamp_calc=c["resamp_calc"],
        resamp_deshift=c["resamp_deshift"])


class System:
    span_names = SPANS

    def __init__(self, config, traffic, seed, device, log, spans):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.dev, self.log, self.spans = device, log, spans
        rng = np.random.default_rng(self.seed)
        self.keep_ids = {int(rng.integers(1, traffic["sample_within"]))}
        self.kept = {}
        self.last = None

    def setup(self) -> None:
        # first: a program without the resident core fails here, at once
        from hyperres_torch.coreg.granule import (
            coregister_stack, s2_bandmap_from_descriptions)

        s = self.cfg["sizes"]
        t = time.perf_counter()
        self.scene = coreg_scene(s["swath_raw_hw"], self.traffic["targets"],
                                 self.seed, self.dev, bands=s["bands"])
        self._sync()
        t = split(self.log, "scene", t)
        for key, grid in (("utm_hw", "utm60"), ("s2_hw", "s2_grid")):
            if list(self.scene[grid].shape) != s[key]:
                raise ValueError(f"scene {grid} {self.scene[grid].shape} "
                                 f"is not the configuration's {s[key]}")
        self.core = coregister_stack
        self.config = coreg_config(self.cfg)
        self.bandmap = s2_bandmap_from_descriptions(self.scene["descriptions"])
        self.grids = (_grid(self.scene["utm60"]), _grid(self.scene["s2_grid"]))
        self.request(-1)
        self.last = None
        split(self.log, "warm-up", t)
        sc = self.scene
        self.log(f"EMIT band {sc['emit_wl']:.2f} nm {tuple(sc['emit'].shape)}"
                 f", {len(sc['stacks'])} S2 stacks "
                 f"{tuple(sc['stacks'][0].shape)} u16")

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def request(self, i: int) -> None:
        self.last = None
        t = i % len(self.scene["stacks"])
        with self.spans.span("coregister", i, device_events=True):
            out = self.core(
                {"B08": self.scene["emit"]}, self.grids[0],
                self.scene["stacks"][t], self.grids[1], self.config,
                s2_bandmap=self.bandmap, nodata_emit=EMIT_NODATA,
                nodata_s2=float(self.cfg["sizes"]["s2_nodata"]),
                device=self.dev)
            self._sync()
        if not out["final"]["success"]:
            raise RuntimeError(f"coregistration failed: {out['attempts']}")
        rec = {"i": i, "t": t, "q": out["shifted"], "result": out["result"]}
        if i in self.keep_ids:
            self.kept[i] = rec
        self.last = rec

    def work_per_request(self) -> float:
        return 1.0

    def shapes(self) -> dict:
        s, c = self.cfg["sizes"], self.cfg["coreg"]
        h, w = s["s2_hw"]
        wx, wy = c["window_size"]
        return {"s2_hw": (h, w), "utm_hw": tuple(s["utm_hw"]),
                "bands": s["bands"], "window_hw": (wy, wx),
                "windows": len(ref.tie_point_grid(h, w, c["grid_res"], wy,
                                                  wx, c["max_points"]))}

    def release(self) -> None:
        if self.last is not None:
            self.kept[self.last["i"]] = self.last
        self.last = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, t: int, control: bool = False) -> dict:
        """The plain reference's attempt on target ``t`` with the B08
        band; ``control``: one precision lower."""
        s = self.cfg["sizes"]
        return ref.coregister(
            self.scene["emit"], self.scene["utm60"], self.scene["stacks"][t],
            self.scene["s2_grid"], self.cfg["coreg"], self.bandmap["B08"] - 1,
            EMIT_NODATA, float(s["s2_nodata"]), control=control)

    def readings(self) -> dict:
        return worst(self._compare(self.kept.pop(i))
                     for i in sorted(self.kept))

    def _compare(self, rec: dict) -> dict:
        return compare(program_points(rec["result"]), rec["result"].affine,
                       rec["q"], self.reference(rec["t"]),
                       self.scene["s2_grid"].shape)

    def control_readings(self, i: int) -> dict:
        """The readings of the control: the reference one precision lower
        (TF32 in the resample, bfloat16 windows), put in the program's
        place for request ``i``."""
        t = i % len(self.scene["stacks"])
        c = self.reference(t, control=True)
        got = {(p["row"], p["col"]): p for p in c["points"] if p["kept"]}
        return compare(got, c["affine"], c["codes"], self.reference(t),
                       self.scene["s2_grid"].shape)


def program_points(result) -> dict:
    """The program's kept tie points by (row, col)."""
    return {(t.row, t.col): {"dy": t.dy, "dx": t.dx, "rel": t.reliability,
                             "used": t.used} for t in result.tie_points}


def compare(got: dict, affine, q: torch.Tensor, want: dict, hw) -> dict:
    """Readings of one request against the reference's attempt:

    - ``tiepoints_diff``: candidate points kept on one side only, plus
      points kept by both but used by one only;
    - ``shift_gap``, ``reliability_gap``: the largest |difference| of
      (dy, dx) in px and of the reliability over the points both keep;
    - ``affine_gap``: the largest |difference| of the two affine fields
      over the footprint's corners, px;
    - ``u16_steps``, ``u16_diff_share``, ``u16_mask``: the largest code
      difference where both are valid, the share of codes that differ,
      and the codes valid on one side only, over the codes the
      reference holds sure (``reference.coreg.deshift_u16``)."""
    ref_pts = {(p["row"], p["col"]): p for p in want["points"] if p["kept"]}
    both = got.keys() & ref_pts.keys()
    r = {"tiepoints_diff": float(len(got.keys() ^ ref_pts.keys())
                                 + sum(got[k]["used"] != ref_pts[k]["used"]
                                       for k in both))}
    r["shift_gap"] = max((max(abs(got[k]["dy"] - ref_pts[k]["dy"]),
                              abs(got[k]["dx"] - ref_pts[k]["dx"]))
                          for k in both), default=0.0)
    r["reliability_gap"] = max((abs(got[k]["rel"] - ref_pts[k]["rel"])
                                for k in both), default=0.0)
    if affine is None or want["affine"] is None:
        # one side found no shift model: nothing to compare it by
        return dict(r, affine_gap=float("inf"), u16_steps=float("inf"),
                    u16_diff_share=1.0, u16_mask=float("inf"))
    h, w = hw
    corners = np.array([[0, 0, 1], [0, w - 1, 1], [h - 1, 0, 1],
                        [h - 1, w - 1, 1]], dtype=np.float64)
    A, B = np.asarray(affine), np.asarray(want["affine"])
    r["affine_gap"] = float(np.abs(corners @ (A - B).T).max())
    steps, ndiff, nmask, n = 0.0, 0, 0, 0
    for k in range(q.shape[0]):
        a = q[k].to(torch.int32)
        b = want["codes"][k].to(torch.int32)
        sure = want["sure"][k]
        va, vb = a != S2_NODATA, b != S2_NODATA
        nmask += int(((va != vb) & sure).sum())
        both_ok = va & vb & sure
        d = (a - b).abs()
        if bool(both_ok.any()):
            steps = max(steps, float(d[both_ok].max()))
        ndiff += int(((d != 0) & sure).sum())
        n += int(sure.sum())
    r.update(u16_steps=steps, u16_diff_share=ndiff / max(n, 1),
             u16_mask=float(nmask))
    return r
