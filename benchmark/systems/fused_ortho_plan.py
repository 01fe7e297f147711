"""System adapter: the fused granule plan of ``hyperres_torch``
(``fusion/fused.py`` ``FusedOrthoFusionPlan``), raw EMIT cube + 10 m S2
RGB -> UTM 60 m cube and fused 10 m RGB.

The configuration's file gives the sizes and the plan's settings; the
traffic mix's file says where each request's raw cube comes from:

- ``"cube": "resident"``: the raw cube and the prepared S2 stack are on
  the card from set-up; a request is one plan call;
- ``"cube": "streamed"``: the raw cube is in host memory and each request
  sends it whole through ``io/ingest.py``'s ``stream_cube_to_device``
  (``transfer`` null: the port's default, with ``chunk_bands`` and
  ``depth``), its u16 S2 stack through ``plan.prepare_s2``, then one plan
  call, then ``readback`` (the named products) to host memory.

Every request has its own OT generator seed, drawn from the run's seed.
Its products are freed before the next request, except the compared
ones: request ``k`` (drawn from the seed below ``sample_within``) and the
window's last.
"""

from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from benchmark.harness.compare import max_gap, worst
from benchmark.harness.runner import split
from benchmark.harness.scene import granule_scene
from benchmark.harness.spectra import s2a_srf
from benchmark.reference import granule as ref
from benchmark.reference.ingest import roundtrip

SPANS = ("ingest", "prepare_s2", "plan", "readback")


def ot_seed(seed: int, i: int) -> int:
    """The OT generator seed of request ``i`` (-1: the warm-up)."""
    return (int(seed) * 1_000_003 + i + 1) % (1 << 63)


def _grid(g):
    from hyperres_torch.core.crs import CRS
    from hyperres_torch.core.grid import Grid

    crs = (CRS.geographic() if g.crs.kind == "geographic"
           else CRS.utm(g.crs.zone, g.crs.north))
    return Grid(crs, g.x0, g.y0, g.dx, g.dy, g.width, g.height)


def build_plan(scene: dict, config: dict, device):
    """The program's plan over the scene, with the configuration's
    settings."""
    from hyperres_torch.core.config import OTConfig, PolyFusionConfig
    from hyperres_torch.fusion.fused import FusedOrthoFusionPlan

    fu = config["fusion"]
    ot = fu["ot"]
    raw_h, raw_w = scene["raw"].shape[:2]
    return FusedOrthoFusionPlan(
        _grid(scene["ortho_grid"]), _grid(scene["utm60"]),
        _grid(scene["s2_grid"]), (raw_h, raw_w), scene["glt"],
        scene["wavelengths"], scene["good_mask"],
        platform=fu["platform"], synth_method=fu["synth_method"],
        fusion_method=fu["method"],
        config=PolyFusionConfig(
            degree=fu["degree"], min_pixels=fu["min_pixels"],
            ot=OTConfig(n_samples=ot["n_samples"], reg=ot["reg"],
                        num_itermax=ot["num_itermax"],
                        stop_thr=ot["stop_thr"], debias=ot["debias"]),
            stretch_percentiles=tuple(fu["stretch_percentiles"])),
        s2_nodata=float(fu["s2_nodata"]), s2_scale=fu["s2_scale"],
        warp_kernel=fu["warp_kernel"], resampling=fu["resampling"],
        srf=s2a_srf(), device=device)


class System:
    span_names = SPANS

    def __init__(self, config, traffic, seed, device, log, spans):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.dev, self.log, self.spans = device, log, spans
        self.streamed = traffic["cube"] == "streamed"
        rng = np.random.default_rng(self.seed)
        self.keep_ids = {int(rng.integers(1, traffic["sample_within"]))}
        self.kept = {}
        self.last = None

    # ---------------------------------------------------------- set-up
    def setup(self) -> None:
        raw_h, raw_w, nb = self.cfg["sizes"]["raw_hwb"]
        t = time.perf_counter()
        self.scene = granule_scene(raw_h, raw_w, nb, self.seed, self.dev)
        self._sync()
        t = split(self.log, "scene", t)
        for key, grid in (("utm_hw", "utm60"), ("s2_hw", "s2_grid")):
            want = self.cfg["sizes"].get(key)
            if want is not None and list(self.scene[grid].shape) != want:
                raise ValueError(f"scene {grid} {self.scene[grid].shape} "
                                 f"is not the configuration's {want}")
        self.plan = build_plan(self.scene, self.cfg, self.dev)
        t = split(self.log, "plan build", t)
        gen = self.plan.generator(ot_seed(self.seed, -1))
        if self.streamed:
            from hyperres_torch.io.ingest import stream_cube_to_device

            self.raw_host = self.scene["raw"].cpu().numpy()
            self.s2_host = self.scene["s2_dn"].cpu().numpy()
            del self.scene["raw"], self.scene["s2_dn"]
            self.transfer = self.traffic["transfer"] or inspect.signature(
                stream_cube_to_device).parameters["transfer"].default
            # warm-up: the two slab shapes the window sends (the full
            # chunk and the tail), then the rest of a request
            cb = self.traffic["chunk_bands"]
            bands = list(range(cb)) + list(range(nb - nb % cb or cb, nb))
            self._ingest(lambda b0, b1: self.raw_host[..., bands[b0:b1]],
                         len(bands))
            raw = torch.from_numpy(self.raw_host).to(self.dev)
            s2rgb = self.plan.prepare_s2(
                torch.from_numpy(self.s2_host).to(self.dev))
            out = self.plan(raw, s2rgb, generator=gen)
            for k in self.traffic["readback"]:
                out[k].cpu()
            del raw, s2rgb, out
        else:
            self.s2rgb = self.plan.prepare_s2(self.scene["s2_dn"])
            out = self.plan(self.scene["raw"], self.s2rgb, generator=gen)
            del out
        self._sync()
        split(self.log, "upload and warm-up (nvcc included)", t)
        self.log(f"scene: raw {tuple(self.cfg['sizes']['raw_hwb'])}, ortho "
                 f"{self.scene['ortho_grid'].shape}, UTM "
                 f"{self.scene['utm60'].shape}, S2 {self.scene['s2_grid'].shape}"
                 f"; cube {self.traffic['cube']}")

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _ingest(self, read, nb):
        from hyperres_torch.io.ingest import stream_cube_to_device

        kw = {} if self.traffic["transfer"] is None else \
            {"transfer": self.traffic["transfer"]}
        h, w = self.raw_host.shape[:2]
        return stream_cube_to_device(
            read, (h, w, nb), chunk_bands=self.traffic["chunk_bands"],
            depth=self.traffic["depth"], device=self.dev, **kw)

    # --------------------------------------------------------- requests
    def request(self, i: int) -> None:
        self.last = None
        sp = self.spans
        rec = {"i": i}
        if self.streamed:
            with sp.span("ingest", i):
                raw = self._ingest(lambda b0, b1: self.raw_host[..., b0:b1],
                                   self.raw_host.shape[2])
                self._sync()
            with sp.span("prepare_s2", i):
                s2rgb = self.plan.prepare_s2(
                    torch.from_numpy(self.s2_host).to(self.dev))
                self._sync()
        else:
            raw, s2rgb = self.scene["raw"], self.s2rgb
        with sp.span("plan", i, device_events=True):
            out = self.plan(raw, s2rgb,
                            generator=self.plan.generator(ot_seed(self.seed, i)))
            self._sync()
        if self.streamed:
            with sp.span("readback", i):
                rec["host"] = {k: out[k].cpu() for k in self.traffic["readback"]}
            rec["raw"] = raw
        rec["out"] = out
        del raw, s2rgb
        if i in self.keep_ids:
            self.kept[i] = rec
        self.last = rec

    # ----------------------------------------------------------- check
    def work_per_request(self) -> float:
        return 1.0

    def shapes(self) -> dict:
        s = self.scene
        return {"raw_hwb": tuple(self.cfg["sizes"]["raw_hwb"]),
                "ortho_hw": s["ortho_grid"].shape, "utm_hw": s["utm60"].shape,
                "s2_hw": s["s2_grid"].shape}

    def release(self) -> None:
        """Free the program's state before the reference runs: only the
        compared requests' products stay."""
        if self.last is not None:
            self.kept[self.last["i"]] = self.last
        self.last = None
        self.plan = None
        self.s2rgb = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        out = []
        for i in sorted(self.kept):
            out.append(self._compare(self.kept.pop(i)))
        return worst(out)

    def reference_inputs(self):
        """The raw cube (on the device) and the S2 DN stack the
        reference reads: what the program was handed, re-derived through
        the ingest's quantization where the cube was streamed."""
        if not self.streamed:
            return self.scene["raw"], self.scene["s2_dn"]
        if not hasattr(self, "_ref_inputs"):
            self._ref_inputs = (
                roundtrip(self.raw_host, self.transfer, self.dev),
                torch.from_numpy(self.s2_host).to(self.dev))
        return self._ref_inputs

    def reference(self, i: int, tf32: bool = False) -> dict:
        raw, s2_dn = self.reference_inputs()
        if not hasattr(self, "_fields"):
            self._fields = ref.warp_fields(
                self.scene["glt"], raw.shape[:2], self.scene["ortho_grid"],
                self.scene["utm60"])
        with ref.precision(tf32):
            want = ref.granule_product(raw, s2_dn, self.scene,
                                       self.cfg["fusion"],
                                       ot_seed(self.seed, i), self._fields)
        want["raw"] = raw
        return want

    def _compare(self, rec: dict) -> dict:
        want = self.reference(rec["i"])
        return compare_products(rec, want, self.scene)

    def control_readings(self, i: int) -> dict:
        """The readings of the control: the reference in TF32, put in
        the program's place for request ``i``."""
        want = self.reference(i)
        ctrl = self.reference(i, tf32=True)
        rec = {"i": i, "out": ctrl}
        if self.streamed:
            rec["raw"] = ctrl["raw"]
        return compare_products(rec, want, self.scene)


def compare_products(rec: dict, want: dict, scene: dict) -> dict:
    """The readings of one request against the reference's products.
    Gaps of the 60 m and 10 m products are weighed by the reference's
    conditioning (``reference.granule.conditioning``): at the swath's
    edge the warp divides by a validity mass near 0, where any two
    float32 evaluations part by rounding over that mass, and a pixel
    whose validity hangs on that rounding is not compared."""
    got = rec["out"]
    w60, w10 = ref.conditioning(want["utm_mass"], want["synth_b2"],
                                scene["utm60"], scene["s2_grid"])
    r = {}
    g = max_gap(got["utm_cube"], want["utm_cube"], fill=ref.EMIT_NODATA,
                weight=w60)
    r["utm_gap"], r["utm_mask"] = g["gap"], g["mask"]
    g = max_gap(got["matched_60m"], want["matched_60m"], weight=w60)
    r["matched_gap"], r["matched_mask"] = g["gap"], g["mask"]
    fused = rec.get("host", {}).get("fused_10m", got["fused_10m"])
    g = max_gap(fused, want["fused_10m"], weight=w10)
    r["fused_gap"], r["fused_mask"] = g["gap"], g["mask"]
    if "raw" in rec:
        g = max_gap(rec["raw"], want["raw"])
        r["ingest_gap"] = g["gap"] + g["mask"]
    return r
