"""System adapter: the 10 m spectral-SR product of ``hyperres_torch``
(``fusion/ridge_sr.py`` ``RidgeSpectralSR``: ``fit``, then
``predict_cube_u16`` in the ``"cmajor"`` layout).

The configuration's file gives the model and the footprint; the traffic
mix's file the training sets: ``train_sets`` sets of ``n_train`` pixels
are made from the seed in set-up, and request i fits on set
i mod ``train_sets``, then predicts the whole resident footprint to u16;
the product stays on the card and is freed before the next request,
except the compared ones: request ``k`` (drawn from the seed below
``sample_within``) and the window's last.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness.compare import worst
from benchmark.harness.runner import split
from benchmark.harness.sr_data import footprint, training_set
from benchmark.reference import ridge as ref
from benchmark.reference.granule import precision

SPANS = ("fit", "predict")
PARAMS = ("x_mean", "x_std", "W", "intercept")


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
        from hyperres_torch.core.config import RidgeSRConfig
        from hyperres_torch.fusion.ridge_sr import RidgeSpectralSR

        m, s = self.cfg["model"], self.cfg["sizes"]
        t = time.perf_counter()
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seed)
        self.sets = [training_set(gen, self.traffic["n_train"], m["bands_in"],
                                  m["bands_out"], self.dev)
                     for _ in range(self.traffic["train_sets"])]
        h, w = s["footprint_hw"]
        self.cube = footprint(gen, m["bands_in"], h, w, s["nodata"],
                              s["nodata_stripe_share"], self.dev)
        self.model = RidgeSpectralSR(
            m["bands_in"], m["bands_out"],
            RidgeSRConfig(degree=m["degree"], alpha=m["alpha"],
                          n_emit_bands=m["bands_out"],
                          logit_eps=m["logit_eps"],
                          batch_pixels=m["batch_pixels"],
                          include_bias=m["include_bias"]),
            device=self.dev)
        self._sync()
        t = split(self.log, "data", t)
        self.request(-1)
        self.last = None
        split(self.log, "warm-up (nvcc included)", t)
        self.log(f"footprint {tuple(self.cube.shape)}, {len(self.sets)} "
                 f"training sets of {self.traffic['n_train']} px")

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def request(self, i: int) -> None:
        self.last = None
        X, Y = self.sets[i % len(self.sets)]
        with self.spans.span("fit", i, device_events=True):
            self.model.fit(X, Y)
            self._sync()
        with self.spans.span("predict", i, device_events=True):
            q = self.model.predict_cube_u16(
                self.cube, nodata=self.cfg["sizes"]["nodata"],
                layout=self.cfg["model"]["layout"])
            self._sync()
        rec = {"i": i, "q": q,
               "params": {k: getattr(self.model, k).clone() for k in PARAMS}}
        if i in self.keep_ids:
            self.kept[i] = rec
        self.last = rec

    def work_per_request(self) -> float:
        """Product pixels a request serves, in Mpx."""
        h, w = self.cfg["sizes"]["footprint_hw"]
        return h * w / 1e6

    def shapes(self) -> dict:
        m = self.cfg["model"]
        h, w = self.cfg["sizes"]["footprint_hw"]
        n = h * w
        return {"px": n, "valid_px": n - n // self.cfg["sizes"]
                ["nodata_stripe_share"], "bands_in": m["bands_in"],
                "bands_out": m["bands_out"],
                "features": len(ref.monomial_index(m["bands_in"],
                                                   m["degree"]))}

    def release(self) -> None:
        if self.last is not None:
            self.kept[self.last["i"]] = self.last
        self.last = None
        self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, i: int, control: bool = False, block: int = 1 << 21):
        """The reference's parameters and a generator of (pixel slice,
        codes (By, n) int32) blocks over the footprint. ``control``: each
        part one precision below the configuration's, the fit in float32
        and the product in TF32."""
        m = self.cfg["model"]
        X, Y = self.sets[i % len(self.sets)]
        p = ref.fit(X, Y, m["degree"], m["alpha"], m["logit_eps"],
                    torch.float32 if control else torch.float64)
        tf32 = control
        combos = ref.monomial_index(m["bands_in"], m["degree"])
        flat = self.cube.reshape(self.cube.shape[0], -1)
        nodata = float(self.cfg["sizes"]["nodata"])

        def blocks():
            with precision(tf32):
                for s in range(0, flat.shape[1], block):
                    yield s, ref.predict_u16_block(
                        flat[:, s:s + block].T, p, combos, nodata).T
        return p, blocks()

    def readings(self) -> dict:
        return worst(self._compare(self.kept.pop(i))
                     for i in sorted(self.kept))

    def _compare(self, rec: dict) -> dict:
        p, blocks = self.reference(rec["i"])
        return compare_codes(rec, p, blocks)

    def control_readings(self, i: int) -> dict:
        """The readings of the control: the reference one precision
        lower (fit in float32, product in TF32), put in the program's place
        for request ``i``."""
        p, blocks = self.reference(i, control=True)
        q = torch.cat([b for _, b in blocks], dim=1)
        rec = {"i": i, "q": q, "params": p}
        p, blocks = self.reference(i)
        return compare_codes(rec, p, blocks)


def compare_codes(rec: dict, p: dict, blocks) -> dict:
    """Readings of one request: ``params_gap`` (the largest parameter
    gap over the parameter's own largest magnitude, worst of the four),
    ``u16_steps`` (largest code difference where both are valid),
    ``u16_diff_share`` (share of codes that differ) and ``u16_mask``
    (codes valid on one side only)."""
    r = {"params_gap": max(
        float((rec["params"][k] - p[k]).abs().max()
              / p[k].abs().max().clamp(min=1e-30)) for k in PARAMS)}
    q = rec["q"].reshape(rec["q"].shape[0], -1)
    steps, ndiff, nmask, n = 0.0, 0, 0, 0
    for s, want in blocks:
        got = q[:, s:s + want.shape[1]].to(torch.int32)
        vg, vw = got != 65535, want != 65535
        nmask += int((vg != vw).sum())
        both = vg & vw
        d = (got - want).abs()
        if bool(both.any()):
            steps = max(steps, float(d[both].max()))
        ndiff += int((d != 0).sum())
        n += d.numel()
    r.update(u16_steps=steps, u16_diff_share=ndiff / max(n, 1),
             u16_mask=float(nmask))
    return r
