"""Spectral super-resolution ridge model (``hyperres/fusion/ridge_sr.py``),
the framework's flagship model, as an ``nn.Module``.

The sklearn pipeline ``StandardScaler -> PolynomialFeatures(degree, no
bias) -> Ridge(alpha)`` trained in logit space, with sigmoid inference:

- ``fit``: biased standardisation, the logit target, the weighted Gram
  system of the monomial features (plain f32 ``torch.matmul``, TF32
  off), centred so the intercept stays unpenalised, and a Cholesky
  solve. Closed form, no backward.
- ``forward`` / ``predict`` / ``predict_cube`` / ``evaluate``: plain
  PyTorch.
- ``predict_cube_u16`` and :func:`sr_predict_u16`: the u16 product and
  serving paths, with the reference's ``engine=`` argument:
  ``"pallas"`` is the hand-written kernel of
  :mod:`hyperres_torch.kernels.sr_predict` (Bx <= 16, degree <= 4),
  ``"xla"`` the batched plain-tensor program
  (:func:`predict_quant_batches`, any model), ``"auto"`` the kernel
  where it takes the model and ``"xla"`` otherwise.

``x_mean``, ``x_std``, ``W`` (F, By) and ``intercept`` are buffers (None
until fitted or loaded); the device is explicit. ``save_params`` /
``load_params`` read and write the reference's ``.npz`` checkpoint, so
a checkpoint crosses between the two packages in either direction.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.config import RidgeSRConfig

from ..device import resolve_device
from ..kernels.host import poly_factor_indices
from ..kernels.lstsq import (
    logit, make_poly_expander, r2_rmse_per_band, ridge_solve, sigmoid,
)
from ..kernels.sr_predict import MAX_BANDS_IN, MAX_DEGREE, kernel_takes
from ..kernels.sr_predict import sr_predict_u16 as _sr_predict_kernel
from ..kernels.sr_predict import valid_pixels

DeviceLike = Union[str, torch.device, None]
ArrayLike = Union[np.ndarray, torch.Tensor]
ENGINES = ("auto", "pallas", "xla")


def predict_quant_batches(model: "RidgeSpectralSR", X: torch.Tensor,
                          valid: torch.Tensor, batch: int,
                          layout: str = "rowmajor") -> torch.Tensor:
    """The ``"xla"`` engine: the reference's ``_predict_quant_batches``
    (``hyperres/fusion/ridge_sr.py:184-214``) as plain tensor ops. X
    (N, Bx) float32 without NaNs, ``valid`` (N,) bool; ``batch`` pixels
    at a time: standardise -> monomial expansion -> f32 matmul with W ->
    sigmoid (its logit clipped to +-50) -> ``clip(rint(y * 1e4), 0,
    65534)`` as uint16, 65535 where not valid. Returns (N, By), or
    (By, N) with ``layout="cmajor"``. Any Bx and degree. The (batch, F)
    feature matrix is the largest temporary; the last batch is short
    where the reference pads (eager ops need no fixed shape)."""
    n, by = X.shape[0], model.n_outputs
    out = torch.empty((by, n) if layout == "cmajor" else (n, by),
                      dtype=torch.uint16, device=X.device)
    for s in range(0, n, batch):
        x = X[s:s + batch]
        z = model.expand((x - model.x_mean) / model.x_std) @ model.W \
            + model.intercept
        q = torch.clamp(torch.round(sigmoid(z) * 10000.0), 0.0, 65534.0)
        # int32 until the end: CUDA takes few operators on uint16
        q = torch.where(valid[s:s + batch, None], q.to(torch.int32),
                        65535).to(torch.uint16)
        if layout == "cmajor":
            out[:, s:s + batch] = q.T
        else:
            out[s:s + batch] = q
    return out


class RidgeSpectralSR(nn.Module):
    """S2 bands -> EMIT-band spectral super-resolution model."""

    def __init__(self, n_inputs: int, n_outputs: int,
                 config: RidgeSRConfig = RidgeSRConfig(),
                 device: DeviceLike = None):
        super().__init__()
        self.cfg = config
        self.n_inputs = int(n_inputs)
        self.n_outputs = int(n_outputs)
        self.expand, self.n_features = make_poly_expander(
            self.n_inputs, config.degree, include_bias=config.include_bias)
        fac = poly_factor_indices(self.n_inputs, config.degree,
                                  config.include_bias)
        dev = resolve_device(device)
        # (F, degree) monomial factor table, the kernel's operand
        self.register_buffer("factors", torch.from_numpy(fac).to(dev),
                             persistent=False)
        for name in ("x_mean", "x_std", "W", "intercept"):
            self.register_buffer(name, None)
        #: the engine the last u16 call took ("pallas" or "xla")
        self.last_engine: Optional[str] = None

    @property
    def device(self) -> torch.device:
        return self.factors.device

    @property
    def fitted(self) -> bool:
        return self.W is not None

    def _require_fitted(self) -> None:
        if not self.fitted:
            raise RuntimeError("RidgeSpectralSR: fit() or load parameters "
                               "first")

    def _as_f32(self, a: ArrayLike) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def params_from_numpy(self, x_mean, x_std, W, intercept
                          ) -> "RidgeSpectralSR":
        """Set the parameters from arrays (for instance the reference's
        ``RidgeSRParams`` as NumPy): x_mean, x_std (Bx,), W (F, By),
        intercept (By,)."""
        shapes = {"x_mean": (self.n_inputs,), "x_std": (self.n_inputs,),
                  "W": (self.n_features, self.n_outputs),
                  "intercept": (self.n_outputs,)}
        for name, a in zip(shapes, (x_mean, x_std, W, intercept)):
            # a copy: the buffers never alias the caller's arrays
            t = (a.detach().clone() if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.array(a, dtype=np.float32)))
            t = t.to(device=self.device, dtype=torch.float32)
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{shapes[name]}")
            setattr(self, name, t)
        return self

    # ---- training ----

    def _gram_terms(self, X, Y_logit, weights, x_mean, x_std):
        """Weighted Gram pieces for the centred ridge system."""
        F = self.expand((X - x_mean) / x_std)
        if weights is None:
            weights = torch.ones(X.shape[0], dtype=torch.float32,
                                 device=X.device)
        Fw = F * weights[:, None]
        n = torch.sum(weights)
        f_sum = torch.sum(Fw, dim=0)
        y_sum = torch.sum(Y_logit * weights[:, None], dim=0)
        return n, f_sum, y_sum, Fw.T @ F, Fw.T @ Y_logit

    @staticmethod
    def _solve_from_gram(n, f_sum, y_sum, FtF, FtY, alpha):
        """Centre the Gram system and solve the penalised normal
        equations; the intercept stays unpenalised (sklearn Ridge)."""
        f_mean = f_sum / n
        y_mean = y_sum / n
        FtF_c = (FtF - torch.outer(f_mean, f_sum) - torch.outer(f_sum, f_mean)
                 + n * torch.outer(f_mean, f_mean))
        FtY_c = (FtY - torch.outer(f_mean, y_sum) - torch.outer(f_sum, y_mean)
                 + n * torch.outer(f_mean, y_mean))
        W = ridge_solve(FtF_c, FtY_c, alpha)
        return W, y_mean - f_mean @ W

    def fit(self, X: ArrayLike, Y: ArrayLike,
            weights: Optional[ArrayLike] = None) -> "RidgeSpectralSR":
        """X (N, Bx) S2 reflectance, Y (N, By) EMIT reflectance in (0, 1)
        (the logit transform happens inside), optional per-sample
        weights (N,)."""
        X = self._as_f32(X)
        Y = self._as_f32(Y)
        w = None if weights is None else self._as_f32(weights)
        if w is None:
            x_mean = X.mean(dim=0)
            x_std = X.std(dim=0, correction=0) + 1e-12  # like StandardScaler
        else:
            n = torch.sum(w)
            x_mean = torch.sum(X * w[:, None], dim=0) / n
            x_std = torch.sqrt(torch.sum(w[:, None] * (X - x_mean) ** 2,
                                         dim=0) / n) + 1e-12
        Y_logit = logit(Y, eps=self.cfg.logit_eps)
        terms = self._gram_terms(X, Y_logit, w, x_mean, x_std)
        W, intercept = self._solve_from_gram(*terms, self.cfg.alpha)
        self.x_mean, self.x_std, self.W, self.intercept = (
            x_mean, x_std, W, intercept)
        return self

    # ---- inference ----

    def predict_logit(self, X: torch.Tensor) -> torch.Tensor:
        self._require_fitted()
        F = self.expand((X - self.x_mean) / self.x_std)
        return F @ self.W + self.intercept

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, Bx) -> (N, By) reflectance in [0, 1] (sigmoid of the
        logits)."""
        return sigmoid(self.predict_logit(x))

    def predict(self, X: ArrayLike) -> torch.Tensor:
        """:meth:`forward` on an array or tensor, on the model's
        device."""
        return self(self._as_f32(X))

    def predict_cube(self, X_bhw: ArrayLike, nodata: Optional[float] = None,
                     batch_pixels: Optional[int] = None) -> torch.Tensor:
        """(Bx, H, W) -> (By, H, W) in [0, 1], ``batch_pixels`` valid
        pixels at a time; invalid pixels (a band not finite or isclose
        to ``nodata``) are NaN."""
        self._require_fitted()
        batch = batch_pixels or self.cfg.batch_pixels
        X = self._as_f32(X_bhw)
        b, h, w = X.shape
        flat = X.reshape(b, -1).T
        out = torch.full((flat.shape[0], self.n_outputs), float("nan"),
                         dtype=torch.float32, device=self.device)
        idx = torch.nonzero(valid_pixels(flat, nodata))[:, 0]
        for s in range(0, idx.numel(), batch):
            sl = idx[s:s + batch]
            out[sl] = self(flat[sl])
        return out.T.reshape(self.n_outputs, h, w)

    def resolve_engine(self, engine: str = "auto") -> str:
        """The engine a u16 call takes, from the model's shape alone and
        before any launch: ``"auto"`` is ``"pallas"`` where the kernel
        takes the model (Bx <= 16 and degree <= 4) and ``"xla"``
        otherwise; ``"pallas"`` past those limits raises ``ValueError``."""
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got "
                             f"{engine!r}")
        takes = kernel_takes(self.n_inputs, self.cfg.degree)
        if engine == "auto":
            return "pallas" if takes else "xla"
        if engine == "pallas" and not takes:
            raise ValueError(
                f"engine='pallas': the kernel takes Bx <= {MAX_BANDS_IN} "
                f"and degree <= {MAX_DEGREE}, got {self.n_inputs} and "
                f"{self.cfg.degree}; engine='xla' takes any model")
        return engine

    def _predict_u16(self, X2: torch.Tensor, layout: str,
                     valid: Optional[torch.Tensor], nodata: Optional[float],
                     engine: str) -> torch.Tensor:
        """The u16 codes of a 2-D X ((Bx, N) with ``"cmajor"``, (N, Bx)
        with ``"rowmajor"``) through the resolved engine, which
        ``last_engine`` then names."""
        engine = self.resolve_engine(engine)
        self.last_engine = engine
        if engine == "pallas":
            return _sr_predict_kernel(X2, self.x_mean, self.x_std, self.W,
                                      self.intercept, self.factors, layout,
                                      valid=valid, nodata=nodata,
                                      batch_pixels=self.cfg.batch_pixels)
        Xp = X2.T if layout == "cmajor" else X2
        if valid is None:
            valid = valid_pixels(Xp, nodata)
        return predict_quant_batches(self, torch.nan_to_num(Xp), valid,
                                     self.cfg.batch_pixels, layout)

    def predict_cube_u16(self, X_bhw: ArrayLike,
                         nodata: Optional[float] = None,
                         layout: str = "cmajor",
                         engine: str = "auto") -> torch.Tensor:
        """The u16 x10000 product (65535 = nodata): (Bx, H, W) -> (By,
        H, W) with ``layout="cmajor"`` (the reference's layout), or
        (H, W, Bx) -> (H, W, By) with ``"rowmajor"``. A pixel is valid
        when all its bands are finite and none is isclose to ``nodata``.

        ``engine`` is the reference's argument
        (``hyperres/fusion/ridge_sr.py:216``). ``"pallas"``: one launch
        of the fused kernel on the card, which reads X and writes Q
        once (on a CPU tensor its plain version in batches of
        ``batch_pixels``); it raises for a model past the kernel's
        limits, and a kernel that fails to build or launch raises too
        (the reference's warn-and-fall-back is not copied). ``"xla"``:
        :func:`predict_quant_batches`, any model. ``"auto"``:
        :meth:`resolve_engine`'s rule by model shape. The engine taken
        is left in ``last_engine``. The engines agree on the 65535 mask
        and to one u16 step."""
        self._require_fitted()
        X = self._as_f32(X_bhw)
        if layout == "cmajor":
            b, h, w = X.shape
            X2, out_shape = X.reshape(b, h * w), (self.n_outputs, h, w)
        elif layout == "rowmajor":
            h, w, b = X.shape
            X2, out_shape = X.reshape(h * w, b), (h, w, self.n_outputs)
        else:
            raise ValueError(f"layout must be 'cmajor' or 'rowmajor', got "
                             f"{layout!r}")
        return self._predict_u16(X2, layout, None, nodata,
                                 engine).reshape(out_shape)

    # ---- evaluation ----

    def evaluate(self, X: ArrayLike, Y_true: ArrayLike
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-band (R^2, RMSE) in reflectance space on the given
        pixels."""
        return r2_rmse_per_band(self._as_f32(Y_true), self.predict(X))


def sr_predict_u16(X: ArrayLike, valid: ArrayLike, model: RidgeSpectralSR,
                   engine: str = "auto") -> torch.Tensor:
    """Row-major serving form: X (N, Bx), valid (N,) bool -> (N, By)
    uint16 (65535 where not valid), through the same engines as
    :meth:`RidgeSpectralSR.predict_cube_u16`. The single-device
    counterpart of the per-shard body of the reference's
    ``sharded_sr_predict_u16`` (``hyperres/parallel/ops.py:414-436``)."""
    model._require_fitted()
    Xt = model._as_f32(X)
    v = torch.as_tensor(valid, dtype=torch.bool, device=model.device)
    return model._predict_u16(Xt, "rowmajor", v, None, engine)


def save_params(path, model: RidgeSpectralSR) -> None:
    """Write a fitted model (config + parameters) as the reference's
    ``.npz`` checkpoint (``hyperres/fusion/ridge_sr.py:307``)."""
    model._require_fitted()
    np.savez(
        path,
        x_mean=model.x_mean.cpu().numpy(), x_std=model.x_std.cpu().numpy(),
        W=model.W.cpu().numpy(), intercept=model.intercept.cpu().numpy(),
        n_inputs=model.n_inputs, n_outputs=model.n_outputs,
        degree=model.cfg.degree, alpha=model.cfg.alpha,
        logit_eps=model.cfg.logit_eps, include_bias=model.cfg.include_bias,
        batch_pixels=model.cfg.batch_pixels,
        n_emit_bands=model.cfg.n_emit_bands,
    )


def load_params(path, device: DeviceLike = None) -> RidgeSpectralSR:
    """Read a ``.npz`` checkpoint written by either package onto
    ``device``."""
    with np.load(path) as z:
        cfg = RidgeSRConfig(
            degree=int(z["degree"]), alpha=float(z["alpha"]),
            n_emit_bands=int(z["n_emit_bands"]),
            logit_eps=float(z["logit_eps"]),
            batch_pixels=int(z["batch_pixels"]),
            include_bias=bool(z["include_bias"]),
        )
        model = RidgeSpectralSR(int(z["n_inputs"]), int(z["n_outputs"]),
                                cfg, device=device)
        return model.params_from_numpy(z["x_mean"], z["x_std"], z["W"],
                                       z["intercept"])
