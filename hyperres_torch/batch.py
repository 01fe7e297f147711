"""Batch pair driver: checkpoint / resume and record-and-continue
(``hyperres/batch.py``).

The library form of a manifest loop over EMIT / S2 pairs:

- checkpoint / resume: the batch manifest (``pairs_manifest.json``) is
  written after every pair and reloaded, so a run that stopped resumes
  with the pairs not yet done; each pipeline stage skips the outputs it
  already wrote;
- failure detection: each attempt runs under try / except and is
  recorded (success, seconds, error and traceback, device), with
  bounded retries; a failed pair does not stop the batch;
- scene-level data parallelism: ``run(jobs, devices=[...])`` runs one
  worker thread per device entry (repeats allowed: two workers on one
  card), each pair's device work on its worker's device.

Where the port departs from the reference:

- an exception raised in a worker outside a pair's attempts (writing the
  manifest, say) is collected, no worker starts another pair, and
  ``run`` re-raises it once the workers have stopped; the reference's
  worker thread dies silently and ``run`` returns. Every job of a run is
  entered as ``pending`` when the run starts (a job not in the manifest
  yet), so a pair that never ran stays ``pending``;
- a ``torch.AcceleratorError`` in an attempt (an illegal address, a
  launch failure: the CUDA context is lost, and every later launch in
  the process fails) is not retried. The attempt is recorded, the pair
  stays ``pending`` (a resumed run in a fresh process takes it again),
  the manifest is written and the error leaves the pair's attempts,
  which stops the batch as above. The reference records and retries
  every ``Exception``; ``torch.OutOfMemoryError`` and every other
  exception are still recorded and retried here.
"""

from __future__ import annotations

import contextlib
import copy
import json
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from .core.config import (
    OrthoConfig, PolyFusionConfig, RidgeSRConfig, TilingConfig,
)
from .pipeline import run_pair_pipeline


@dataclass
class PairJob:
    pair_id: str
    emit_nc_path: str
    s2_stack_tif: str
    meta: Dict = field(default_factory=dict)


def _on(device: Optional[torch.device]):
    """The worker's current CUDA device while it runs a pair (the
    default device of the pair's allocations and launches)."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class BatchPairDriver:
    """Run the pair pipeline over many jobs with resume and retry."""

    def __init__(self, out_root: Union[str, Path], *,
                 max_retries: int = 1,
                 ortho_config: OrthoConfig = OrthoConfig(),
                 fusion_config: PolyFusionConfig = PolyFusionConfig(),
                 tiling_config: TilingConfig = TilingConfig(),
                 sr_config: Optional[RidgeSRConfig] = RidgeSRConfig(),
                 runner: Optional[Callable] = None):
        self.out_root = Path(out_root)
        self.out_root.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.out_root / "pairs_manifest.json"
        self.max_retries = max_retries
        self.ortho_config = ortho_config
        self.fusion_config = fusion_config
        self.tiling_config = tiling_config
        self.sr_config = sr_config
        self.runner = runner or self._default_runner
        self.manifest: Dict[str, Dict] = self._load_manifest()
        # the device of the pair the calling thread runs
        self._local = threading.local()
        # held while a worker changes the manifest and writes it
        self._lock = threading.Lock()

    def _load_manifest(self) -> Dict[str, Dict]:
        if self.manifest_path.exists():
            return json.loads(self.manifest_path.read_text())
        return {}

    def _save_manifest(self) -> None:
        self.manifest_path.write_text(
            json.dumps(self.manifest, indent=2, default=str))

    def _default_runner(self, job: PairJob, pair_dir: Path) -> Dict:
        res = run_pair_pipeline(
            job.emit_nc_path, job.s2_stack_tif, pair_dir,
            ortho_config=self.ortho_config,
            fusion_config=self.fusion_config,
            tiling_config=self.tiling_config,
            sr_config=self.sr_config,
            device=getattr(self._local, "device", None))
        return {
            "fused_tif": str(res.fused_tif),
            "report": str(res.report_path),
            "n_tiles": len(res.tiles),
            "sr_r2_mean": (res.sr_metrics or {}).get("r2_mean"),
            "total_seconds": res.info.get("total_seconds"),
        }

    def _record(self, job: PairJob) -> Dict:
        return self.manifest.get(job.pair_id) or {
            "pair_id": job.pair_id,
            "emit_nc_path": job.emit_nc_path,
            "s2_stack_tif": job.s2_stack_tif,
            "meta": job.meta,
            "status": "pending",
            "attempts": [],
        }

    def _store(self, rec: Dict) -> None:
        """Enter a pair's record in the manifest and write it."""
        with self._lock:
            self.manifest[rec["pair_id"]] = rec
            self._save_manifest()

    def _run_one(self, job: PairJob,
                 device: Optional[torch.device] = None) -> None:
        """Execute one job (with retries) and store its manifest record.
        ``device``: the device the pair runs on (default: the pipeline's,
        the card); the default runner passes it to ``run_pair_pipeline``,
        and it is the thread's current CUDA device meanwhile. A
        ``torch.AcceleratorError`` is recorded, the pair left ``pending``
        and the error re-raised once the record is stored."""
        # a private copy: another worker may write the manifest meanwhile
        rec = copy.deepcopy(self._record(job))
        pair_dir = self.out_root / job.pair_id
        dev_key = {"device": str(device)} if device is not None else {}
        self._local.device = device
        done = False
        for attempt in range(1, self.max_retries + 2):
            t0 = time.perf_counter()
            try:
                with _on(device):
                    outputs = self.runner(job, pair_dir)
                rec["attempts"].append({
                    "attempt": attempt,
                    "success": True,
                    "seconds": round(time.perf_counter() - t0, 3),
                    **dev_key,
                })
                rec["status"] = "done"
                rec["outputs"] = outputs
                done = True
                break
            except Exception as e:  # record-and-continue
                rec["attempts"].append({
                    "attempt": attempt,
                    "success": False,
                    "seconds": round(time.perf_counter() - t0, 3),
                    "error": str(e),
                    "traceback": traceback.format_exc(limit=5),
                    **dev_key,
                })
                if isinstance(e, torch.AcceleratorError):
                    self._store(rec)    # still pending
                    raise
        if not done:
            rec["status"] = "failed"
        self._store(rec)

    def run(self, jobs: List[PairJob], resume: bool = True,
            devices: Optional[Sequence[Union[str, torch.device]]] = None
            ) -> Dict[str, Dict]:
        """Process all jobs; with ``resume`` the pairs already ``done``
        are skipped. Returns the manifest {pair_id: record}.

        ``devices``: a list of devices to spread the batch over scenes,
        one worker thread per entry (repeats allowed: two entries of one
        card run two pipelines on it at once). Each worker takes jobs
        from a shared queue and runs each pair on its device (the pair's
        attempts record it), so the pipelines run concurrently with
        per-pair records and resume unchanged. ``None`` or one entry: the
        sequential loop (on that device; ``None`` is the pipeline's
        default, the card). An exception outside a pair's attempts, or a
        ``torch.AcceleratorError`` in one, stops every worker from taking
        another pair and is re-raised here."""
        devs = [torch.device(d) for d in devices] if devices else []
        todo = [j for j in jobs if not (
            resume and self.manifest.get(j.pair_id, {}).get("status")
            == "done")]
        for job in todo:
            self.manifest[job.pair_id] = self._record(job)
        if len(devs) <= 1:
            dev = devs[0] if devs else None
            for job in todo:
                self._run_one(job, dev)
            return self.manifest

        q: "queue.Queue[PairJob]" = queue.Queue()
        for job in todo:
            q.put(job)
        stop = threading.Event()
        errors: List[BaseException] = []

        def worker(dev):
            try:
                while not stop.is_set():
                    try:
                        job = q.get_nowait()
                    except queue.Empty:
                        return
                    self._run_one(job, dev)
            except BaseException as e:  # noqa: BLE001 (re-raised by run)
                stop.set()
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(d,), daemon=True)
                   for d in devs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return self.manifest

    def summary(self) -> Dict[str, int]:
        out = {"done": 0, "failed": 0, "pending": 0}
        for rec in self.manifest.values():
            out[rec.get("status", "pending")] = out.get(
                rec.get("status", "pending"), 0) + 1
        return out
