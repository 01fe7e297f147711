"""Each fault a cell can have, planted underneath the timed path of an
otherwise whole run (set-up, window, reference, comparison), turns
``correct`` false. The harness's look for a card is skipped: these runs
are on the CPU at a small size."""

import pytest
import torch

from benchmark.systems import fused_ortho_plan, ridge_sr

from conftest import run_small


def plan_with(fault):
    class Broken(fused_ortho_plan.System):
        def request(self, i):
            if fault == "stale":
                # the product of another request (another OT draw) is
                # handed out as this one's
                super().request(i + 1000)
                prev = self.last
                super().request(i)
                self.last = dict(self.last, out=prev["out"],
                                 host=prev.get("host", {}))
                self.kept = {k: self.last for k in self.kept}
                return
            super().request(i)
            out = self.last["out"]
            if fault == "altered":
                h, w = out["fused_10m"].shape[:2]
                out["fused_10m"][h // 2, w // 2, 0] += 0.05
            elif fault == "altered_utm":
                h, w = out["utm_cube"].shape[:2]
                out["utm_cube"][h // 2, w // 2, 100] += 0.05
            elif fault == "raises" and i == 0:
                raise RuntimeError("planted failure")
    return Broken


def sr_with(fault):
    class Broken(ridge_sr.System):
        def request(self, i):
            if fault == "stale":
                # the product of the next request's training set
                super().request(i + 1)
                prev = self.last
                super().request(i)
                self.last = dict(self.last, q=prev["q"], params=prev["params"])
                self.kept = {k: self.last for k in self.kept}
                return
            super().request(i)
            q = self.last["q"]
            if fault == "altered":
                q[3, 10, 10] = int(q[3, 10, 10].to(torch.int32)) + 5
            elif fault == "half":
                flat = q.view(q.shape[0], -1)
                flat[:, flat.shape[1] // 2:] = 65535
    return Broken


@pytest.mark.parametrize("cell", ["rgb10.resident", "rgb10.streamed"])
@pytest.mark.parametrize("fault", ["altered", "altered_utm", "stale", "raises"])
def test_granule_faults_turn_correct_false(cell, fault):
    res = run_small(cell, seconds=0.3, system_factory=plan_with(fault))
    assert res["correct"] is False, (fault, res["compared"])


@pytest.mark.parametrize("fault", ["altered", "half", "stale"])
def test_sr_faults_turn_correct_false(fault):
    res = run_small("sr10.resident", seconds=0.2, system_factory=sr_with(fault))
    assert res["correct"] is False, (fault, res["compared"])


def test_sound_runs_are_correct():
    for cell in ("rgb10.resident", "sr10.resident"):
        res = run_small(cell, seconds=0.2, system_factory=None)
        assert res["correct"] is True, res["compared"]
