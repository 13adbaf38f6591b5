"""What decides `correct`, run on the CPU at a small size (the harness's
look for a card skipped, the rest of a run driven): sound runs pass, and
the control and each fault the cells can have come out not correct."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.small import run_small

BAD = ("jax", "jaxlib", "flax", "densesurfelmapping_tpu")


def compared(out):
    return {k: v["value"] for k, v in out["result"]["compared"].items()}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["kitti00_depth.replay",
                                  "kitti00_stereo.replay"])
def test_sound_run_is_correct(cell, traced):
    out = run_small(cell, traced=traced)
    assert out["result"]["correct"], out["result"]["compared"]
    assert out["result"]["failed"] == 0 and out["result"]["attempted"] > 0
    samples = out["log"]["samples"]
    kinds = {k for s in samples for k in s}
    assert {"share", "warp_gap"} <= kinds
    # the last sample is the frame after the window's last
    assert samples[-1]["frame"] == out["log"]["frames_fed"] - 1
    if traced:
        dev = out["result"]["device"]
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert "breakdown" in out["result"]


@pytest.mark.parametrize("cell", ["kitti00_depth.replay",
                                  "kitti00_stereo.replay"])
def test_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place."""
    out = run_small(cell, lowp_control=True)
    assert not out["result"]["correct"]
    assert compared(out)["step_rows_off"] > harness.load_cell(
        cell).limits["step_rows_off"]


def _restore_after(method):
    """Wrap a feed method so that the bank is left as it was before the
    call: a step that returns its state unchanged."""
    def wrapped(self, m):
        bank = self.bank
        keep = {k: getattr(bank, k).clone() for k in check_fields()}
        method(self, m)
        for k, t in keep.items():
            getattr(bank, k).copy_(t)
    return wrapped


def check_fields():
    from benchmark.check import FIELDS
    return FIELDS + ("count",)


def test_step_returning_its_state_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(harness.Solo, "feed_frame",
                        _restore_after(harness.Solo.feed_frame))
    out = run_small("kitti00_depth.replay")
    assert not out["result"]["correct"]
    assert compared(out)["step_rows_off"] > 0.5


def test_altered_answer_is_not_correct(monkeypatch):
    """Every row the step wrote moved by 5 mm where it is produced."""
    feed = harness.Solo.feed_frame

    def altered(self, m):
        before = self.bank.position.clone()
        feed(self, m)
        moved = (self.bank.position != before).any(dim=1, keepdim=True)
        self.bank.position.add_(torch.where(moved, 5e-3, 0.0))
    monkeypatch.setattr(harness.Solo, "feed_frame", altered)
    out = run_small("kitti00_depth.replay")
    assert not out["result"]["correct"]


def test_wrong_warp_is_not_correct(monkeypatch):
    """The loop warp applied twice to the program's bank."""
    from densesurfelmapping_tpu_torch.pipeline import device_driver
    apply = device_driver.DeviceResidentMapping._apply_pose_warp

    def twice(self, wstack, mstack):
        apply(self, wstack, mstack)
        apply(self, wstack, mstack)
    monkeypatch.setattr(device_driver.DeviceResidentMapping,
                        "_apply_pose_warp", twice)
    out = run_small("kitti00_stereo.replay")
    assert not out["result"]["correct"]
    assert compared(out)["warp_gap"] > 0


def test_no_jax_after_a_run():
    """The top-level name of every module loaded by a run (the part
    before the first dot), compared whole: the port's own name begins
    with the JAX package's."""
    code = ("import sys, json\n"
            "from benchmark.tests.small import run_small\n"
            "run_small('kitti00_depth.replay', seconds=0.5)\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    top = json.loads(subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True,
        text=True, cwd=harness.ROOT).stdout.strip().splitlines()[-1])
    assert "densesurfelmapping_tpu_torch" in top
    assert not set(top) & set(BAD)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json\n"
            "import benchmark.reference.step, benchmark.check\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    top = json.loads(subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True,
        text=True, cwd=harness.ROOT).stdout.strip().splitlines()[-1])
    assert not set(top) & set(BAD + ("densesurfelmapping_tpu_torch",))


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """One short run of the depth-fed replay through the command."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "kitti00_depth.replay", "--seed", "4000000001", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
