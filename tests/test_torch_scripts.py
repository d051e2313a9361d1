"""The port's command-line tools (sparf_tpu_torch/scripts) on the CPU at tiny
sizes: the dataset drill on the synthetic scene, the matcher panel, and the
step profiler's JSON line."""
import json

import numpy as np
import pytest

from sparf_tpu_torch.scripts import profile_step, test_matcher_installation, validate_dataset
from sparf_tpu_torch.utils import imgproc


def test_validate_dataset_passes_on_the_synthetic_scene(capsys):
    assert validate_dataset.main(["--dataset", "synthetic", "--scene", "spheres"]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and "0 failed" in out
    assert "train/test split disjoint" in out


def test_validate_dataset_refuses_a_missing_root(tmp_path):
    assert validate_dataset.main(["--dataset", "dtu", "--root", str(tmp_path / "nope"),
                                  "--scene", "scan82"]) == 2


def test_matcher_installation_writes_its_panel(tmp_path, capsys):
    out = tmp_path / "panel.png"
    assert test_matcher_installation.main(["--out", str(out), "--size", "32x40",
                                           "--device", "cpu"]) == 0
    panel = imgproc.read_png(str(out))
    # two 32x40 views side by side, then the confidence map at their height
    assert panel.shape[0] == 32 and panel.shape[1] == 40 * 3 and panel.shape[2] == 3
    assert np.ptp(panel) > 0
    assert f"wrote {out}" in capsys.readouterr().out


def test_profile_step_prints_its_categories_on_the_cpu(capsys):
    res = profile_step.main(["--tiny", "--steps", "2", "--device", "cpu", "--warmup", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {k: v for k, v in res.items() if k != "kernels"}
    assert line["platform"] == "cpu" and line["device"] == "cpu"
    # no device trace on the CPU: the kernel table names the CPU operators by
    # their self time, and the device shares are not measured
    names = [k["name"] for k in res["kernels"]]
    ms = [k["ms_per_step"] for k in res["kernels"]]
    assert 0 < len(names) <= 30 and "aten::mm" in names
    assert ms == sorted(ms, reverse=True) and all(k["calls"] > 0 for k in res["kernels"])
    assert line["busy_share"] is None and line["idle_share"] is None
    assert line["window_ms_per_step"] > 0
    assert np.isfinite(line["loss"]) and line["stage"] == "fine" and line["steps"] == 2


@pytest.mark.parametrize("events, idle", [
    # overlapping and nested busy intervals merge; the gaps before, between
    # and after them, inside the window, are idle
    ([("k1", 15, 30), ("k2", 20, 25), ("k3", 28, 40), ("k4", 60, 70), ("k5", 95, 120)],
     [(10, 15), (40, 60), (70, 95)]),
    # synchronisation records are no device work: they leave the gaps idle
    ([("k1", 10, 20), ("cudaStreamSynchronize Sync", 20, 50),
      ("Stream Wait Event", 55, 80), ("k2", 80, 100)], [(20, 80)]),
])
def test_profile_idle_intervals(events, idle):
    assert profile_step.idle_intervals(events, 10, 100) == idle
