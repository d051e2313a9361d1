"""A later change adds a configuration, a traffic mix, a cell and a metric
as files and BENCHMARK.json entries; the harness finds each by name."""
import json
import shutil

from benchmark import harness


def test_cell_config_and_metric_added_as_files(tmp_path):
    root = harness.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark").mkdir()
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(root / "benchmark" / sub, tmp_path / "benchmark" / sub)
    cfg = json.loads((root / "benchmark/configs/sparf-dtu.json").read_text())
    cfg["run"]["nerf.rand_rays"] = cfg["overrides"]["nerf"] = 2048
    (tmp_path / "benchmark/configs/sparf-dtu-2k.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/fine-40k.json").write_text(json.dumps(
        {"kind": "train", "start_iteration": 40000, "checked_steps": 2}))
    (tmp_path / "benchmark/limits/sparf-dtu-2k.fine.json").write_text(json.dumps(
        {"loss_gap": 1.0}))
    (tmp_path / "benchmark/metrics/steps.train.py").write_text(
        "def read(rec):\n    return float(rec['units'])\n")
    bench["configs"].append(dict(name="sparf-dtu-2k", source="x",
                                 file="benchmark/configs/sparf-dtu-2k.json", reduced=[], why="x"))
    bench["workloads"].append(dict(name="sparf-dtu-2k.fine", config="sparf-dtu-2k",
                                   traffic="fine-40k", chips=1, why="x"))
    bench["per_layer"].append(dict(name="steps.train", unit="steps", better="higher",
                                   source="host_clock", layer="step", moves="train_it_per_s",
                                   workloads=["sparf-dtu-2k.fine"]))
    for m in bench["end_to_end"]:
        if m["name"] == "train_it_per_s":
            m["workloads"].append("sparf-dtu-2k.fine")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("sparf-dtu-2k.fine", root=tmp_path)
    assert cell.config["run"]["nerf.rand_rays"] == 2048
    assert cell.traffic["start_iteration"] == 40000 and cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["steps.train"]
    assert "train_it_per_s" in [m["name"] for m in cell.end_to_end]
    assert harness.read_metric("steps.train", {"units": 3}, root=tmp_path) == 3.0
