"""The points counted per step and per frame (benchmark/counts.py) are the
points that pass through the MLP op's entry points, with and without a
gradient, and the presets' chain counts 1,055,744 operations a point."""
import pytest
import torch

from benchmark import counts, harness
from conftest import tiny_cell


def test_presets_chain():
    run = harness.load_cell("sparf-dtu.fine").config["run"]
    # 63->256, three 256->256, 319->256, two 256->256, 256->257, 283->128, 128->3
    assert counts.chain(run)[4] == (319, 256) and counts.chain(run)[7] == (256, 257)
    assert counts.flops_per_point(run) == 2 * 527_872


@pytest.fixture
def points_seen(monkeypatch):
    from sparf_tpu_torch.ops import fused_mlp

    seen = {"grad": 0, "nograd": 0}
    fn = fused_mlp.nerf_apply_fused

    def counting(params, cfg, pts, ray, progress, density_noise=None):
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in [pts, ray] + [x for W, b in params["feat"] + params["rgb"]
                                                   for x in (W, b)])
        seen["grad" if grad else "nograd"] += pts.shape[:-1].numel()
        return fn(params, cfg, pts, ray, progress, density_noise)

    monkeypatch.setattr(fused_mlp, "nerf_apply_fused", counting)
    return seen


@pytest.mark.parametrize("name", ["sparf-dtu.fine", "sparf-llff.joint"])
def test_step_points(name, points_seen):
    torch.set_num_threads(2)
    cell = tiny_cell(name, checked_steps=1)
    run = harness.new_run(cell, 7, "cpu")
    run.setup()
    assert points_seen == counts.step_points(cell.config["run"], cell.traffic["start_iteration"])
    assert points_seen["grad"] > 0


def test_frame_points(points_seen):
    torch.set_num_threads(2)
    cell = tiny_cell("sparf-dtu.render")
    run = harness.new_run(cell, 7, "cpu")
    run.setup()  # renders one frame
    # 24 x 32 pixels are whole chunks of 16 rays: no padding
    assert points_seen["grad"] == 0
    assert points_seen["nograd"] == counts.frame_points(cell.config["run"],
                                                        cell.traffic["start_iteration"])
