"""With the timed path broken underneath, a run's `correct` comes out
false: a step that returns its state unchanged, half of the batch left out
(the mean taken over the rest), an answer altered where it is produced.
The faults are planted in the program; the rest of the run is the
harness's own, on the CPU at the tiny size and the cells' own limits."""
import dataclasses

import pytest
import torch

from benchmark import harness
from conftest import tiny_cell

TRAIN = ["sparf-dtu.fine", "sparf-llff.joint"]


def _run(name):
    torch.set_num_threads(2)
    return harness.run_once(tiny_cell(name), 99, 0.3, False, device="cpu")


@pytest.mark.parametrize("name", TRAIN)
def test_state_unchanged(name, monkeypatch):
    from sparf_tpu_torch.training import engine

    make = engine.make_train_step

    def frozen(*args, **kwargs):
        step = make(*args, **kwargs)

        def still(state, draws):
            new, stats = step(state, draws)
            return dataclasses.replace(state, iteration=new.iteration,
                                       iteration_nerf=new.iteration_nerf), stats
        return still

    monkeypatch.setattr(engine, "make_train_step", frozen)
    rec = _run(name)
    assert not rec["correct"]
    assert rec["numbers"]["grad_gap"] >= 0.99 and rec["numbers"]["change_gap"] >= 0.5


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch(name, monkeypatch):
    from sparf_tpu_torch.training.losses import photometric

    loss = photometric.photometric_and_regu_loss

    def half(out, image_at_rays, **kwargs):
        n = image_at_rays.shape[1] // 2
        out = {k: v[:, :n] if k in ("rgb", "rgb_fine") else v for k, v in out.items()}
        return loss(out, image_at_rays[:, :n], **kwargs)

    monkeypatch.setattr(photometric, "photometric_and_regu_loss", half)
    rec = _run(name)
    assert not rec["correct"]


def test_render_answer_altered(monkeypatch):
    from sparf_tpu_torch.training.trainer import NerfTrainerPerScene

    render = NerfTrainerPerScene.render_full_image

    def altered(self, *args, **kwargs):
        out = render(self, *args, **kwargs)
        key = "rgb_fine" if "rgb_fine" in out else "rgb"
        out[key] = out[key].clone()
        out[key][0, 0, 0] += 0.1
        return out

    monkeypatch.setattr(NerfTrainerPerScene, "render_full_image", altered)
    rec = _run("sparf-dtu.render")
    assert not rec["correct"]
