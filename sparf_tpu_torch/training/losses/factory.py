"""Loss factory: substrings of cfg.loss_type select loss builders (torch port
of sparf_tpu/training/losses/factory.py). Each entry is a
`make(fine_enabled) -> builder` callable."""
from __future__ import annotations

from typing import Callable, List


def build_extra_loss_builders(trainer) -> List[Callable]:
    loss_type = trainer.cfg.get("loss_type", "photometric") or "photometric"
    builders: List[Callable] = []
    if "corres" in loss_type:
        from sparf_tpu_torch.training.losses.corres import make_corres_loss_builder

        builders.append(make_corres_loss_builder(trainer))
    if "depth_cons" in loss_type:
        from sparf_tpu_torch.training.losses.depth_cons import make_depth_cons_loss_builder

        builders.append(make_depth_cons_loss_builder(trainer))
    if "SparseCOLMAPDepthLoss" in loss_type:
        raise NotImplementedError("the COLMAP depth loss (SparseCOLMAPDepthLoss) is not ported "
                                  "yet (ROADMAP Queue 1 item 12)")
    return builders
