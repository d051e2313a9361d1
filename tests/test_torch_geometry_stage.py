"""The whole geometry stage of the port's ZNCC matcher
(`compute_zncc_flow_of_combi_list(..., intr=...)`: stage 1, mini-SfM rounds,
plane-sweep rematch) on the DTU-like 64x80 rig of tests/test_sparf_losses.py,
clean and photometrically perturbed: the JAX package's contract, more than 45
confident pixels per pair and a median per-pair EPE under 1.5 px against GT
flow. The stage reports its route in `geom_out`."""
import numpy as np
import pytest

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu_torch.datasets import synthetic
from sparf_tpu_torch.models import flow_net as ft

COMBI = np.array([[0, 0, 1], [1, 2, 2]], np.int32)
PERTURBED = dict(specular=0.3, exposure_jitter=0.3, wb_jitter=0.1, noise_sigma=0.01,
                 vignette=0.2)


@pytest.mark.parametrize("photometry", ["clean", "perturbed"])
def test_stage_meets_the_epe_contract_on_the_dtu_like_rig(photometry):
    kw = PERTURBED if photometry == "perturbed" else {}
    sc = synthetic.load_synthetic_scene(split="train", H=64, W=80, n_train=3, n_test=1,
                                        angular_span=0.35, **kw)
    geom = {}
    corres, conf = ft.compute_zncc_flow_of_combi_list(sc["image"], COMBI, intr=sc["intr"],
                                                      geom_out=geom, device="cpu")
    assert corres.shape == (3, 2, 64, 80) and conf.shape == (3, 1, 64, 80)
    assert corres.dtype == conf.dtype == np.float32
    gt_corres, gt_conf = ft.compute_gt_flow_of_combi_list(sc, COMBI)
    medians, counts = [], []
    for p in range(COMBI.shape[1]):
        m = (conf[p, 0] > 0.95) & (gt_conf[p, 0] > 0.5)
        counts.append(int(m.sum()))
        medians.append(float(np.median(np.linalg.norm(corres[p] - gt_corres[p], axis=0)[m])))
    print(f"{photometry}: confident px {counts}, median EPE per pair {np.round(medians, 3)}, "
          f"rounds {[(r['winner'], round(r['score'], 4)) for r in geom['rounds']]}")
    assert min(counts) > 45
    assert np.median(medians) < 1.5
    # the report: no bootstrap at 80 px, three rounds, each won by a global candidate
    assert geom["bootstrap"] is None and geom["output"] == "rematched flows"
    assert [r["round"] for r in geom["rounds"]] == [0, 1, 2]
    assert all(r["winner"] in ("prior", "fresh") and r["views"] == 3 for r in geom["rounds"])
    assert geom["poses_w2c"].shape == (3, 3, 4) and "stage1" in geom["seconds"]
