"""What the port's entry-point tests share (tests/test_torch_entry*.py): the
repo root and the tiny CLI overrides. The entry tests are split over several
files so that `pytest -n ... --dist loadfile` spreads them over its workers."""
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["--synthetic.H=24", "--synthetic.W=32", "--synthetic.n_train=3", "--synthetic.n_test=1",
        "--arch.layers_feat=[null,64,64,64,64]", "--arch.layers_rgb=[null,32,3]",
        "--arch.skip=[2]", "--nerf.sample_intvs=32", "--nerf.sample_intvs_fine=16",
        "--nerf.rand_rays=16", "--depth_cons_nbr_rays=16", "--min_nbr_matches=10",
        "--use_gt_correspondences=True", "--max_iter=1000"]

# raw PDC-Net flows (bundled weights) instead of GT-depth correspondences
RAW_PDCNET = [a for a in TINY if not a.startswith("--use_gt_correspondences")] + [
    "--use_gt_correspondences=False", "--flow_backbone=PDCNet", "--pdcnet_geometry_refine=false"]
