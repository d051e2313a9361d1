"""The port's command-line tools (sparf_tpu_torch/scripts) on the CPU at tiny
sizes: the dataset drill on the synthetic scene, the matcher panel, and the
step profiler's JSON line."""
import json

import numpy as np

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
    assert set(line["ms_per_step"]) == set(profile_step.CATEGORIES)
    # no device trace on the CPU: the kernels' categories stay empty and the
    # device shares are not measured
    assert all(line["ms_per_step"][k] == 0.0 for k in ("K1", "k2_backward", "K3", "k_pack"))
    assert line["ms_per_step"]["gemm"] > 0 and line["busy_share"] is None
    assert np.isfinite(line["loss"]) and line["stage"] == "fine" and line["steps"] == 2


def test_profile_categories_name_the_kernels():
    cat = profile_step.categorize
    assert cat("void k1_forward<Tf32x3>(Params)") == "K1"
    assert cat("_Z11k2_backwardI4Bf16EvP6Params") == "k2_backward"
    assert cat("void k2_dw<Tf32x3>(...)") == "k2_dw" and cat("k2_reduce") == "k2_reduce"
    assert cat("void k3_forward<Bf16>(...)") == "K3" and cat("void k_pack<Bf16>()") == "k_pack"
    assert cat("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n") == "gemm"
    assert cat("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "collective"
    assert cat("Memcpy HtoD (Pageable -> Device)") == "memcpy"
    assert cat("void at::native::vectorized_elementwise_kernel<4, ...>") == "elementwise"
    assert cat("void at::native::reduce_kernel<512, 1, ...>") == "reduction"
    assert cat("void at::native::bitonicSortKVInPlace<...>") == "sort"


def test_profile_categories_name_the_wgmma_kernels():
    """The bf16 K1 / K2 / K3 of csrc/fused_mlp_wgmma.cu fall in K1's, K2's and
    K3's parts."""
    cat = profile_step.categorize
    assert cat("(anonymous namespace)::k1_wg(Maps, WgDesc, ...)") == "K1"
    assert cat("(anonymous namespace)::k3_wg(Maps, WgDesc, ...)") == "K3"
    assert cat("(anonymous namespace)::k2_wg(Maps, WgDesc, ...)") == "k2_backward"
    assert cat("(anonymous namespace)::k2_dw_wg(Maps, WgDesc, ...)") == "k2_dw"
    assert cat("(anonymous namespace)::k2_reduce_wg(WgDesc, ...)") == "k2_reduce"
    assert cat("(anonymous namespace)::k_wg_layout(WgDesc, ...)") == "k_pack"
