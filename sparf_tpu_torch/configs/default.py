"""Default config trees.

Option names/values mirror the reference's train_settings/default_config.py
(:21-333) so that experiment configs translate 1:1 and saved options.yaml
files stay meaningful, with extra TPU-specific knobs under `cfg.tpu`.
"""
from __future__ import annotations

from sparf_tpu_torch.configs.config import ConfigDict, override_options


def get_base_config() -> ConfigDict:
    cfg = ConfigDict()
    cfg.model = None
    cfg.grad_acc_steps = 1
    cfg.barf_c2f = None          # coarse-to-fine positional encoding (BARF)
    cfg.apply_cf_pe = True
    cfg.seed = 0
    cfg.do_eval = True

    cfg.increase_depth_range_by_x_percent = 0.0

    # training schedules
    cfg.first_joint_pose_nerf_then_nerf = False
    cfg.restart_nerf = False
    cfg.ratio_end_joint_nerf_pose_refinement = None

    cfg.clip_by_norm = True
    cfg.nerf_gradient_clipping = 0.1
    cfg.pose_gradient_clipping = None
    cfg.skip_large_gradients = None  # skip steps whose grad norm exceeds this
    cfg.print_gradients = False  # log max-abs + total grad norm every step
    # (reference iter_based_trainer.py:152-163)
    # mid-training matcher refresh (NO reference counterpart): at this ratio
    # of max_iter, rebuild the correspondence pools with the current pose
    # estimates as the matcher's SfM prior (joint_trainer.
    # refresh_correspondence_pools). None = reference-parity static pools.
    cfg.rematch_at_ratio = None
    cfg.arch = ConfigDict()

    # loss module
    cfg.loss_type = "photometric"
    cfg.load_colmap_depth = False

    # data options
    cfg.dataset = None
    cfg.scene = None
    cfg.resize = None
    cfg.crop_ratio = None
    cfg.val_on_test = False
    cfg.train_sub = None
    cfg.val_sub = None
    cfg.mask_img = False

    cfg.loss_weight = ConfigDict()
    cfg.optim = ConfigDict(lr=1.0e-3, lr_end=None, weight_decay=1e-4, sched=ConfigDict())

    cfg.max_iter = 200000
    cfg.vis_steps = 1000
    cfg.log_steps = 100
    cfg.val_steps = 5000
    cfg.snapshot_steps = 5000

    # --- TPU-specific knobs (no reference counterpart) ---
    cfg.tpu = ConfigDict()
    cfg.tpu.mesh_shape = None          # e.g. [8] -> 1-D 'data' mesh over ray batch
    cfg.tpu.compute_dtype = "float32"  # or 'bfloat16' for MXU-friendly matmuls
    # fused fwd+bwd Pallas MLP kernels (custom VJP, activations recomputed in
    # VMEM, dW accumulated on the MXU): 1.4x faster render+grad on v5e than
    # the XLA path (whose dW contractions lower to HBM-bound loop fusions).
    # Auto-disabled off-TPU.
    cfg.tpu.use_pallas = True
    cfg.tpu.donate_state = True
    # batch every loss module's ray bundles of a step into ONE MLP call per
    # hierarchy level (renderer.render_bundles). Numerically equivalent to
    # per-bundle rendering (tests/test_merged_render.py) but measured SLOWER
    # on v5e at both tiny and DTU shapes (joint stage 17.8 vs 34.6 it/s):
    # XLA already pipelines the separate renders, and the merge's extra
    # concat/slice/flatten materialization outweighs the launches it saves.
    # Default off; kept as an option (and for the SPMD mesh audit).
    cfg.tpu.merged_render = False
    return cfg


def get_nerf_default_config_llff() -> ConfigDict:
    cfg_base = get_base_config()

    cfg = ConfigDict()
    cfg.model = "nerf_gt_poses"

    cfg.arch = ConfigDict()
    cfg.arch.layers_feat = [None, 256, 256, 256, 256, 256, 256, 256, 256]
    cfg.arch.layers_feat_fine = None
    cfg.arch.layers_rgb = [None, 128, 3]
    cfg.arch.skip = [4]
    cfg.arch.posenc = ConfigDict(
        include_pi_in_posenc=True,
        add_raw_3D_points=True,
        add_raw_rays=True,
        log_sampling=True,
        L_3D=10,
        L_view=4,
    )
    cfg.arch.density_activ = "softplus"
    cfg.arch.tf_init = True

    cfg.nerf = ConfigDict()
    cfg.nerf.view_dep = True
    cfg.nerf.depth = ConfigDict(param="inverse", range=[1, 0])
    cfg.nerf.sample_intvs = 128
    cfg.nerf.sample_stratified = True
    cfg.nerf.fine_sampling = False
    cfg.nerf.sample_intvs_fine = 128
    cfg.nerf.rand_rays = 2048
    cfg.nerf.density_noise_reg = False
    cfg.nerf.setbg_opaque = False
    cfg.nerf.ratio_start_fine_sampling_at_x = None

    cfg.camera = ConfigDict(model="perspective", ndc=False)

    # ray sampling
    cfg.precrop_frac = 0.5
    cfg.precrop_iters = 0
    cfg.sample_fraction_in_fg_mask = 0.0
    cfg.sampled_fraction_in_center = 0.0
    cfg.depth_regu_patch_size = 2

    cfg.huber_loss_for_photometric = True

    cfg.loss_weight = ConfigDict(
        equalize_losses=False,
        parametrization="exp",   # weights are 10^w
        render=0,
        render_matches=None,
        depth_patch=None,
        distortion=None,
        fg_mask=None,
        corres=None,
        depth_cons=None,
        colmap_depth=None,
    )

    # debugging flags: GT-correspondence substitution (corres_loss.py:43-45)
    cfg.use_gt_correspondences = False
    cfg.use_dummy_all_one_confidence = False
    cfg.use_gt_depth = False
    cfg.compute_photo_on_matches = False

    cfg.start_iter = ConfigDict(photometric=0, corres=0, depth_cons=0)
    cfg.start_ratio = ConfigDict(photometric=None, corres=None, depth_cons=None)

    # multi-view correspondence loss scheduling
    cfg.gradually_decrease_corres_weight = False
    cfg.ratio_start_decrease_corres_weight = None
    cfg.iter_start_decrease_corres_weight = 0
    cfg.corres_weight_reduct_at_x_iter = 10000
    cfg.stop_corres_loss_at = None

    cfg.gradually_decrease_depth_cons_loss = False
    cfg.depth_cons_loss_reduct_at_x_iter = 10000

    cfg.optim = ConfigDict(
        start_decrease=0,
        lr=1.0e-3,
        lr_end=1.0e-4,
        sched=ConfigDict(type="ExponentialLR", gamma=None),
    )

    # correspondence prediction
    cfg.use_flow = False
    cfg.matching_pair_generation = "all_to_all"
    cfg.pairing_angle_threshold = 45
    cfg.flow_backbone = "PDCNet"
    cfg.flow_ckpt_path = None
    cfg.use_homography_flow = False
    # PDC-Net 'multiscale' inference variant (reference: external submodule
    # inference_parameters; see docs/parity_map.md): extra center-zoom
    # source pre-warps raced per pixel by p_r. E.g. [0.7, 1.4]; empty = off.
    cfg.pdcnet_multiscale = ()
    cfg.flow_batch_size = 5
    # sparf_tpu addition: pipe the learned backend's flows through the
    # mini-SfM + plane-sweep geometry stage (epipolar-consistent pools;
    # projects out the learned net's per-pair coherent bias). Off -> raw
    # PDC-Net flows as in the reference.
    cfg.pdcnet_geometry_refine = True

    cfg.renderrepro_do_pixel_reprojection_check = False
    cfg.renderrepro_do_depth_reprojection_check = False
    cfg.renderrepro_pixel_reprojection_thresh = 20.0
    cfg.renderrepro_depth_reprojection_thresh = 0.1

    cfg.filter_corr_w_cc = False
    cfg.min_conf_valid_corr = 0.95
    cfg.min_conf_cc_valid_corr = 1 / (1.0 + 1.5)
    cfg.min_nbr_matches = 500
    cfg.diff_loss_type = "huber"

    return override_options(cfg_base, cfg)


def get_joint_pose_nerf_default_config_llff() -> ConfigDict:
    cfg_base = get_nerf_default_config_llff()

    cfg = ConfigDict()
    cfg.model = "joint_pose_nerf_training"
    cfg.barf_c2f = [0.3, 0.7]
    cfg.increase_depth_range_by_x_percent = 0.2

    cfg.camera = ConfigDict(
        pose_parametrization="two_columns",
        optimize_c2w=False,
        optimize_trans=True,
        optimize_rot=True,
        optimize_relative_poses=False,
        n_first_fixed_poses=0,
        initial_pose="identity",
        noise=None,
    )

    cfg.optim = ConfigDict(
        algo_pose="Adam",
        lr_pose=3.0e-3,
        lr_pose_end=1.0e-5,
        sched_pose=ConfigDict(type="ExponentialLR", gamma=None),
        warmup_pose=None,
        test_photo=True,
        test_iter=100,
    )
    return override_options(cfg_base, cfg)


def get_nerf_default_config_360_data() -> ConfigDict:
    default_config = get_nerf_default_config_llff()

    cfg = ConfigDict()
    cfg.model = "nerf_gt_poses"
    cfg.nerf = ConfigDict(depth=ConfigDict(param="metric"), rand_rays=1024)
    cfg.optim = ConfigDict(
        start_decrease=0,
        lr=5.0e-4,
        lr_end=1.0e-4,
        sched=ConfigDict(type="ExponentialLR", gamma=None),
    )
    cfg.trimesh = ConfigDict(res=128, range=[-1.2, 1.2], thres=25.0, chunk_size=16384)
    return override_options(default_config, cfg)


def get_joint_pose_nerf_default_config_360_data() -> ConfigDict:
    default_cfg = get_nerf_default_config_360_data()

    cfg = ConfigDict()
    cfg.model = "joint_pose_nerf_training"
    cfg.barf_c2f = [0.3, 0.7]
    cfg.increase_depth_range_by_x_percent = 0.2

    cfg.camera = ConfigDict(
        pose_parametrization="two_columns",
        optimize_c2w=False,
        optimize_trans=True,
        optimize_rot=True,
        optimize_relative_poses=False,
        n_first_fixed_poses=0,
        initial_pose="noisy_gt",
        noise=0.15,
    )
    cfg.optim = ConfigDict(
        algo_pose="Adam",
        lr_pose=1.0e-3,
        lr_pose_end=1.0e-4,
        sched_pose=ConfigDict(type="ExponentialLR", gamma=None),
        warmup_pose=None,
        test_photo=True,
        test_iter=100,
    )
    return override_options(default_cfg, cfg)


def get_fixed_colmap_poses_default_config_360_data() -> ConfigDict:
    default_cfg = get_nerf_default_config_360_data()

    cfg = ConfigDict()
    cfg.model = "nerf_fixed_noisy_poses"
    cfg.increase_depth_range_by_x_percent = 0.2

    cfg.camera = ConfigDict(
        optimize_c2w=False,
        optimize_trans=True,
        optimize_rot=True,
        optimize_relative_poses=False,
        n_first_fixed_poses=0,
        initial_pose="sfm_pdcnet",
    )
    cfg.optim = ConfigDict(
        algo_pose="Adam",
        lr_pose=1.0e-3,
        lr_pose_end=1.0e-4,
        test_photo=True,
        test_iter=100,
    )
    return override_options(default_cfg, cfg)
