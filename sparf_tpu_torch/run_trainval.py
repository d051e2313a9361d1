#!/usr/bin/env python
"""Train+eval entry point of the PyTorch port (counterpart of run_trainval.py).

Usage:
  python -m sparf_tpu_torch.run_trainval joint_pose_nerf_training/synthetic sparf \\
      --scene spheres --debug True --device cuda
Extra config overrides: --k.k=v (dotted keys, yaml-parsed values).
A run resumes from the workspace's latest snapshot unless --no_resume, and
ends with `evaluate_full` on the test split (unless --debug or do_eval is
off); --test_metrics_only evaluates the latest snapshot without training,
--render_video_only renders the novel-view and pose videos of the latest
snapshot (animated PNGs under <workspace>/videos).
The config is the JAX package's: correspondences come from the matcher that
flow_backbone names (the presets: PDCNet with its bundled weights, refined
by the matchers' geometry stage, pdcnet_geometry_refine=True);
--pdcnet_geometry_refine=false trains on raw PDC-Net flows and
--use_gt_correspondences=true on GT-depth correspondences. Every preset's
trainer is ported (joint pose+NeRF, GT poses, fixed noisy poses), with
gradient accumulation (grad_acc_steps), the COLMAP depth loss and
--tpu.compute_dtype=bfloat16 (the MLP's products in bf16, through the bf16
kernels on the card), --tpu.merged_render=true (one MLP call per hierarchy
level for all of a step's bundles) and ray sharding over processes:

  torchrun --nproc_per_node N -m sparf_tpu_torch.run_trainval \
      joint_pose_nerf_training/synthetic sparf --scene spheres --tpu.mesh_shape [N]

joins the process group torchrun describes (NCCL on the card, one GPU per
rank as cuda:LOCAL_RANK; gloo with --device cpu); --tpu.mesh_shape auto
takes the world size.
"""
from __future__ import annotations

import argparse
import os


def build_env(args, cfg):
    """Machine-local paths: local settings / env vars, overridden by CLI args."""
    from sparf_tpu_torch.admin import env_settings

    env = env_settings()
    if args.workspace_dir:
        env.workspace_dir = args.workspace_dir
    env.eval_dir = env.get("eval_dir") or os.path.join(env.workspace_dir, "eval")
    if args.data_root:
        env.llff = env.dtu = env.replica = args.data_root
    if args.dtu_mask_root:
        env.dtu_mask = args.dtu_mask_root
    if args.dtu_depth_root:
        env.dtu_depth = args.dtu_depth_root
    cfg.env = env
    return cfg


def run_training(args, extra_overrides):
    from sparf_tpu_torch.configs.config import parse_dotted_args
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    cfg = build_config(args.train_module, args.train_name)
    cfg.scene = args.scene
    if args.train_sub is not None:
        cfg.train_sub = args.train_sub if args.train_sub > 0 else None
    cfg.seed = args.seed
    cfg = build_env(args, cfg)
    if extra_overrides:
        parse_dotted_args(extra_overrides, base=cfg)
    project = os.path.join(args.train_module, args.train_name,
                           f"{args.scene}" + (f"_sub{args.train_sub}" if args.train_sub else ""))
    workspace = os.path.join(args.workspace_dir, project)
    from sparf_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.init_from_env(args.device)
    trainer = define_trainer(cfg, workspace=workspace, debug=args.debug, device=args.device)
    eval_dir = os.path.join(cfg.env.eval_dir, project)
    if args.test_metrics_only:
        if not trainer.load_snapshot("latest"):
            raise FileNotFoundError(f"no snapshot to evaluate in {workspace}")
        trainer.evaluate_full(out_dir=eval_dir)
        return trainer
    if args.render_video_only:
        from sparf_tpu_torch.utils.video import generate_videos_pose, generate_videos_synthesis

        if not trainer.load_snapshot("latest"):
            raise FileNotFoundError(f"no snapshot to render in {workspace}")
        generate_videos_synthesis(trainer)   # every rank renders its share, rank 0 writes
        if trainer.is_main:
            generate_videos_pose(trainer)
        return trainer
    trainer.run(load_latest=not args.no_resume)
    if cfg.get("do_eval", True) and not args.debug:
        trainer.evaluate_full(out_dir=eval_dir)
    return trainer


def main(argv=None):
    parser = argparse.ArgumentParser(description="sparf_tpu_torch training")
    parser.add_argument("train_module", help="e.g. joint_pose_nerf_training/synthetic")
    parser.add_argument("train_name", help="e.g. sparf | barf | nerf")
    parser.add_argument("--scene", required=True)
    parser.add_argument("--train_sub", type=int, default=None)
    parser.add_argument("--data_root", default="")
    parser.add_argument("--dtu_mask_root", default=None)
    parser.add_argument("--dtu_depth_root", default=None)
    parser.add_argument("--workspace_dir", default="./workspace")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--debug", type=lambda x: str(x).lower() in ("1", "true"), default=False)
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' fails when no GPU is present")
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument("--render_video_only", action="store_true")
    parser.add_argument("--test_metrics_only", action="store_true")
    args, extra = parser.parse_known_args(argv)
    try:
        return run_training(args, extra)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
