"""sparf_tpu_torch: the PyTorch + CUDA port of sparf_tpu (SPARF joint pose+NeRF
optimization) for NVIDIA Hopper GPUs.

The JAX package `sparf_tpu` stays the reference; every module here keeps the
name of its counterpart there. This package imports torch and never JAX; it
shares only the JAX package's host modules that import no JAX (configs,
dataset registry and base, pose alignment, logging utilities, admin).

Layers, from the entry point down:
  run_trainval.py -> training/{define_trainer, joint_trainer, trainer, engine}
  -> training/losses/{photometric, corres, depth_cons, ...}, training/sampling
  -> models/{renderer, pose_params, nerf_mlp, embedder, flow_net}
  -> ops/fused_mlp (CUDA kernels K1/K2 in csrc/fused_mlp.cu)
  -> utils/{camera, geometry, draws}; datasets/synthetic.
"""

__version__ = "0.1.0"
