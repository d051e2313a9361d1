"""sparf_tpu_torch: the PyTorch + CUDA port of sparf_tpu (SPARF joint pose+NeRF
optimization) for NVIDIA Hopper GPUs.

The JAX package `sparf_tpu` stays the reference; every module here keeps the
name of its counterpart there. This package imports torch and never JAX,
never the JAX package and never OpenCV: it keeps its own copies of the host
modules it needs (configs, dataset registry and loaders, pose alignment,
logging utilities, admin) and its own image operations (utils/imgproc).

Layers, from the entry point down:
  run_trainval.py -> training/{define_trainer, joint_trainer, trainer, engine}
  -> training/losses/{photometric, corres, depth_cons, ...}, training/sampling
  -> models/{renderer, pose_params, nerf_mlp, embedder}
  -> ops/fused_mlp (CUDA kernels K1/K2/K3 in csrc/fused_mlp.cu)
  -> utils/{camera, geometry, draws, precision}; datasets/.
The correspondence pools (training/losses/corres) come from the matcher facade
models/flow_net (PDC-Net in models/pdcnet, SPSG in models/sparse_matcher, the
ZNCC appearance stage, GT depth), verified with utils/imgproc's RANSAC.
"""

__version__ = "0.1.0"
