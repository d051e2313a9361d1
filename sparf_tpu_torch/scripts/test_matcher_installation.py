#!/usr/bin/env python
"""Matcher sanity check of the port (the counterpart of
scripts/test_matcher_installation.py): renders two synthetic views, runs the
configured matcher and writes a panel of matches and the confidence map as
a PNG, for comparison by eye.

    python -m sparf_tpu_torch.scripts.test_matcher_installation [--backend zncc|pdcnet_jax]
        [--out test_matcher.png] [--device cuda|cpu] [--size HxW]

The panel is drawn with utils/vis.py (plot_matches, colorize) and written
with utils/imgproc.write_png: no OpenCV, imageio or PIL.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--backend", default="zncc")
    parser.add_argument("--out", default="test_matcher.png")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", default="120x160", help="HxW of the rendered views")
    args = parser.parse_args(argv)

    import numpy as np

    from sparf_tpu_torch.datasets.synthetic import load_synthetic_scene
    from sparf_tpu_torch.models import flow_net
    from sparf_tpu_torch.utils import imgproc, vis

    H, W = (int(v) for v in args.size.split("x"))
    scene = load_synthetic_scene(split="train", H=H, W=W, n_train=3, n_test=1)
    combi = np.array([[0], [1]], np.int32)
    wrapper = flow_net.FlowSelectionWrapper(backend=args.backend, adapt_steps=200,
                                            device=args.device)
    corres, conf = wrapper.compute_flow_and_confidence_map_of_combi_list(scene, combi)
    corres, conf = np.asarray(corres), np.asarray(conf)

    img_t = scene["image"][0].transpose(1, 2, 0)
    img_s = scene["image"][1].transpose(1, 2, 0)
    mask = conf[0, 0] > 0.95
    ys, xs = np.where(mask)
    sel = np.random.RandomState(0).permutation(len(ys))[:80]
    kp_t = np.stack([xs[sel], ys[sel]], -1).astype(np.float32)
    kp_s = corres[0][:, ys[sel], xs[sel]].T

    panel_matches = vis.plot_matches(img_t, img_s, kp_t, kp_s)
    panel_conf = vis.colorize(conf[0, 0], 0.0, 1.0)
    rows = panel_matches.shape[0]
    panel_conf = imgproc.resize_linear(
        panel_conf, (rows, int(round(panel_conf.shape[1] * rows / panel_conf.shape[0]))))
    panel = np.concatenate([panel_matches, panel_conf], axis=1)
    imgproc.write_png(args.out, np.clip(panel, 0.0, 1.0))
    n_conf = int(mask.sum())
    print(f"backend={args.backend}: {n_conf} confident matches; wrote {args.out}")
    if n_conf < 100:
        print("WARNING: very few confident matches - check the matcher setup")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
