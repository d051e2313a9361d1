"""One run of one cell: build the port's trainer for the cell's
configuration, hand it weights and draws made from the seed, warm up, run
the window, and hold what the window's own path produced to the reference.

A cell is driven by data: its configuration file (benchmark/configs/), its
traffic file (benchmark/traffic/<traffic>.json, read by the one generator of
its `kind`), its limits (benchmark/limits/<cell>.json) and the metric
readers that BENCHMARK.json names (benchmark/metrics/<metric>.py).

Traffic kinds:
  - "train": consecutive iterations from `start_iteration`, as the trainer's
    loop makes them (`get_step(it)`, then `step(state, draws)`), closed
    loop. Set-up drives the first `checked_steps` of them through that same
    call on recorded draws; the reference then follows them from the same
    weights and draws.
  - "render": full frames back to back along the novel-view path
    (utils/video.novel_view_poses_w2c, `path_frames` poses, taken in turn)
    through `Trainer.render_full_image`, at `start_iteration`'s state. After
    the window the reference renders `checked_frames` of the frames the
    window rendered, drawn from the seed, the last one among them.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import random
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import counts
from benchmark import trace as trace_mod

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent


# --------------------------------------------------------------------------
# the cell's files
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _for_cell(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files under root/benchmark/."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / BENCH_DIR.name
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name))


def read_metric(name: str, record: Dict, root: Path = ROOT) -> Optional[float]:
    """The reader root/benchmark/metrics/<name>.py over the run's record."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", root / BENCH_DIR.name / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


# --------------------------------------------------------------------------
# inputs made from the seed
# --------------------------------------------------------------------------


def sub_seed(seed: int, k: int) -> int:
    """A generator seed for stream k of a run's seed (any whole number)."""
    return (int(seed) * 7919 + 104729 * k) % (2**63 - 1)


class SeedDraws:
    """The draws a training step asks for (uniform, randint, normal), from a
    torch.Generator on the device; `record` keeps what it hands out."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(sub_seed(seed, 1))
        self.log: Optional[List[Tuple[str, torch.Tensor]]] = None

    def _keep(self, kind: str, x: torch.Tensor) -> torch.Tensor:
        if self.log is not None:
            self.log.append((kind, x.clone()))
        return x

    def uniform(self, shape):
        return self._keep("u", torch.rand(tuple(shape), generator=self.generator,
                                          device=self.device))

    def randint(self, shape, low: int, high: int):
        return self._keep("i", torch.randint(int(low), int(high), tuple(shape),
                                             generator=self.generator, device=self.device))

    def normal(self, shape):
        return self._keep("n", torch.randn(tuple(shape), generator=self.generator,
                                           device=self.device))


class ReplayDraws:
    """Hands out recorded draws in order; a request of another kind or shape raises."""

    def __init__(self, log: List[Tuple[str, torch.Tensor]], device):
        self.log = [(k, x.to(device)) for k, x in log]

    def _next(self, kind: str, shape):
        if not self.log:
            raise RuntimeError("the reference asked for more draws than the program took")
        k, x = self.log.pop(0)
        if k != kind or tuple(x.shape) != tuple(shape):
            raise RuntimeError(f"the reference asked for {kind}{tuple(shape)}, "
                               f"the program took {k}{tuple(x.shape)}")
        return x

    def uniform(self, shape):
        return self._next("u", shape)

    def randint(self, shape, low: int, high: int):
        return self._next("i", shape)

    def normal(self, shape):
        return self._next("n", shape)


def make_weights(run: Dict, seed: int, device) -> Dict:
    """The coarse (and fine) MLP's parameters, from one generator on the
    device in one call: Xavier-uniform weights with ReLU gain (gain 1 for the
    density row and the last RGB layer), zero biases. W is (out, in)."""
    layers = counts.chain(run)
    n_trunk = len([w for w in run["arch.layers_feat"] if w is not None])
    nets = ["coarse", "fine"] if run["nerf.fine_sampling"] else ["coarse"]
    total = len(nets) * sum(i * o for i, o in layers)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    params, ofs = {}, 0
    for net in nets:
        feat, rgb = [], []
        for li, (k_in, k_out) in enumerate(layers):
            W = u[ofs: ofs + k_in * k_out].view(k_out, k_in).clone()
            ofs += k_in * k_out
            gains = torch.full((k_out, 1), math.sqrt(2.0), device=device)
            if li == n_trunk - 1:
                gains[0] = 1.0
                scale = torch.full((k_out, 1), math.sqrt(6.0 / (k_in + k_out - 1)), device=device)
                scale[0] = math.sqrt(6.0 / (k_in + 1))
            else:
                if li == len(layers) - 1:
                    gains[:] = 1.0
                scale = torch.full((k_out, 1), math.sqrt(6.0 / (k_in + k_out)), device=device)
            (feat if li < n_trunk else rgb).append((W * gains * scale,
                                                   torch.zeros(k_out, device=device)))
        params[net] = {"feat": feat, "rgb": rgb}
    return params


# --------------------------------------------------------------------------
# the program under test
# --------------------------------------------------------------------------


def _get(cfg, dotted: str):
    node = cfg
    for part in dotted.split("."):
        node = node.get(part) if hasattr(node, "get") else None
    return node


def _plain(x):
    return json.loads(json.dumps(x, default=list))


def build_trainer(config: Dict, device, dtype: Optional[str] = None):
    """The port's trainer for a configuration file; every key of its `run`
    section must read the same in the program's resolved configuration."""
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    module, name = config["preset"].rsplit("/", 1)
    overrides = json.loads(json.dumps(config["overrides"]))
    if dtype is not None:
        overrides.setdefault("tpu", {})["compute_dtype"] = dtype
    cfg = build_config(module, name, overrides)
    differ = [f"{k}: file {v!r}, program {_plain(_get(cfg, k))!r}"
              for k, v in config["run"].items() if k != "tpu.compute_dtype"
              and _plain(_get(cfg, k)) != v]
    if differ:
        raise RuntimeError("the program's configuration differs from the benchmark's: "
                           + "; ".join(differ))
    workspace = tempfile.mkdtemp(prefix="sparf_bench_")
    trainer = define_trainer(cfg, workspace=workspace, device=device, save_option=False)
    return trainer, workspace


def close_trainer(trainer, workspace: str) -> None:
    trainer.writer.close()
    shutil.rmtree(workspace, ignore_errors=True)


def _leaves(tree) -> List[torch.Tensor]:
    from sparf_tpu_torch.training import engine

    return engine.tree_leaves(tree)


def _cpu(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [x.detach().to("cpu", copy=True) for x in xs]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# runs
# --------------------------------------------------------------------------


class TrainRun:
    """kind "train": consecutive iterations of the trainer's step."""

    kind = "train"

    def __init__(self, cell: Cell, seed: int, device, dtype: Optional[str] = None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.run_cfg = cell.config["run"]
        self.dtype = dtype or self.run_cfg["tpu.compute_dtype"]
        self.it0 = int(cell.traffic["start_iteration"])

    def setup(self, trainer=None) -> None:
        """`trainer`: one built for this cell and dtype by an earlier run of the
        same process (the readings), whose initial state is still its own."""
        from sparf_tpu_torch.training import engine

        self.own = trainer is None
        self.trainer, self.workspace = (build_trainer(self.cell.config, self.device, self.dtype)
                                        if self.own else (trainer, None))
        tr = self.trainer
        self.weights = make_weights(self.run_cfg, self.seed, self.device)
        self.state = dataclasses.replace(
            tr.state, nerf_params=self.weights,
            opt_state_nerf=tr.tx_nerf.init(engine.tree_leaves(self.weights)),
            iteration=self.it0, iteration_nerf=self.it0)
        self.draws = SeedDraws(self.seed, self.device)
        self.p0 = _cpu(_leaves(self.weights) + _leaves(self.state.pose_params))
        self.weights_cpu = {k: {p: [(W.cpu(), b.cpu()) for W, b in v[p]] for p in v}
                            for k, v in self.weights.items()}
        # the checked steps: the window's own call and feed, on recorded draws
        self.draws.log, self.losses, self.g1 = [], [], None
        for k in range(int(self.cell.traffic["checked_steps"])):
            self.state, stats = self.step(self.state)
            self.losses.append(float(stats["all"]))
            if k == 0:
                self.g1 = _cpu(self.first_grads(self.state))
        self.change = [p - q for p, q in zip(_cpu(_leaves(self.state.nerf_params)
                                                  + _leaves(self.state.pose_params)), self.p0)]
        self.recorded, self.draws.log = self.draws.log, None
        self.nan0 = int(self.state.nan_count)
        _sync(self.device)

    def step(self, state):
        return self.trainer.get_step(state.iteration)(state, self.draws)

    @staticmethod
    def first_grads(state) -> List[torch.Tensor]:
        """The gradient Adam took at its first update, from its first moment."""
        mu = list(state.opt_state_nerf.mu)
        mu += list(state.opt_state_pose.mu) if state.opt_state_pose is not None else []
        return [m / (1 - 0.9) for m in mu]

    def window(self, seconds: float, trace: bool) -> Dict:
        from sparf_tpu_torch.ops import fused_mlp
        from torch.profiler import record_function

        n = 0
        fused_mlp.reset_launch_counts()
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            if trace:
                with record_function(trace_mod.STEP_RANGE):
                    self.state, _ = self.step(self.state)
            else:
                self.state, _ = self.step(self.state)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        window_s = time.perf_counter() - t0
        failed = int(self.state.nan_count) - self.nan0
        work = counts.step_work(self.run_cfg, int(self.state.iteration) - 1)
        return dict(units=n, window_s=window_s, attempted=n, failed=failed,
                    launches=fused_mlp.launch_counts(bf16=self.dtype == "bfloat16"),
                    work_per_unit=work)

    def release(self) -> None:
        if self.own:
            close_trainer(self.trainer, self.workspace)
        del self.trainer, self.state, self.weights
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> Dict:
        """The reference's losses, first gradients and parameter change over
        the checked steps, from the same weights and draws."""
        from benchmark.reference import scene as rs
        from benchmark.reference import step as rstep

        r = self.run_cfg
        scene = rs.synthetic_train_scene(r["synthetic.H"], r["synthetic.W"],
                                         r["synthetic.n_train"], r["synthetic.n_test"],
                                         r["increase_depth_range_by_x_percent"])
        pools = rs.gt_pools(scene, r["min_nbr_matches"])
        init = rs.initial_poses_w2c(r["camera.initial_pose"], scene["pose"],
                                    r["camera.noise"], r["seed"])
        ref = rstep.ReferenceTrainer(r, scene, pools, init, self.device)
        dev = self.device
        nerf = {k: {p: [(W.to(dev), b.to(dev)) for W, b in v[p]] for p in v}
                for k, v in self.weights_cpu.items()}
        pose = rstep.pose_embedding(ref.init_poses)
        p0 = rstep.leaves(nerf) + [pose]
        opt_n, opt_p = rstep.adam_init(rstep.leaves(nerf)), rstep.adam_init([pose])
        draws = ReplayDraws(self.recorded, dev)
        losses, g1 = [], None
        it = self.it0
        for k in range(len(self.losses)):
            nerf, opt_n, pose, opt_p, loss = ref.step(nerf, opt_n, pose, opt_p, it, it, draws)
            losses.append(float(loss))
            if k == 0:
                g1 = _cpu([m / (1 - 0.9) for m in opt_n.mu + opt_p.mu])
            it += 1
        change = [p - q for p, q in zip(_cpu(rstep.leaves(nerf) + [pose]), _cpu(p0))]
        return dict(losses=losses, g1=g1, change=change)

    def numbers(self) -> Dict[str, float]:
        ref = self.reference()
        return compare_steps(dict(losses=self.losses, g1=self.g1, change=self.change), ref)


def compare_steps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap: the relative gap of the first checked step's loss (the later
    steps' losses carry the rounding of the updates before them: PERF.md
    section 4). grad_gap: by the worst leaf, the gap between the program's and the
    reference's norm of the first gradient, over the larger of the
    reference leaf's norm and the median leaf's. change_gap: the same gap for
    the parameters' change over the checked steps, of the median leaf (by
    the worst leaf it is set by single elements of small leaves whose Adam
    update rounding moves: PERF.md section 4). Leaves whose reference
    gradient is under a thousandth of the median leaf's (nought to rounding)
    are left out."""
    loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    g_ref = [float(torch.linalg.norm(g)) for g in ref["g1"]]
    keep = [i for i, g in enumerate(g_ref) if g >= 1e-3 * float(np.median(g_ref))]

    def gaps(a: List[torch.Tensor], b: List[torch.Tensor]) -> List[float]:
        na = [float(torch.linalg.norm(x)) for x in a]
        nb = [float(torch.linalg.norm(x)) for x in b]
        med = float(np.median([nb[i] for i in keep]))
        return [abs(na[i] - nb[i]) / max(nb[i], med) for i in keep]

    return dict(loss_gap=loss_gap, grad_gap=max(gaps(prog["g1"], ref["g1"])),
                change_gap=float(np.median(gaps(prog["change"], ref["change"]))))


class RenderRun:
    """kind "render": full frames along the novel-view path."""

    kind = "render"
    KEYS = ("rgb", "depth", "rgb_fine", "depth_fine")

    def __init__(self, cell: Cell, seed: int, device, dtype: Optional[str] = None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.run_cfg = cell.config["run"]
        self.dtype = dtype or self.run_cfg["tpu.compute_dtype"]
        self.it0 = int(cell.traffic["start_iteration"])

    def setup(self, trainer=None) -> None:
        from sparf_tpu_torch.training import engine
        from sparf_tpu_torch.utils import video

        self.own = trainer is None
        self.trainer, self.workspace = (build_trainer(self.cell.config, self.device, self.dtype)
                                        if self.own else (trainer, None))
        tr = self.trainer
        weights = make_weights(self.run_cfg, self.seed, self.device)
        tr.state = dataclasses.replace(
            tr.state, nerf_params=weights,
            opt_state_nerf=tr.tx_nerf.init(engine.tree_leaves(weights)),
            iteration=self.it0, iteration_nerf=self.it0)
        self.weights_cpu = {k: {p: [(W.cpu(), b.cpu()) for W, b in v[p]] for p in v}
                            for k, v in weights.items()}
        self.poses = torch.as_tensor(
            video.novel_view_poses_w2c(tr, int(self.cell.traffic["path_frames"])),
            dtype=torch.float32, device=self.device)
        self.fine = tr.fine_enabled_at(self.it0)
        self.frames: List[Tuple[int, Dict[str, torch.Tensor]]] = []
        self.render(0)
        _sync(self.device)

    def render(self, i: int) -> Dict[str, torch.Tensor]:
        tr = self.trainer
        return tr.render_full_image(tr.train_scene, 0, self.poses[i % len(self.poses)][None],
                                    self.fine)

    def window(self, seconds: float, trace: bool) -> Dict:
        from sparf_tpu_torch.ops import fused_mlp
        from torch.profiler import record_function

        fused_mlp.reset_launch_counts()
        _sync(self.device)
        t0 = time.perf_counter()
        i = 0
        while True:
            if trace:
                with record_function(trace_mod.STEP_RANGE):
                    out = self.render(i)
            else:
                out = self.render(i)
            self.frames.append((i, {k: out[k] for k in self.KEYS if k in out}))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        window_s = time.perf_counter() - t0
        failed = sum(int(not all(torch.isfinite(v).all() for v in f.values()))
                     for _, f in self.frames)
        r = self.run_cfg
        return dict(units=i, window_s=window_s, attempted=i, failed=failed,
                    rays_per_unit=r["synthetic.H"] * r["synthetic.W"],
                    launches=fused_mlp.launch_counts(bf16=self.dtype == "bfloat16"),
                    work_per_unit=counts.frame_work(r, self.it0))

    def release(self) -> None:
        tr = self.trainer
        self.frames = [(i, {k: v.cpu() for k, v in f.items()}) for i, f in self.frames]
        self.poses = self.poses.cpu()
        if self.own:
            close_trainer(tr, self.workspace)
        del self.trainer, tr
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self) -> Dict[str, float]:
        """rgb_gap: the largest absolute gap of a colour channel, depth_gap
        the largest gap of a depth over the far bound, over every pixel of
        the checked frames, coarse and fine."""
        from benchmark.reference import nerf as rn
        from benchmark.reference import scene as rs

        r, dev = self.run_cfg, self.device
        n_check = min(int(self.cell.traffic["checked_frames"]), len(self.frames))
        rng = random.Random(sub_seed(self.seed, 3))
        picked = sorted(rng.sample(range(len(self.frames) - 1), n_check - 1)) + [
            len(self.frames) - 1]
        scene = rs.synthetic_train_scene(r["synthetic.H"], r["synthetic.W"],
                                         r["synthetic.n_train"], r["synthetic.n_test"],
                                         r["increase_depth_range_by_x_percent"])
        depth_range = rn.depth_range(r, scene, dev)
        intr = torch.as_tensor(scene["intr"][:1], device=dev)
        params = {k: {p: [(W.to(dev), b.to(dev)) for W, b in v[p]] for p in v}
                  for k, v in self.weights_cpu.items()}
        spec = rn.init_spec(r)
        far = float(depth_range[1])
        rgb_gap = depth_gap = 0.0
        for j in picked:
            i, got = self.frames[j]
            want = rn.render_image(params, spec, self.poses[i % len(self.poses)][None].to(dev),
                                   intr, r["synthetic.H"], r["synthetic.W"], depth_range,
                                   rn.progress(r, self.it0), self.fine,
                                   int(r["nerf.rand_rays"]))
            for k, v in want.items():
                gap = float(torch.max(torch.abs(got[k].to(dev) - v)))
                if k.startswith("rgb"):
                    rgb_gap = max(rgb_gap, gap)
                else:
                    depth_gap = max(depth_gap, gap / far)
        return dict(rgb_gap=rgb_gap, depth_gap=depth_gap)


RUNS = {"train": TrainRun, "render": RenderRun}


def new_run(cell: Cell, seed: int, device, dtype: Optional[str] = None):
    return RUNS[cell.traffic["kind"]](cell, seed, device, dtype)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """correct: every number is finite and within its limit."""
    check = {k: dict(value=float(numbers[k]), limit=float(limits[k])) for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())
    return ok, check


def run_once(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, dtype: Optional[str] = None) -> Dict:
    """One run: set-up, the window (traced or not), the check. Returns the
    record the metric readers take, with `correct` and `check`."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = new_run(cell, seed, device, dtype)
    run.setup()
    setup_s = time.perf_counter() - t_start
    if trace:
        from torch.profiler import ProfilerActivity, profile

        with trace_mod.mlp_ranges() as wrapped:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                win = run.window(seconds, True)
        win["trace"] = trace_mod.reduce(prof, win["window_s"], win["units"], wrapped)
        del prof
    else:
        win = run.window(seconds, False)
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.release()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    numbers = run.numbers()
    correct, check = judge(numbers, cell.limits)
    return dict(win, kind=run.kind, setup_s=setup_s, dtype=run.dtype,
                peak_flops=counts.PEAK_FLOPS[run.dtype], memory_peak_bytes=int(peak),
                numbers=numbers, correct=correct, check=check)


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, or "" without it."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""

