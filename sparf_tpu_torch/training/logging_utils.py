"""Meters, summary board, logger, TB writer.

Parity with reference engine/: SummaryBoard windowed means with pose errors
reported as .last() and _max_ keys as max (summary_board.py:113-124),
AverageMeter (average_meter.py:19-60), Logger (logger.py:22-71),
Timer (timer.py:20-95).
"""
from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque
from typing import Dict, Optional


class AverageMeter:
    def __init__(self, last_n: Optional[int] = None):
        self._records = deque(maxlen=last_n)
        self._total = 0.0
        self._count = 0

    def update(self, result: float):
        self._records.append(float(result))
        self._total += float(result)
        self._count += 1

    def reset(self):
        self._records.clear()
        self._total = 0.0
        self._count = 0

    def sum(self) -> float:
        return sum(self._records)

    def mean(self) -> float:
        return sum(self._records) / max(len(self._records), 1)

    def avg(self) -> float:
        return self.mean()

    def last(self) -> float:
        return self._records[-1] if self._records else 0.0

    def max(self) -> float:
        return max(self._records) if self._records else 0.0


class SummaryBoard:
    """Auto-registering windowed meters (summary_board.py:23-124)."""

    def __init__(self, last_n: Optional[int] = None, adaptive: bool = True):
        self.meters: Dict[str, AverageMeter] = {}
        self.last_n = last_n
        self.adaptive = adaptive

    def register_meter(self, name: str):
        self.meters[name] = AverageMeter(self.last_n)

    def update(self, name: str, value: float):
        if name not in self.meters:
            if not self.adaptive:
                raise KeyError(name)
            self.register_meter(name)
        self.meters[name].update(value)

    def update_from_dict(self, results: Dict[str, float]):
        for k, v in results.items():
            try:
                self.update(k, float(v))
            except (TypeError, ValueError):
                pass

    def summary(self) -> Dict[str, float]:
        out = {}
        for name, meter in self.meters.items():
            if "error_R" in name or "error_t" in name:
                out[name] = meter.last()  # pose errors: latest value
            elif "_max_" in name:
                out[name] = meter.max()
            else:
                out[name] = meter.mean()
        return out


class Timer:
    """prepare/process split timer (timer.py:20-61)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._last = time.time()
        self.prepare_time = 0.0
        self.process_time = 0.0
        self._count_prepare = 0
        self._count_process = 0

    def add_prepare_time(self):
        now = time.time()
        self.prepare_time += now - self._last
        self._count_prepare += 1
        self._last = now

    def add_process_time(self):
        now = time.time()
        self.process_time += now - self._last
        self._count_process += 1
        self._last = now

    def get_prepare_time(self) -> float:
        return self.prepare_time / max(self._count_prepare, 1)

    def get_process_time(self) -> float:
        return self.process_time / max(self._count_process, 1)


def create_logger(log_file: Optional[str] = None, name: str = "sparf_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s", "%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setLevel(logging.INFO)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class TensorboardWriter:
    """Thin tensorboardX wrapper; no-op when tensorboardX is unavailable."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter

                os.makedirs(log_dir, exist_ok=True)
                self.writer = SummaryWriter(log_dir)
            except ImportError:
                pass

    def write_event(self, split: str, results: Dict[str, float], step: int):
        if self.writer is None:
            return
        for name, value in results.items():
            try:
                self.writer.add_scalar(f"{split}/{name}", float(value), step)
            except (TypeError, ValueError):
                pass

    def write_image(self, split: str, images: Dict, step: int):
        """(H, W, 3) float [0, 1] images as image summaries. The PNG is encoded
        by utils/imgproc.encode_png and the summary added through
        tensorboardX's protobuf: its add_image encodes with PIL, which the
        port does not use."""
        if self.writer is None:
            return
        from tensorboardX.proto.summary_pb2 import Summary

        from sparf_tpu_torch.utils.imgproc import encode_png

        for name, img in images.items():
            H, W = img.shape[:2]
            image = Summary.Image(height=H, width=W, colorspace=3,
                                  encoded_image_string=encode_png(img))
            self.writer._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=f"{split}/{name}", image=image)]), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()
