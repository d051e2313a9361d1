"""Where a training step takes its random numbers from.

The JAX package splits PRNG keys inside its jitted step. The port consumes
draws in program order from one object instead: `Draws` wraps a seeded
torch.Generator on the training device; `ReplayDraws` hands out given arrays
in order, which lets a test feed the JAX step and the port the same numbers;
`KeyedDraws` hands out numbers by the request's kind and shape, which lets
two programs that take the same draws in another order (the merged and the
per-bundle render) get the same numbers per request.
"""
from __future__ import annotations

import zlib
from collections import defaultdict
from typing import Iterable, Sequence

import numpy as np
import torch


class Draws:
    """Uniform, integer and normal draws from a seeded generator on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """float32 in [0, 1)."""
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        """int64 in [low, high)."""
        return torch.randint(int(low), int(high), tuple(shape), generator=self.generator,
                             device=self.device)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)


class ReplayDraws:
    """Returns the given arrays one per request, in order; a request whose shape
    differs from the next array's raises, so a reordered program is caught."""

    def __init__(self, arrays: Iterable[np.ndarray], device="cpu"):
        self.arrays = [np.asarray(a) for a in arrays]
        self.device = torch.device(device)

    def _next(self, shape: Sequence[int], dtype) -> torch.Tensor:
        if not self.arrays:
            raise IndexError("ReplayDraws: no draws left")
        a = self.arrays.pop(0)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"ReplayDraws: next draw has shape {a.shape}, asked for {tuple(shape)}")
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return self._next(shape, torch.float32)

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        return self._next(shape, torch.int64)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return self._next(shape, torch.float32)


class KeyedDraws:
    """Draws whose numbers depend only on the request's kind and shape (and
    range) and on how many requests of that key came before: two programs
    that request the same draws, interleaved differently across keys, get
    the same numbers per request."""

    def __init__(self, seed: int, device="cpu"):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.count = defaultdict(int)

    def _rng(self, key) -> np.random.RandomState:
        n = self.count[key]
        self.count[key] += 1
        return np.random.RandomState((zlib.crc32(repr(key).encode()) + 7919 * n + self.seed)
                                     % 2**32)

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        a = self._rng(("u", shape)).uniform(size=shape).astype(np.float32)
        return torch.as_tensor(a, device=self.device)

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        a = self._rng(("i", shape, int(low), int(high))).randint(int(low), int(high), size=shape)
        return torch.as_tensor(a, dtype=torch.int64, device=self.device)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        a = self._rng(("n", shape)).standard_normal(shape).astype(np.float32)
        return torch.as_tensor(a, device=self.device)
