# Copied from src/repro/data/synthetic.py; imports rebound to repro_torch.
"""Deterministic synthetic datasets (the container is offline).

The paper evaluates on MNIST, CIFAR-10 and DeepGlobe.  We generate
*class-structured* synthetic stand-ins with the same shapes so that
non-IID federation effects (the thing FedLEO's aggregation must survive)
are faithfully reproduced: each class is a distinct distribution
(class-specific frequency/phase patterns + noise), so a model trained on
classes {0..3} genuinely fails on classes {4..9} until aggregation mixes
knowledge across orbits.

  * ``mnist-like``   : (28, 28, 1) grayscale, 10 classes
  * ``cifar10-like`` : (32, 32, 3) color, 10 classes
  * ``deepglobe-like``: (64, 64, 3) images + (64, 64) binary road masks
  * token streams for the assigned-architecture smoke tests
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    x: np.ndarray          # features, (N, ...) float32
    y: np.ndarray          # labels, (N,) int32 or (N, H, W) masks
    num_classes: int
    name: str = "synthetic"

    def __len__(self) -> int:
        return self.x.shape[0]

    def subset(self, idx: np.ndarray) -> "Dataset":
        return Dataset(
            x=self.x[idx], y=self.y[idx], num_classes=self.num_classes,
            name=self.name,
        )


def _class_pattern(
    rng: np.random.Generator, num_classes: int, shape: Tuple[int, ...]
) -> np.ndarray:
    """Per-class base pattern: smooth low-frequency fields, one per class."""
    h, w = shape[0], shape[1]
    c = shape[2] if len(shape) == 3 else 1
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    patterns = np.zeros((num_classes, h, w, c), np.float32)
    for k in range(num_classes):
        for ch in range(c):
            fx, fy = rng.uniform(1.0, 5.0, size=2)
            px, py = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(0.6, 1.0)
            patterns[k, :, :, ch] = amp * (
                np.sin(2 * np.pi * fx * xx + px) * np.cos(2 * np.pi * fy * yy + py)
            )
    return patterns


def make_classification_dataset(
    kind: str = "mnist-like",
    num_samples: int = 2048,
    num_classes: int = 10,
    seed: int = 0,
    noise: float = 0.35,
    pattern_seed: int = 1234,
) -> Dataset:
    """Class-structured image classification data.

    ``pattern_seed`` fixes the class-defining distributions (the "world");
    ``seed`` varies the drawn samples — so train/test splits built with
    different ``seed`` values are IID draws from the *same* task.
    """
    if kind == "mnist-like":
        shape: Tuple[int, ...] = (28, 28, 1)
    elif kind == "cifar10-like":
        shape = (32, 32, 3)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    pattern_rng = np.random.default_rng(pattern_seed + hash(kind) % 1000)
    patterns = _class_pattern(pattern_rng, num_classes, shape)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
    x = patterns[y] + noise * rng.standard_normal(
        (num_samples,) + patterns.shape[1:]
    ).astype(np.float32)
    return Dataset(x=x.astype(np.float32), y=y, num_classes=num_classes, name=kind)


def make_segmentation_dataset(
    num_samples: int = 256,
    size: int = 64,
    seed: int = 0,
    noise: float = 0.25,
) -> Dataset:
    """DeepGlobe-like road-extraction data: images with synthetic road masks.

    Roads are random piecewise-linear strips; the image channels carry the
    road signature plus textured background, so a U-Net can genuinely
    learn pixel-wise extraction.
    """
    rng = np.random.default_rng(seed)
    xs = np.zeros((num_samples, size, size, 3), np.float32)
    ys = np.zeros((num_samples, size, size), np.int32)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    for i in range(num_samples):
        mask = np.zeros((size, size), bool)
        for _ in range(rng.integers(1, 4)):
            # random line: a*x + b*y = c, thickness w
            theta = rng.uniform(0, np.pi)
            a, b = np.cos(theta), np.sin(theta)
            c = rng.uniform(0.2, 0.8) * size * (a + b)
            width = rng.uniform(1.0, 3.0)
            mask |= np.abs(a * xx + b * yy - c) < width
        bg = 0.3 * rng.standard_normal((size, size, 3))
        img = bg.copy()
        img[mask] += np.array([0.9, 0.85, 0.8])  # road signature
        img += noise * rng.standard_normal((size, size, 3))
        xs[i] = img
        ys[i] = mask.astype(np.int32)
    return Dataset(x=xs, y=ys, num_classes=2, name="deepglobe-like")


def make_token_dataset(
    num_sequences: int = 64,
    seq_len: int = 128,
    vocab_size: int = 1024,
    seed: int = 0,
    pattern_seed: int = 1234,
) -> Dataset:
    """Markov-ish synthetic token streams for LM smoke tests."""
    # chain parameters fixed by pattern_seed; sampling varies with seed
    chain_rng = np.random.default_rng(pattern_seed)
    rng = np.random.default_rng(seed)
    # sticky-state Markov chain so there is actual structure to learn
    num_states = 8
    trans = chain_rng.dirichlet(np.ones(num_states) * 0.3, size=num_states)
    emit = chain_rng.dirichlet(np.ones(vocab_size) * 0.05, size=num_states)
    toks = np.zeros((num_sequences, seq_len), np.int32)
    for i in range(num_sequences):
        s = rng.integers(0, num_states)
        for t in range(seq_len):
            toks[i, t] = rng.choice(vocab_size, p=emit[s])
            s = rng.choice(num_states, p=trans[s])
    return Dataset(
        x=toks, y=toks, num_classes=vocab_size, name="tokens"
    )
