"""Synthetic datasets (generated from a seed; nothing is downloaded).

A copy of ``repro/data/synthetic.py`` (numpy only): the port imports nothing of
the JAX package.

* ``synthetic_image_dataset`` — class-prototype + noise image classification
  sets standing in for Fashion-MNIST (28x28x1), CIFAR-10 / SVHN (32x32x3).
  Labels are real (prototype index) so federated non-IID label skew via the
  Dirichlet partitioner is meaningful and accuracy is a real signal.
* ``synthetic_tokens`` — Zipf-distributed token streams with a per-client
  topic bias (non-IID for language models).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


_SHAPES = {
    "fashion_mnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "svhn": (32, 32, 3),
}


def synthetic_image_dataset(name: str, n: int, n_classes: int = 10,
                            seed: int = 0, noise: float = 0.35
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (n, H, W, C) float32 in [0,1]-ish, labels (n,))."""
    h, w, c = _SHAPES[name]
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.5, 0.25, size=(n_classes, h, w, c))
    # low-frequency structure so convs have something to learn
    for k in range(n_classes):
        yy, xx = np.mgrid[0:h, 0:w]
        wave = np.sin(2 * np.pi * (k + 1) * xx / w) * \
            np.cos(2 * np.pi * (k % 3 + 1) * yy / h)
        protos[k, :, :, 0] += 0.3 * wave
    labels = rng.integers(0, n_classes, size=n)
    imgs = protos[labels] + noise * rng.normal(size=(n, h, w, c))
    return imgs.astype(np.float32), labels.astype(np.int32)


def synthetic_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0,
                     topic: int = 0, n_topics: int = 8) -> np.ndarray:
    """Zipf tokens with a topic-dependent permutation of the vocabulary —
    different topics => shifted unigram distributions (non-IID clients)."""
    rng = np.random.default_rng(seed + 7919 * topic)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    perm = np.random.default_rng(topic).permutation(vocab)
    toks = rng.choice(vocab, size=(n_seqs, seq_len), p=p)
    return perm[toks].astype(np.int32)


def synthetic_frontend_embeds(n: int, tokens: int, d_model: int,
                              seed: int = 0) -> np.ndarray:
    """Precomputed patch/frame embeddings for stubbed VLM/audio frontends."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.02, size=(n, tokens, d_model))
            .astype(np.float32))
