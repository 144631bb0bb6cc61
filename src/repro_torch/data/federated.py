"""Federated partitioning + batch iteration.

A copy of ``repro/data/federated.py`` (numpy only): the port imports nothing of
the JAX package.

Non-IID: Dirichlet label-skew split (concentration theta), the protocol of
Yurochkin et al. / Wang et al. used by the paper (theta = 0.1 in Sec. VII).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, theta: float,
                        seed: int = 0) -> List[np.ndarray]:
    """Split example indices across clients with Dirichlet(theta) label
    proportions.  Lower theta => more skew.  Every client gets >= 1 item."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        props = rng.dirichlet([theta] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cl, part in enumerate(np.split(idx, cuts)):
            client_idx[cl].extend(part.tolist())
    # guarantee non-empty clients
    all_idx = np.arange(len(labels))
    for cl in range(n_clients):
        if not client_idx[cl]:
            client_idx[cl].append(int(rng.choice(all_idx)))
        rng.shuffle(client_idx[cl])
    return [np.asarray(ix, dtype=np.int64) for ix in client_idx]


def iid_partition(n: int, n_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.asarray(p, dtype=np.int64)
            for p in np.array_split(perm, n_clients)]


def client_batches(arrays: Sequence[np.ndarray], parts: List[np.ndarray],
                   batch_size: int, seed: int = 0):
    """One client-major batch per call: returns a pytree-compatible tuple of
    stacked arrays with leading dim (n_clients, batch_size, ...).  Clients
    with fewer than batch_size examples sample with replacement (the paper's
    D~_n minibatch)."""
    rng = np.random.default_rng(seed)
    picks = []
    for part in parts:
        replace = len(part) < batch_size
        picks.append(rng.choice(part, size=batch_size, replace=replace))
    picks = np.stack(picks)                       # (C, B)
    return tuple(np.stack([a[p] for p in picks]) for a in arrays), \
        np.asarray([len(p) for p in parts], np.float32)
