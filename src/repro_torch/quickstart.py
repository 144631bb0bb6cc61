"""Quickstart: FedAdam-SSM against dense FedAdam on a federated image task,
through the port.

Counterpart of ``examples/quickstart.py``.  Runs on the CUDA card, where
FedAdam-SSM's compress goes through the hand-written kernels, or on the
CPU with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import FedConfig, fed_init, make_fl_round
from repro_torch.data import (client_batches, dirichlet_partition,
                              synthetic_image_dataset)
from repro_torch.device import resolve_device
from repro_torch.models.vision import build_vision
from repro_torch.optim import AdamHyper


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params, _, loss_fn, acc_fn, ds = build_vision(
        "cnn", width=args.width, seed=args.seed, device=dev)
    d = sum(x.numel() for x in params.values())
    print(f"model: CNN ({d / 1e3:.0f}k params), dataset: synthetic {ds}, "
          f"device: {dev}")

    imgs, labels = synthetic_image_dataset(ds, 2048, seed=args.seed)
    parts = dirichlet_partition(labels[:1536], n_clients=args.clients,
                                theta=0.1, seed=args.seed)
    test = (torch.from_numpy(imgs[1536:]).to(dev),
            torch.from_numpy(labels[1536:]).to(dev))

    # the paper's FedAdam-SSM (threshold masks, error feedback), then dense
    # FedAdam (alpha = 1: the whole triple crosses the uplink)
    for algo, alpha in (("fedadam_ssm", 0.05), ("fedadam", 1.0)):
        fed = FedConfig(algorithm=algo, alpha=alpha, local_epochs=3,
                        n_clients=args.clients, adam=AdamHyper(lr=1e-3),
                        exact_topk=False, error_feedback=True)
        round_fn = make_fl_round(fed, loss_fn)
        state = fed_init(fed, params)
        print(f"\n== {algo} (alpha={alpha}) ==")
        total_mb = 0.0
        for r in range(args.rounds):
            (bx, by), w = client_batches([imgs[:1536], labels[:1536]], parts,
                                         32, seed=r)
            batch = (torch.from_numpy(bx).to(dev),
                     torch.from_numpy(by).to(dev))
            state, mets = round_fn(state, batch, torch.from_numpy(w).to(dev))
            total_mb += float(mets["uplink_bits"]) / 8e6
            with torch.no_grad():
                acc = float(acc_fn(state.W, test))
            print(f" round {r:2d} loss={float(mets['loss'].mean()):.4f} "
                  f"test_acc={acc:.3f} cum_uplink={total_mb:7.2f} MB")

if __name__ == "__main__":
    main()
