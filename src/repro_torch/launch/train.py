"""FL training driver of the port: a model of the zoo (dense, MoE, MLA or
Mamba-2 decoders, Whisper's encoder-decoder, the VLM's stub frontend;
``--arch`` any name of the zoo) under a
FedAdam algorithm, in synchronous rounds or buffered-async under client
churn.

Counterpart of ``repro/launch/train.py``.  Runs on the CUDA card (the
default; the compress, the wire and, with ``--kernel-adam``, the local
Adam go through the hand-written kernels) or on the CPU with ``--device
cpu``, where each kernel wrapper runs its plain version:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch starcoder2-3b --smoke --rounds 2 --device cpu \\
        --kernel-adam --threshold-topk [--algorithm fedadam_top] \\
        [--client-mode vmap --aggregate sparse_gather]

(``--arch deepseek-v2-lite-16b`` or ``mamba2-1-3b`` runs the MoE + MLA or
the SSD model the same way.)

``--algorithm`` takes any registered compressor: ``fedadam_ssm`` (the
default; one shared mask) or ``fedadam_top`` (three independent masks,
the paper's baseline), among others.  ``--client-mode vmap`` stacks the
clients' outputs and aggregates them with ``--aggregate`` (``dense``, or
``sparse_gather``: the clients' wire payloads, decoded by the server).

``--async-buffer K`` switches to the buffered-async driver (one
virtual-clock simulation of ``--rounds`` server steps, K updates each)
under seeded churn, and ``--checkpoint PATH`` saves the final FedState
(an npz that the JAX package's ``load_fed_state`` reads too):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch starcoder2-3b --smoke --rounds 2 --device cpu \\
        --async-buffer 2 --churn-drop-prob 0.3 --checkpoint /tmp/ck

ends in a line ``[train] async: N server steps, X landed / Y dropped /
Z discarded, total uplink=... MB (...s)`` and ``[train] saved /tmp/ck``;
the total uplink is exactly X times a client's payload.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import save_fed_state
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (AsyncConfig, FedConfig, fed_init,
                              make_async_round, make_fl_round)
from repro_torch.core.compressors import make_compressor
from repro_torch.core.compressors import available as available_algorithms
from repro_torch.data import (ChurnConfig, ChurnModel,
                              synthetic_frontend_embeds, synthetic_tokens)
from repro_torch.device import DeviceLike, exact_float32, resolve_device
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim import AdamHyper


def build_client_batches(cfg, n_clients, batch_size, seq_len, *, seed=0,
                         non_iid=True, device: DeviceLike = None):
    """``{"tokens": (C, B, S) int32}`` on ``device``: Zipf tokens with a
    topic per client (non-IID), from the seed; for a stub frontend also
    ``"embeds": (C, B, n_front, d)`` float32, the precomputed frame (the
    encoder's src_len) or patch (at most 16) embeddings, client c's from
    seed + c, as the JAX package's trainer makes them."""
    dev = resolve_device(device)
    toks = np.stack([
        synthetic_tokens(batch_size, seq_len, cfg.vocab_size, seed=seed,
                         topic=(c if non_iid else 0))
        for c in range(n_clients)])
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if cfg.stub_frontend:
        n_front = cfg.encoder.src_len if cfg.encoder is not None else \
            min(cfg.stub_frontend_tokens, 16)
        emb = np.stack([
            synthetic_frontend_embeds(batch_size, n_front, cfg.d_model,
                                      seed=seed + c)
            for c in range(n_clients)])
        batch["embeds"] = torch.from_numpy(emb).to(dev)
    return batch


def make_trainer(cfg, fed: FedConfig, *, seed: int = 0,
                 device: DeviceLike = None, acfg: Optional[AsyncConfig] = None,
                 churn: Optional[ChurnModel] = None):
    """``(round_fn, state)`` of ``cfg`` under ``fed`` on ``device``, from
    random weights made from ``seed``; with ``acfg``, the buffered-async
    driver under ``churn`` in place of the round.  Turns TF32 off
    (:func:`repro_torch.device.exact_float32`)."""
    dev = resolve_device(device)
    exact_float32()
    params = init_params(cfg, seed=seed, device=dev)

    def loss(p, batch):
        return loss_fn(cfg, p, batch["tokens"],
                       frontend_embeds=batch.get("embeds"), remat="none")

    run = make_fl_round(fed, loss) if acfg is None else \
        make_async_round(fed, loss, acfg, churn=churn)
    return run, fed_init(fed, params)


def main(argv: Optional[list] = None):
    """Run the command line ``argv``; returns the final ``(state,
    metrics)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--algorithm", default="fedadam_ssm",
                    choices=available_algorithms())
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-epochs", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--kernel-adam", action="store_true",
                    help="local Adam through the fused_adam kernel")
    ap.add_argument("--threshold-topk", action="store_true",
                    help="O(d) threshold masks instead of exact top-k")
    ap.add_argument("--sparsify-backend", default="auto",
                    choices=("auto", "kernel", "reference"),
                    help="threshold-mask implementation (auto: the kernels "
                         "on the card, the bisection reference on the CPU)")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients sampled per round (sync: "
                         "weight masking; async: dispatch pool)")
    ap.add_argument("--client-mode", default="scan", choices=("scan", "vmap"))
    ap.add_argument("--aggregate", default="dense",
                    choices=("dense", "sparse_gather"),
                    help="the vmap round's transport")
    # buffered-async mode: K > 0 switches the driver
    ap.add_argument("--async-buffer", type=int, default=0, metavar="K",
                    help="server buffer size; 0 = synchronous round")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="discard updates staler than this at arrival")
    ap.add_argument("--staleness-power", type=float, default=0.5,
                    help="aggregation weight (1+s)**-power")
    ap.add_argument("--churn-seed", type=int, default=0)
    ap.add_argument("--churn-jitter", type=int, default=0)
    ap.add_argument("--churn-straggler-prob", type=float, default=0.0)
    ap.add_argument("--churn-drop-prob", type=float, default=0.0)
    ap.add_argument("--checkpoint", default=None,
                    help="save the final FedState here (npz)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    fed = FedConfig(
        algorithm=args.algorithm, alpha=args.alpha,
        local_epochs=args.local_epochs, n_clients=args.clients,
        adam=AdamHyper(lr=args.lr), client_mode=args.client_mode,
        aggregate=args.aggregate, use_kernel_adam=args.kernel_adam,
        exact_topk=not args.threshold_topk,
        sparsify_backend=args.sparsify_backend,
        participation=args.participation)
    comp = make_compressor(fed)
    acfg = churn = None
    if args.async_buffer > 0:
        churn = ChurnModel(
            ChurnConfig(seed=args.churn_seed, jitter=args.churn_jitter,
                        straggler_prob=args.churn_straggler_prob,
                        drop_prob=args.churn_drop_prob),
            args.clients)
        acfg = AsyncConfig(buffer_size=args.async_buffer,
                           max_staleness=args.max_staleness,
                           staleness_power=args.staleness_power)
    round_fn, state = make_trainer(cfg, fed, device=dev, acfg=acfg,
                                   churn=churn)
    n_params = sum(x.numel() for x in T.leaves(state.W))
    print(f"[train] {cfg.name}: {n_params/1e6:.2f}M params, "
          f"{args.clients} clients, L={args.local_epochs}, "
          f"alpha={args.alpha}, algo={args.algorithm} "
          f"(transport={comp.transport}, "
          f"{comp.bits_per_client(n_params)/8e6:.2f} MB/client/round), "
          f"device: {dev}")
    if acfg is not None:
        # one virtual-clock simulation covers every server step; clients
        # train on the same per-client shards at every dispatch
        batch = build_client_batches(cfg, args.clients, args.batch,
                                     args.seq, non_iid=not args.iid,
                                     device=dev)
        t0 = time.time()
        state, mets = round_fn(state, batch, rounds=args.rounds)
        for r, (loss_v, bits) in enumerate(zip(mets["loss_per_step"],
                                               mets["bits_per_step"])):
            print(f"[round {r:3d}] loss={loss_v:.4f} "
                  f"uplink={bits/8e6:.2f} MB")
        print(f"[train] async: {mets['server_steps']} server steps, "
              f"{mets['landed']} landed / {mets['dropped']} dropped / "
              f"{mets['discarded']} discarded, "
              f"total uplink={float(mets['uplink_bits'])/8e6:.2f} MB "
              f"({time.time()-t0:.1f}s)")
    else:
        for r in range(args.rounds):
            batch = build_client_batches(cfg, args.clients, args.batch,
                                         args.seq, seed=r,
                                         non_iid=not args.iid, device=dev)
            t0 = time.time()
            state, mets = round_fn(state, batch)
            loss_v = float(mets["loss"].mean())
            bits = float(mets["uplink_bits"])
            print(f"[round {r:3d}] loss={loss_v:.4f} "
                  f"uplink={bits/8e6:.2f} MB  ({time.time()-t0:.1f}s)")
    if args.checkpoint:
        save_fed_state(state, args.checkpoint,
                       meta=dict(arch=cfg.name, algorithm=args.algorithm,
                                 rounds=args.rounds))
        print(f"[train] saved {args.checkpoint}")
    return state, mets


if __name__ == "__main__":
    main()
