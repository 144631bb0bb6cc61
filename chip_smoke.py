#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and hold every kernel of
its main path against the kernel's plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout (it imports ``src/repro_torch``).
Phases:

1. device and build: the card's name and power limit, the kernels built
   from ``src/repro_torch/csrc`` (timed), cuDNN deterministic, no TF32;
2. the main path: FedAdam-SSM rounds of the paper's CNN at full width
   (alpha 0.05, threshold masks, error feedback, 20 clients, 3 local
   epochs, batch 32, Dirichlet 0.1 synthetic Fashion-MNIST), with the
   kernel launch counters zeroed just before and read just after, and
   the first client's wire payload measured on the card; then one more
   round under torch.profiler (device busy share, top kernels) and one
   that counts the stream synchronisations the host waits on; then one
   FedAdam-Top round of the same configuration (three independent masks
   through the packed compress, exact launches per client, the
   three-bitmap payload measured on the card), a profiled one and a
   sync-counting one;
3. each kernel against its plain version on the card, bitwise, on the
   inputs the first client's compress gave it and at VGG-11 width-1.0
   packed shapes, with times from CUDA events and the memory bound; the
   packed histogram and apply also on the FedAdam-Top client's inputs
   (dW ++ dM ++ dV in 3L segments, the single-stream apply with its
   residual over every row); their device time takes in every device
   operation of a call (one per histogram call, two per apply call, both
   checked), beside the grid and blocks per CTA of their launches and the
   device time of one empty launch (the card's floor);
4. one round on the card against the same round on the CPU (4 clients,
   same weights and batch), within the CPU parity tests' tolerances, for
   FedAdam-SSM and for FedAdam-Top;
5. the transformer path: 2 FedAdam-SSM rounds of starcoder2-3b at full
   width (d_model 3072, vocab 49152, bfloat16 with float32 norm scales)
   cut to 2 pattern repeats, 4 clients, 3 local epochs of the fused Adam,
   batch 2, sequence 128, threshold masks, error feedback, through
   ``repro_torch.launch.train``; the launch counters zeroed just before
   and read just after (exact counts per client and round), peak device
   memory and round wall times; then one round under torch.profiler and
   one that counts stream synchronisations, in which the first client's
   wire payload is measured and the kernels' inputs are kept for 6;
6. the per-leaf kernels (fused_adam, absmax, count_ge, ssm_apply_ef, and
   ssm_apply, which no path calls, on ssm_apply_ef's inputs) against
   their plain versions on the card, on the inputs the first client of
   that round gave them at the embed, w_up and norm leaf shapes (count_ge
   on both passes' candidates), with times; the device time of a call
   takes in every device operation the wrapper makes, and one absmax or
   count_ge call must be one; pack_words and unpack_words on that
   client's bitmap (493,895,680 slots); the host cost of the wrapper's
   steps at the norm leaf; then phase 5 again for FedAdam-Top on the
   same configuration (the per-leaf threshold masks of three deltas:
   absmax, two counts and apply_mask per leaf and delta; three bitmaps),
   its trainer built after phase 5's is freed, and apply_mask against its
   plain version on that round's inputs;
7. one round of the smoke starcoder2 on the card against the CPU, for
   FedAdam-SSM and for FedAdam-Top;
8. (run after phase 4) the CNN's dense and quantized baselines at full
   width, alpha 1.0: 3 rounds each of FedAdam, FedSGD and Efficient-Adam
   (8-bit codes, error feedback), and 1-bit Adam as the paper's runner
   drives it (2 dense FedAdam warm-up rounds, then 2 compressed rounds
   from their W, M and V); per round exact launches per client (one
   pack_words and one unpack_words a client for the quantized rounds, none
   for the dense ones), the first client's payload built on the card
   (``8 * bytes`` equal to the layout's wire bits; the dense round builds
   none, so ``pack_wire`` builds it from that client's deltas, and the
   round must not have called ``pack_dense``), wall time, peak memory,
   a profiled round and 0 stream syncs; then one round card vs CPU for
   Efficient-Adam and 1-bit Adam, each after a first round (1-bit Adam's
   a dense FedAdam warm-up on each side; Efficient-Adam's its own, on the
   CPU, its state handed to both sides), with Efficient-Adam's per-client
   moments compared beside W, M and V;
9. (after 8) the exact top-k masks on ties, card against CPU bitwise
   (float32 and bfloat16; a blocked leaf with a mostly zero, padded last
   block; three rows of a tied leaf of the embed's size, whose sort's
   wall time and peak memory are recorded), and one FedAdam-SSM CNN round
   with exact masks card vs CPU;
10. (after 6) starcoder2-3b at phase 5's configuration under
   Efficient-Adam (2 rounds, the fused local Adam on persistent moments)
   and 1-bit Adam (1 dense FedAdam warm-up round, then 1 compressed
   round): exact launches per client, 0 syncs, payload bytes, wall times
   and peaks; pack_words and unpack_words against their plain versions on
   the client's 8-bit codes and sign plane; ``pack_dense`` timed on the
   warm-up client's deltas;
11. (after 9) the round's drivers on phase 2's CNN configuration: a round
   with participation 0.5 (the JAX round's client draw; 10 clients
   billed), a vmap round with the wire transport bitwise the scan round,
   a vmap round with the dense transport within the summation bound, the
   buffered-async driver with zero churn and K = 20 bitwise the scan
   round, then under churn (K 5, jitter 3, stragglers 0.1, drops 0.2, max
   staleness 2, 4 server steps): the landed payloads billed exactly,
   dropped and discarded clients' residuals as their last accepted update
   left them, a bitwise replay from the seed, and its state through the
   checkpoint, loaded on the CPU, bitwise; walls, peaks, launches per
   client or dispatch and stream syncs (0 for a round, exactly 1 for an
   async run); the four kernels against their plain versions, bitwise,
   on the first inputs the churned run gave them;
12. (after 10) starcoder2-3b at phase 5's width and cut: a vmap round with
   the wire transport bitwise the scan round from the same state, with
   its peak memory; then the async trainer's command line (``--async-
   buffer 2 --churn-jitter 2 --churn-drop-prob 0.25 --rounds 2
   --checkpoint``) in process: server steps, landed, dropped and
   discarded updates, uplink exactly the landed payloads, wall time and
   peak memory; the per-leaf kernels of the vmap round (fused_adam,
   absmax, count_ge's two passes, ssm_apply_ef) against their plain
   versions on its first inputs at w_up and a norm leaf;
13. (after 12) the MoE, MLA and Mamba-2 (SSD) layers at full width, each
   model built after the previous one is freed: deepseek-v2-lite-16b (MLA,
   64 routed experts top-6 and 2 shared; cut to 1 of 27 pattern repeats,
   the whole period, with its whole 102,400-row vocabulary: 1,002,051,584
   parameters in 17 leaves) and mamba2-1-3b (SSD, d_state 128, chunk 256,
   tied embeddings; cut to 8 of 48 repeats: 310,081,024 parameters in 11
   leaves), no width cut, each under phase 5's FedAdam-SSM at sequence 512
   (deepseek as vmap rounds with the wire transport, after one scan round
   tried on its own, whose peak or failed allocation is recorded) through
   ``train.make_trainer``: 2 rounds with finite losses, exact launches per
   client (fused_adam 3L, absmax L, count_ge 2L, ssm_apply_ef L,
   pack_words and unpack_words 1, L the leaves), the bill ``8 *
   payload_nbytes`` equal to the layout's wire bits, wall times, peak
   memory (reset before the model is built), a profiled round, 0 stream
   syncs, and a round from one state run twice bit for bit (else the
   leaves and gradients that differ are named); the per-leaf kernels
   against their plain versions on that round's first inputs at the new
   leaf kinds (deepseek's w_gate expert stack, 184,549,376 bfloat16
   elements, and its float32 router; mamba's in_proj and its float32
   a_log), pack_words and unpack_words on its bitmap; then one block of
   each (MLA + MoE; SSD) forward and backward in float32 at b = 1, s =
   512 on the card against the host's CPU, routing identical, outputs and
   gradients within ``ZOO_BLOCK_TOL``;
14. (after 13) serving, each model whole (every pattern repeat, the whole
   vocabulary) in bfloat16 and built after the previous one is freed:
   deepseek-v2-lite-16b (16,150,149,120 parameters), mamba2-1-3b,
   starcoder2-3b, llava-next-mistral-7b and whisper-base, through
   ``repro_torch.launch.serve``'s functions at the CLI's defaults (batch
   2, a 32-token prompt replayed through ``decode_step``, 16 greedy
   tokens; whisper's cross caches from ``prefill`` over its 1500 frames
   first, llava's prompt through ``prefill`` after its 16-token prefix):
   build time and peak (reset before the build), replay or prefill wall,
   decode wall and tokens/s, no kernel of the port launched, 0 stream
   syncs and bitwise the same tokens and logits in a second decode from
   the same cache state, one decode step profiled beside its byte bound,
   the peak; then, in float32 at full width, one decode step of an MLA +
   MoE, an SSD and a cross-attention block on the card against the CPU
   (routing identical, output and caches within ``ZOO_BLOCK_TOL``), and
   at 2 pattern repeats the teacher-forced decode against ``forward`` and
   a prefill-seeded continuation against the replay's, within
   ``SERVE_REL``;
15. (after 14) the multi-GPU spatial driver: (a) on a world-1 NCCL group,
   the CNN's client 0 at phase 2's configuration through the spatial round
   with the per-shard bitmap transport, against a 1-client scan round from
   the same state: bitwise except at the values the transport's per-leaf
   capacity drops into the residual (counted), launches per client
   (packed_hist 2, packed_apply 1, no word kernel), the bytes gathered
   against the bytes billed, 0 stream syncs; whether NCCL gathers uint32
   as it is; then deepseek-v2-lite-16b's spatial train step
   (``launch.steps.build_train_step``, its DeployPlan) at full width, the
   whole vocabulary, train_4k's sequence of 4096, the global batch cut to
   1 and the pattern repeats cut to the most of ``SPATIAL_REPEATS`` that
   fit the card (each that does not recorded): one round with remat
   "full" and one with "none" from the same state, bitwise, each with its
   peak, launches (absmax L, count_ge 2L, ssm_apply_ef L), the bill; the
   packed and per-leaf kernels against their plain versions on each
   path's first inputs; (b) 4 gloo processes with CUDA tensors sharing
   the card: the CNN's spatial round (C = 4) against the 4-client scan
   round, and the async driver under churn with the group's cohort
   bitwise the scan cohort;
16. (after 15) tensor parallelism on a model axis, gloo processes with
   CUDA tensors sharing the card (``launch.steps.build_train_step`` with
   the ``tp`` rules: each rank holds its shard of every leaf, the
   Megatron-split layers, the whole leaf's threshold, the per-shard
   transport): (a) 2 ranks, a (data 1, model 2) mesh: starcoder2-3b at
   full width (phase 5's cut and traffic), one FedAdam-SSM and one
   FedAdam-Top round in float32 with error feedback, each against the
   whole-leaf world-1 round from the same params and batch (W, M, V and
   the residual within ``TENSOR_TOL``/``TENSOR_ERR_TOL`` except where a
   support differs or a transport dropped a value, both counted; the
   bill equal), then one round in its bfloat16; launches per rank
   (absmax L, count_ge 2L, ssm_apply_ef L; FedAdam-Top absmax, count_ge
   and apply_mask for three masks), wall, peak per rank, the bytes the
   client group all-gathers and the model group reduces or gathers; the
   selection kernels and the applies bitwise their plain versions on the
   largest leaf's shard inputs, with times; then deepseek-v2-lite-16b at
   full width at the most of ``TENSOR_MOE_REPEATS`` that both ranks fit,
   one round against the whole-leaf round; (b) 4 ranks, a (data 2, model
   2) mesh: starcoder2-3b's FedAdam-SSM round through each client group's
   per-shard transport, against the world-2 whole-leaf round;
17. (after 16) the virtual clients and the FSDP leaves, 4 gloo processes
   with CUDA tensors sharing the card on a (data 2, model 2) mesh with no
   client axes (the ``fsdp`` rules: every leaf split over "model" by the
   tp rules and along its ``embed`` dim over "data", gathered over the
   data group at its use), each part run only where its predicted peaks
   fit ``FSDP_FIT`` of the card (every prediction recorded): (a) the
   ``DeployPlan(clients="virtual", train_params="fsdp", n_virtual=2)``
   round of starcoder2-3b at phase 5's width and cut (2 virtual clients of
   4 sequences, 2 a data rank, sequence 128, FedAdam-SSM with error
   feedback, float32) through ``launch/steps.build_train_step``, each
   rank's shards drawn leaf by leaf on the card, against the whole-leaf
   world-1 scan round rank 0 runs after it (``TENSOR_TOL``/
   ``TENSOR_ERR_TOL`` except where a support differs, counted; the bill
   equal, 2 x 375,854,948 bytes); launches per rank exactly absmax 2L,
   count_ge 4L, ssm_apply_ef 2L (L = 11) and no word or Adam kernel; the
   bytes each group (model, data, leaf) moves, wall and peak per rank;
   the selection and apply kernels bitwise their plain versions on the
   embedding's shard; then one bfloat16 round; (b) mistral-large-123b at
   full width, 1 of 88 repeats (2,189,463,552 parameters): one step,
   loss and gradient, in float32 at sequence 512 with 2 sequences a data
   rank through the FSDP+tp layers, against the whole-leaf step rank 0
   runs after it, compared shard by shard on the card (within
   ``FSDP_GRAD_TOL``); ``select_tau`` over every rank on the embedding
   gradient's shard (100,663,296 elements a rank) bitwise the whole
   leaf's; absmax, count_ge and ssm_apply_ef bitwise their plain versions
   on that shard, with times; and the predicted peak of mistral's whole
   round at this depth, in float32 and bfloat16 (not run);
18. (after 17) sharded serving (``launch.steps.build_prefill_step`` and
   ``build_serve_step`` on serving meshes with no client axes), gloo
   processes with CUDA tensors sharing the card, each part's predicted
   peak over its ranks and the whole model's checked against
   ``SM_FIT`` of the card first (``sm_predict``), the weights and caches
   drawn by block from a seed (``seeded_block``: any block of a leaf
   without the whole), and each part then run whole in this process
   from the same seeds and compared (logits and cache blocks within
   ``SM_TOL`` of the whole's largest element, greedy picks equal where
   the whole's top two lie apart): (a) 4 ranks, (data 2, model 2):
   starcoder2-3b whole (30 repeats) in float32, batch 4 (2 a row), a
   32-token prompt through the prefill step, the cache shards seated in
   the serve step's, 16 greedy decode steps; 2 ranks, (data 1, model 2):
   deepseek-v2-lite-16b whole (27 repeats, MLA + MoE) the same at batch
   2; (b) gemma3-27b at full width, its first 6 of 31 specs (5 local, 1
   global), 1 repeat, the long shape (batch 1, 524,288 positions,
   ``kv_seq`` over "data": each rank attends over its half of the slots
   and the softmax is combined over the data group), float32, from
   seeded caches (no prefill), 4 decode steps at positions in each data
   rank's half of the global cache and of the local rings; (c) kimi-k2-
   1t-a32b at full width, 1 of 61 repeats, its ``fsdp`` plan's 2-D
   serving in bfloat16 (the leaves' ``embed`` dims split over "data",
   the activations gathered instead), a 16-token prompt at batch 2 and
   16 greedy steps, within ``SM_TOL_BF16`` on every row the split run
   routed as the whole did (a rerouted row: every flip of its experts
   explained by a router near-tie, ``_reroutes``).  Each part prints
   its cuts, predicted and measured peaks per rank, walls per step, the
   bytes each group (model, data) moves per step and the elements
   beyond its tolerance; records:
   ``chiprun_out/phase18.json``;
19. (after 18) the dry run (``launch/dryrun.py``) and rank 0's real step
   held to it: (a) ``DRY_COMBOS`` (starcoder2-3b train_4k and
   decode_32k, mamba2-1-3b train_4k, deepseek-v2-lite-16b decode_32k,
   gemma3-27b long_500k) on pod1, each dry run a process of its own
   tracing fake CUDA tensors on the 256-rank fake world, all started
   together; every record ok, or skip with the JAX package's reason, one
   line each; (b) beside them, as the predictions appear, one spawned
   process, rank 0 of the fake world with its collectives standing in
   for its peers (``launch/mesh.stand_in``), runs each combo whose
   predicted peak fits ``DRY_FIT_BYTES`` for real on the card, its
   weights drawn by block from the seed (``seeded_tree``): FLOPs
   (``FlopCounterMode``), kernel launches and collective bytes equal to
   the prediction, ``max_memory_allocated`` within 10% or 2 GiB of the
   predicted peak, a decode's logits finite (a train combo's loss and
   state recorded: the stand-in's sums compound through a deep split
   backward), a train combo's absmax, count_ge and ssm_apply_ef bitwise
   their plain versions on its first inputs at its largest leaf; a
   decode step again without counters for its wall (a train step's wall
   is the counted run's), and the achieved share of the dtype's peak
   FLOP/s; the combos that do not fit listed with their predictions;
   records: ``chiprun_out/phase19.json`` and ``chiprun_out/dryrun/``;
20. (after 19) split leaves, 4 gloo ranks of a (data 2, model 2) group
   sharing the card: (a) the tp plan's round of each baseline and
   ``fairness_top``, (b) the fsdp plan's of FedAdam, Efficient-Adam and
   global FedAdam-Top, each at the dry run's predicted cut and against
   the whole-leaf round; (c) the buffered-async driver, FedAdam-SSM under
   churn for 2 server steps, as the tp plan's group cohort
   (``async_tp``) and the fsdp plan's virtual clients (``async_fsdp``):
   the event log, counts and bill equal to the whole-leaf driver's on
   rank 0, the state within ``_async_vs_whole``'s bounds, exact
   launches per client step, and absmax, count_ge and ssm_apply_ef
   bitwise their plain versions on the first dispatch's inputs; records:
   ``chiprun_out/phase20.json``.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Any failure
raises, exits non-zero and prints no result line.  A JSON record of the
run goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (the port's roofline, from the data sheet): HBM3
#: bandwidth and float32 outside the tensor cores; the bound of a kernel is
#: the larger of bytes over the first and operations over the second.
from repro_torch.roofline import (  # noqa: E402
    F32_FLOPS as F32_OPS_PER_S, HBM_BW as HBM_BYTES_PER_S)

CNN_WIRE_BYTES_PER_CLIENT = 346_880
CLIENTS = 20
ROUNDS = 3
#: FedAdam-Top on the CNN: three (bitmap, value stream) pairs per client.
CNN_TOP_WIRE_BYTES_PER_CLIENT = 461_568

#: The transformer path: starcoder2-3b at full width, 2 pattern repeats.
LM_REPEATS = 2
LM_PARAMS = 493_894_656
LM_CLIENTS = 4
LM_ROUNDS = 2
LM_LOCAL_EPOCHS = 3
#: Leaf sizes whose first inputs phase 6 replays: embed, w_up, a norm.
LM_SHAPES = {"embed": 150_994_944, "w_up": 75_497_472, "norm": 6_144}
#: Slots of its support bitmap: the packed layout's rows of 128 elements,
#: in whole blocks of 32 rows.
LM_BITMAP_SLOTS = 493_895_680


#: Phase 13, the MoE, MLA and Mamba-2 (SSD) layers at full width: each
#: configuration's cut (deepseek-v2-lite-16b: 1 of 27 pattern repeats, the
#: whole period; mamba2-1-3b: 8 of 48 repeats; no width and no vocabulary
#: is cut), its parameters, leaves and FedAdam-SSM payload bytes per
#: client, the round's driver, and the leaves whose first inputs the phase
#: replays through the per-leaf kernels: name -> (elements, leaves of that
#: size before it in leaf order).  deepseek's scan round does not fit the
#: card (``scan_round_probe`` measures it), so it runs the vmap round with
#: the wire transport, whose numbers are bitwise the scan round's (phase
#: 12).
ZOO = {
    "deepseek-v2-lite-16b": {
        "cut": {"pattern_repeats": 1},
        "params": 1_002_051_584, "leaves": 17, "wire_bytes": 762_563_036,
        "driver": {"client_mode": "vmap", "aggregate": "sparse_gather"},
        "replayed": {"w_gate": (184_549_376, 1), "router": (131_072, 0)}},
    "mamba2-1-3b": {
        "cut": {"pattern_repeats": 8},
        "params": 310_081_024, "leaves": 11, "wire_bytes": 235_972_972,
        "driver": {},
        "replayed": {"in_proj": (139_460_608, 0), "a_log": (512, 0)}},
}
#: Phase 13's sequence (two SSD chunks of 256; 64 slots per deepseek
#: expert and row); otherwise phase 5's traffic.
ZOO_SEQ = 512
#: Phase 13's card-vs-CPU block: outputs and gradients within this share
#: of their largest element (float32 on both sides, TF32 off; the two
#: sum contractions of up to 8,512 terms in other orders).
ZOO_BLOCK_TOL = 1e-4


def per_client_round(**nonzero):
    """Expected launches of every kernel per client and round: those
    named, and 0 for the others."""
    names = ("packed_hist", "packed_apply", "pack_words", "unpack_words",
             "fused_adam", "absmax", "count_ge", "apply_mask",
             "ssm_apply_ef", "ssm_apply")
    return {k: nonzero.get(k, 0) for k in names}


#: Expected launches per client and round of the CNN's FedAdam-Top: the
#: histogram and the refine count, the pick/apply, and three bitmaps packed
#: and unpacked.
CNN_TOP_LAUNCHES = per_client_round(packed_hist=2, packed_apply=1,
                                    pack_words=3, unpack_words=3)

def ssm_launches(n_leaves: int) -> dict:
    """Expected launches per client and round of a FedAdam-SSM round of a
    mixed-dtype model with ``n_leaves`` leaves (the per-leaf compress):
    fused_adam once per leaf and local epoch; per leaf one absmax, two
    counts and one fused apply; one bitmap."""
    return per_client_round(
        pack_words=1, unpack_words=1, fused_adam=n_leaves * LM_LOCAL_EPOCHS,
        absmax=n_leaves, count_ge=2 * n_leaves, ssm_apply_ef=n_leaves)


#: The transformer's two algorithms: payload bytes per client, the
#: payload's encoder, expected launches per client and round, and the
#: per-leaf kernels whose inputs phase 6 replays.  FedAdam-Top: per leaf
#: and delta one absmax, two counts and one mask apply; three bitmaps.
LM_PATHS = {
    "fedadam_ssm": {
        "wire_bytes": 375_854_948, "encoder": "pack_shared_mask",
        "launches": ssm_launches(11),
        "replayed": ("fused_adam", "absmax", "count_ge", "ssm_apply_ef")},
    "fedadam_top": {
        "wire_bytes": 499_328_868, "encoder": "pack_independent_mask",
        "launches": per_client_round(
            pack_words=3, unpack_words=3, fused_adam=11 * LM_LOCAL_EPOCHS,
            absmax=33, count_ge=66, apply_mask=33),
        "replayed": ("apply_mask",)},
}

#: The CNN's dense and quantized baselines: payload bytes per client, the
#: payload's encoder, word-kernel launches per client and round (one
#: pack_words and one unpack_words of 8-bit codes or of a sign plane).
CNN_BASELINES = {
    "fedadam": {"wire_bytes": 5_456_256, "encoder": "pack_dense",
                "words": 0},
    "fedsgd": {"wire_bytes": 1_818_752, "encoder": "pack_dense",
               "words": 0},
    "efficient_adam": {"wire_bytes": 460_532, "encoder": "pack_bbit_codes",
                       "words": 1},
    "onebit_adam": {"wire_bytes": 59_136, "encoder": "pack_sign",
                    "words": 1},
}

#: The same on the transformer (fused local Adam: 11 leaves x 3 epochs;
#: 1-bit Adam's compressed round takes one momentum step, no Adam), with
#: the word kernels' code width.
LM_BASELINES = {
    "efficient_adam": {
        "wire_bytes": 495_824_956, "encoder": "pack_bbit_codes", "words": 1,
        "bits": 8, "launches": per_client_round(
            pack_words=1, unpack_words=1, fused_adam=11 * LM_LOCAL_EPOCHS)},
    "fedadam": {
        "wire_bytes": 5_926_735_872, "encoder": "pack_dense", "words": 0,
        "launches": per_client_round(fused_adam=11 * LM_LOCAL_EPOCHS)},
    "onebit_adam": {
        "wire_bytes": 63_666_240, "encoder": "pack_sign", "words": 1,
        "bits": 1, "launches": per_client_round(pack_words=1,
                                                unpack_words=1)},
}

KERNELS = {
    "packed_hist": ("src/repro_torch/csrc/packed_topk.cu",
                    "src/repro/kernels/packed_topk/packed_topk.py:91"),
    "packed_apply": ("src/repro_torch/csrc/packed_topk.cu",
                     "src/repro/kernels/packed_topk/packed_topk.py:233"),
    "pack_words": ("src/repro_torch/csrc/wirepack.cu",
                   "src/repro/kernels/wirepack/wirepack.py:92"),
    "unpack_words": ("src/repro_torch/csrc/wirepack.cu",
                     "src/repro/kernels/wirepack/wirepack.py:111"),
}

#: The transformer path's per-leaf kernels: (source, TPU kernel, position
#: of the leaf among the wrapper's arguments).
LM_KERNELS = {
    "fused_adam": ("src/repro_torch/csrc/fused_adam.cu",
                   "src/repro/kernels/fused_adam/fused_adam.py:56", 1),
    "absmax": ("src/repro_torch/csrc/topk_mask.cu",
               "src/repro/kernels/topk_mask/topk_mask.py:55", 0),
    "count_ge": ("src/repro_torch/csrc/topk_mask.cu",
                 "src/repro/kernels/topk_mask/topk_mask.py:89", 1),
    "apply_mask": ("src/repro_torch/csrc/topk_mask.cu",
                   "src/repro/kernels/topk_mask/topk_mask.py:115", 1),
    "ssm_apply_ef": ("src/repro_torch/csrc/ssm_apply.cu",
                     "src/repro/kernels/ssm_apply/ssm_apply.py:110", 1),
    "ssm_apply": ("src/repro_torch/csrc/ssm_apply.cu",
                  "src/repro/kernels/ssm_apply/ssm_apply.py:46", 1),
}


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def phase(n: int, what: str) -> None:
    """Log a phase's start, so that a failed run names it on its last
    lines."""
    log(f"== phase {n}: {what}")


def host_cpu() -> str:
    """The host's CPU model (the CPU side of the card-vs-CPU phases)."""
    info = Path("/proc/cpuinfo")
    names = [line.split(":", 1)[1].strip()
             for line in (info.read_text().splitlines() if info.exists()
                          else []) if line.startswith("model name")]
    return f"{names[0]} x {len(names)}" if names else "unknown"


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device_and_build(torch):
    require(torch.cuda.is_available(), "no CUDA device is available")
    require((ROOT / "src" / "repro_torch" / "csrc").is_dir(),
            "src/repro_torch is missing: run from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import exact_float32
    from repro_torch.kernels import _lib

    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda};"
        f" host CPU: {host_cpu()}")
    t0 = time.perf_counter()
    _lib.library()
    log(f"kernel library: {len(_lib.sources())} sources built in "
        f"{_lib.build_seconds:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    torch.backends.cudnn.deterministic = True
    exact_float32()
    return smi, _lib.build_seconds


# ---------------------------------------------------------------------------
# Phase 2: the main path
# ---------------------------------------------------------------------------


class Capture:
    """Records (a clone of) the arguments, and the result, of the first
    call of each wrapped entry point, then calls through unchanged:
    ``args[name][None]`` is a list of ``(args, kwargs)``.  With ``arg`` and
    ``sizes``, the first call for each size in ``sizes`` of argument
    ``arg`` instead (``args[name][size]``); with ``calls``, the first that
    many calls of each."""

    def __init__(self, host=False):
        """``host``: keep the copies in pinned host memory (``_clone``)."""
        self.args = collections.defaultdict(dict)
        self.outs = {}
        self.wrapped = []
        self.host = host

    def restore(self):
        """Put every wrapped entry point back.  An entry point wrapped twice
        holds the first wrapper, which holds this object: the list is
        emptied, or that cycle would keep the captured tensors alive until
        Python's cyclic collector ran."""
        for module, attr, fn in reversed(self.wrapped):
            setattr(module, attr, fn)
        self.wrapped.clear()

    def wrap(self, module, attr, name, arg=None, sizes=(None,), calls=1,
             keep=None, skip=0):
        """``keep``: record ``keep(out)`` instead of the output (what a
        phase needs of a large payload without holding it); ``skip``: pass
        over the first that many calls of each size (another leaf of the
        same size ahead of the one wanted)."""
        fn = getattr(module, attr)
        self.wrapped.append((module, attr, fn))
        passed = collections.Counter()

        def rec(*args, **kw):
            key = None if arg is None else args[arg].numel()
            seen = None
            if key in sizes:
                passed[key] += 1
                if passed[key] > skip:
                    seen = self.args[name].setdefault(key, [])
            first = seen is not None and len(seen) < calls
            if first:
                seen.append(([_clone(a, self.host) for a in args],
                             dict(kw)))
            out = fn(*args, **kw)
            if first and arg is None and name not in self.outs:
                self.outs[name] = out if keep is None else keep(out)
            return out

        setattr(module, attr, rec)


def make_data(seed, n_clients):
    from repro_torch.data import dirichlet_partition, synthetic_image_dataset
    imgs, labels = synthetic_image_dataset("fashion_mnist", 12_000,
                                           seed=seed)
    n_train = 10_000
    parts = dirichlet_partition(labels[:n_train], n_clients=n_clients,
                                theta=0.1, seed=seed)
    return imgs, labels, n_train, parts


def round_batch(torch, imgs, labels, n_train, parts, r, device):
    from repro_torch.data import client_batches
    (bx, by), w = client_batches([imgs[:n_train], labels[:n_train]], parts,
                                 32, seed=r)
    return ((torch.from_numpy(bx).to(device),
             torch.from_numpy(by).to(device)),
            torch.from_numpy(w).to(device))


def cnn_fed(algorithm, **kw):
    """The CNN rounds' configuration: alpha 0.05, threshold masks, error
    feedback, 20 clients, 3 local epochs of Adam at lr 1e-3 (``kw``
    overrides any of them)."""
    from repro_torch.core import FedConfig
    from repro_torch.optim import AdamHyper
    fields = dict(alpha=0.05, local_epochs=3, n_clients=CLIENTS,
                  adam=AdamHyper(lr=1e-3), exact_topk=False,
                  error_feedback=True)
    fields.update(kw)
    return FedConfig(algorithm=algorithm, **fields)


def phase_main_path(torch, seed):
    from repro_torch.core import fed_init, make_fl_round
    from repro_torch.core import sparsify, wire
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.vision import build_vision

    dev = torch.device("cuda")
    params, _, loss_fn, acc_fn, _ = build_vision("cnn", width=1.0,
                                                 seed=seed, device=dev)
    d = sum(x.numel() for x in params.values())
    require(d == 454_688, f"CNN width 1.0 has {d} parameters")
    imgs, labels, n_train, parts = make_data(seed, CLIENTS)
    test = (torch.from_numpy(imgs[n_train:]).to(dev),
            torch.from_numpy(labels[n_train:]).to(dev))
    fed = cnn_fed("fedadam_ssm")
    round_fn = make_fl_round(fed, loss_fn)
    state = fed_init(fed, params)

    cap = Capture()
    cap.wrap(sparsify, "packed_hist", "packed_hist")
    cap.wrap(sparsify, "packed_apply", "packed_apply")
    cap.wrap(wire, "pack_mask_bits", "pack_words")
    cap.wrap(wire, "unpack_mask_bits", "unpack_words")
    cap.wrap(wire, "pack_shared_mask", "payload")

    rounds = []
    torch.cuda.synchronize()
    reset_launches()
    for r in range(ROUNDS):
        before = dict(LAUNCHES)
        batch, w = round_batch(torch, imgs, labels, n_train, parts, r, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mets = round_fn(state, batch, w)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.no_grad():
            acc = float(acc_fn(state.W, test))
        loss = float(mets["loss"].mean())
        per_client = float(mets["uplink_bits"]) / 8 / CLIENTS
        launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        rounds.append({"round": r, "loss": loss, "test_acc": acc,
                       "wall_s": wall, "wire_bytes_per_client": per_client,
                       "launches": launches})
        log(f"round {r}: loss={loss:.6f} test_acc={acc:.4f} "
            f"wall={wall:.4f} s wire_bytes/client={per_client:.0f} "
            f"launches={launches}")
        require(math.isfinite(loss), f"round {r} loss is {loss}")
        require(per_client == CNN_WIRE_BYTES_PER_CLIENT,
                f"wire bytes per client {per_client}")
    main_launches = dict(LAUNCHES)
    require(all(main_launches[k] > 0 for k in KERNELS),
            f"a kernel of the main path never launched: {main_launches}")
    for name in "WMV":
        for k, x in getattr(state, name).items():
            require(bool(torch.isfinite(x).all()), f"{name}[{k}] not finite")
    ref = build_vision("cnn", width=1.0, seed=seed, device=dev)[0]
    require({k: v.shape for k, v in state.W.items()} ==
            {k: v.shape for k, v in ref.items()}, "parameter shapes changed")
    # the bytes the card's kernels put on the wire for the first client
    payload = cap.outs["payload"]
    require(all(a.is_cuda for part in payload for a in part),
            "the wire payload was not built on the card")
    nbytes = wire.payload_nbytes(payload)
    log(f"first client's payload built on the card: {nbytes} bytes")
    require(nbytes == CNN_WIRE_BYTES_PER_CLIENT,
            f"the card's payload holds {nbytes} bytes")
    cap.restore()
    captured = {k: cap.args[k][None][0] for k in KERNELS}
    prof = profile_round(torch, round_fn, state, batch, w)
    prof["syncs"] = count_syncs(torch, round_fn, state, batch, w)
    log(f"profiled round: {json.dumps(prof)}")
    return rounds, main_launches, captured, prof, nbytes


def phase_cnn_top(torch, seed):
    """One FedAdam-Top round of the CNN at full width on phase 2's
    configuration: exact launches per client, the first client's
    three-bitmap payload measured on the card, then a round that counts
    stream synchronisations.  Also returns the first client's inputs to the
    packed kernels (one buffer of dW ++ dM ++ dV in 3L segments, the
    single-stream apply), which ``phase_cnn_top_kernels`` replays."""
    from repro_torch.core import fed_init, make_fl_round
    from repro_torch.core import sparsify, wire
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.vision import build_vision

    dev = torch.device("cuda")
    params, _, loss_fn, _, _ = build_vision("cnn", width=1.0, seed=seed,
                                            device=dev)
    imgs, labels, n_train, parts = make_data(seed, CLIENTS)
    fed = cnn_fed("fedadam_top")
    round_fn = make_fl_round(fed, loss_fn)
    state = fed_init(fed, params)
    batch, w = round_batch(torch, imgs, labels, n_train, parts, 0, dev)
    cap = Capture()
    cap.wrap(wire, "pack_independent_mask", "payload")
    cap.wrap(sparsify, "packed_hist", "packed_hist")
    cap.wrap(sparsify, "packed_apply", "packed_apply")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, mets = round_fn(state, batch, w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    cap.restore()
    loss = float(mets["loss"].mean())
    log(f"cnn fedadam_top round: loss={loss:.6f} wall={wall:.4f} s "
        f"launches={launches}")
    want = {k: v * CLIENTS for k, v in CNN_TOP_LAUNCHES.items()}
    require(launches == want, f"launches {launches}, expected {want}")
    require(math.isfinite(loss), f"cnn fedadam_top loss is {loss}")
    for name in "WMV":
        for k, x in getattr(state, name).items():
            require(bool(torch.isfinite(x).all()), f"{name}[{k}] not finite")
    payload = cap.outs["payload"]
    require(len(payload.words) == 3 and all(
        a.is_cuda for part in payload for a in part),
        "the three-bitmap payload was not built on the card")
    nbytes = wire.payload_nbytes(payload)
    uplink = float(mets["uplink_bits"])
    log(f"cnn fedadam_top first client's payload built on the card: "
        f"{nbytes} bytes; uplink bits {uplink}")
    require(nbytes == CNN_TOP_WIRE_BYTES_PER_CLIENT,
            f"the card's payload holds {nbytes} bytes")
    require(uplink == CLIENTS * 8 * CNN_TOP_WIRE_BYTES_PER_CLIENT,
            f"uplink bits {uplink}")
    prof = profile_round(torch, round_fn, state, batch, w)
    log(f"cnn fedadam_top profiled round: {json.dumps(prof)}")
    syncs = count_syncs(torch, round_fn, state, batch, w)
    log(f"cnn fedadam_top syncs: {json.dumps(syncs)}")
    # the apply is called without a score: make it explicit for the replay
    args, kw = cap.args["packed_apply"][None][0]
    require(len(args[4]) == 1 and len(args) == 5,
            "FedAdam-Top's packed apply is not the single-stream call")
    require(args[2].numel() == 3 * len(params),
            f"{args[2].numel()} tau segments for {len(params)} leaves")
    captured = {"packed_hist": cap.args["packed_hist"][None][0],
                "packed_apply": (args + [None], kw)}
    return {"loss": loss, "wall_s": wall, "launches": launches,
            "payload_bytes": nbytes, "uplink_bits": uplink,
            "round_profile": prof, "syncs": syncs}, captured


def phase_cnn_top_kernels(torch, captured, kernels):
    """The packed kernels against their plain versions on FedAdam-Top's
    inputs: the histogram over 3L segments and the single-stream apply
    with its residual over every row.  Adds the record to ``kernels``."""
    by_name = {k["name"]: k for k in kernels}
    for name in ("packed_hist", "packed_apply"):
        args, kw = captured[name]
        rec = measure(torch, name, args, kw, iters=200, plain_iters=20)
        rec["segments"] = captured["packed_apply"][0][2].numel()
        log(f"{name}: cnn fedadam_top {json.dumps(rec)}")
        k = by_name[name]
        k["max_abs_err"] = max(k["max_abs_err"], rec["max_abs_err"])
        k["at_cnn_fedadam_top"] = rec


def count_syncs(torch, round_fn, state, batch, w) -> dict:
    """Stream synchronisations in one round (host-to-device copies from
    pageable memory, ``.item()`` and the like), as PyTorch's sync debug
    mode reports them, with the innermost line of this checkout (and the
    line outside it) that made each."""
    return count_syncs_of(torch, lambda: round_fn(state, batch, w))


def count_syncs_of(torch, fn) -> dict:
    """``count_syncs`` of one call of ``fn()``."""
    import traceback
    import warnings

    sites = collections.Counter()

    def record(message, *_):
        if "synchronizing" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if Path(f.filename).name != "warnings.py"]
        ours = [f for f in stack if Path(f.filename).is_relative_to(ROOT)]
        here = (f"{Path(ours[-1].filename).relative_to(ROOT)}:"
                f"{ours[-1].lineno}" if ours else "?")
        sites[f"{here} -> {stack[-1].filename}:{stack[-1].lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # switching the mode on reports one sync of its own: not counted
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = record
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"per_round": sum(sites.values()), "sites": dict(sites)}


def port_kernel_names() -> list:
    """Every ``__global__`` function of the port's CUDA sources: a key of
    the profiler that names one is the port's device time."""
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)")
    return sorted({name for src in (ROOT / "src/repro_torch/csrc").glob("*.cu")
                   for name in decl.findall(src.read_text())})


def profile_round(torch, round_fn, state, batch, w, port_kernels=True):
    """One more round under torch.profiler, device activity only (the host
    pays no per-operator cost): its wall time, the device's busy share and
    the kernels that took the most device time.  ``port_kernels``: the
    round must run some of the port's kernels (a dense round runs none)."""
    return profile_call(torch, lambda: round_fn(state, batch, w),
                        port_kernels)


def profile_call(torch, fn, port_kernels=True):
    """``profile_round`` of one call of ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in ops)
    require(busy_ms > 0, "the profiler saw no device time in the round")
    ours = re.compile(r"\b(%s)\b" % "|".join(port_kernel_names()))
    port_ms = sum(ms for key, ms, _ in ops if ours.search(key))
    require((port_ms > 0) == port_kernels,
            f"the profiler saw {port_ms} ms of the port's kernels")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_ops": sum(c for *_, c in ops),
            "port_kernels_ms": port_ms,
            "top": [{"name": key[:80], "ms": ms, "count": c}
                    for key, ms, c in ops[:8]]}


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: Profiler windows a measurement tries before it gives up: the profiler
#: on the H100 loses device records (``device_ms``), in some windows all
#: of them.
PROFILER_WINDOWS = 10


def device_ms(torch, fn, iters: int, kernel_names=("",)):
    """(device time per call, device operations per call) of the named
    CUDA kernels (by default every device operation the call makes:
    kernels, fills, copies), from torch.profiler over ``iters`` calls.

    The profiler on the H100 loses device records.  In one process that
    profiled windows of 10 calls for 200 s (an H100 80GB, torch 2.11),
    windows lost k records, k growing by about one every 9 s whatever the
    calls took; past the first minute every other window mostly lost none,
    and from about 150 s the others came back empty (the whole script once
    saw ten empty windows in a row).  So the first window that kept every
    record (each operation's count a multiple of the calls) counts; after
    four windows without one, the one with the most records does, each
    operation counting ``round(records / calls)`` times per call at its
    mean recorded time; two windows in a row that saw none of the named
    kernels make the next ones four times as long, at most
    ``PROFILER_WINDOWS`` windows in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best, n = None, iters
    for w in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [(e.count, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count
              and any(k in e.key for k in kernel_names)]
        per_call = [(round(c / n), us / c) for c, us in ev]
        if ev and all(c % n == 0 for c, _ in ev):
            best = (None, per_call)
            break
        records = sum(c for c, _ in ev) / n
        if sum(c for c, _ in per_call) and (best is None
                                            or records > best[0]):
            best = (records, per_call)
        if w % 2 and best is None:
            log(f"device_ms: no device time of {kernel_names} in two "
                f"windows of {n} calls")
            n *= 4
        elif w >= 3 and best is not None:
            log(f"device_ms: no window of {kernel_names} kept every record;"
                f" the best kept {best[0]:.2f} per call of {n}")
            break
    if best is None:
        raise RuntimeError(f"chip_smoke: the profiler saw no device time of "
                           f"{kernel_names} in {PROFILER_WINDOWS} windows")
    per_call = best[1]
    return (sum(c * us for c, us in per_call) / 1e3,
            sum(c for c, _ in per_call))


def max_abs_err(torch, a, b) -> float:
    """Max |a - b|; raises unless a and b are bitwise equal (outputs are
    float32, int32, uint32 or bfloat16)."""
    require(a.shape == b.shape and a.dtype == b.dtype,
            f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
            f"{tuple(b.shape)} {b.dtype}")
    same = torch.equal(_bits(torch, a), _bits(torch, b))
    err = 0.0 if same else (a.double() - b.double()).abs().max().item()
    require(same, f"kernel differs from its plain version (max {err})")
    return err


def _bits(torch, x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def vgg11_inputs(torch, seed):
    """Packed select/apply operands at VGG-11 width-1.0 shapes."""
    from repro_torch.core import sparsify as S
    from repro_torch.kernels.packed_topk import ops as P
    from repro_torch.kernels.packed_topk.ref import refine_taus
    from repro_torch.kernels.topk_mask.ref import log2_taus
    from repro_torch.models.vision import vgg11_shapes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = [s for s, _ in (v for _, v in sorted(vgg11_shapes().items()))]
    rnd = lambda s, scale: torch.randn(s, generator=gen, device=dev) * scale
    w = [rnd(s, 1e-3) for s in shapes]
    m = [rnd(s, 1e-4) for s in shapes]
    v = [rnd(s, 1e-6).abs() for s in shapes]
    layout = S.plan_packed_layout(w)
    require(layout.total == 9_747_456 and layout.num_segments == 11,
            f"VGG-11 packed layout {layout.total} / {layout.num_segments}")
    wp, mp, vp = layout.pack(w), layout.pack(m), layout.pack(v)
    ks, ns = layout.ks_ns(0.05)
    absmax = S._segment_absmax(layout, w)
    edges = log2_taus(absmax)
    taus2 = refine_taus(P.packed_hist_plain(wp, layout.seg_ids, edges),
                        edges, absmax, ks)
    return {"packed_hist": ([wp, layout.seg_ids, edges], {}),
            "packed_apply": ([taus2, layout.seg_ids, ks, ns, (wp, mp, vp),
                              None], {"with_residual": True,
                                      "value_dtype": None}),
            "support_rows": -(-wp.shape[0] // 32) * 32}


def packed_count_ops(xp) -> int:
    """float32 operations of one packed count: per element the abs, the
    rank search's 6 compares and the counter's add (every segment takes the
    rank path; the sort of a segment's edges and the flushes, a fixed cost
    per CTA, are not counted)."""
    return 8 * xp.numel()


def kernel_cost(torch, name, args, kw):
    """(bytes each input read once and each output written once, float32
    operations) of one call, from this call's shapes."""
    if name == "packed_hist":
        xp, seg_ids, edges = args
        n = xp.numel()
        return (4 * n + 4 * seg_ids.numel() + 2 * 4 * edges.numel(),
                packed_count_ops(xp))
    if name == "packed_apply":
        taus2, seg_ids, ks, ns, streams, score = args
        n = streams[0].numel()
        n_in = len(streams) + (score is not None)
        n_out = len(streams) + bool(kw.get("with_residual", True))
        small = 4 * (taus2.numel() + seg_ids.numel() + ks.numel()
                     + ns.numel() + 2 * ks.numel())
        return (4 * n * (n_in + n_out) + small,
                packed_count_ops(streams[0]) + 3 * n * n_out)
    bits = word_bits(args)
    if name == "pack_words":
        n = args[0].numel()
        return 4 * n + n * bits // 8, 2 * n
    n = args[0].numel() * 32 // bits
    return n * bits // 8 + 4 * n, 2 * n


def word_bits(args) -> int:
    """Code width of a captured word-kernel call: ``(codes, bits)`` when
    captured at ``pack_words``/``unpack_words``, the support bitmap (b=1)
    when captured at ``pack_mask_bits``/``unpack_mask_bits``."""
    return args[1] if len(args) > 1 else 1


def run_kernel(torch, name, args, kw):
    from repro_torch.kernels.packed_topk import ops as P
    from repro_torch.kernels.wirepack import ops as W
    # the packed wrappers are timed over every device operation they make
    if name == "packed_hist":
        return (lambda: P.packed_hist(*args)), \
            (lambda: P.packed_hist_plain(*args)), ("",)
    if name == "packed_apply":
        return (lambda: P.packed_apply(*args, **kw)), \
            (lambda: P.packed_apply_plain(*args, **kw)), ("",)
    bits = word_bits(args)
    if name == "pack_words":
        codes = args[0].to(torch.int32)
        return (lambda: W.pack_words(codes, bits)), \
            (lambda: W.pack_words_plain(codes, bits)), ["pack_words_kernel"]
    return (lambda: W.unpack_words(args[0], bits)), \
        (lambda: W.unpack_words_plain(args[0], bits)), \
        ["unpack_words_kernel"]


def _clone(a, host=False):
    """A copy of ``a`` (a tensor or a tuple of them); with ``host``, a
    card tensor's copy goes to pinned host memory without waiting for the
    stream (``_on_card`` brings it back, in stream order)."""
    if isinstance(a, tuple):
        return tuple(_clone(x, host) for x in a)
    if not hasattr(a, "clone"):
        return a
    if host and a.is_cuda:
        import torch
        out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        return out.copy_(a, non_blocking=True)
    return a.clone()


def _on_card(a):
    if isinstance(a, (tuple, list)):
        return type(a)(_on_card(x) for x in a)
    return a.to("cuda") if hasattr(a, "is_cuda") and not a.is_cuda else a


#: Bytes a timing loop must cycle through so that every launch finds its
#: inputs in device memory rather than in the 50 MB L2 cache.
_COLD_BYTES = 2 * 50e6

#: Device operations one call of a packed wrapper must make: the count
#: (packed_hist); the count with the pick, then the apply (packed_apply).
PACKED_DEVICE_OPS = {"packed_hist": 1, "packed_apply": 2}


def measure(torch, name, args, kw, iters, plain_iters, cold=False):
    """Bitwise check against the plain version, then times.  ``cold``
    cycles the timed launches over enough copies of the inputs that none
    is still in L2 (as a caller streaming a large model finds them).  A
    packed wrapper's device time takes in every device operation of its
    call, their number is checked, and the grid and blocks per CTA of its
    launches are recorded."""
    fk, fp, knames = run_kernel(torch, name, args, kw)
    a, b = fk(), fp()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    require(len(a) == len(b), f"{name}: output count")
    err = max(max_abs_err(torch, x, y) for x, y in zip(a, b))
    nbytes, ops = kernel_cost(torch, name, args, kw)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    copies = math.ceil(_COLD_BYTES / nbytes) if cold else 1
    fks = [fk] + [run_kernel(torch, name, [_clone(x) for x in args], kw)[0]
                  for _ in range(copies - 1)]
    nxt = itertools.cycle(fks)
    timed = lambda: next(nxt)()
    ms = time_ms(torch, timed, iters)
    plain = time_ms(torch, fp, plain_iters)
    dev_ms, dev_ops = device_ms(torch, timed, 20, knames)
    n = args[4][0].numel() if name == "packed_apply" else (
        args[0].numel() * 32 // word_bits(args) if name == "unpack_words"
        else args[0].numel())
    rec = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "operations": ops, "elements": int(n),
           "input_copies": copies}
    if name in ("pack_words", "unpack_words"):
        rec["bits"] = word_bits(args)
    if name in PACKED_DEVICE_OPS:
        require(dev_ops == PACKED_DEVICE_OPS[name],
                f"{name}: {dev_ops} device operations per call")
        rec.update(device_ops_per_call=dev_ops,
                   launch_shape=launch_shapes(torch, name, fk,
                                              args[1].numel()))
    return rec


#: the kernel of each launch kind of the packed wrappers (the pick is
#: packed_apply's count)
_PACKED_KERNELS = {"count": "packed_count_kernel",
                   "pick": "packed_count_kernel",
                   "apply": "packed_apply_kernel"}


def launch_shapes(torch, name, fn, nb) -> dict:
    """Grid, block and blocks per CTA of each kernel launch of a packed
    wrapper over ``nb`` blocks.  Grid and block are read from the
    profiler's trace of 20 calls and every traced launch of each
    kind's kernel must equal the grid the launcher computes
    (``ops.launch_shape``), which also gives the blocks per CTA (a kernel
    argument, not in the trace).  The profiler drops records now and then
    (``device_ms``), so a window of many calls needs only one launch of
    each kernel to arrive, and a window with none is profiled again."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.packed_topk import ops as P
    kinds = ("count",) if name == "packed_hist" else ("pick", "apply")
    want, calls = P.launch_shape(nb), 20
    trace = ROOT / "build" / "launch_trace.json"
    trace.parent.mkdir(exist_ok=True)
    for _ in range(PROFILER_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        launches = [e for e in json.loads(trace.read_text())["traceEvents"]
                    if e.get("cat") == "kernel"]
        trace.unlink()
        if all(any(_PACKED_KERNELS[k] in e["name"] for e in launches)
               for k in kinds):
            break
    out = {}
    for kind in kinds:
        seen = [e for e in launches if _PACKED_KERNELS[kind] in e["name"]]
        require(seen, f"{name}: no {_PACKED_KERNELS[kind]} launch in "
                      f"{PROFILER_WINDOWS} traced windows of {calls} calls")
        g, c = want[kind]
        grids = {(tuple(e["args"]["grid"]), tuple(e["args"]["block"]))
                 for e in seen}
        for grid, block in grids:
            require(grid == (g, 1, 1) and block[1:] == (1, 1),
                    f"{name} {kind}: grid {list(grid)} block "
                    f"{list(block)}, the launcher says grid {g}")
        out[kind] = {"grid": g, "block": next(iter(grids))[1][0],
                     "blocks_per_cta": c}
    return out


def launch_floor_ms(torch) -> float:
    """Device time of one launch of an empty kernel: the card's floor for
    any launch, set beside the packed kernels' times at the CNN's shapes."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels._check import stream
    st = stream(torch.device("cuda"))
    return device_ms(torch, lambda: _lib.launch("repro_empty_launch", st),
                     200)[0]


def phase_kernels(torch, captured, main_launches, n_client_rounds, seed):
    from repro_torch.kernels.wirepack import ops as W
    require(set(captured) == set(KERNELS),
            f"captured inputs for {sorted(captured)}")
    vgg = vgg11_inputs(torch, seed)
    rows = vgg["support_rows"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    support = (torch.rand((rows, 128), generator=gen, device="cuda")
               < 0.05).to(torch.int32)
    vgg["pack_words"] = ([support], {})
    vgg["unpack_words"] = ([W.pack_words_plain(support, 1)], {})
    floor = launch_floor_ms(torch)
    log(f"launch floor (one empty kernel, device): {floor} ms")
    out = []
    for name, (src, replaces) in KERNELS.items():
        args, kw = captured[name]
        cnn = measure(torch, name, args, kw, iters=200, plain_iters=20)
        big = measure(torch, name, *vgg[name], iters=50, plain_iters=3,
                      cold=True)
        log(f"{name}: cnn {json.dumps(cnn)}")
        log(f"{name}: vgg11 {json.dumps(big)}")
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": main_launches[name],
               "max_abs_err": max(cnn["max_abs_err"], big["max_abs_err"]),
               "ms": cnn["ms"], "plain_ms": cnn["plain_ms"],
               "bound_ms": cnn["bound_ms"], "bound_by": cnn["bound_by"],
               "library_ms": None, "device_ms": cnn["device_ms"],
               "launches_per_client_round":
                   main_launches[name] / n_client_rounds,
               "at_cnn": cnn, "at_vgg11": big}
        if name in PACKED_DEVICE_OPS:
            rec["launch_floor_ms"] = floor
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Phase 4: the card against the CPU
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def onednn_conv(torch, enabled: bool):
    """The CNN's CPU convolutions through oneDNN (``enabled``) or the native
    kernels, which the port's models take (``models/vision.py``); on the
    card, cuDNN either way."""
    from repro_torch.models import vision
    own = vision._conv2d
    if enabled:
        F = torch.nn.functional
        vision._conv2d = lambda x, w, s: (F.conv2d(x, w, stride=s)
                                          if x.device.type == "cpu"
                                          else own(x, w, s))
    try:
        with torch.backends.mkldnn.flags(enabled=enabled):
            yield
    finally:
        vision._conv2d = own


def conv1_float64_gap(torch, loss_fn, W, batch, h) -> dict:
    """How far float32 runs of the CNN's conv1 sit from float64 at ``W`` on
    ``batch`` (CPU tensors), on the card, on the CPU with the native
    convolution (the port's) and on the CPU through oneDNN: the median
    relative error of client 0's weight gradient, and per client the share
    of conv1's first moment, after 3 local Adam epochs from zero moments
    (the round's Adam, ``h``), beyond the card-vs-CPU tolerance."""
    def local(c, dev, dtype, onednn, epochs):
        w = {k: v.to(dev, dtype).clone() for k, v in W.items()}
        m = {k: torch.zeros_like(v) for k, v in w.items()}
        v_ = {k: torch.zeros_like(x) for k, x in w.items()}
        xy = (batch[0][c].to(dev, dtype), batch[1][c].to(dev))
        with onednn_conv(torch, onednn):
            for e in range(epochs):
                p = {k: x.requires_grad_(True) for k, x in w.items()}
                g = dict(zip(p, torch.autograd.grad(loss_fn(p, xy),
                                                    list(p.values()))))
                if e == 0:
                    g0 = g["conv1"].cpu().double()
                for k, x in w.items():
                    m[k] = h.beta1 * m[k] + (1 - h.beta1) * g[k]
                    v_[k] = h.beta2 * v_[k] + (1 - h.beta2) * g[k] * g[k]
                    root = torch.sqrt((v_[k] + h.eps).double()).to(dtype)
                    w[k] = (x - h.lr * (m[k] / root)).detach()
        return g0, m["conv1"].cpu().double()
    runs = {"card": ("cuda", torch.float32, True),
            "cpu_native": ("cpu", torch.float32, False),
            "cpu_onednn": ("cpu", torch.float32, True)}
    out = {"grad_rel_median": {}, "adam_m_beyond": {n: [] for n in runs}}
    for c in range(batch[1].shape[0]):
        g64, m64 = local(c, "cpu", torch.float64, False, 3)
        for name, run in runs.items():
            g, m = local(c, *run, 3)
            if c == 0:
                out["grad_rel_median"][name] = float(
                    ((g - g64).abs() / g64.abs().clamp_min(1e-30)).median())
            out["adam_m_beyond"][name].append(float((~torch.isclose(
                m, m64, rtol=1e-4, atol=1e-5 * float(m64.abs().max())))
                .double().mean()))
    return out


def phase_card_vs_cpu(torch, np, seed, algorithm, **fed_kw):
    """One CNN round of ``algorithm`` on the card and on the CPU (plain
    versions of the kernels, the native convolution of the port's models),
    from the same weights and batch.  The quantized algorithms' compared
    round starts from one state computed on the CPU and handed to both
    sides: for 1-bit Adam a dense FedAdam warm-up round, for Efficient-Adam
    a first round of its own (its server moves W alone, so the clients'
    persistent moments are what the compared round adds; they are compared
    too).  Each side running that first round itself would compare states
    that already differ: a few elements of a round of local Adam from zero
    moments sit beyond tolerance of float64 on either side (measured here
    by :func:`conv1_float64_gap`), and a code flipped on a half step moves
    W by a whole step."""
    from repro_torch import tree as T
    from repro_torch.core import fed_init, make_fl_round
    from repro_torch.models.vision import build_vision

    C = 4
    params, _, loss_fn, _, _ = build_vision("cnn", width=1.0,
                                            seed=seed + 1, device="cpu")
    imgs, labels, n_train, parts = make_data(seed, C)
    mk_fed = lambda: cnn_fed(algorithm, n_clients=C,
                             sparsify_backend="kernel", **fed_kw)
    first, gap = None, None
    if algorithm in ("onebit_adam", "efficient_adam"):
        b0, w0 = round_batch(torch, imgs, labels, n_train, parts, 0, "cpu")
        if algorithm == "onebit_adam":
            warm = cnn_fed("fedadam", n_clients=C, alpha=1.0)
            st, _ = make_fl_round(warm, loss_fn)(fed_init(warm, params),
                                                 b0, w0)
            first = fed_init(mk_fed(), st.W)._replace(M=st.M, V=st.V)
        else:
            first, _ = make_fl_round(mk_fed(), loss_fn)(
                fed_init(mk_fed(), params), b0, w0)
        b1 = round_batch(torch, imgs, labels, n_train, parts, 1, "cpu")[0]
        gap = {"first_round": conv1_float64_gap(torch, loss_fn, params, b0,
                                                mk_fed().adam),
               "compared_round": conv1_float64_gap(torch, loss_fn, first.W,
                                                   b1, mk_fed().adam)}
        log(f"cnn {algorithm}: conv1 against float64 at the start of the "
            f"first and the compared round {json.dumps(gap)}")
    results = {}
    for dev in ("cuda", "cpu"):
        on = lambda t: T.tree_map(lambda x: x.to(dev), t)
        if first is None:
            state = fed_init(mk_fed(), on(params))
            batch, w = round_batch(torch, imgs, labels, n_train, parts, 0,
                                   dev)
        else:
            state = first._replace(W=on(first.W), M=on(first.M),
                                   V=on(first.V),
                                   client_state=on(first.client_state))
            batch, w = round_batch(torch, imgs, labels, n_train, parts, 1,
                                   dev)
        results[dev] = make_fl_round(mk_fed(), loss_fn)(state, batch, w)
    (gs, gm), (cs, cm) = results["cuda"], results["cpu"]
    require(float(gm["uplink_bits"]) == float(cm["uplink_bits"]),
            "uplink bits differ between the card and the CPU")
    # the CPU parity tests' tolerances: loss rtol 1e-5 (1e-4 here: cuDNN
    # and the CPU sum the convolutions in other orders), W/M/V within
    # rtol 1e-4 / atol 1e-5 * max except at most 0.2% of the elements,
    # which sit on a segment's tau and may be kept on one side only (for
    # FedAdam-Top, on any of the three streams' taus; for the quantizers,
    # on a half step of a code or at a sign)
    np.testing.assert_allclose(gm["loss"].cpu().numpy(),
                               cm["loss"].numpy(), rtol=1e-4)
    worst = 0.0
    compared = [(name, getattr(gs, name), getattr(cs, name))
                for name in "WMV"]
    if algorithm == "efficient_adam":
        compared += [(f"client {part}", gs.client_state[part],
                      cs.client_state[part]) for part in ("m", "v")]
    for name, tg, tc in compared:
        for k, a in tg.items():
            b = tc[k].numpy()
            bad = ~np.isclose(a.cpu().numpy(), b, rtol=1e-4,
                              atol=1e-5 * float(np.abs(b).max()))
            worst = max(worst, float(bad.mean()))
            require(bad.mean() <= 2e-3, f"{name}[{k}]: {bad.sum()} of "
                    f"{bad.size} elements differ beyond tolerance")
    err_g, err_c = gs.client_state["comp"]["err"], cs.client_state["comp"]["err"]
    if algorithm in ("efficient_adam", "onebit_adam"):
        # a residual carries its delta's absolute error: held to the
        # absolute tolerance of W (Efficient-Adam) or M (1-bit Adam)
        ref = cs.W if algorithm == "efficient_adam" else cs.M
        support = max(float(np.mean(~np.isclose(
            err_g[k].cpu().numpy(), err_c[k].numpy(), rtol=1e-4,
            atol=1e-5 * float(ref[k].abs().max())))) for k in err_g)
        what = "EF residuals beyond tolerance"
    else:
        support = max(float(np.mean((err_g[k].cpu().numpy() == 0)
                                    != (err_c[k].numpy() == 0)))
                      for k in err_g)
        what = "EF support mismatch"
    require(support <= 2e-3, f"{what}: {support:.2e}")
    log(f"cnn {algorithm}{''.join(f' {k}={v}' for k, v in fed_kw.items())}"
        f" card vs CPU: loss "
        f"{gm['loss'].cpu().numpy().tolist()} vs "
        f"{cm['loss'].numpy().tolist()}; share of W/M/V elements beyond "
        f"tolerance {worst:.2e}; {what} {support:.2e}")
    return {"loss_cuda": gm["loss"].cpu().numpy().tolist(),
            "loss_cpu": cm["loss"].numpy().tolist(),
            "wmv_beyond_tolerance": worst, "support_mismatch": support,
            "conv1_float64_gap": gap}

# ---------------------------------------------------------------------------
# Phase 5: the transformer path
# ---------------------------------------------------------------------------


def lm_fed(n_clients, algorithm):
    from repro_torch.core import FedConfig
    from repro_torch.optim import AdamHyper
    return FedConfig(algorithm=algorithm, alpha=0.05,
                     local_epochs=LM_LOCAL_EPOCHS, n_clients=n_clients,
                     adam=AdamHyper(lr=1e-3), exact_topk=False,
                     error_feedback=True, use_kernel_adam=True)


def _lm_entry_points():
    """(module, attribute) where the path looks up each per-leaf kernel's
    wrapper, and so where phase 5 captures its inputs."""
    from repro_torch.core import sparsify
    from repro_torch.kernels.fused_adam import ops as FA
    from repro_torch.kernels.topk_mask import ops as TM
    return {"fused_adam": (FA, "fused_adam_apply"),
            "absmax": (TM, "absmax"), "count_ge": (TM, "count_ge"),
            "apply_mask": (TM, "apply_mask"),
            "ssm_apply_ef": (sparsify, "ssm_apply_ef")}


def lm_rounds(torch, cfg, fed, seed, seq, per_client, label):
    """``cfg``'s trainer under ``fed`` built on the card (the peak memory
    statistic reset just before), then LM_ROUNDS rounds of batch 2 at
    sequence ``seq`` with the launch counters zeroed just before and read
    just after: finite losses and states, and exactly ``per_client``
    launches per client and round.  Returns ``(round_fn, state, batches,
    the last round's metrics, record)``."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    round_fn, state = train.make_trainer(cfg, fed, seed=seed, device=dev)
    batches = [train.build_client_batches(cfg, fed.n_clients, 2, seq,
                                          seed=r, device=dev)
               for r in range(LM_ROUNDS)]
    rounds = []
    torch.cuda.synchronize()
    reset_launches()
    for r in range(LM_ROUNDS):
        t0 = time.perf_counter()
        state, mets = round_fn(state, batches[r])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = mets["loss"].cpu().tolist()
        rounds.append({"round": r, "loss": losses, "wall_s": wall})
        log(f"{label} round {r}: loss={losses} wall={wall:.3f} s")
        require(all(math.isfinite(x) for x in losses),
                f"{label} round {r} loss is {losses}")
    launches = dict(LAUNCHES)
    n_cr = LM_ROUNDS * fed.n_clients
    want = {k: v * n_cr for k, v in per_client.items()}
    log(f"{label} launches: {launches}")
    require(launches == want, f"{label} launches {launches}, expected "
            f"{want}")
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} peak device memory: {peak / 2**30:.2f} GiB "
        f"({held / 2**30:.2f} GiB held before the phase began)")
    _finite_state(torch, state, label)
    return round_fn, state, batches, mets, {
        "rounds": rounds, "launches": launches, "peak_bytes": peak,
        "held_bytes_at_start": held}


def phase_transformer(torch, seed, algorithm):
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import wire

    spec = LM_PATHS[algorithm]
    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              pattern_repeats=LM_REPEATS)
    round_fn, state, batches, mets, out = lm_rounds(
        torch, cfg, lm_fed(LM_CLIENTS, algorithm), seed, 128,
        spec["launches"], f"lm {algorithm}")
    sizes = tuple(x.numel() for x in T.leaves(state.W))
    require(sum(sizes) == LM_PARAMS and len(sizes) == 11,
            f"starcoder2-3b at 2 repeats has {sum(sizes)} parameters in "
            f"{len(sizes)} leaves")
    dtypes = sorted({str(x.dtype) for x in T.leaves(state.W)})
    require(dtypes == ["torch.bfloat16", "torch.float32"],
            f"leaf dtypes {dtypes}")
    uplink = float(mets["uplink_bits"])
    wire_bytes = spec["wire_bytes"]
    require(wire.mask_wire_bits(sizes, 0.05, exact_topk=False,
                                shared=algorithm != "fedadam_top")
            == 8 * wire_bytes, "accounted wire bits")
    require(uplink == float(torch.tensor(
        float(LM_CLIENTS * 8 * wire_bytes), dtype=torch.float32)),
        f"uplink bits {uplink}")
    batch = batches[-1]
    prof = profile_round(torch, round_fn, state, batch, None)
    # the inputs phase 6 replays are captured in the sync-counting round,
    # so that the copies kept for it stay out of the measured peak
    cap = Capture()
    cap.wrap(wire, spec["encoder"], "payload")
    entry = _lm_entry_points()
    for name in spec["replayed"]:
        cap.wrap(*entry[name], name, LM_KERNELS[name][2],
                 tuple(LM_SHAPES.values()), len(LM_PASSES.get(name, ("",))))
    if algorithm == "fedadam_ssm":
        # the bitmap's support and words at the model's size
        cap.wrap(wire, "pack_mask_bits", "pack_words")
        cap.wrap(wire, "unpack_mask_bits", "unpack_words")
    prof["syncs"] = count_syncs(torch, round_fn, state, batch, None)
    cap.restore()
    log(f"lm {algorithm} profiled round: {json.dumps(prof)}")
    payload = cap.outs["payload"]
    require(all(a.is_cuda for part in payload for a in part),
            "the wire payload was not built on the card")
    nbytes = wire.payload_nbytes(payload)
    log(f"lm {algorithm} first client's payload built on the card: "
        f"{nbytes} bytes")
    require(nbytes == wire_bytes,
            f"the card's payload holds {nbytes} bytes")
    require(all(len(cap.args[k]) == len(LM_SHAPES)
                for k in spec["replayed"]),
            f"captured {({k: sorted(v) for k, v in cap.args.items()})}")
    require(prof["syncs"]["per_round"] == 0,
            f"the transformer round synchronised the stream: {prof['syncs']}")
    return dict(out, payload_bytes=nbytes, uplink_bits=uplink,
                round_profile=prof), dict(cap.args)


# ---------------------------------------------------------------------------
# Phase 6: the per-leaf kernels against their plain versions
# ---------------------------------------------------------------------------


def count_ge_ops(torch, taus, x):
    """(operations of one count over x, by the path the kernel takes for
    these candidates, and the same by the 32-compare path).  Non-increasing
    NaN-free candidates take the rank path: per bfloat16 element the key's
    mask and the counter's add (its rank is a load from the CTA's table),
    per float32 element the abs, the search's 6 compares and the add; other
    candidates the abs and 32 compares and adds per element.  The table and
    the flush, a fixed cost per CTA, are not counted."""
    n = x.numel()
    every = 2 * 32 * n + n
    if not bool((taus == taus).all() and (taus[:-1] >= taus[1:]).all()):
        return every, every
    return (2 if x.dtype == torch.bfloat16 else 8) * n, every


def lm_kernel(torch, name, args, kw):
    """(kernel call, plain call, library call or None, bytes, float32
    operations) for one captured call."""
    from repro_torch.kernels.fused_adam import ops as FA
    from repro_torch.kernels.ssm_apply import ops as SSM
    from repro_torch.kernels.topk_mask import ops as TM
    if name == "fused_adam":
        scalars, w, g, m, v = args
        n, e = w.numel(), w.element_size()
        return (lambda: FA.fused_adam_apply(*args)), \
            (lambda: FA.fused_adam_plain(*args)), \
            None, 7 * n * e + 16, 12 * n
    if name == "absmax":
        (x,) = args
        n, e = x.numel(), x.element_size()
        inf = float("inf")
        return (lambda: TM.absmax(x)), (lambda: TM.absmax_plain(x)), \
            (lambda: torch.linalg.vector_norm(x, inf)), n * e + 4, 2 * n
    if name == "count_ge":
        taus, x, pad = (list(args) + [0])[:3]
        n, e = x.numel(), x.element_size()
        return (lambda: TM.count_ge(taus, x, pad)), \
            (lambda: TM.count_ge_plain(taus, x, pad)), \
            None, n * e + 2 * 4 * 32, count_ge_ops(torch, taus, x)[0]
    if name == "apply_mask":
        tau, x = args
        n, e = x.numel(), x.element_size()
        return (lambda: TM.apply_mask(tau, x)), \
            (lambda: TM.apply_mask_plain(tau, x)), \
            None, n * e + 4 + n, 2 * n
    if name == "ssm_apply":
        tau, dw, dm, dv = args
        n, e = dw.numel(), dw.element_size()
        return (lambda: SSM.ssm_apply(*args)), \
            (lambda: SSM.ssm_apply_plain(*args)), \
            None, 6 * n * e + 4, 5 * n
    tau, dw, dm, dv, score = (list(args) + [None])[:5]
    n, e = dw.numel(), dw.element_size()
    n_out = 3 + bool(kw.get("with_residual", True))
    # a score of its own type (fairness_top's float32 beside bfloat16)
    score_bytes = 0 if score is None else n * score.element_size()
    return (lambda: SSM.ssm_apply_ef(*args, **kw)), \
        (lambda: SSM.ssm_apply_ef_plain(*args, **kw)), \
        None, (3 + n_out) * n * e + score_bytes + 4, 6 * n


def fused_adam_w_check(torch, a, b, w):
    """w' bitwise, or within the root's bound: the kernel and the plain
    version both take rsqrtf, but should their roots differ by a float32
    ulp, lr * upd moves by 2 float32 epsilons of itself and w' rounds once
    to its dtype: |a - b| <= spacing(w') + 4 eps32 |w - w'|.  Returns the
    largest difference in units of the dtype's last place."""
    if torch.equal(_bits(torch, a), _bits(torch, b)):
        return 0.0
    a64, b64, w64 = a.double(), b.double(), w.double()
    ulp = torch.finfo(a.dtype).eps
    spacing = b64.abs().clamp_min(torch.finfo(a.dtype).tiny) * ulp
    bound = spacing + 4 * torch.finfo(torch.float32).eps * (w64 - b64).abs()
    err = (a64 - b64).abs()
    require(bool((err <= bound).all()),
            f"fused_adam w' beyond its bound by {float((err - bound).max())}")
    return float((err / spacing).max())


#: The passes phase 5 captures per leaf: count_ge's two (the log2 bracket,
#: then the linear refine), one of every other kernel.
LM_PASSES = {"count_ge": ("log2", "refine")}


def phase_lm_kernels(torch, captured, launches, names):
    """The per-leaf kernels ``names`` against their plain versions on
    ``captured`` inputs, with times; ``launches``: the counts of the path
    that gave the inputs.  ``device_ms`` takes in every device operation
    of a wrapper's call, and absmax and count_ge must make one."""
    out = []
    n_cr = LM_ROUNDS * LM_CLIENTS
    for name in names:
        src, replaces, leaf_arg = LM_KERNELS[name]
        per_shape = {}
        for shape_name, n in LM_SHAPES.items():
            passes = LM_PASSES.get(name, ("",))
            calls = captured[name][n]
            require(len(calls) == len(passes),
                    f"{name}: {len(calls)} calls captured at {shape_name}")
            for pass_name, (args, kw) in zip(passes, calls):
                label = f"{shape_name}/{pass_name}" if pass_name \
                    else shape_name
                per_shape[label] = rec = lm_kernel_record(
                    torch, name, args, kw, leaf_arg, n)
                log(f"{name} at {label}: {json.dumps(rec)}")
                if name in ("absmax", "count_ge"):
                    require(rec["device_ops_per_call"] == 1,
                            f"{name} at {label}: "
                            f"{rec['device_ops_per_call']} device operations"
                            f" per call")
        head = per_shape["embed" if name not in LM_PASSES else
                         f"embed/{LM_PASSES[name][0]}"]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"]
                                       for r in per_shape.values()),
                    "ms": head["ms"], "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"],
                    "bound_by": head["bound_by"],
                    "library_ms": head["library_ms"],
                    "device_ms": head["device_ms"],
                    "library_device_ms": head["library_device_ms"],
                    "launches_per_client_round": launches[name] / n_cr,
                    "at": per_shape})
    return out


def lm_kernel_record(torch, name, args, kw, leaf_arg, n):
    """One captured call of a per-leaf kernel: bitwise against its plain
    version, then times (CUDA events for the wrapper, the plain version and
    the library call; torch.profiler for their device time) and the
    bound."""
    fk, fp, lib, nbytes, ops = lm_kernel(torch, name, args, kw)
    a, b = fk(), fp()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    require(len(a) == len(b), f"{name}: output count")
    ulps = 0.0
    if name == "fused_adam":
        ulps = fused_adam_w_check(torch, a[0], b[0], args[1])
        a, b = a[1:], b[1:]
    err = max(max_abs_err(torch, x, y) for x, y in zip(a, b))
    big = n >= 1 << 20
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    dev, dev_ops = device_ms(torch, fk, 10 if big else 50)
    rec = {"elements": n, "dtype": str(args[leaf_arg].dtype),
           "max_abs_err": err, "w_max_ulps": ulps,
           "ms": time_ms(torch, fk, 20 if big else 2000),
           "device_ms": dev, "device_ops_per_call": dev_ops,
           "plain_ms": time_ms(torch, fp, 3 if big else 20),
           "library_ms": None if lib is None else
           time_ms(torch, lib, 20 if big else 2000),
           "library_device_ms": None if lib is None else
           device_ms(torch, lib, 10 if big else 50)[0],
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "operations": ops}
    if name == "count_ge":
        every = count_ge_ops(torch, args[0], args[1])[1]
        rec["operations_compare_all"] = every
        rec["bound_ms_compare_all"] = max(t_bytes,
                                          every / F32_OPS_PER_S * 1e3)
    return rec


def phase_lm_wire_kernels(torch, captured, kernels):
    """pack_words and unpack_words against their plain versions and their
    bounds at the transformer's bitmap: the first client's support and
    words from phase 5's FedAdam-SSM round.  Adds ``at_lm`` to their
    records in ``kernels``."""
    by_name = {k["name"]: k for k in kernels}
    for name in ("pack_words", "unpack_words"):
        ((args, kw),) = captured[name][None]
        rec = measure(torch, name, args, kw, iters=10, plain_iters=1)
        log(f"{name}: lm {json.dumps(rec)}")
        require(rec["elements"] == LM_BITMAP_SLOTS,
                f"{name}: {rec['elements']} bitmap slots")
        k = by_name[name]
        k["max_abs_err"] = max(k["max_abs_err"], rec["max_abs_err"])
        k["at_lm"] = rec


def phase_host_cost(torch, x, iters=5000):
    """Host microseconds per call (host clock, calls enqueued back to back)
    of each step a selection wrapper takes on its way to the card, in the
    way it takes it ("used") beside the dearer way it avoids ("avoided":
    a Stream object per call, a fill launch for the output, a cast launch
    for the counts), at a norm leaf ``x``; then the whole absmax wrapper
    beside ``vector_norm(x, inf)``."""
    import ctypes
    from repro_torch.kernels import _lib
    from repro_torch.kernels.topk_mask import ops as TM
    require(x.dtype == torch.float32, f"the norm leaf is {x.dtype}")
    dev = x.device
    word = torch.zeros((1,), dtype=torch.int32, device=dev)
    counts = torch.zeros((32,), dtype=torch.int32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    st = torch.cuda.current_stream(dev).cuda_stream
    ws = TM._workspace(dev, st)
    launch = _lib._fns["repro_absmax"]
    steps = {
        "stream: current_stream(dev).cuda_stream (avoided)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream: _cuda_getCurrentRawStream (used)":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "pointer: c_void_p(data_ptr()) (avoided)":
            lambda: ctypes.c_void_p(x.data_ptr()),
        "pointer: data_ptr() (used)": lambda: x.data_ptr(),
        "function: getattr(library(), name) (avoided)":
            lambda: getattr(_lib.library(), "repro_absmax"),
        "function: cached (used)": lambda: _lib._fns["repro_absmax"],
        "output: zeros((1,), int32), a fill launch (avoided)":
            lambda: torch.zeros((1,), dtype=torch.int32, device=dev),
        "output: empty((), float32) (used)":
            lambda: torch.empty((), dtype=torch.float32, device=dev),
        "result: view(float32)[0] of an int32 word (avoided)":
            lambda: word.view(torch.float32)[0],
        "result: to(float32) of int32 counts, a cast launch (avoided)":
            lambda: counts.to(torch.float32),
        "checks: dtype, device, contiguity": lambda: TM._leaf_arg(x),
        "ctypes call and kernel launch":
            lambda: launch(x.data_ptr(), ws, out.data_ptr(), x.numel(),
                           0, st),
        "absmax wrapper": lambda: TM.absmax(x),
        "vector_norm(x, inf)":
            lambda: torch.linalg.vector_norm(x, float("inf")),
    }
    res = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        res[name] = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
    log(f"host cost per call at {x.numel()} {x.dtype} elements (us): "
        f"{json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# Phase 7: the transformer round on the card against the CPU
# ---------------------------------------------------------------------------


def phase_lm_card_vs_cpu(torch, np, seed, algorithm):
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import fed_init, make_fl_round
    from repro_torch.launch import train
    from repro_torch.models import model as TM

    # reduce_for_smoke rebuilds each layer with the default gated MLP: put
    # back starcoder2's tanh-GELU MLP, the one phase 5 runs (11 leaves).
    # FedAdam-Top runs the per-leaf masks on that mixed-dtype tree.
    cfg = reduce_for_smoke(get_config("starcoder2-3b"))
    cfg = dataclasses.replace(cfg, layer_pattern=tuple(
        dataclasses.replace(s, gated_mlp=False) for s in cfg.layer_pattern))
    params = TM.init_params(cfg, seed=seed + 1, device="cpu")
    require(len(T.leaves(params)) == 11, "smoke starcoder2 is not 11 leaves")
    C = 4
    results = {}
    for dev in ("cuda", "cpu"):
        fed = dataclasses.replace(lm_fed(C, algorithm),
                                  sparsify_backend="kernel")
        p = T.tree_map(lambda x: x.to(dev), params)
        batch = train.build_client_batches(cfg, C, 2, 128, seed=0,
                                           device=dev)
        loss = lambda q, b: TM.loss_fn(cfg, q, b["tokens"])
        results[dev] = make_fl_round(fed, loss)(fed_init(fed, p), batch)
    (gs, gm), (cs, cm) = results["cuda"], results["cpu"]
    require(float(gm["uplink_bits"]) == float(cm["uplink_bits"]),
            "uplink bits differ between the card and the CPU")
    # the CPU parity tests' bfloat16 tolerances: loss within 2e-3, each
    # client's (dW) support on at most 4% of a leaf's elements
    np.testing.assert_allclose(gm["loss"].cpu().numpy(),
                               cm["loss"].numpy(), rtol=2e-3)
    support = 0.0
    for a, b in zip(T.leaves(gs.client_state["comp"]["err"]),
                    T.leaves(cs.client_state["comp"]["err"])):
        support = max(support, float(np.mean(
            (a.cpu().float().numpy() == 0) != (b.float().numpy() == 0))))
    require(support <= 4e-2, f"EF supports differ on {support:.2e}")
    # W, M and V (FedAdam-Top's M and V carry masks of their own): at most
    # 3% of a leaf beyond rtol 2^-7 plus 1e-3 (W) or 4e-2 (M, V) of the
    # leaf's largest, the bound the CPU tests hold FedAdam-Top's round to
    worst = {}
    for name, atol in (("W", 1e-3), ("M", 4e-2), ("V", 4e-2)):
        for a, b in zip(T.leaves(getattr(gs, name)),
                        T.leaves(getattr(cs, name))):
            a, b = a.cpu().float().numpy(), b.float().numpy()
            bad = ~np.isclose(a, b, rtol=2.0 ** -7,
                              atol=atol * float(np.abs(b).max()))
            worst[name] = max(worst.get(name, 0.0), float(bad.mean()))
    require(all(v <= 3e-2 for v in worst.values()),
            f"W/M/V beyond tolerance on {worst}")
    log(f"lm {algorithm} card vs CPU: loss "
        f"{gm['loss'].cpu().numpy().tolist()} vs "
        f"{cm['loss'].numpy().tolist()}; support mismatch {support:.2e}; "
        f"worst share of a leaf beyond tolerance {worst}")
    return {"loss_cuda": gm["loss"].cpu().numpy().tolist(),
            "loss_cpu": cm["loss"].numpy().tolist(),
            "support_mismatch": support, "wmv_beyond_tolerance": worst}



# ---------------------------------------------------------------------------
# Phase 8: the dense and quantized baselines on the CNN
# ---------------------------------------------------------------------------


def _payload_facts(payload):
    """(bytes, every array on the card) of a wire payload: what a phase
    keeps of it, so that a large payload is not held."""
    from repro_torch.core import wire
    return (wire.payload_nbytes(payload),
            all(a.is_cuda for part in payload for a in part))


def wrap_payload(cap, comp, encoder):
    """Wrap what builds a client's payload in a round: the wire encoder
    (its first payload's facts kept) and, for the dense transport, whose
    round builds no payload, the compressor's ``compress`` (the first
    client's deltas kept by reference)."""
    from repro_torch.core import wire
    cap.wrap(wire, encoder, "payload", keep=_payload_facts)
    if comp.transport == "dense":
        cap.wrap(type(comp), "compress", "deltas", keep=lambda _: None)


def payload_of(cap, comp, what):
    """``((bytes, every array on the card), deltas)`` of the first client's
    payload: the one the round built, or for the dense transport the one
    ``pack_wire`` builds from the first client's deltas (and ``deltas``
    those deltas), the round having built none."""
    from repro_torch.core.compressors import Deltas
    if comp.transport != "dense":
        return cap.outs["payload"], None
    require("payload" not in cap.outs,
            f"{what}: the dense round built a wire payload")
    deltas = Deltas(*cap.args["deltas"][None][0][0][1])
    return _payload_facts(comp.pack_wire(deltas)), deltas


def _finite_state(torch, state, what):
    from repro_torch import tree as T
    for name in "WMV":
        for x in T.leaves(getattr(state, name)):
            require(bool(torch.isfinite(x).all()), f"{what}: {name} not "
                    f"finite")


def _f32(torch, x: int) -> float:
    """``x`` as the round's float32 ``uplink_bits`` holds it."""
    return float(torch.tensor(float(x), dtype=torch.float32))


def _next_state(fed, params, state):
    """The first stage's state from ``params``; a later stage's from the
    last one's W, M and V."""
    from repro_torch.core import fed_init
    if state is None:
        return fed_init(fed, params)
    return fed_init(fed, state.W)._replace(M=state.M, V=state.V)


def phase_cnn_baseline(torch, seed, algorithm):
    """Rounds of a dense or quantized baseline on the CNN at full width (20
    clients, Dirichlet 0.1, batch 32, 3 local epochs; alpha 1.0 as the
    paper's runner sets it for these): per round the launch counters zeroed
    just before and read just after (exact per client), uplink bits and
    wall time; the first client's payload built on the card; peak memory;
    then a profiled round and one that counts stream syncs."""
    from repro_torch.core import make_fl_round
    from repro_torch.core.compressors import make_compressor
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.vision import build_vision

    dev = torch.device("cuda")
    params, _, loss_fn, acc_fn, _ = build_vision("cnn", width=1.0,
                                                 seed=seed, device=dev)
    sizes = tuple(x.numel() for x in params.values())
    imgs, labels, n_train, parts = make_data(seed, CLIENTS)
    test = (torch.from_numpy(imgs[n_train:]).to(dev),
            torch.from_numpy(labels[n_train:]).to(dev))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rounds, stages, state, r = [], {}, None, 0
    # 1-bit Adam as the paper's runner drives it (benchmarks/fl_vision.py):
    # dense FedAdam warm-up rounds, then compressed rounds from their W, M
    # and V
    schedule = [("fedadam", 2), ("onebit_adam", 2)] \
        if algorithm == "onebit_adam" else [(algorithm, ROUNDS)]
    for algo, n in schedule:
        spec = CNN_BASELINES[algo]
        fed = cnn_fed(algo, alpha=1.0)
        comp = make_compressor(fed)
        require(comp.wire_bits_per_client(sizes) == 8 * spec["wire_bytes"],
                f"{algo}: accounted wire bits")
        round_fn = make_fl_round(fed, loss_fn)
        state = _next_state(fed, params, state)
        cap = Capture()
        wrap_payload(cap, comp, spec["encoder"])
        want = {k: v * CLIENTS for k, v in per_client_round(
            pack_words=spec["words"], unpack_words=spec["words"]).items()}
        for _ in range(n):
            batch, w = round_batch(torch, imgs, labels, n_train, parts, r,
                                   dev)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            state, mets = round_fn(state, batch, w)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            with torch.no_grad():
                acc = float(acc_fn(state.W, test))
            loss = float(mets["loss"].mean())
            uplink = float(mets["uplink_bits"])
            rounds.append({"round": r, "algorithm": algo, "loss": loss,
                           "test_acc": acc, "wall_s": wall,
                           "uplink_bits": uplink, "launches": launches})
            log(f"cnn {algorithm} round {r} ({algo}): loss={loss:.6f} "
                f"test_acc={acc:.4f} wall={wall:.4f} s launches="
                f"{ {k: v for k, v in launches.items() if v} }")
            require(math.isfinite(loss), f"{algo} round {r} loss is {loss}")
            require(launches == want, f"{algo} launches {launches}, "
                    f"expected {want}")
            require(uplink == _f32(torch, CLIENTS * 8 * spec["wire_bytes"]),
                    f"{algo} uplink bits {uplink}")
            r += 1
        cap.restore()
        (nbytes, on_card), _ = payload_of(cap, comp, algo)
        del cap
        require(on_card, f"{algo}: the payload was not built on the card")
        require(nbytes == spec["wire_bytes"],
                f"{algo}: the card's payload holds {nbytes} bytes")
        stages[algo] = {"payload_bytes": nbytes,
                        "launches_per_client_round":
                            {k: v // CLIENTS for k, v in want.items() if v}}
    peak = torch.cuda.max_memory_allocated()
    _finite_state(torch, state, f"cnn {algorithm}")
    prof = profile_round(torch, round_fn, state, batch, w,
                         port_kernels=bool(spec["words"]))
    prof["syncs"] = count_syncs(torch, round_fn, state, batch, w)
    require(prof["syncs"]["per_round"] == 0,
            f"cnn {algorithm} synchronised the stream: {prof['syncs']}")
    walls = [x["wall_s"] for x in rounds]
    log(f"cnn {algorithm}: payload bytes {stages}; peak "
        f"{peak / 2**30:.3f} GiB; profiled round {json.dumps(prof)}")
    return {"rounds": rounds, "stages": stages, "peak_bytes": peak,
            "held_bytes_at_start": held,
            "wall_s_after_first": walls[1:], "round_profile": prof}


# ---------------------------------------------------------------------------
# Phase 9: exact top-k on ties, the card against the CPU
# ---------------------------------------------------------------------------


def exact_mask_designs(torch, S, k):
    """Three designs of the exact blocked mask over an (nb, BLOCK) tile of
    magnitudes, timed beside each other: ``torch.topk``'s indices
    scattered (ties kept in an unstated order), the first k of a full
    stable sort (the lower index kept among ties), and the one the port
    ships, the k-th value and a running count of its ties (the same set
    as the sort's)."""
    def scatter(a, idx):
        m = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        return m.scatter_(1, idx, True)
    return {
        "topk_indices": lambda a: scatter(a, torch.topk(a, k, dim=1)
                                          .indices),
        "stable_sort": lambda a: scatter(a, torch.sort(
            a, dim=1, descending=True, stable=True).indices[:, :k]),
        "kth_value_tie_count": lambda a: S._topk_rows(a, k),
    }


def phase_exact_topk(torch, np, seed):
    """The exact masks' tie order on the card: ``topk_mask_exact`` and
    ``blocked_topk_mask`` on tied float32 and bfloat16 leaves, the blocked
    one with a mostly zero, padded last block, bitwise against the CPU;
    then the blocked mask of a tied bfloat16 leaf of starcoder2-3b's embed
    size (144 blocks of 2^20), its wall time and peak memory, with three
    of its rows against the CPU; then the three designs of
    :func:`exact_mask_designs` on that leaf's magnitudes, each timed with
    CUDA events and its peak memory above its input read."""
    from repro_torch.core import sparsify as S
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    tied = lambda n: np.round(rng.standard_normal(n), 1).astype(np.float32)
    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(tied(65_536)).to(dtype)
        k = S.k_for(x.numel(), 0.05)
        require(torch.equal(S.topk_mask_exact(x.to(dev), k).cpu(),
                            S.topk_mask_exact(x, k)),
                f"topk_mask_exact on ties differs from the CPU ({dtype})")
        y = tied((1 << 20) + 3000)
        y[(1 << 20) + 100:] = 0.0
        y = torch.from_numpy(y).to(dtype)
        require(torch.equal(S.blocked_topk_mask(y.to(dev), 0.05).cpu(),
                            S.blocked_topk_mask(y, 0.05)),
                f"blocked_topk_mask on ties differs from the CPU ({dtype})")
        checked += [f"exact 65536 {dtype}", f"blocked 2^20+3000 {dtype}"]
    n, B = LM_SHAPES["embed"], S.BLOCK
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randint(-64, 65, (n,), generator=gen, device=dev)
         .to(torch.float32) * 2.0 ** -10).to(torch.bfloat16)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mask = S.blocked_topk_mask(x, 0.05)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    kept = int(mask.sum())
    require(kept == n // B * S.k_for(B, 0.05), f"embed mask keeps {kept}")
    for row in (0, 1, n // B - 1):
        sl = slice(row * B, (row + 1) * B)
        require(torch.equal(mask[sl].cpu(),
                            S.blocked_topk_mask(x[sl].cpu(), 0.05)),
                f"embed-size blocked mask row {row} differs from the CPU")
    checked.append("blocked embed rows 0, 1, 143 bfloat16")
    a = x.abs().reshape(n // B, B)
    designs = {}
    for name, fn in exact_mask_designs(torch, S, S.k_for(B, 0.05)).items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m = fn(a)
        torch.cuda.synchronize()
        rec = {"peak_bytes_above_input":
                   torch.cuda.max_memory_allocated() - base,
               "ms": time_ms(torch, lambda: fn(a), 5),
               "positions_differing_from_shipped":
                   int((m.reshape(-1) != mask).sum())}
        del m
        designs[name] = rec
    require(designs["stable_sort"]["positions_differing_from_shipped"] == 0,
            "the stable sort's embed mask differs from the shipped one")
    log(f"exact top-k ties: {checked} equal on the card and the CPU; embed "
        f"({n} bfloat16, {n // B} blocks) in {wall * 1e3:.3f} ms, peak "
        f"{peak / 2**30:.3f} GiB above its input; designs "
        f"{json.dumps(designs)}")
    return {"checked": checked, "embed_ms": wall * 1e3,
            "embed_peak_bytes_above_input": peak, "embed_kept": kept,
            "embed_designs": designs}


# ---------------------------------------------------------------------------
# Phase 10: the quantized baselines on starcoder2-3b
# ---------------------------------------------------------------------------


def lm_loss(cfg):
    from repro_torch.models.model import loss_fn
    return lambda p, batch: loss_fn(cfg, p, batch["tokens"], remat="none")


def phase_lm_baseline(torch, seed, algorithm):
    """Efficient-Adam (2 rounds, the persistent local Adam through the
    fused kernel) or 1-bit Adam (1 dense FedAdam warm-up round, then 1
    compressed round from its W, M and V) on starcoder2-3b at full width,
    2 repeats, 4 clients, batch 2, sequence 128: per round the launch
    counters zeroed just before and read just after (exact per client),
    uplink bits, wall time and peak memory; then per stage a round that
    counts stream syncs, in which the payload is measured and the word
    kernels' inputs (or the dense stage's first client deltas, from which
    ``pack_wire`` builds the payload the dense round does not) are
    captured, and a profiled round of the compressed stage."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import make_fl_round
    from repro_torch.core.compressors import make_compressor
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.wirepack import ops as WO
    from repro_torch.launch import train
    from repro_torch.models.model import init_params

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              pattern_repeats=LM_REPEATS)
    loss = lm_loss(cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=seed, device=dev)
    sizes = tuple(x.numel() for x in T.leaves(params))
    require(sum(sizes) == LM_PARAMS, f"{sum(sizes)} parameters")
    schedule = [("fedadam", 1), ("onebit_adam", 1)] \
        if algorithm == "onebit_adam" else [(algorithm, LM_ROUNDS)]
    batches = [train.build_client_batches(cfg, LM_CLIENTS, 2, 128, seed=r,
                                          device=dev)
               for r in range(sum(n for _, n in schedule))]
    out = {"rounds": [], "stages": {}, "held_bytes_at_start": held}
    captured, state, r = {}, None, 0
    for algo, n in schedule:
        spec = LM_BASELINES[algo]
        fed = lm_fed(LM_CLIENTS, algo)
        comp = make_compressor(fed)
        require(comp.wire_bits_per_client(sizes) == 8 * spec["wire_bytes"],
                f"{algo}: accounted wire bits")
        round_fn = make_fl_round(fed, loss)
        state, params = _next_state(fed, params, state), None
        want = {k: v * LM_CLIENTS for k, v in spec["launches"].items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(n):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            state, mets = round_fn(state, batches[r])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            losses = mets["loss"].cpu().tolist()
            uplink = float(mets["uplink_bits"])
            out["rounds"].append({"round": r, "algorithm": algo,
                                  "loss": losses, "wall_s": wall,
                                  "uplink_bits": uplink,
                                  "launches": launches})
            log(f"lm {algorithm} round {r} ({algo}): loss={losses} "
                f"wall={wall:.3f} s launches="
                f"{ {k: v for k, v in launches.items() if v} }")
            require(all(math.isfinite(v) for v in losses),
                    f"lm {algo} round {r} loss is {losses}")
            require(launches == want, f"lm {algo} launches {launches}, "
                    f"expected {want}")
            require(uplink == _f32(torch, LM_CLIENTS * 8
                                   * spec["wire_bytes"]),
                    f"lm {algo} uplink bits {uplink}")
            r += 1
        peak = torch.cuda.max_memory_allocated()
        _finite_state(torch, state, f"lm {algo}")
        batch = batches[r - 1]
        stage = {"peak_bytes": peak,
                 "launches_per_client_round":
                     {k: v for k, v in spec["launches"].items() if v}}
        if spec["words"]:
            stage["round_profile"] = profile_round(torch, round_fn, state,
                                                   batch, None)
        # the captures ride the sync-counting round, out of the peak
        cap = Capture()
        wrap_payload(cap, comp, spec["encoder"])
        if spec["words"]:
            cap.wrap(WO, "pack_words", "pack_words")
            cap.wrap(WO, "unpack_words", "unpack_words")
        syncs = count_syncs(torch, round_fn, state, batch, None)
        cap.restore()
        require(syncs["per_round"] == 0,
                f"lm {algo} synchronised the stream: {syncs}")
        (nbytes, on_card), deltas = payload_of(cap, comp, f"lm {algo}")
        require(on_card, f"lm {algo}: the payload was not built on the card")
        require(nbytes == spec["wire_bytes"],
                f"lm {algo}: the card's payload holds {nbytes} bytes")
        stage.update(payload_bytes=nbytes, syncs=syncs)
        if spec["words"]:
            captured[algo] = {k: cap.args[k][None][0]
                              for k in ("pack_words", "unpack_words")}
        else:
            stage["pack_dense"] = time_pack_dense(torch, tuple(deltas))
        out["stages"][algo] = stage
        del cap, deltas  # the dense deltas stay out of the next stage
        log(f"lm {algorithm} stage {algo}: peak {peak / 2**30:.2f} GiB "
            f"({held / 2**30:.2f} GiB held before the phase); payload "
            f"{nbytes} bytes; syncs {syncs['per_round']}; "
            f"{json.dumps(stage.get('round_profile', {}))}")
    return out, captured


def time_pack_dense(torch, trees):
    """``wire.pack_dense`` on a client's dense deltas at the model's size
    (the dense payload, one float32 plane per tensor), timed with CUDA
    events, beside the bytes it must move over the card's rate."""
    from repro_torch import tree as T
    from repro_torch.core import wire
    leaves = [x for t in trees for x in T.leaves(t)]
    n = sum(x.numel() for x in leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves) + 4 * n
    ms = time_ms(torch, lambda: wire.pack_dense(trees), 5)
    rec = {"ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bytes": nbytes, "elements": n}
    log(f"pack_dense at the model's size: {json.dumps(rec)}")
    return rec


def phase_lm_baseline_kernels(torch, captured, kernels):
    """pack_words and unpack_words against their plain versions on the
    transformer client's own inputs: Efficient-Adam's 8-bit codes and 1-bit
    Adam's sign plane (493,895,680 slots each).  Adds ``at_lm_<algo>`` to
    their records in ``kernels``."""
    by_name = {k["name"]: k for k in kernels}
    for algo, calls in captured.items():
        for name in ("pack_words", "unpack_words"):
            args, kw = calls[name]
            want = LM_BASELINES[algo]["bits"]
            require(word_bits(args) == want,
                    f"lm {algo} {name}: b={word_bits(args)}, not {want}")
            rec = measure(torch, name, args, kw, iters=10, plain_iters=1)
            log(f"{name}: lm {algo} {json.dumps(rec)}")
            require(rec["elements"] == LM_BITMAP_SLOTS,
                    f"{name}: {rec['elements']} slots")
            k = by_name[name]
            k["max_abs_err"] = max(k["max_abs_err"], rec["max_abs_err"])
            k[f"at_lm_{algo}"] = rec



# ---------------------------------------------------------------------------
# Phase 11: the CNN's round drivers (participation, vmap, async, checkpoint)
# ---------------------------------------------------------------------------


def _states_bitwise(torch, a, b, what, parts=("W", "M", "V",
                                             "client_state")):
    """Raise unless FedStates ``a`` and ``b`` agree bit for bit."""
    from repro_torch import tree as T
    for name in parts:
        la, lb = T.leaves(getattr(a, name)), T.leaves(getattr(b, name))
        require(len(la) == len(lb), f"{what}: {name} has another structure")
        for x, y in zip(la, lb):
            require(x.shape == y.shape and x.dtype == y.dtype and
                    torch.equal(_bits(torch, x), _bits(torch, y.to(x.device))),
                    f"{what}: {name} differs")
    require(int(a.round) == int(b.round), f"{what}: round differs")


def _timed(torch, fn):
    """``(out, wall seconds, peak bytes, launches)`` of ``fn()``: the peak
    memory statistic and the launch counters reset just before it."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            dict(LAUNCHES))


def _per(launches, n):
    return {k: v / n for k, v in launches.items() if v}


def _dispatch_launches(per_client, dispatches, landed, decoded):
    """An async run's launches: each dispatch a scan client's, each landed
    update one more ``pack_words`` (its repack), each payload a server
    step folds one more ``unpack_words``; the kernels that launch."""
    want = collections.Counter({k: v * dispatches
                                for k, v in per_client.items()})
    want["pack_words"] += landed
    want["unpack_words"] += decoded
    return {k: v for k, v in want.items() if v}


def phase_cnn_drivers(torch, np, seed):
    """The FL round's drivers on the CNN at full width, phase 2's
    configuration and data: (a) one round with participation 0.5 (the
    JAX round's draw, 10 clients billed, the other 10 weighted 0.0); (b)
    one vmap round with the wire transport, bitwise the scan round from
    the same state; (c) one vmap round with the dense transport, within
    the summation bound of the scan round; (d) the buffered-async driver
    with zero churn and K = 20, one server step: bitwise the scan round;
    (e) the async driver under churn (K 5, jitter 3, stragglers 0.1, drops
    0.2, max staleness 2, 4 server steps): bills exactly the landed
    payloads, leaves each dropped or discarded client's residual as its
    last accepted update left it, and replays bitwise from its seed; (f)
    (e)'s state through the port's checkpoint, loaded on the CPU, bitwise.
    Walls, peaks, launches per client or dispatch and stream syncs of
    each (one for an async run: its step losses, read once at the end).
    Also returns the first inputs (e)'s run gave each kernel, which
    ``phase_driver_kernels`` holds against the plain versions."""
    import tempfile
    from repro_torch import tree as T
    from repro_torch.checkpoint import load_fed_state, save_fed_state
    from repro_torch.core import (AsyncConfig, _threefry, aggregate,
                                  async_fed, fed_init, make_async_round,
                                  make_fl_round)
    from repro_torch.core import sparsify, wire
    from repro_torch.core.fed import participation_weights
    from repro_torch.data import ChurnConfig, ChurnModel
    from repro_torch.models.vision import build_vision

    dev = torch.device("cuda")
    params, _, loss_fn, _, _ = build_vision("cnn", width=1.0, seed=seed,
                                            device=dev)
    imgs, labels, n_train, parts = make_data(seed, CLIENTS)
    batch, w = round_batch(torch, imgs, labels, n_train, parts, 0, dev)
    w_host = w.cpu().numpy()
    out = {}

    # the scan round every driver is held against
    fed = cnn_fed("fedadam_ssm")
    state0 = fed_init(fed, params)
    scan_fn = make_fl_round(fed, loss_fn)
    (scan, smets), wall, peak, launches = _timed(
        torch, lambda: scan_fn(state0, batch, w))
    per_client = _per(launches, CLIENTS)
    out["scan"] = {"wall_s": wall, "peak_bytes": peak,
                   "launches_per_client": per_client}
    log(f"cnn drivers: scan round wall={wall:.4f} s peak="
        f"{peak / 2**30:.3f} GiB launches/client={per_client}")

    # (a) participation 0.5
    fed_p = cnn_fed("fedadam_ssm", participation=0.5)
    part_fn = make_fl_round(fed_p, loss_fn)
    (st, mets), wall, peak, launches = _timed(
        torch, lambda: part_fn(state0, batch, w))
    masked = participation_weights(fed_p, w, 0).cpu().numpy()
    active = sorted(int(c) for c in _threefry.client_permutation(0, CLIENTS)
                    [:CLIENTS // 2])
    uplink = float(mets["uplink_bits"])
    syncs = count_syncs(torch, part_fn, state0, batch, w)
    log(f"cnn participation 0.5: active clients {active}; wall={wall:.4f} s "
        f"uplink bits {uplink}; syncs {syncs['per_round']}")
    require(np.flatnonzero(masked).tolist() ==
            [c for c in active if w_host[c] > 0],
            f"weighted clients {np.flatnonzero(masked).tolist()}")
    require(all(masked[c] == 0.0 for c in range(CLIENTS) if c not in active),
            "an undrawn client kept its weight")
    require(uplink == CLIENTS // 2 * 8 * CNN_WIRE_BYTES_PER_CLIENT,
            f"uplink bits {uplink}")
    require(_per(launches, CLIENTS) == per_client,
            f"participation launches {launches}")
    require(syncs["per_round"] == 0, f"participation syncs {syncs}")
    _finite_state(torch, st, "cnn participation")
    out["participation"] = {"active": active, "wall_s": wall,
                            "peak_bytes": peak, "uplink_bits": uplink,
                            "launches_per_client": _per(launches, CLIENTS),
                            "syncs": syncs}
    del st, mets

    # (b) vmap, the wire transport: bitwise the scan round
    fed_v = cnn_fed("fedadam_ssm", client_mode="vmap",
                    aggregate="sparse_gather")
    vmap_fn = make_fl_round(fed_v, loss_fn)
    (st, mets), wall, peak, launches = _timed(
        torch, lambda: vmap_fn(state0, batch, w))
    _states_bitwise(torch, st, scan, "cnn vmap wire round vs scan")
    require(float(mets["uplink_bits"]) == float(smets["uplink_bits"]),
            "vmap uplink bits")
    require(_per(launches, CLIENTS) == per_client,
            f"vmap launches {launches}")
    syncs = count_syncs(torch, vmap_fn, state0, batch, w)
    require(syncs["per_round"] == 0, f"vmap syncs {syncs}")
    out["vmap_wire"] = {"wall_s": wall, "peak_bytes": peak,
                        "launches_per_client": _per(launches, CLIENTS),
                        "syncs": syncs, "bitwise_scan": True}
    log(f"cnn vmap wire round: bitwise the scan round; wall={wall:.4f} s "
        f"peak={peak / 2**30:.3f} GiB")
    del st, mets

    # (c) vmap, the dense transport: the weighted sum in the library's
    # order, within C * eps * sum |w x| of the scan's fold
    fed_d = cnn_fed("fedadam_ssm", client_mode="vmap", aggregate="dense")
    cap = Capture()
    cap.wrap(aggregate, "dense_weighted_sum", "dense", calls=3)
    (st, _), wall, peak, launches = _timed(
        torch, lambda: make_fl_round(fed_d, loss_fn)(state0, batch, w))
    cap.restore()
    eps = float(np.finfo(np.float32).eps)
    worst, wsum = 0.0, float(w.sum())
    require(len(cap.args["dense"][None]) == 3, "dense sums of W, M, V")
    for name, ((trees, weights), _) in zip("WMV", cap.args["dense"][None]):
        dense = aggregate.dense_weighted_sum(trees, weights)
        fold = aggregate.ordered_weighted_sum(trees, weights)
        for k, x in trees.items():
            mag = (weights.double()[:, None] * x.double().reshape(
                x.shape[0], -1)).abs().sum(0).reshape(x.shape[1:])
            err = (dense[k].double() - fold[k].double()).abs()
            worst = max(worst, float((err / (CLIENTS * eps * mag)
                                      ).nan_to_num(0.0).max()))
            require(bool((err <= CLIENTS * eps * mag).all()),
                    f"dense sum of {k} beyond C * eps * sum |w x|")
            # the server adds sum / wsum to the global: the sums' bound,
            # a rounding of each quotient and of each sum
            a, b = getattr(st, name)[k], getattr(scan, name)[k]
            bound = (CLIENTS + 1) * eps * mag / wsum + 2 * eps * \
                torch.maximum(a.abs(), b.abs()).double()
            require(bool(((a.double() - b.double()).abs() <= bound).all()),
                    f"dense vmap {name}[{k}] beyond the bound of the scan "
                    f"round's")
    syncs = count_syncs(torch, make_fl_round(fed_d, loss_fn), state0,
                        batch, w)
    require(syncs["per_round"] == 0, f"dense vmap syncs {syncs}")
    out["vmap_dense"] = {"wall_s": wall, "peak_bytes": peak,
                         "launches_per_client": _per(launches, CLIENTS),
                         "worst_err_over_bound": worst, "syncs": syncs}
    log(f"cnn vmap dense round: the sums within {worst:.3f} of C * eps * "
        f"sum |w x|; wall={wall:.4f} s")
    del st, cap

    # (d) async, zero churn, K = 20, one server step: the scan round
    deg = make_async_round(fed, loss_fn, AsyncConfig(buffer_size=CLIENTS),
                           churn=ChurnModel(ChurnConfig(), CLIENTS))
    (st, mets), wall, peak, launches = _timed(
        torch, lambda: deg(state0, batch, w_host, rounds=1))
    _states_bitwise(torch, st, scan, "cnn async degenerate vs scan")
    require(mets["landed"] == CLIENTS and mets["server_steps"] == 1,
            f"degenerate async: {mets['landed']} landed")
    require(float(mets["uplink_bits"]) == float(smets["uplink_bits"]),
            "degenerate async uplink bits")
    # a dispatch is a scan client; each landed update is repacked once,
    # and decoded once by the server step
    want = _dispatch_launches(per_client, CLIENTS, CLIENTS, CLIENTS)
    require({k: v for k, v in launches.items() if v} == want,
            f"degenerate async launches {launches}, expected {want}")
    syncs = count_syncs(torch, lambda s, b, w_: deg(s, b, w_, rounds=1),
                        state0, batch, w_host)
    # its one sync: the step losses read to the host after the simulation
    require(syncs["per_round"] == 1, f"degenerate async syncs {syncs}")
    out["async_degenerate"] = {"wall_s": wall, "peak_bytes": peak,
                               "launches_per_dispatch":
                                   _per(launches, CLIENTS),
                               "bitwise_scan": True, "syncs": syncs}
    log(f"cnn async degenerate (K=20, no churn): bitwise the scan round; "
        f"wall={wall:.4f} s")
    del st, mets

    # (e) async under churn, twice from the same seed
    churn_cfg = ChurnConfig(seed=seed, jitter=3, straggler_prob=0.1,
                            drop_prob=0.2)
    acfg = AsyncConfig(buffer_size=5, max_staleness=2)
    committed = {}
    make_commit = async_fed.make_commit_client

    def recording_commit(has_cs):
        commit = make_commit(has_cs)

        def rec(cs, new_c, c):
            committed[c] = T.tree_map(torch.clone, new_c["comp"]["err"])
            return commit(cs, new_c, c)
        return rec

    def churned():
        run = make_async_round(fed, loss_fn, acfg,
                               churn=ChurnModel(churn_cfg, CLIENTS))
        return run(state0, batch, w_host, rounds=4)

    async_fed.make_commit_client = recording_commit
    try:
        (st, mets), wall, peak, launches = _timed(torch, churned)
    finally:
        async_fed.make_commit_client = make_commit
    ev = mets["events"]
    dispatches = sum(e[1] == "dispatch" for e in ev)
    landed, steps = mets["landed"], mets["server_steps"]
    require(steps == 4, f"{steps} server steps")
    require(mets["dropped"] + mets["discarded"] > 0,
            "the churn dropped and discarded nothing")
    require(sum(mets["bits_per_step"]) == 8 * CNN_WIRE_BYTES_PER_CLIENT
            * landed, f"billed {mets['bits_per_step']} for {landed} landed")
    require(float(mets["uplink_bits"]) == _f32(
        torch, landed * 8 * CNN_WIRE_BYTES_PER_CLIENT),
        f"uplink bits {float(mets['uplink_bits'])} for {landed} landed")
    # a dispatch is a scan client; a landed update is repacked once and
    # every buffered payload decoded once by its server step
    want = _dispatch_launches(per_client, dispatches, landed,
                              acfg.buffer_size * steps)
    require({k: v for k, v in launches.items() if v} == want,
            f"churn async launches {launches}, expected {want}")
    err = st.client_state["comp"]["err"]
    for c in range(CLIENTS):
        for k, x in err.items():
            last = committed[c][k] if c in committed else \
                state0.client_state["comp"]["err"][k][c]
            require(torch.equal(_bits(torch, x[c]), _bits(torch, last)),
                    f"client {c}'s residual is not its last accepted one")
    # the sync-counting run also keeps one dispatch's kernel inputs (the
    # first call of each), which main() holds against the plain versions
    cap = Capture()
    cap.wrap(sparsify, "packed_hist", "packed_hist")
    cap.wrap(sparsify, "packed_apply", "packed_apply")
    cap.wrap(wire, "pack_mask_bits", "pack_words")
    cap.wrap(wire, "unpack_mask_bits", "unpack_words")
    try:
        syncs = count_syncs(torch, lambda s, b, w_: make_async_round(
            fed, loss_fn, acfg, churn=ChurnModel(churn_cfg, CLIENTS))(
                s, b, w_, rounds=4), state0, batch, w_host)
    finally:
        cap.restore()
    require(syncs["per_round"] == 1, f"churn async syncs {syncs}")
    captured = {k: cap.args[k][None] for k in KERNELS}
    (st2, mets2), wall2, _, _ = _timed(torch, churned)
    require(mets2["events"] == ev, "the replay's event log differs")
    _states_bitwise(torch, st2, st, "cnn async replay")
    del st2, mets2
    counts = {k: mets[k] for k in ("server_steps", "landed", "dropped",
                                   "discarded", "buffer_pending")}
    out["async_churn"] = dict(counts, wall_s=wall, replay_wall_s=wall2,
                              peak_bytes=peak, dispatches=dispatches,
                              launches=launches,
                              launches_per_dispatch=_per(launches,
                                                         dispatches),
                              uplink_bits=float(mets["uplink_bits"]),
                              bits_per_step=mets["bits_per_step"],
                              syncs=syncs, replay_bitwise=True)
    log(f"cnn async churn (K=5): {json.dumps(counts)}; {dispatches} "
        f"dispatches; wall={wall:.3f} s (replay {wall2:.3f} s); launches "
        f"{launches}; syncs {syncs['per_round']} at {syncs['sites']}")

    # (f) the checkpoint, loaded on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_fed_state(st, Path(tmp) / "ck", meta={"phase": 11})
        on_cpu = st._replace(**{k: T.tree_map(
            lambda x: torch.zeros(x.shape, dtype=x.dtype), getattr(st, k))
            for k in ("W", "M", "V", "client_state")}, round=0)
        back = load_fed_state(on_cpu, Path(tmp) / "ck")
        ck_s = time.perf_counter() - t0
        size = (Path(tmp) / "ck.npz").stat().st_size
    require(all(x.device.type == "cpu" for x in T.leaves(back.W)),
            "the checkpoint did not load on the CPU")
    _states_bitwise(torch, back, st, "cnn checkpoint round trip")
    out["checkpoint"] = {"bytes": size, "save_load_s": ck_s,
                         "bitwise": True}
    log(f"cnn checkpoint: {size} bytes, saved and loaded on the CPU in "
        f"{ck_s:.3f} s, bitwise")
    return out, captured


def phase_driver_kernels(torch, captured, kernels, label):
    """Each kernel against its plain version, bitwise, on the inputs a
    driver's run gave it (``captured``: name -> list of ``(args, kw)``;
    fused_adam's w' within its root's bound, as in phase 6).  Adds
    ``at_<label>`` to the kernels' records and folds the error into their
    ``max_abs_err``."""
    by_name = {k["name"]: k for k in kernels}
    for name, calls in captured.items():
        require(len(calls) > 0, f"{label}: no input of {name} captured")
        errs = []
        for args, kw in calls:
            if name in KERNELS:
                fk, fp, _ = run_kernel(torch, name, args, kw)
            else:
                fk, fp = lm_kernel(torch, name, args, kw)[:2]
            a, b = fk(), fp()
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            require(len(a) == len(b), f"{name}: output count")
            if name == "fused_adam":
                fused_adam_w_check(torch, a[0], b[0], args[1])
                a, b = a[1:], b[1:]
            errs.append(max(max_abs_err(torch, x, y) for x, y in zip(a, b)))
        rec = {"calls": len(calls), "max_abs_err": max(errs)}
        log(f"{name} at {label}: bitwise its plain version {json.dumps(rec)}")
        k = by_name[name]
        k["max_abs_err"] = max(k["max_abs_err"], rec["max_abs_err"])
        k[f"at_{label}"] = rec


# ---------------------------------------------------------------------------
# Phase 12: the transformer's vmap round and the async trainer
# ---------------------------------------------------------------------------


def phase_lm_drivers(torch, seed):
    """starcoder2-3b at phase 5's width and cut: (a) one vmap round with
    the wire transport (FedAdam-SSM, fused Adam, threshold masks, error
    feedback, 4 clients), bitwise the scan round from the same state (the
    scan round's result is held on the host meanwhile), with its peak
    memory; (b) the async trainer as its command line runs it (``--async-
    buffer 2 --churn-jitter 2 --churn-drop-prob 0.25 --rounds 2
    --checkpoint``, 4 clients), in process: server steps, landed, dropped
    and discarded updates, uplink (exactly the landed payloads), wall time
    and peak memory.  Also returns the first inputs (a)'s round gave the
    per-leaf kernels at w_up and a norm leaf, which
    ``phase_driver_kernels`` holds against the plain versions."""
    import dataclasses
    import io
    import tempfile
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import fed_init, make_fl_round
    from repro_torch.launch import train

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              pattern_repeats=LM_REPEATS)
    spec = LM_PATHS["fedadam_ssm"]
    loss = lm_loss(cfg)
    out = {}
    fed = lm_fed(LM_CLIENTS, "fedadam_ssm")
    round_fn, state0 = train.make_trainer(cfg, fed, seed=seed, device=dev)
    batch = train.build_client_batches(cfg, LM_CLIENTS, 2, 128, seed=0,
                                       device=dev)
    (scan, smets), wall, peak, launches = _timed(
        torch, lambda: round_fn(state0, batch))
    want = {k: v * LM_CLIENTS for k, v in spec["launches"].items()}
    require(launches == want, f"lm scan launches {launches}")
    scan = scan._replace(**{k: T.tree_map(lambda x: x.cpu(),
                                          getattr(scan, k))
                            for k in ("W", "M", "V", "client_state")})
    out["scan"] = {"wall_s": wall, "peak_bytes": peak}
    log(f"lm scan round: wall={wall:.3f} s peak={peak / 2**30:.2f} GiB")
    del round_fn

    fed_v = dataclasses.replace(fed, client_mode="vmap",
                                aggregate="sparse_gather")
    vmap_fn = make_fl_round(fed_v, loss)
    (st, mets), wall, peak, launches = _timed(
        torch, lambda: vmap_fn(state0, batch))
    require(launches == want, f"lm vmap launches {launches}, "
            f"expected {want}")
    require(float(mets["uplink_bits"]) == float(smets["uplink_bits"]),
            "lm vmap uplink bits")
    _states_bitwise(torch, st, scan, "lm vmap wire round vs scan")
    stacked = LM_CLIENTS * spec["wire_bytes"]
    del st, mets
    # the sync-counting round also keeps the per-leaf kernels' first
    # inputs at w_up and a norm leaf (count_ge's two passes), which main()
    # holds against the plain versions
    cap = Capture()
    entry = _lm_entry_points()
    for name in spec["replayed"]:
        cap.wrap(*entry[name], name, LM_KERNELS[name][2],
                 (LM_SHAPES["w_up"], LM_SHAPES["norm"]),
                 len(LM_PASSES.get(name, ("",))))
    try:
        syncs = count_syncs(torch, vmap_fn, state0, batch, None)
    finally:
        cap.restore()
    require(syncs["per_round"] == 0, f"lm vmap syncs {syncs}")
    captured = {k: [c for calls in cap.args[k].values() for c in calls]
                for k in spec["replayed"]}
    out["vmap_wire"] = {"wall_s": wall, "peak_bytes": peak,
                        "stacked_payload_bytes": stacked,
                        "launches_per_client": _per(launches, LM_CLIENTS),
                        "bitwise_scan": True, "syncs": syncs}
    log(f"lm vmap wire round: bitwise the scan round; wall={wall:.3f} s "
        f"peak={peak / 2**30:.2f} GiB (stacked payloads "
        f"{stacked / 2**30:.2f} GiB)")
    del scan, state0, vmap_fn

    # (b) the async trainer's command line, in process, at the 2-repeat
    # cut (the command's config is the full 30 repeats)
    own = train.get_config
    train.get_config = lambda name: dataclasses.replace(
        own(name), pattern_repeats=LM_REPEATS)
    argv = ["--arch", "starcoder2-3b", "--kernel-adam", "--threshold-topk",
            "--async-buffer", "2", "--churn-jitter", "2",
            "--churn-drop-prob", "0.25", "--rounds", "2"]
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck = str(Path(tmp) / "ck")
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                (st, mets), wall, peak, launches = _timed(
                    torch, lambda: train.main(argv + ["--checkpoint", ck]))
            ck_bytes = (Path(tmp) / "ck.npz").stat().st_size
    finally:
        train.get_config = own
    lines = printed.getvalue().splitlines()
    for line in lines:
        log(f"lm async trainer: {line}")
    landed = mets["landed"]
    counts = {k: mets[k] for k in ("server_steps", "landed", "dropped",
                                   "discarded", "buffer_pending")}
    require(mets["server_steps"] == 2, f"{mets['server_steps']} steps")
    require(sum(mets["bits_per_step"]) == 8 * spec["wire_bytes"] * landed,
            f"billed {mets['bits_per_step']} for {landed} landed")
    require(float(mets["uplink_bits"]) == _f32(
        torch, landed * 8 * spec["wire_bytes"]), "lm async uplink bits")
    require(any(x.startswith("[train] async: 2 server steps") for x in lines)
            and lines[-1] == f"[train] saved {ck}", "the trainer's lines")
    _finite_state(torch, st, "lm async")
    dispatches = sum(e[1] == "dispatch" for e in mets["events"])
    out["async_trainer"] = dict(
        counts, argv=argv, wall_s=wall, peak_bytes=peak,
        dispatches=dispatches, launches=launches,
        launches_per_dispatch=_per(launches, dispatches),
        uplink_bytes=sum(mets["bits_per_step"]) // 8,
        checkpoint_bytes=ck_bytes)
    log(f"lm async trainer: {json.dumps(counts)}; {dispatches} dispatches; "
        f"uplink {sum(mets['bits_per_step']) // 8} bytes; wall={wall:.2f} s "
        f"peak={peak / 2**30:.2f} GiB; checkpoint {ck_bytes} bytes")
    return out, captured



# ---------------------------------------------------------------------------
# Phase 13: the MoE, MLA and Mamba-2 (SSD) layers at full width
# ---------------------------------------------------------------------------


def _nondeterministic(torch, round_fn, state, batch, first, loss):
    """Why two rounds from one state differ: the leaves of W, M, V and the
    client state that differ, and the parameters whose gradient (one
    client's first local step, taken twice) differs, named by their path:
    the backward operation that writes that gradient is the one to fix."""
    from repro_torch import tree as T
    from repro_torch.checkpoint.io import _paths
    from repro_torch.core.fed import _value_and_grad
    second = round_fn(state, batch)[0]
    names = [n for n, _ in _paths(state.W, ())]
    out = {}
    for part in ("W", "M", "V"):
        out[part] = [n for n, x, y in zip(names, T.leaves(getattr(second,
                                                                part)),
                                          T.leaves(getattr(first, part)))
                     if not torch.equal(_bits(torch, x),
                                        _bits(torch, y.to(x.device)))]
    del second
    one = T.tree_map(lambda x: x[0], batch)
    grads = [_value_and_grad(loss, state.W, one)[1] for _ in range(2)]
    out["gradient"] = [n for n, a, b in zip(names, T.leaves(grads[0]),
                                            T.leaves(grads[1]))
                       if not torch.equal(_bits(torch, a), _bits(torch, b))]
    return out


def scan_round_probe(torch, cfg, fed, seed, name):
    """One scan round of ``cfg`` under ``fed`` from a trainer of its own
    (the peak memory statistic reset just before it is built): its peak,
    or, where the card runs out, the peak allocated when an allocation
    failed and the allocator's message.  Everything it made is freed and
    the cache emptied before it returns."""
    import gc
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"fits": True, "error": None}
    try:
        round_fn, state = train.make_trainer(cfg, fed, seed=seed,
                                             device="cuda")
        batch = train.build_client_batches(cfg, fed.n_clients, 2, ZOO_SEQ,
                                           seed=0, device="cuda")
        t0 = time.perf_counter()
        state = round_fn(state, batch)
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
    except torch.OutOfMemoryError as e:
        out = {"fits": False, "error": str(e)[:400]}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    round_fn = state = batch = None
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{name} scan round tried alone: {json.dumps(out)}")
    return out


def phase_zoo(torch, seed, name):
    """``name`` at ZOO's cut under FedAdam-SSM (alpha 0.05, threshold
    masks, error feedback, the fused Adam; 4 clients, 3 local epochs,
    batch 2, sequence 512), through ``train.make_trainer`` with ZOO's
    driver (where that is not the scan round, ``scan_round_probe`` first):
    2 rounds with the launch counters zeroed just before and read just
    after (exact per client), wall times and the peak memory (reset just
    before the model is built); the bill against the layout's wire bits;
    a profiled round; a round that counts stream syncs, in which the first
    client's payload is measured and the per-leaf kernels' inputs at the
    replayed leaves (and the bitmap's) are kept for
    ``phase_zoo_kernels``; then one more round from the state the rounds
    left, twice, bitwise (else the phase fails naming the leaves and
    gradients that differ)."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import wire

    spec = ZOO[name]
    cfg = dataclasses.replace(get_config(name), **spec["cut"])
    fed = lm_fed(LM_CLIENTS, "fedadam_ssm")
    probe = None
    if spec["driver"]:
        probe = scan_round_probe(torch, cfg, fed, seed, name)
        fed = dataclasses.replace(fed, **spec["driver"])
    round_fn, state, batches, mets, out = lm_rounds(
        torch, cfg, fed, seed, ZOO_SEQ, ssm_launches(spec["leaves"]), name)
    sizes = tuple(x.numel() for x in T.leaves(state.W))
    require(sum(sizes) == spec["params"] and len(sizes) == spec["leaves"],
            f"{name} at its cut has {sum(sizes)} parameters in "
            f"{len(sizes)} leaves")
    wire_bits = wire.mask_wire_bits(sizes, 0.05, exact_topk=False)
    require(wire_bits == 8 * spec["wire_bytes"], f"{name}: wire bits "
            f"{wire_bits}")
    uplink = float(mets["uplink_bits"])
    require(uplink == _f32(torch, LM_CLIENTS * wire_bits),
            f"{name} uplink bits {uplink}")
    batch = batches[-1]
    prof = profile_round(torch, round_fn, state, batch, None)
    # the kernels' inputs are captured in the sync-counting round, so that
    # the copies kept stay out of the measured peak, and kept on the host:
    # deepseek's round leaves no room for them on the card
    cap = Capture(host=True)
    cap.wrap(wire, "pack_shared_mask", "payload", keep=_payload_facts)
    entry = _lm_entry_points()
    for kname in LM_PATHS["fedadam_ssm"]["replayed"]:
        passes = len(LM_PASSES.get(kname, ("",)))
        for n, before in spec["replayed"].values():
            cap.wrap(*entry[kname], kname, LM_KERNELS[kname][2], (n,),
                     passes, skip=before * passes)
    # nor are the codec's outputs held (deepseek's bitmap unpacks to
    # 3.73 GiB of int32)
    cap.wrap(wire, "pack_mask_bits", "pack_words", keep=lambda _: None)
    cap.wrap(wire, "unpack_mask_bits", "unpack_words", keep=lambda _: None)
    try:
        prof["syncs"] = count_syncs(torch, round_fn, state, batch, None)
    finally:
        cap.restore()
    log(f"{name} profiled round: {json.dumps(prof)}")
    nbytes, on_card = cap.outs["payload"]
    log(f"{name} first client's payload built on the card: {nbytes} bytes")
    require(on_card and 8 * nbytes == wire_bits,
            f"{name}: the card's payload holds {nbytes} bytes")
    require(prof["syncs"]["per_round"] == 0,
            f"{name} round synchronised the stream: {prof['syncs']}")
    captured = dict(cap.args)
    del cap
    # the repeat: one round from this state, twice, the first result held
    # on the host
    t0 = time.perf_counter()
    first = round_fn(state, batches[0])[0]
    first = first._replace(**{k: T.tree_map(lambda x: x.cpu(),
                                            getattr(first, k))
                              for k in ("W", "M", "V", "client_state")})
    second = round_fn(state, batches[0])[0]
    try:
        _states_bitwise(torch, second, first, f"{name} repeated round")
    except RuntimeError:
        del second
        why = _nondeterministic(torch, round_fn, state, batches[0], first,
                                lm_loss(cfg))
        raise RuntimeError(f"chip_smoke: {name}: a round from one state "
                           f"does not repeat bit for bit: {why}")
    repeat_s = time.perf_counter() - t0
    log(f"{name}: a round from one state repeats bit for bit "
        f"({repeat_s:.2f} s for both and the host copy)")
    return dict(out, cut=spec["cut"], params=sum(sizes),
                leaves=len(sizes), leaf_sizes=list(sizes),
                payload_bytes=nbytes,
                uplink_bits=uplink, round_profile=prof,
                launches_per_client_round=_per(
                    out["launches"], LM_ROUNDS * LM_CLIENTS),
                repeat_bitwise=True, client_mode=fed.client_mode,
                aggregate=fed.aggregate, scan_round_probe=probe), captured


def phase_zoo_kernels(torch, name, captured, launches, kernels):
    """The per-leaf kernels against their plain versions, bitwise, on the
    inputs ``name``'s first client gave them at the replayed leaves
    (count_ge on both passes; fused_adam's w' within its root's bound),
    with times and bounds; one absmax or count_ge call must be one device
    operation.  Then pack_words and unpack_words on that client's bitmap.
    Adds ``at_<name>`` and the phase's launches to the kernels' records."""
    by_name = {k["name"]: k for k in kernels}
    for kname in LM_PATHS["fedadam_ssm"]["replayed"]:
        leaf_arg = LM_KERNELS[kname][2]
        passes = LM_PASSES.get(kname, ("",))
        per_leaf = {}
        for leaf, (n, _) in ZOO[name]["replayed"].items():
            calls = captured[kname].get(n, [])
            require(len(calls) == len(passes),
                    f"{kname}: {len(calls)} calls captured at {leaf}")
            for pass_name, (args, kw) in zip(passes, calls):
                args = _on_card(args)
                label = f"{leaf}/{pass_name}" if pass_name else leaf
                per_leaf[label] = rec = lm_kernel_record(
                    torch, kname, args, kw, leaf_arg, n)
                rec["shape"] = list(args[leaf_arg].shape)
                log(f"{kname} at {name} {label}: {json.dumps(rec)}")
                if kname in ("absmax", "count_ge"):
                    require(rec["device_ops_per_call"] == 1,
                            f"{kname} at {name} {label}: "
                            f"{rec['device_ops_per_call']} device "
                            f"operations per call")
        k = by_name[kname]
        k["max_abs_err"] = max(k["max_abs_err"],
                               *(r["max_abs_err"] for r in per_leaf.values()))
        k[f"at_{name}"] = per_leaf
    for kname in ("pack_words", "unpack_words"):
        ((args, kw),) = captured[kname][None]
        rec = measure(torch, kname, _on_card(args), kw, iters=10,
                      plain_iters=1)
        log(f"{kname} at {name}'s bitmap: {json.dumps(rec)}")
        k = by_name[kname]
        k["max_abs_err"] = max(k["max_abs_err"], rec["max_abs_err"])
        k[f"at_{name}"] = rec
    for k in kernels:
        k.setdefault("launches_zoo", {})[name] = launches[k["name"]]


def phase_zoo_block_vs_cpu(torch, seed, name):
    """One block of ``name`` (deepseek: MLA and the MoE FFN; mamba2: the
    SSD mixer) at full width in float32, forward and backward of ``sum(y *
    cot) + aux`` with b = 1 and s = 512, on the card and on the host's CPU
    from the same weights and input: the MoE routing (experts, keep, dst)
    identical, outputs and gradients within ``ZOO_BLOCK_TOL`` of their
    largest element."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as TM
    from repro_torch.models.params import materialize

    cfg = dataclasses.replace(get_config(name), dtype="float32")
    spec = cfg.layer_pattern[0]
    params = materialize(TM._block_params(cfg, spec), seed, "float32",
                         "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((1, ZOO_SEQ, cfg.d_model), generator=gen)
    cot = torch.randn(x.shape, generator=gen)
    side = {}
    for dev in ("cuda", "cpu"):
        cap = Capture()
        cap.wrap(L, "moe_route", "route",
                 keep=lambda r: (r.eidx.cpu(), r.keep.cpu(), r.dst.cpu()))
        try:
            p = T.tree_map(lambda t: t.to(dev).requires_grad_(True), params)
            xd = x.to(dev).requires_grad_(True)
            pos = torch.arange(ZOO_SEQ, device=dev)[None]
            t0 = time.perf_counter()
            y, aux, _ = TM._block_fwd(cfg, spec, p, xd, positions=pos)
            loss = (y * cot.to(dev)).sum()
            if aux is not None:
                loss = loss + aux
            loss.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            cap.restore()
        side[dev] = {"y": y.detach().cpu(), "route": cap.outs.get("route"),
                     "grads": [t.grad.cpu() for t in T.leaves(p)]
                     + [xd.grad.cpu()], "wall_s": wall}
        del p, xd, y, loss
    gpu, cpu = side["cuda"], side["cpu"]
    moe = spec.moe is not None
    require(moe == (gpu["route"] is not None), f"{name}: routing capture")
    if moe:
        for what, a, b in zip(("eidx", "keep", "dst"), gpu["route"],
                              cpu["route"]):
            require(torch.equal(a, b), f"{name}: routing {what} differs "
                    f"between the card and the CPU")
    rel = lambda a, b: float((a.double() - b.double()).abs().max()
                             / b.double().abs().max().clamp_min(1e-30))
    y_err = rel(gpu["y"], cpu["y"])
    g_err = max(rel(a, b) for a, b in zip(gpu["grads"], cpu["grads"]))
    out = {"routing_identical": moe or None, "y_rel_err": y_err,
           "grad_rel_err": g_err, "tolerance": ZOO_BLOCK_TOL,
           "wall_s_cuda": gpu["wall_s"], "wall_s_cpu": cpu["wall_s"],
           "host_cpu": host_cpu()}
    log(f"{name} block card vs CPU: {json.dumps(out)}")
    require(y_err <= ZOO_BLOCK_TOL and g_err <= ZOO_BLOCK_TOL,
            f"{name} block: card vs CPU {y_err:.2e} / {g_err:.2e}")
    return out


# ---------------------------------------------------------------------------
# Phase 14: serving at full width and depth
# ---------------------------------------------------------------------------

#: Phase 14's models, whole (every pattern repeat, the whole vocabulary),
#: in bfloat16 as configured: parameters of the port's tree and leaves.
SERVE = {
    "deepseek-v2-lite-16b": (16_150_149_120, 17),
    "mamba2-1-3b": (1_344_052_224, 11),
    "starcoder2-3b": (3_180_518_400, 11),
    "llava-next-mistral-7b": (7_241_732_096, 12),
    "whisper-base": (97_271_808, 25),
}
#: The serving CLI's defaults: batch, prompt length, generated tokens.
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 32, 16
#: The float32 checks: one block family each (MLA + MoE, SSD, GQA with
#: cross-attention) at full width, one decode step card vs CPU within
#: ZOO_BLOCK_TOL; at full width and 2 pattern repeats, a teacher-forced
#: decode of SERVE_CHECK_TOKENS against the port's own forward, and a
#: prefill-seeded continuation against the replay's, within SERVE_REL of
#: the largest logit (the JAX package's decode test's bound).
SERVE_CHECK = ("deepseek-v2-lite-16b", "mamba2-1-3b", "whisper-base")
SERVE_CHECK_TOKENS = 16
SERVE_REL = 0.05


def _no_drop(cfg):
    """The MoE capacity factor raised to 8: no token drops, where the
    parallel forward and one-token decode route alike (the JAX package's
    decode test does the same)."""
    import dataclasses
    return dataclasses.replace(cfg, layer_pattern=tuple(
        dataclasses.replace(sp, moe=dataclasses.replace(
            sp.moe, capacity_factor=8.0)) if sp.moe else sp
        for sp in cfg.layer_pattern))


def _seed_caches(torch, caches, pre):
    """Copy prefill's caches ``pre`` into decode caches: a leaf of the
    same shape whole, else into the first slots of its kv_seq axis (axis
    3 of (repeat, count, b, S, ...))."""
    from repro_torch import tree as T
    for z, p in zip(T.leaves(caches), T.leaves(pre)):
        (z if z.shape == p.shape else z[:, :, :, :p.shape[3]]).copy_(p)


def _nbytes(tree) -> int:
    from repro_torch import tree as T
    return sum(x.numel() * x.element_size() for x in T.leaves(tree))


def phase_serve(torch, seed, name):
    """``name`` whole in bfloat16 through ``launch/serve.py``'s functions
    at the CLI's defaults (batch 2, prompt 32, 16 greedy tokens): the
    build (timed; the peak reset before it), the prompt replayed through
    ``decode_step`` (whisper's cross keys and values from ``prefill`` over
    its 1500 frames first; llava's prompt through ``prefill`` after its
    16-token prefix instead of the replay), the generation (wall,
    tokens/s) with the launch counters zeroed before and read after (the
    path runs no kernel of the port), then the generation again from the
    same cache state, counting stream syncs (0) and bitwise the same
    tokens and logits, and one decode step profiled (device operations,
    busy share) beside its byte bound: every weight the step reads (all
    but an untied embedding table and the encoder) and the caches, over
    the HBM rate."""
    import gc
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve
    from repro_torch.models import model as TM

    cfg = get_config(name)
    n_params, n_leaves = SERVE[name]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"param_count": cfg.param_count(),
           "pattern_repeats": cfg.pattern_repeats,
           "vocab_rows": cfg.padded_vocab}
    with torch.inference_mode():
        t0 = time.perf_counter()
        params, toks, embeds, seq = serve.setup(
            cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, device="cuda",
            seed=seed)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        out["build_peak_bytes"] = torch.cuda.max_memory_allocated()
        leaves = T.leaves(params)
        out["params"] = sum(x.numel() for x in leaves)
        out["param_bytes"] = _nbytes(params)
        require(out["params"] == n_params and len(leaves) == n_leaves,
                f"{name}: {out['params']} parameters in {len(leaves)} "
                f"leaves")
        caches = serve.new_caches(cfg, SERVE_BATCH, seq, "cuda")
        out["seq_len"], out["cache_bytes"] = seq, _nbytes(caches)
        reset_launches()
        pos = 0
        if embeds is not None:
            t0 = time.perf_counter()
            logits, pre = TM.prefill(cfg, params, toks,
                                     frontend_embeds=embeds)
            torch.cuda.synchronize()
            out["prefill_s"] = time.perf_counter() - t0
            out["frontend_tokens"] = embeds.shape[1]
            if cfg.encoder is not None:
                for c, pc in zip(caches, pre):
                    c["cross_k"].copy_(pc["cross_k"])
                    c["cross_v"].copy_(pc["cross_v"])
            else:
                _seed_caches(torch, caches, pre)
                pos = embeds.shape[1] + SERVE_PROMPT
            del pre
        if pos == 0:
            t0 = time.perf_counter()
            logits, pos = serve.replay(cfg, params, caches, toks,
                                       seq_len=seq)
            torch.cuda.synchronize()
            out["replay_s"] = time.perf_counter() - t0
        snap = (T.tree_map(torch.clone, caches), logits.clone(), pos)
        t0 = time.perf_counter()
        tokens, last = serve.generate(cfg, params, caches, logits, pos,
                                      SERVE_GEN, seq_len=seq)
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t0
        out["tokens_per_s"] = SERVE_BATCH * SERVE_GEN / out["decode_s"]
        out["launches"] = dict(LAUNCHES)
        require(not any(out["launches"].values()),
                f"{name}: the serving path launched {out['launches']}")
        tokens = tokens.cpu()
        require(bool(torch.isfinite(last).all()), f"{name}: logits")
        require(int(tokens.max()) < cfg.vocab_size, f"{name}: tokens")
        out["sample"] = tokens[0][:12].tolist()

        def again(res):
            res["run"] = serve.generate(
                cfg, params, T.tree_map(torch.clone, snap[0]), snap[1],
                snap[2], SERVE_GEN, seq_len=seq)

        res = {}
        out["syncs"] = count_syncs_of(torch, lambda: again(res))
        require(out["syncs"]["per_round"] == 0,
                f"{name}: the decode loop synchronised: {out['syncs']}")
        tok_b, last_b = res.pop("run")
        require(torch.equal(tok_b.cpu(), tokens)
                and torch.equal(_bits(torch, last_b), _bits(torch, last)),
                f"{name}: a decode from one cache state does not repeat "
                f"bit for bit")
        out["repeat_bitwise"] = True
        c = T.tree_map(torch.clone, snap[0])
        nxt = serve.pick(snap[1], cfg.vocab_size)
        out["step_profile"] = profile_call(
            torch, lambda: TM.decode_step(cfg, params, c, snap[2], nxt,
                                          seq_len=seq), port_kernels=False)
        read = out["param_bytes"] - _nbytes(params.get("encoder")) - (
            0 if cfg.tie_embeddings else _nbytes(params["embed"]))
        out["step_bytes"] = read + out["cache_bytes"]
        out["step_bound_ms"] = out["step_bytes"] / HBM_BYTES_PER_S * 1e3
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        del params, caches, snap, c, res, logits, last, tok_b, last_b
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{name} served whole: {json.dumps(out)}")
    return out


def serve_block_vs_cpu(torch, seed, name):
    """One decode step of ``name``'s first block at full width in float32
    (no drop), card against the host's CPU, from the same weights, input
    and cache (random, b = 2, the CLI's 48 slots, pos 32; whisper's cross
    keys and values over 1500 frames): the MoE routing identical, the
    output and every cache leaf within ``ZOO_BLOCK_TOL`` of its largest
    element."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as TM
    from repro_torch.models.params import materialize

    cfg = _no_drop(dataclasses.replace(get_config(name), dtype="float32"))
    spec = cfg.layer_pattern[0]
    params = materialize(TM._block_params(cfg, spec), seed, "float32",
                         "cpu")
    meta = TM._layer_cache_meta(cfg, spec, SERVE_BATCH,
                                SERVE_PROMPT + SERVE_GEN)
    gen = torch.Generator().manual_seed(seed + 2)
    cache = {k: torch.randn(p.shape, generator=gen) * 0.5
             for k, p in meta.items()}
    x = torch.randn((SERVE_BATCH, 1, cfg.d_model), generator=gen)
    side = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            cap = Capture()
            cap.wrap(L, "moe_route", "route",
                     keep=lambda r: (r.eidx.cpu(), r.keep.cpu(),
                                     r.dst.cpu()))
            try:
                p = T.tree_map(lambda t: t.to(dev), params)
                c = {k: v.to(dev).clone() for k, v in cache.items()}
                y = TM._block_decode(cfg, spec, p, x.to(dev), c,
                                     pos=SERVE_PROMPT, ring=False,
                                     window_eff=None)
            finally:
                cap.restore()
            side[dev] = (y.cpu(), {k: v.cpu() for k, v in c.items()},
                         cap.outs.get("route"))
    (gy, gc_, groute), (cy, cc, croute) = side["cuda"], side["cpu"]
    rel = lambda a, b: float((a.double() - b.double()).abs().max()
                             / b.double().abs().max().clamp_min(1e-30))
    moe = spec.moe is not None
    require(moe == (groute is not None), f"{name}: routing capture")
    if moe:
        for what, a, b in zip(("eidx", "keep", "dst"), groute, croute):
            require(torch.equal(a, b), f"{name} decode: routing {what} "
                    f"differs between the card and the CPU")
    out = {"y_rel_err": rel(gy, cy),
           "cache_rel_err": max(rel(gc_[k], cc[k]) for k in cc),
           "cache_leaves": sorted(cc), "routing_identical": moe or None,
           "tolerance": ZOO_BLOCK_TOL}
    log(f"{name} decode block card vs CPU: {json.dumps(out)}")
    require(out["y_rel_err"] <= ZOO_BLOCK_TOL
            and out["cache_rel_err"] <= ZOO_BLOCK_TOL,
            f"{name} decode block: card vs CPU {out}")
    return out


def serve_depth_check(torch, seed, name):
    """``name`` at full width, 2 pattern repeats, float32 (no drop), on
    the card: SERVE_CHECK_TOKENS tokens through ``decode_step`` (whisper's
    cross caches from ``prefill``) against ``forward`` at every position,
    and prefill's caches, padded, continuing one step as the replay's do,
    both within SERVE_REL of the largest logit."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as TM

    cfg = _no_drop(dataclasses.replace(get_config(name), dtype="float32",
                                       pattern_repeats=2))
    n, b = SERVE_CHECK_TOKENS, SERVE_BATCH
    rel = lambda a, e: float((a - e).abs().max() / e.abs().max())
    with torch.inference_mode():
        params = TM.init_params(cfg, seed=seed, device="cuda")
        gen = torch.Generator().manual_seed(seed + 3)
        toks = torch.randint(0, cfg.vocab_size, (b, n + 1),
                             generator=gen).cuda()
        kw = {}
        if cfg.encoder is not None:
            kw["frontend_embeds"] = (torch.randn(
                (b, cfg.encoder.src_len, cfg.d_model), generator=gen)
                * 0.02).cuda()
        fwd, _ = TM.forward(cfg, params, toks[:, :n], **kw)
        last, pre = TM.prefill(cfg, params, toks[:, :n], **kw)
        replay = serve.new_caches(cfg, b, n + 1, "cuda")
        if cfg.encoder is not None:
            for c, pc in zip(replay, pre):
                c["cross_k"].copy_(pc["cross_k"])
                c["cross_v"].copy_(pc["cross_v"])
        dec = torch.stack([TM.decode_step(cfg, params, replay, i,
                                          toks[:, i], seq_len=n + 1)[0]
                           for i in range(n)], 1)
        seeded = serve.new_caches(cfg, b, n + 1, "cuda")
        _seed_caches(torch, seeded, pre)
        la = TM.decode_step(cfg, params, replay, n, toks[:, n],
                            seq_len=n + 1)[0]
        lb = TM.decode_step(cfg, params, seeded, n, toks[:, n],
                            seq_len=n + 1)[0]
        out = {"decode_vs_forward": rel(dec, fwd),
               "prefill_vs_replay_last": rel(last, dec[:, -1]),
               "continuation": rel(lb, la), "tokens": n,
               "bound": SERVE_REL}
        del params, pre, replay, seeded, fwd, dec
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{name} at 2 repeats, float32: {json.dumps(out)}")
    require(max(out["decode_vs_forward"], out["prefill_vs_replay_last"],
                out["continuation"]) <= SERVE_REL,
            f"{name}: decode against forward / prefill {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the multi-GPU spatial driver
# ---------------------------------------------------------------------------

#: The spatial train step's model and its cuts: the global batch cut to 1
#: (the client's one sequence of train_4k's 4096 tokens) and the pattern
#: repeats cut to the most of these that fit one card with remat "full"
#: (each tried in turn; one that does not fit is recorded).
SPATIAL_ARCH = "deepseek-v2-lite-16b"
SPATIAL_REPEATS = (4, 3, 2, 1)
#: Ranks of part (b), gloo processes sharing the one card.
SPATIAL_RANKS = 4
#: part (b)'s async run: phase 11's churn at 4 clients, K 2.
SPATIAL_CHURN = dict(seed=0, jitter=3, straggler_prob=0.1, drop_prob=0.2)
SPATIAL_ASYNC = dict(buffer_size=2, max_staleness=2)
SPATIAL_ASYNC_STEPS = 4


def spatial_gather_bytes(sizes, alpha) -> int:
    """Bytes one client's transport all-gathers (FedAdam-SSM, float32
    values): per leaf its bitmap, 4 ceil(n / 32), and three streams of kb
    = k + overselect_bound(k) values."""
    from repro_torch.core import sparsify as S
    from repro_torch.kernels.topk_mask.ref import overselect_bound
    total = 0
    for n in sizes:
        k = S.k_for(n, alpha)
        total += 4 * -(-n // 32) + 3 * 4 * min(n, k + overselect_bound(k))
    return total


@contextlib.contextmanager
def _count_gathered(aggregate):
    """The bytes of every tensor the transport all-gathers, in a list."""
    sizes, gather = [], aggregate._gather_clients

    def counting(x, mesh):
        sizes.append(x.numel() * x.element_size())
        return gather(x, mesh)

    aggregate._gather_clients = counting
    try:
        yield sizes
    finally:
        aggregate._gather_clients = gather


@contextlib.contextmanager
def _count_overflow(aggregate):
    """Per call of the transport's pack (one per leaf for a shared mask,
    in leaf order): the slots its capacity drops, a device scalar
    (``max(0, nnz - kb)``)."""
    drops, pack = [], aggregate._local_pack

    def counting(wf, alpha):
        out = pack(wf, alpha)
        drops.append(((wf != 0).sum() - out[3]).clamp_min(0))
        return out

    aggregate._local_pack = counting
    try:
        yield drops
    finally:
        aggregate._local_pack = pack


def _spatial_vs_scan(torch, st, ref, drops, what):
    """The spatial round against the scan round from one state: every
    leaf of W, M, V and the clients' residuals bitwise where no client's
    pack dropped a value; where one did (``drops[c][leaf]``, values past
    the leaf's capacity k + overselect_bound(k), which the transport feeds
    back into the residual while the wire's pooled capacity keeps them),
    the two differ at no more positions than were dropped.  Returns the
    positions that differ, by leaf and part."""
    from repro_torch import tree as T
    names = [n for n, _ in _paths_of(st.W)]
    total = [sum(d[i] for d in drops) for i in range(len(names))]
    out = {}
    for part in ("W", "M", "V"):
        for name, n, x, y in zip(names, total, T.leaves(getattr(st, part)),
                                 T.leaves(getattr(ref, part))):
            diff = int((_bits(torch, x) != _bits(torch, y)).sum())
            require(diff <= n, f"{what}: {part}[{name}] differs at {diff} "
                    f"positions, {n} values dropped")
            if diff:
                out[f"{part}/{name}"] = diff
    err_s = T.leaves(st.client_state["comp"]["err"])
    err_r = T.leaves(ref.client_state["comp"]["err"])
    for i, (name, x, y) in enumerate(zip(names, err_s, err_r)):
        for c in range(x.shape[0]):
            diff = int((_bits(torch, x[c]) != _bits(torch, y[c])).sum())
            require(diff <= drops[c][i], f"{what}: client {c}'s residual "
                    f"at {name} differs at {diff} positions, "
                    f"{drops[c][i]} dropped")
            if diff:
                out[f"err/{c}/{name}"] = diff
    return out


def _nccl_uint32(torch, mesh):
    """Whether the group's backend gathers a uint32 tensor as it is (the
    transport gathers the bitmap as int32 either way): True, or the
    error."""
    import torch.distributed as dist
    x = torch.arange(3, dtype=torch.int32, device=mesh.device).view(
        torch.uint32)
    out = [torch.empty_like(x) for _ in range(mesh.world_size)]
    try:
        dist.all_gather(out, x)
    except (RuntimeError, TypeError) as e:
        return f"{type(e).__name__}: {e}"[:200]
    return True


def spatial_cnn(torch, seed, mesh):
    """(a) the full-width CNN (phase 2's configuration, its client 0)
    through the spatial round on a world-1 group with the bitmap
    transport, FedAdam-SSM with error feedback, against a 1-client
    round_scan from the same state (``_spatial_vs_scan``: bitwise but
    where the pack dropped values); launches (packed_hist 2, packed_apply
    1, no word kernel: the step builds no payload); the bytes gathered
    against the bytes billed; 0 stream syncs.  Also returns the first
    inputs the round gave the packed kernels."""
    from repro_torch import tree as T
    from repro_torch.core import aggregate, fed_init, make_fl_round
    from repro_torch.core import sparsify
    from repro_torch.models.vision import build_vision

    dev = torch.device("cuda")
    params, _, loss_fn, _, _ = build_vision("cnn", width=1.0, seed=seed,
                                            device=dev)
    imgs, labels, n_train, parts = make_data(seed, CLIENTS)
    batch, w = round_batch(torch, imgs, labels, n_train, parts, 0, dev)
    batch, w = T.tree_map(lambda x: x[:1], batch), w[:1]
    fed_s = cnn_fed("fedadam_ssm", n_clients=1)
    fed_m = cnn_fed("fedadam_ssm", n_clients=1, client_mode="vmap",
                    client_axes=mesh.client_axes, aggregate="sparse_gather")
    spatial = make_fl_round(
        fed_m, loss_fn, aggregate.make_shardmap_sparse_aggregate(
            mesh, None, mesh.client_axes, fed_m.alpha), mesh=mesh)
    state0 = fed_init(fed_s, params)
    (ref, _), scan_wall, _, scan_launches = _timed(
        torch, lambda: make_fl_round(fed_s, loss_fn)(state0, batch, w))
    cap = Capture()
    cap.wrap(sparsify, "packed_hist", "packed_hist")
    cap.wrap(sparsify, "packed_apply", "packed_apply")
    try:
        with _count_gathered(aggregate) as gathered, \
                _count_overflow(aggregate) as drops:
            (st, mets), wall, peak, launches = _timed(
                torch, lambda: spatial(state0, batch, w))
    finally:
        cap.restore()
    drops = [int(d) for d in drops]
    differ = _spatial_vs_scan(torch, st, ref, [drops],
                              "cnn spatial round vs 1-client scan")
    _finite_state(torch, st, "cnn spatial round")
    want = per_client_round(packed_hist=2, packed_apply=1)
    require(launches == want, f"cnn spatial launches {launches}")
    require(scan_launches == per_client_round(
        packed_hist=2, packed_apply=1, pack_words=1, unpack_words=1),
        f"cnn 1-client scan launches {scan_launches}")
    sizes = [x.numel() for x in T.leaves(params)]
    gathered = sum(gathered)
    billed = float(mets["uplink_bits"]) / 8
    require(gathered == spatial_gather_bytes(sizes, fed_m.alpha),
            f"cnn spatial round gathered {gathered} bytes")
    require(billed == CNN_WIRE_BYTES_PER_CLIENT, f"billed {billed} bytes")
    syncs = count_syncs(torch, spatial, state0, batch, w)
    require(syncs["per_round"] == 0, f"cnn spatial syncs {syncs}")
    rec = {"bitwise_scan": not differ, "dropped_per_leaf": drops,
           "differ_from_scan": differ,
           "wall_s": wall, "scan_wall_s": scan_wall,
           "peak_bytes": peak, "launches_per_client": launches,
           "gathered_bytes_per_client": gathered,
           "billed_bytes_per_client": billed, "syncs": syncs}
    log(f"cnn spatial round (world 1, {mesh.device.type}): dropped per "
        f"leaf {drops}; differs from the 1-client scan round at {differ} "
        f"(bitwise elsewhere); wall={wall:.4f} s (scan {scan_wall:.4f} s); "
        f"gathered {gathered} bytes, billed {billed:.0f}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; syncs "
        f"{syncs['per_round']}")
    return rec, {k: cap.args[k][None] for k in ("packed_hist",
                                                 "packed_apply")}


def _free(torch):
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _try_round(torch, fn):
    """``_timed(fn)``, or where the card runs out of memory ``None`` and
    the peak allocated when the allocation failed, with the message."""
    try:
        return _timed(torch, fn), None
    except torch.OutOfMemoryError as e:
        err = {"peak_bytes": torch.cuda.max_memory_allocated(),
               "error": str(e)[:400]}
    _free(torch)
    return None, err


def spatial_lm_at(torch, cfg, mesh, seed):
    """One spatial round of ``cfg`` through ``launch.steps.
    build_train_step`` (its DeployPlan, train_4k's sequence, batch 1) with
    remat "full", then one with "none" from the same state: peaks, walls,
    launches, bitwise or the leaves that differ; then one more "full"
    round that captures the per-leaf kernels' first inputs at the largest
    bfloat16 leaf and the float32 router (on the host, outside the timed
    rounds).  ``(fits, record, captured)``: where the "full" round
    does not fit, the record of its failed allocation."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.launch import steps, train
    from repro_torch.models.model import init_params

    dev = torch.device("cuda")
    shape = dataclasses.replace(steps.SHAPES["train_4k"], global_batch=1)
    bundles = {r: steps.build_train_step(cfg, mesh, shape, remat=r)
               for r in ("full", "none")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state0 = bundles["full"].init(init_params(cfg, seed=seed, device=dev))
    build_peak = torch.cuda.max_memory_allocated()
    per_client, text_len = bundles["full"].batch_shapes["tokens"][1:]
    batch = train.build_client_batches(cfg, 1, per_client, text_len,
                                       seed=0, device=dev)
    sizes = [x.numel() for x in T.leaves(state0.W)]
    names = [n for n, _ in _paths_of(state0.W)]
    big = max(range(len(sizes)), key=lambda i: (
        T.leaves(state0.W)[i].dtype != torch.float32, sizes[i]))
    router = next(i for i, n in enumerate(names) if n.endswith("router"))
    replayed = {names[big]: sizes[big], names[router]: sizes[router]}
    full, oom = _try_round(torch, lambda: bundles["full"].fn(state0, batch))
    if full is None:
        return False, dict(oom, params=sum(sizes),
                           build_peak_bytes=build_peak), None
    (st, mets), wall, peak, launches = full
    _finite_state(torch, st, f"{cfg.name} spatial round")
    loss = mets["loss"].cpu().tolist()
    require(all(math.isfinite(x) for x in loss), f"loss {loss}")
    L = len(sizes)
    want = per_client_round(absmax=L, count_ge=2 * L, ssm_apply_ef=L)
    require(launches == want, f"{cfg.name} spatial launches {launches}")
    from repro_torch.core.compressors import make_compressor
    bits = make_compressor(bundles["full"].static["fed"]) \
        .wire_bits_per_client(tuple(sizes))
    require(float(mets["uplink_bits"]) == _f32(torch, bits),
            f"uplink bits {float(mets['uplink_bits'])}")
    # the first result on the host, the second beside it on the card
    first = st._replace(**{k: T.tree_map(lambda x: x.cpu(), getattr(st, k))
                           for k in ("W", "M", "V")})
    del st, mets, full
    _free(torch)
    none, none_oom = _try_round(
        torch, lambda: bundles["none"].fn(state0, batch))
    rec = {"params": sum(sizes), "leaves": L, "build_peak_bytes": build_peak,
           "full": {"wall_s": wall, "peak_bytes": peak, "loss": loss},
           "launches": launches, "uplink_bits": float(bits),
           "captured_leaves": replayed}
    if none is None:
        rec["none"] = dict(none_oom, fits=False)
    else:
        (st2, _), wall2, peak2, _ = none
        differ = [f"{p}.{n}" for p in ("W", "M", "V")
                  for n, x, y in zip(names, T.leaves(getattr(st2, p)),
                                     T.leaves(getattr(first, p)))
                  if not torch.equal(_bits(torch, x),
                                     _bits(torch, y.to(x.device)))]
        rec["none"] = {"fits": True, "wall_s": wall2, "peak_bytes": peak2,
                       "bitwise_full": not differ, "differ": differ}
        require(not differ, f"{cfg.name}: remat full and none differ in "
                f"{differ}")
        del st2, none
    _free(torch)
    cap = Capture(host=True)
    entry = _lm_entry_points()
    for kname in ("absmax", "count_ge", "ssm_apply_ef"):
        passes = len(LM_PASSES.get(kname, ("",)))
        for n in replayed.values():
            cap.wrap(*entry[kname], kname, LM_KERNELS[kname][2], (n,),
                     passes)
    try:
        bundles["full"].fn(state0, batch)
    finally:
        cap.restore()
    log(f"{cfg.name} spatial train step at {cfg.pattern_repeats} repeats "
        f"({sum(sizes):,} parameters): {json.dumps(rec)}")
    captured = {k: [(_on_card(a), kw) for calls in cap.args[k].values()
                    for a, kw in calls] for k in cap.args}
    del state0, batch, first
    _free(torch)
    return True, rec, captured


def _paths_of(tree):
    from repro_torch.checkpoint.io import _paths
    return _paths(tree, ())


def spatial_lm(torch, seed, mesh):
    """(a) the spatial train step of SPATIAL_ARCH at full width (its whole
    vocabulary, train_4k's sequence of 4096, the global batch cut to 1)
    at the most of SPATIAL_REPEATS pattern repeats that fit: each count
    that does not is recorded."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.sharding import plan_for
    cfg0 = get_config(SPATIAL_ARCH)
    require(plan_for(cfg0.name).clients == "spatial",
            f"{SPATIAL_ARCH}'s plan is not spatial")
    tried = {}
    for repeats in SPATIAL_REPEATS:
        cfg = dataclasses.replace(cfg0, pattern_repeats=repeats)
        fits, rec, captured = spatial_lm_at(torch, cfg, mesh, seed)
        if not fits:
            log(f"{SPATIAL_ARCH}: {repeats} repeats do not fit: "
                f"{json.dumps(rec)}")
            tried[repeats] = rec
            _free(torch)
            continue
        return dict(repeats=repeats, tried=tried,
                    reduced={"global_batch": 1,
                             "pattern_repeats": [repeats,
                                                 cfg0.pattern_repeats]},
                    **rec), captured
    raise RuntimeError(f"chip_smoke: {SPATIAL_ARCH} fits at none of "
                       f"{SPATIAL_REPEATS} repeats: {tried}")


def phase_spatial(torch, seed):
    """Phase 15 (a): a world-1 group on the card (NCCL): the CNN's spatial
    round and SPATIAL_ARCH's spatial train step (``spatial_cnn``,
    ``spatial_lm``); whether NCCL gathers uint32 as it is.  Returns the
    record and the kernels' first inputs of each path."""
    import shutil
    import tempfile
    from repro_torch.launch import mesh as MM

    tmp = tempfile.mkdtemp()
    mesh = MM.init(1, 0, store=os.path.join(tmp, "store"), device="cuda")
    try:
        import torch.distributed as dist
        out = {"backend": dist.get_backend(),
               "uint32_gather": _nccl_uint32(torch, mesh)}
        log(f"world-1 group: {out}")
        out["cnn"], cnn_inputs = spatial_cnn(torch, seed, mesh)
        out["lm"], lm_inputs = spatial_lm(torch, seed, mesh)
    finally:
        mesh.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out, cnn_inputs, lm_inputs


def spatial_rank(rank, world, store, seed):
    """Phase 15 (b), one rank of a gloo group of CUDA tensors sharing the
    card: the CNN's spatial round (C = world) against the world-client
    scan round, and the async driver under churn with the group's cohort
    against the scan cohort, both bitwise (rank 0 runs the references);
    the launches of each; rank 0 also holds the packed kernels against
    their plain versions on its first inputs."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import tree as T
    from repro_torch.core import (AsyncConfig, aggregate, fed_init,
                                  make_async_round, make_fl_round, sparsify)
    from repro_torch.core.fed import gather_client_state, local_clients
    from repro_torch.data import ChurnConfig, ChurnModel
    from repro_torch.device import exact_float32
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import mesh as MM
    from repro_torch.models.vision import build_vision

    torch.backends.cudnn.deterministic = True
    exact_float32()
    dev = torch.device("cuda")
    mesh = MM.init(world, rank, store=store, device=dev, backend="gloo")
    try:
        params, _, loss_fn, _, _ = build_vision("cnn", width=1.0, seed=seed,
                                                device=dev)
        imgs, labels, n_train, parts = make_data(seed, world)
        batch, w = round_batch(torch, imgs, labels, n_train, parts, 0, dev)
        fed_s = cnn_fed("fedadam_ssm", n_clients=world)
        fed_m = cnn_fed("fedadam_ssm", n_clients=world, client_mode="vmap",
                        client_axes=mesh.client_axes,
                        aggregate="sparse_gather")
        spatial = make_fl_round(
            fed_m, loss_fn, aggregate.make_shardmap_sparse_aggregate(
                mesh, None, mesh.client_axes, fed_m.alpha), mesh=mesh)
        state0 = fed_init(fed_s, params)
        mine = state0._replace(client_state=local_clients(
            state0.client_state, mesh))
        cap = Capture()
        cap.wrap(sparsify, "packed_hist", "packed_hist")
        cap.wrap(sparsify, "packed_apply", "packed_apply")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            with _count_overflow(aggregate) as drops:
                st, mets = spatial(mine, local_clients(batch, mesh), w)
            torch.cuda.synchronize()
        finally:
            cap.restore()
        drops = mesh.all_gather(torch.stack(drops)).tolist()
        out = {"rank": rank, "round_wall_s": time.perf_counter() - t0,
               "round_launches": dict(LAUNCHES)}
        st = gather_client_state(st, mesh)
        out["uplink_bits"] = float(mets["uplink_bits"])
        out["dropped_per_client_leaf"] = drops
        if rank == 0:
            ref, _ = make_fl_round(fed_s, loss_fn)(state0, batch, w)
            out["differ_from_scan"] = _spatial_vs_scan(
                torch, st, ref, drops, f"{world}-rank spatial round vs scan")
            out["round_bitwise_scan"] = not out["differ_from_scan"]
            errs = {}
            for name in ("packed_hist", "packed_apply"):
                ((args, kw),) = cap.args[name][None]
                fk, fp, _ = run_kernel(torch, name, args, kw)
                a, b = fk(), fp()
                a = a if isinstance(a, tuple) else (a,)
                b = b if isinstance(b, tuple) else (b,)
                errs[name] = max(max_abs_err(torch, x, y)
                                 for x, y in zip(a, b))
            out["kernel_max_abs_err"] = errs
        st = ref = None
        runs = {}
        for kind in ("scan", "shardmap") if rank == 0 else ("shardmap",):
            fed = fed_m if kind == "shardmap" else fed_s
            run = make_async_round(
                fed, loss_fn, AsyncConfig(**SPATIAL_ASYNC),
                churn=ChurnModel(ChurnConfig(**SPATIAL_CHURN), world),
                client_exec=kind, mesh=mesh if kind == "shardmap" else None)
            reset_launches()
            t0 = time.perf_counter()
            runs[kind] = run(fed_init(fed, params), batch, w,
                             rounds=SPATIAL_ASYNC_STEPS)
            torch.cuda.synchronize()
            out[f"async_{kind}"] = {
                "wall_s": time.perf_counter() - t0,
                "launches": dict(LAUNCHES),
                **{k: runs[kind][1][k] for k in (
                    "server_steps", "landed", "dropped", "discarded")}}
        if rank == 0:
            (a, ma), (b, mb) = runs["scan"], runs["shardmap"]
            require(ma["events"] == mb["events"], "async event logs differ")
            require(float(ma["uplink_bits"]) == float(mb["uplink_bits"]),
                    "async bills differ")
            _states_bitwise(torch, b, a, "async group cohort vs scan cohort")
            require(mb["server_steps"] == SPATIAL_ASYNC_STEPS,
                    f"async steps {mb['server_steps']}")
            out["async_bitwise_scan"] = True
        return out
    finally:
        mesh.close()


def phase_spatial_ranks(torch, seed):
    """Phase 15 (b): SPATIAL_RANKS gloo processes with CUDA tensors on the
    one card (NCCL takes one rank per device): ``spatial_rank`` on each.
    A failure in any rank fails the phase."""
    import shutil
    import tempfile
    from repro_torch.launch import mesh as MM

    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    try:
        ranks = MM.run_ranks(spatial_rank, SPATIAL_RANKS,
                             store=os.path.join(tmp, "store"),
                             args=(seed,), timeout_s=300)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"ranks": ranks, "wall_s": time.perf_counter() - t0}
    require(ranks[0]["async_bitwise_scan"], "phase 15 (b) async check")
    want = per_client_round(packed_hist=2, packed_apply=1)
    for r in ranks:
        require(r["round_launches"] == want,
                f"rank {r['rank']} launches {r['round_launches']}")
    r0 = ranks[0]
    log(f"phase 15 (b): {SPATIAL_RANKS} gloo ranks on the card in "
        f"{out['wall_s']:.1f} s: the spatial round against the scan round: "
        f"dropped {r0['dropped_per_client_leaf']}, differs at "
        f"{r0['differ_from_scan']} (bitwise elsewhere); the async group "
        f"cohort bitwise the scan cohort ({r0['async_shardmap']}); "
        f"kernels vs plain {r0['kernel_max_abs_err']}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: tensor parallelism on a model axis (gloo ranks sharing the card)
# ---------------------------------------------------------------------------

#: (a) and (b)'s dense model: starcoder2-3b at full width, phase 5's cut
#: (2 of 30 pattern repeats) and traffic (sequence 128, 2 sequences a
#: client), build_train_step's 2 local epochs, error feedback.
TENSOR_ARCH = "starcoder2-3b"
TENSOR_REPEATS = 2
TENSOR_SEQ = 128
TENSOR_PER_CLIENT = 2
#: (a)'s MLA + MoE model at full width, in float32 as starcoder2's
#: compared rounds, and the repeats it tries, most first; phase 13's
#: sequence, one sequence.
TENSOR_MOE_ARCH = "deepseek-v2-lite-16b"
TENSOR_MOE_REPEATS = (3, 2, 1)
TENSOR_MOE_SEQ = 512
#: The split float32 round against the whole-leaf one: W, M, V within
#: ``TENSOR_TOL`` of a leaf's largest element and the residual within
#: ``TENSOR_ERR_TOL`` (tests/test_torch_tensor.py's bounds against JAX),
#: except at the elements whose support differs (a tie, or a value at the
#: threshold that the split products' other summation order moves across
#: it) or that a transport's capacity dropped, both counted.
TENSOR_TOL = 1e-4
TENSOR_ERR_TOL = 1e-3
#: The share of the elements whose support may differ, and the share of
#: a leaf's elements that may lie beyond those bounds besides: at full
#: width a gradient summed over 512 tokens or 102,400 logits cancels at
#: some elements, where the split products' other summation order moves
#: its low bits far (chip run 1 of PR 21: 10,787 of deepseek's
#: 209,715,200 lm_head residuals beyond 1e-3 of the largest).
TENSOR_SUPPORT_SHARE = 1e-3
TENSOR_SHARE = 1e-4
#: A rank that runs out of memory inside a collective leaves the other
#: waiting, so a count of repeats is tried only where both ranks' peaks,
#: and then rank 0's whole-leaf round's, are predicted to fit
#: ``TENSOR_MOE_FIT`` of the card, at ``TENSOR_MOE_BYTES_PER_PARAM``
#: (deepseek's float32 rounds at 1 repeat peaked at 59.2 bytes a
#: parameter on a rank and 61.9 whole: chip run 4 of PR 21).
TENSOR_MOE_FIT = 0.9
TENSOR_MOE_BYTES_PER_PARAM = 62
#: The kernels of the split rounds: replayed at the largest leaf's shard.
TENSOR_KERNELS = ("absmax", "count_ge", "ssm_apply_ef", "apply_mask")


@contextlib.contextmanager
def _collectives(MM):
    """The collectives this rank makes while the block runs, read off
    ``launch/mesh``'s counters (``COLLECTIVES``; each call's bytes are
    those of its result as the backend moves it: an all-gather's every
    part, a reduction's tensor in float32 for the 2-byte types, a
    reduce-scatter's whole tensor): ``"<group>/<kind>"`` -> bytes,
    ``"<group>/calls"`` -> calls and ``"total"`` -> bytes, a group named
    by the mesh axes it spans (``model``; ``data``, the client or the
    data group; ``data+model``, the leaf group)."""
    MM.reset_collectives()
    out = {}
    try:
        yield out
    finally:
        for (kind, group), (nbytes, calls) in sorted(
                MM.COLLECTIVES.items()):
            out[f"{group}/{kind}"] = nbytes
            out[f"{group}/calls"] = out.get(f"{group}/calls", 0) + calls
        out["total"] = sum(b for b, _ in MM.COLLECTIVES.values())


def _host_params(cfg, seed, dev):
    """``cfg``'s random weights from ``seed``, drawn on ``dev`` (every rank
    the same) and kept on the host, leaf by leaf."""
    from repro_torch import tree as T
    from repro_torch.models.model import init_params
    return T.tree_map(lambda x: x.cpu(), init_params(cfg, seed=seed,
                                                     device=dev))


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _tensor_cfg(name, repeats, dtype, smoke):
    import dataclasses
    from repro_torch.configs import get_config, reduce_for_smoke
    cfg = get_config(name)
    cfg = reduce_for_smoke(cfg) if smoke else dataclasses.replace(
        cfg, pattern_repeats=repeats)
    return dataclasses.replace(cfg, dtype=dtype or cfg.dtype)


def _pinned(torch, x):
    """A copy of ``x`` in pinned host memory (a card's copy out of pinned
    memory runs at the link's rate, out of pageable memory at a tenth)."""
    if not x.is_cuda:
        return x.contiguous()
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)


def _keep(torch, x, to):
    """A copy of ``x`` where ``to`` says: ``"pinned"`` or ``"pageable"``
    host memory (a host tensor stays as it is), or the ``"card"``.
    Pageable memory goes back to the system when freed; a process keeps
    its pinned blocks cached."""
    if to == "card":
        return x.clone()
    return _pinned(torch, x) if to == "pinned" else x.cpu()


def _empty_kept(torch, shape, x, to):
    """An empty tensor of ``x``'s dtype where ``_keep(x, to)`` puts it."""
    return torch.empty(shape, dtype=x.dtype,
                       device=x.device if to == "card" else "cpu",
                       pin_memory=x.is_cuda and to == "pinned")


def _to_first(torch, x, group, to="pinned"):
    """Every copy of ``x`` over ``group`` (a list in the group's rank
    order) at the group's first rank, kept as ``_keep(x, to)`` keeps
    them; ``None`` at the others.  A card's copies are read where they
    lie (:func:`_ipc_to_first`); host tensors go through a gloo gather,
    as bytes (gloo refuses bfloat16)."""
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(group)
    host = lambda t: _keep(torch, t, to)
    if len(ranks) == 1:
        return [host(x)]
    if x.is_cuda:
        return _ipc_to_first(torch, x, group, ranks, host)
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    out = [torch.empty_like(flat) for _ in ranks] \
        if dist.get_rank() == ranks[0] else None
    dist.gather(flat, out, dst=ranks[0], group=group)
    return None if out is None else \
        [o.view(x.dtype).reshape(x.shape) for o in out]


def _ipc_to_first(torch, x, group, ranks, host):
    """``_to_first`` of a card's tensor, the group's ranks being processes
    on the one card: each other rank hands the first a CUDA IPC handle to
    a copy of ``x`` (pickled through gloo), the first copies each peer's
    straight to where ``host`` keeps it, and the others keep their copies
    until it has (a barrier).  The copy lies in a segment of its own: the
    caching allocator's expandable segments do not export a handle.  A
    gloo gather stages every byte through the host instead: 0.4-0.5 GB/s
    (PERF.md §5)."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor
    first = dist.get_rank() == ranks[0]
    handle = mine = None
    if not first:
        setting = torch.cuda.memory._set_allocator_settings
        setting("expandable_segments:False")
        try:
            mine = x.clone(memory_format=torch.contiguous_format)
        finally:
            setting("expandable_segments:" + str("expandable_segments:True"
                    in os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")))
        handle = reduce_tensor(mine)
    handles = [None] * len(ranks) if first else None
    dist.gather_object(handle, handles, dst=ranks[0], group=group)
    out = None
    if first:
        out = []
        for h in handles:
            peer = x if h is None else h[0](*h[1])
            out.append(host(peer))
            del peer
    dist.barrier(group=group)
    return out


def _state_at_rank0(torch, state, specs, mesh, on_device=False,
                    parts=("W", "M", "V"), to="pinned"):
    """W, M, V whole and every client's residual whole (C, ...), at
    global rank 0 (``None`` at every other rank), kept as ``_keep(x,
    to)`` keeps them: each leaf's shards gathered to its client's model
    index 0, then the residuals over model index 0's client group, leaf
    by leaf (only rank 0 keeps a model's worth of them).  ``on_device``:
    a whole-leaf state's W, M and V stay where they are (on the
    card)."""
    import torch.distributed as dist
    from repro_torch import tree as T
    group = mesh.model_group
    specs = T.leaves(specs)

    first = dist.get_rank() == 0

    def whole(x, spec, need, here=False):
        if group is None:
            return (x if here else _keep(torch, x, to)) if need else None
        parts = _to_first(torch, x, group, to)
        if parts is None:
            return None
        dims = [d for d, e in enumerate(spec) if e == "model"]
        if not dims:
            return parts[0]
        shape = list(parts[0].shape)
        shape[dims[0]] *= len(parts)
        return torch.cat(parts, dims[0],
                         out=_empty_kept(torch, shape, x, to))

    out = {p: [] for p in ("W", "M", "V")}
    for part in parts:
        leaves = [whole(x, sp, first, on_device) for x, sp in zip(
            T.leaves(getattr(state, part)), specs)]
        out[part] = leaves if first else None
    out["err"] = []
    cs = state.client_state
    errs = [] if cs is None or "comp" not in cs else \
        T.leaves(cs["comp"]["err"])
    for x, sp in zip(errs, specs):
        w = whole(x[0], sp, True)
        if mesh.model_index == 0:
            parts = _to_first(torch, w, mesh.group, to)
            if first:
                out["err"].append(torch.stack(parts))
    return out if first else None


def tensor_round(torch, mesh, cfg, algorithm, params, tokens, *, seq,
                 per_client, capture=None, drops=None, gather=True,
                 on_device=False, parts=("W", "M", "V"), **build_kw):
    """One round of ``launch.steps.build_train_step`` (error feedback;
    ``build_kw``: more of its keywords) on ``mesh`` from the whole
    ``params`` (host) and every client's ``tokens`` (host, (C,
    per_client, seq)): its wall, peak, launches and the collectives'
    bytes, with ``gather`` the state whole on global rank 0's host
    (``_state_at_rank0``; ``None`` elsewhere; a whole-leaf round's W, M,
    V kept on the card with ``on_device``), and at the rank ``capture``
    names the per-leaf kernels' first inputs at the largest leaf's shard.
    The peak is the round's (from after the build).  ``parts``: the
    server state's parts gathered (the others left out as empty)."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.core import aggregate
    from repro_torch.core.fed import local_clients
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import steps

    dev = mesh.device
    shape = dataclasses.replace(steps.SHAPES["train_4k"], seq_len=seq,
                                global_batch=per_client * mesh.n_clients)
    bundle = steps.build_train_step(cfg, mesh, shape, algorithm=algorithm,
                                    error_feedback=True, **build_kw)
    require(bundle.batch_shapes["tokens"] == (1, per_client, seq),
            f"batch {bundle.batch_shapes}")
    state = bundle.init(T.tree_map(lambda x: x.to(dev), params))
    sizes = [x.numel() for x in T.leaves(state.W)]
    batch = local_clients({"tokens": tokens.to(dev)}, mesh)
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with _collectives(MM) as moved, \
            _count_overflow(aggregate) as dropped:
        reset_launches()
        t0 = time.perf_counter()
        st, mets = bundle.fn(state, batch)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "launches": dict(LAUNCHES),
           "peak_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None,
           "collective_bytes": dict(moved),
           "loss": mets["loss"].cpu().tolist(),
           "uplink_bits": float(mets["uplink_bits"]),
           "leaves": len(sizes), "shard_elements": sum(sizes)}
    if drops is not None:
        drops.extend(int(d) for d in dropped)
    t0 = time.perf_counter()
    host = _state_at_rank0(torch, st, bundle.static["pspecs"], mesh,
                           on_device, parts) if gather else None
    rec["state_gather_s"] = time.perf_counter() - t0
    # the round's result is not needed past here: the capture round
    # below holds its own (four ranks' peaks then fit the card)
    del st
    _free(torch)
    captured = None
    if capture is not None:
        # the round again from the same state, its kernels' first inputs
        # at the largest leaf's shard kept on the card for the replay
        # (outside the timed round, whose peak they would raise); every
        # rank runs it, rank ``capture`` keeps them
        cap = Capture() if mesh.rank == capture else None
        if cap is not None:
            entry = _lm_entry_points()
            for k in TENSOR_KERNELS:
                passes = len(LM_PASSES.get(k, ("",)))
                cap.wrap(*entry[k], k, LM_KERNELS[k][2], (max(sizes),),
                         passes)
        try:
            bundle.fn(state, batch)
        finally:
            if cap is not None:
                cap.restore()
        if cap is not None:
            captured = {k: [(a, kw) for calls in cap.args[k].values()
                            for a, kw in calls] for k in cap.args}
    del state, bundle
    _free(torch)
    return rec, host, captured


def _tensor_vs_whole(torch, split, whole, drops, what, widen=1,
                     support_part="err"):
    """The split round's whole-state against the whole-leaf round's, leaf
    by leaf: the elements beyond ``TENSOR_TOL`` (``TENSOR_ERR_TOL`` for
    the residual; each ``widen`` times that) of the leaf's largest must
    be no more than those whose
    support differs between the two (a zero ``support_part`` on one side
    only: the residual, or M after a first server step from zero M)
    plus the values the two transports' capacities dropped at that leaf,
    plus ``TENSOR_SHARE`` of the leaf's elements; beyond the dropped
    values, the supports may differ at ``TENSOR_SUPPORT_SHARE`` of the
    elements.  Returns the counts, the largest error relative to each
    leaf's largest element and the failures (the phase raises on any,
    after its record is written)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda") if torch.cuda.is_available() else \
        torch.device("cpu")
    L = len(whole["W"]) or len(whole[support_part])
    per_leaf = [0] * L
    for d in drops:                     # one list per run and rank
        k = len(d) // L                 # one pack per leaf and mask
        for i in range(L):
            per_leaf[i] += sum(d[i * k:(i + 1) * k])
    support = [int(((a.to(dev) == 0) != (b.to(dev) == 0)).sum())
               for a, b in zip(split[support_part], whole[support_part])] \
        or [0] * L
    out = {"support_differs": sum(support),
           "dropped": sum(per_leaf), "beyond": {}, "beyond_10x": {},
           "max_rel_err": {}, "elements": sum(x.numel() for x in whole["W"]),
           "failures": []}
    total = sum(x.numel() for x in whole[support_part]) or 1
    for part, t in (("W", TENSOR_TOL), ("M", TENSOR_TOL),
                    ("V", TENSOR_TOL), ("err", TENSOR_ERR_TOL)):
        t *= widen
        beyond, rel = [], []
        for i, (a, b) in enumerate(zip(split[part], whole[part])):
            a, b = a.to(dev).double(), b.to(dev).double()
            d = (a - b).abs() / b.abs().max().clamp_min(1e-30)
            n = int((d > t).sum())
            rel.append(float(d.max()))
            if n > support[i] + per_leaf[i] + TENSOR_SHARE * b.numel():
                out["failures"].append(
                    f"{what}: {part}[{i}] beyond {t} at {n} of {b.numel()}"
                    f" elements, {support[i]} supports differ, "
                    f"{per_leaf[i]} dropped")
            beyond.append(n)
            out["beyond_10x"].setdefault(part, []).append(
                int((d > 10 * t).sum()))
        out["beyond"][part] = beyond
        out["max_rel_err"][part] = rel
    out["support_per_leaf"], out["dropped_per_leaf"] = support, per_leaf
    if out["support_differs"] - out["dropped"] > TENSOR_SUPPORT_SHARE * total:
        out["failures"].append(
            f"{what}: supports differ at {out['support_differs']} of "
            f"{total}, {out['dropped']} values dropped")
    out["compare_s"] = time.perf_counter() - t0
    return out


def _replay_tensor_kernels(torch, captured, on_card, measure_times):
    """Each captured kernel against its plain version, bitwise, on its
    first shard inputs (``on_card``: back on the card, else as captured in
    a CPU rehearsal); with ``measure_times`` also its times and bound
    (``lm_kernel_record``).  Returns name -> record."""
    out = {}
    for name, calls in captured.items():
        passes = LM_PASSES.get(name, ("",))
        for pass_name, (args, kw) in zip(passes, calls):
            if on_card:
                args = _on_card(args)
            label = f"{name}/{pass_name}" if pass_name else name
            leaf_arg = LM_KERNELS[name][2]
            n = args[leaf_arg].numel()
            if measure_times:
                rec = lm_kernel_record(torch, name, args, kw, leaf_arg, n)
            else:
                fk, fp = lm_kernel(torch, name, args, kw)[:2]
                a, b = fk(), fp()
                a = a if isinstance(a, tuple) else (a,)
                b = b if isinstance(b, tuple) else (b,)
                rec = {"elements": n, "max_abs_err": max(
                    max_abs_err(torch, x, y) for x, y in zip(a, b))}
            rec["shape"] = list(args[leaf_arg].shape)
            out[label] = rec
    return out


def _tensor_launches(L, algorithm):
    """Launches per rank and round of the split step: the per-leaf
    selection on each shard (absmax, two counts), then FedAdam-SSM's fused
    apply, or FedAdam-Top's three masks' applies; no Adam kernel (the
    step's Adam is unfused, as JAX's) and no word kernel (no payload)."""
    if algorithm == "fedadam_top":
        return per_client_round(absmax=3 * L, count_ge=6 * L,
                                apply_mask=3 * L)
    return per_client_round(absmax=L, count_ge=2 * L, ssm_apply_ef=L)


def _world_drops(torch, dist, drops, world):
    """Every rank's list of the values its packs dropped (one entry per
    pack, in pack order), gathered over the whole world."""
    g = [torch.zeros(len(drops), dtype=torch.int64) for _ in range(world)]
    dist.all_gather(g, torch.tensor(drops, dtype=torch.int64))
    return [x.tolist() for x in g]


def _world1_group(mesh, ranks):
    """A whole-leaf world-1 ClientMesh for each rank of ``ranks`` (every
    rank of the world must call it, in the same order)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as MM
    out = None
    for r in ranks:
        g = dist.new_group([r])
        if r == mesh.rank:
            out = MM.ClientMesh(shape={"data": 1}, client_axes=("data",),
                                rank=0, device=mesh.device, group=g)
    return out


def tensor_rank(rank, world, store, seed, part, device="cuda", smoke=False):
    """Phase 16 on one rank of a gloo group of CUDA tensors sharing the
    card.  (a) a (data 1, model 2) mesh: starcoder2's split rounds in
    float32 (FedAdam-SSM, FedAdam-Top) against the whole-leaf world-1
    round rank 0 runs after them, one bfloat16 round, then deepseek's at
    the most repeats that fit; (b) a (data 2, model 2) mesh: starcoder2's
    split FedAdam-SSM round against the world-2 whole-leaf round of the
    model index 0's client group.  ``device``/``smoke``: a CPU rehearsal
    at the smoke configs."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.device import exact_float32
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import train

    exact_float32()
    dev = torch.device(device)
    shape = {"data": 1 if part == "a" else 2, "model": 2}
    mesh = MM.init(world, rank, store=store, device=dev, backend="gloo",
                   shape=shape, timeout_s=180)
    out = {"rank": rank, "client": mesh.client_index,
           "model_index": mesh.model_index}
    t_rank = time.perf_counter()
    try:
        C = mesh.n_clients
        cfg32 = _tensor_cfg(TENSOR_ARCH, TENSOR_REPEATS, "float32", smoke)
        params = _host_params(cfg32, seed, dev)
        seq = 32 if smoke else TENSOR_SEQ
        tokens = train.build_client_batches(cfg32, C, TENSOR_PER_CLIENT, seq,
                                            seed=seed, device="cpu")["tokens"]
        # whole-leaf references: rank 0 alone at (a), the client group of
        # model index 0 at (b)
        ref_mesh = _world1_group(mesh, [0]) if part == "a" else (
            MM.ClientMesh(shape={"data": C}, client_axes=("data",),
                          rank=mesh.client_index, device=dev,
                          group=mesh.group)
            if mesh.model_index == 0 else None)
        algs = ("fedadam_ssm", "fedadam_top") if part == "a" \
            else ("fedadam_ssm",)
        for alg in algs:
            drops = []
            rec, split, captured = tensor_round(
                torch, mesh, cfg32, alg, params, tokens, seq=seq,
                per_client=TENSOR_PER_CLIENT, capture=0, drops=drops)
            L = rec["leaves"]
            require(rec["launches"] == _tensor_launches(L, alg)
                    or dev.type != "cuda",
                    f"rank {rank} {alg} launches {rec['launches']}")
            drops_all = _world_drops(torch, dist, drops, world)
            dist.barrier()
            if ref_mesh is not None:
                wdrops = []
                wrec, whole, _ = tensor_round(
                    torch, ref_mesh, cfg32, alg, params, tokens, seq=seq,
                    per_client=TENSOR_PER_CLIENT, drops=wdrops,
                    on_device=True)
                wdrops = ref_mesh.all_gather(torch.tensor(wdrops)).tolist()
                rec["whole_leaf"] = wrec
                if rank == 0:
                    require(wrec["uplink_bits"] == rec["uplink_bits"],
                            f"{alg}: bill {rec['uplink_bits']} against "
                            f"the whole-leaf round's {wrec['uplink_bits']}")
                    require(max(abs(a - b) for a, b in zip(
                        rec["loss"], wrec["loss"])) <= 1e-5 * max(
                        abs(b) for b in wrec["loss"]), f"{alg}: losses "
                        f"{rec['loss']} against {wrec['loss']}")
                    rec["vs_whole_leaf"] = _tensor_vs_whole(
                        torch, split, whole, drops_all + wdrops,
                        f"{alg} split vs whole")
                del whole
            dist.barrier()
            if captured is not None:
                t0 = time.perf_counter()
                rec["kernels"] = _replay_tensor_kernels(
                    torch, captured, dev.type == "cuda",
                    dev.type == "cuda" and part == "a")
                rec["kernels_s"] = time.perf_counter() - t0
            rec["dropped"] = sum(drops)
            out[alg] = rec
            if rank == 0:
                log(f"phase 16 ({part}) {alg}: " + json.dumps(
                    {k: v for k, v in rec.items() if k != "kernels"}))
            del split, captured
            _free(torch)
        if part == "a":
            cfg16 = _tensor_cfg(TENSOR_ARCH, TENSOR_REPEATS, None, smoke)
            p16 = _host_params(cfg16, seed, dev)
            rec, _, _ = tensor_round(torch, mesh, cfg16, "fedadam_ssm", p16,
                                     tokens, seq=seq,
                                     per_client=TENSOR_PER_CLIENT,
                                     gather=False)
            require(rec["launches"] == _tensor_launches(rec["leaves"],
                                                        "fedadam_ssm")
                    or dev.type != "cuda",
                    f"bf16 launches {rec['launches']}")
            out["bfloat16"] = rec
            if rank == 0:
                log(f"phase 16 (a) bfloat16: {json.dumps(rec)}")
            del p16
            out["moe"] = tensor_moe(torch, mesh, ref_mesh, seed, smoke)
        out["rank_s"] = time.perf_counter() - t_rank
        return out
    finally:
        mesh.close()


def tensor_moe(torch, mesh, ref_mesh, seed, smoke):
    """(a)'s deepseek-v2-lite-16b at full width in float32, the most of
    ``TENSOR_MOE_REPEATS`` whose split round (on both ranks) and whole-leaf
    round are predicted to fit the card (``TENSOR_MOE_FIT``; each that is
    not recorded with its prediction), one FedAdam-SSM round against the
    whole-leaf round rank 0 runs after it."""
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch import sharding as shd
    from repro_torch import tree as T
    from repro_torch.models import params as PM
    from repro_torch.models.model import abstract_params
    tried = {}
    card = torch.cuda.get_device_properties(0).total_memory \
        if mesh.device.type == "cuda" else float("inf")
    for repeats in ((2,) if smoke else TENSOR_MOE_REPEATS):
        cfg = _tensor_cfg(TENSOR_MOE_ARCH, repeats, "float32", smoke)
        meta = abstract_params(cfg)
        split = PM.model_split(PM.pspecs(meta, shd.param_rules("tp", False),
                                         mesh))
        whole = sum(math.prod(p.shape) for p in T.leaves(meta))
        on_rank = sum(math.prod(p.shape) // (2 if s else 1)
                      for p, s in zip(T.leaves(meta), split))
        predicted = TENSOR_MOE_BYTES_PER_PARAM * on_rank
        predicted_whole = TENSOR_MOE_BYTES_PER_PARAM * whole
        if max(2 * predicted, predicted_whole) > TENSOR_MOE_FIT * card:
            tried[repeats] = {"params": whole,
                              "predicted_peak_bytes_per_rank": predicted,
                              "predicted_whole_leaf_peak_bytes":
                                  predicted_whole,
                              "card_bytes": card, "tried": False}
            continue
        params = _host_params(cfg, seed, mesh.device)
        seq = 64 if smoke else TENSOR_MOE_SEQ
        tokens = train.build_client_batches(cfg, 1, 1, seq, seed=seed,
                                            device="cpu")["tokens"]
        drops = []
        rec, split, _ = tensor_round(torch, mesh, cfg, "fedadam_ssm",
                                     params, tokens, seq=seq, per_client=1,
                                     drops=drops)
        g = _world_drops(torch, dist, drops, 2)
        dist.barrier()
        rec.update(repeats=repeats, tried=tried, params=whole,
                   predicted_peak_bytes_per_rank=predicted,
                   predicted_whole_leaf_peak_bytes=predicted_whole)
        if ref_mesh is not None:
            wdrops = []
            wrec, whole_state, _ = tensor_round(
                torch, ref_mesh, cfg, "fedadam_ssm", params, tokens,
                seq=seq, per_client=1, drops=wdrops, on_device=True)
            rec["whole_leaf"] = wrec
            rec["dropped"] = sum(map(sum, g))
            require(wrec["uplink_bits"] == rec["uplink_bits"],
                    f"deepseek bill {rec['uplink_bits']}")
            require(abs(rec["loss"][0] - wrec["loss"][0])
                    <= 1e-5 * abs(wrec["loss"][0]),
                    f"deepseek losses {rec['loss']} {wrec['loss']}")
            rec["vs_whole_leaf"] = _tensor_vs_whole(
                torch, split, whole_state, g + [wdrops],
                "deepseek split vs whole")
            del whole_state
        dist.barrier()
        if mesh.rank == 0:
            log(f"phase 16 (a) {TENSOR_MOE_ARCH}: {json.dumps(rec)}")
        return rec
    raise RuntimeError(f"chip_smoke: {TENSOR_MOE_ARCH}'s split round fits "
                       f"at none of {TENSOR_MOE_REPEATS} repeats: {tried}")


def phase_tensor(torch, seed):
    """Phase 16: (a) 2, then (b) 4 gloo processes with CUDA tensors on the
    one card (``tensor_rank``); a failure in any rank fails the phase.
    Returns the record and rank 0's kernel records."""
    import shutil
    import tempfile
    from repro_torch.launch import mesh as MM

    out = {}
    for part, world in (("a", 2), ("b", 4)):
        tmp = tempfile.mkdtemp()
        t0 = time.perf_counter()
        try:
            ranks = MM.run_ranks(tensor_rank, world,
                                 store=os.path.join(tmp, "store"),
                                 args=(seed, part), timeout_s=600)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out[part] = {"ranks": ranks, "wall_s": time.perf_counter() - t0}
        r0 = ranks[0]
        dump = ROOT / "chiprun_out" / f"phase16_{part}.json"
        dump.parent.mkdir(exist_ok=True)
        dump.write_text(json.dumps(ranks, indent=1))
        log(f"phase 16 ({part}): {world} gloo ranks on the card "
            f"({smi_line()}) in {out[part]['wall_s']:.1f} s: "
            + json.dumps({k: {kk: r0[k][kk] for kk in (
                "wall_s", "peak_bytes", "collective_bytes", "uplink_bits",
                "vs_whole_leaf", "dropped") if kk in r0[k]}
                for k in r0 if isinstance(r0[k], dict)}))
        failures = [f for k in r0.values() if isinstance(k, dict)
                    for f in k.get("vs_whole_leaf", {}).get("failures", [])]
        require(not failures, "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# Phase 17: the virtual clients and the FSDP leaves (gloo ranks on the card)
# ---------------------------------------------------------------------------

#: A (data 2, model 2) mesh with no client axes: every leaf split over
#: "model" by the tp rules and along its ``embed`` dim over "data".
FSDP_MESH = {"data": 2, "model": 2}
FSDP_WORLD = 4
#: (a): the virtual/fsdp round of starcoder2-3b at phase 5's width and
#: cut (2 of 30 repeats, 493,894,656 parameters, sequence 128), 2 virtual
#: clients of 4 sequences (2 a data rank), build_train_step's 2 local
#: epochs, FedAdam-SSM with error feedback.
FSDP_N_VIRTUAL = 2
FSDP_GLOBAL_BATCH = 4
FSDP_BILL_BYTES = 2 * 375_854_948
#: (b): mistral-large-123b at full width, 1 of 88 repeats (2,189,463,552
#: parameters), one local step (loss and gradient) in float32 at
#: sequence 512, 2 sequences a data rank.
FSDP_STEP_ARCH = "mistral-large-123b"
FSDP_STEP_REPEATS = 1
FSDP_STEP_SEQ = 512
FSDP_STEP_PER_RANK = 2
FSDP_STEP_PARAMS = 2_189_463_552
FSDP_EMBED_SHARD = 100_663_296
#: The split step's gradient against the whole-leaf step's: within
#: ``FSDP_GRAD_TOL`` of each leaf's largest element, but at
#: ``TENSOR_SHARE`` of its elements (the split products and the data
#: group's sums add in another order, and a gradient summed over 1,024
#: tokens cancels at some elements); the loss within ``FSDP_LOSS_TOL``.
FSDP_GRAD_TOL = 1e-4
FSDP_LOSS_TOL = 1e-5
#: The per-leaf kernels of the split round, replayed at its largest
#: leaf's shard (the embedding's).
FSDP_KERNELS = ("absmax", "count_ge", "ssm_apply_ef")
#: Each part runs only where its predicted peaks fit this share of the
#: card: the split ranks' sum, and the whole-leaf reference's (run after
#: them, alone), each.
FSDP_FIT = 0.9
#: (a)'s float32 round, measured on an H100 80GB: a split rank peaked at
#: 84 bytes a parameter it holds (the virtual clients' residuals stacked,
#: a layer gathered), the whole-leaf scan round at 113.5 a parameter (its
#: wire round trip and the fold's float32 sums besides); the spatial
#: round's ``TENSOR_MOE_BYTES_PER_PARAM`` predicts neither.
FSDP_SPLIT_BYTES_PER_PARAM = 84
FSDP_WHOLE_BYTES_PER_PARAM = 114


def fsdp_plan():
    from repro_torch.sharding import DeployPlan
    return DeployPlan(clients="virtual", train_params="fsdp",
                      n_virtual=FSDP_N_VIRTUAL)


def fsdp_specs(cfg, mesh):
    from repro_torch import sharding as shd
    from repro_torch.models import params as PM
    from repro_torch.models.model import abstract_params
    meta = abstract_params(cfg)
    return meta, PM.pspecs(meta, shd.param_rules("fsdp", False), mesh)


def fsdp_local_params(cfg, mesh) -> list:
    """Every rank's count of parameters it holds under the fsdp rules."""
    import dataclasses as dc
    from repro_torch import tree as T
    from repro_torch.models import params as PM
    meta, specs = fsdp_specs(cfg, mesh)
    out = []
    for r in range(mesh.world_size):
        view = dc.replace(mesh, rank=r)
        out.append(sum(math.prod(b.stop - b.start for b in PM.shard_block(
            sp, p.shape, view)) for p, sp in zip(T.leaves(meta),
                                                 T.leaves(specs))))
    return out


#: Float32 activations a step keeps live per token and unit of model
#: width (a layer's recompute, its MLP's hidden state, the logits): a
#: bound read off the layer shapes, not measured.
FSDP_ACT_FLOATS = 64


def fsdp_step_bytes(cfg, mesh, seq, per_rank) -> dict:
    """The predicted peak bytes of one float32 FSDP+tp step (loss and
    gradient) on each split rank and of the whole-leaf step, counted from
    the shapes: a rank holds its shards and their gradients, one layer's
    leaves gathered over the data group (its tp shard) with their
    gradients and the reduce-scatter's all-reduce buffer of the largest,
    the embedding and head gathered the same way, and the activations of
    a layer's recompute (``FSDP_ACT_FLOATS`` per token and model width);
    the whole step holds the params, their gradients and its
    activations."""
    from repro_torch import tree as T
    from repro_torch.models.model import pattern_groups
    meta, specs = fsdp_specs(cfg, mesh)
    local = max(fsdp_local_params(cfg, mesh))
    whole = sum(math.prod(p.shape) for p in T.leaves(meta))
    M = mesh.shape["model"]
    tp = lambda p, sp: math.prod(p.shape) // (M if "model" in sp.axes()
                                             else 1)
    leaves = list(zip(T.leaves(meta), T.leaves(specs)))
    layers = sum(c for _, c in pattern_groups(cfg)) * cfg.pattern_repeats
    block = [tp(p, sp) // layers for p, sp in leaves if len(p.shape) > 2]
    top = [tp(p, sp) for p, sp in leaves if len(p.shape) == 2]
    per_layer, biggest = sum(block), max(block + top)
    acts = FSDP_ACT_FLOATS * per_rank * seq * cfg.d_model
    rank = 4 * (2 * local + 2 * per_layer + max(top) * 2 + biggest) \
        + 4 * acts
    whole_b = 4 * 2 * whole + 4 * acts * mesh.shape["data"]
    return {"split_rank": rank, "split_total": rank * mesh.world_size,
            "whole": whole_b, "local_params": local,
            "gathered_layer_params": per_layer, "params": whole}


def _whole_at_rank0(torch, leaves, specs, mesh, to="pinned"):
    """The whole leaves of this rank's ``leaves`` (shards under ``specs``)
    at global rank 0, kept as ``_keep(x, to)`` keeps them, ``None``
    elsewhere: each leaf's shards gathered over every rank and placed at
    their blocks, leaf by leaf."""
    import dataclasses as dc
    import torch.distributed as dist
    from repro_torch.models import params as PM
    first = dist.get_rank() == 0
    out = []
    for x, sp in zip(leaves, specs):
        parts = _to_first(torch, x, dist.group.WORLD, to)
        if not first:
            continue
        shape = [n * math.prod(mesh.shape[a] for a in (
            () if e is None else (e,) if isinstance(e, str) else e))
            for n, e in zip(x.shape, sp)]
        whole = _empty_kept(torch, shape, x, to)
        for r, part in enumerate(parts):
            whole[PM.shard_block(sp, shape, dc.replace(mesh, rank=r))] = part
        out.append(whole)
    return out if first else None


def fsdp_round(torch, mesh, cfg, seed, tokens, *, gather=True,
               capture=None, algorithm="fedadam_ssm",
               parts=("W", "M", "V"), kernels=FSDP_KERNELS, **build_kw):
    """One virtual/fsdp round of ``launch.steps.build_train_step``
    (``algorithm``, error feedback; ``build_kw``: more of its keywords)
    on ``mesh`` from ``cfg``'s random
    weights (this rank's shards drawn leaf by leaf on the card,
    ``models/params.materialize_shards``) and every client's ``tokens``
    (host, (C, global batch, seq)): wall, peak, launches, the bytes each
    group moves, and with ``gather`` the whole state (W, M, V, the
    clients' residuals) on global rank 0's host.  ``capture``: the rank
    that keeps the per-leaf kernels' first inputs at the largest leaf's
    shard, from the round run again from the same state (its wall, warm
    but for those copies, recorded besides)."""
    import dataclasses as dc
    from repro_torch import tree as T
    from repro_torch.core.fed import local_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import steps
    from repro_torch.models import params as PM
    from repro_torch.models.model import abstract_params

    dev = mesh.device
    shape = dc.replace(steps.SHAPES["train_4k"], seq_len=tokens.shape[2],
                       global_batch=tokens.shape[1])
    bundle = steps.build_train_step(cfg, mesh, shape, algorithm=algorithm,
                                    error_feedback=True, plan=fsdp_plan(),
                                    **build_kw)
    specs = bundle.static["pspecs"]
    shards = PM.materialize_shards(abstract_params(cfg), specs, mesh, seed,
                                   cfg.dtype, dev)
    state = bundle.init(shards, sharded=True)
    del shards
    batch = local_batch({"tokens": tokens.to(dev)}, mesh)
    require(tuple(batch["tokens"].shape) == bundle.batch_shapes["tokens"],
            f"batch {tuple(batch['tokens'].shape)} against "
            f"{bundle.batch_shapes}")
    sizes = [x.numel() for x in T.leaves(state.W)]
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    with _collectives(MM) as moved:
        reset_launches()
        t0 = time.perf_counter()
        st, mets = bundle.fn(state, batch)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "launches": dict(LAUNCHES),
           "peak_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None, "held_bytes": held,
           "collective_bytes": dict(moved),
           "loss": mets["loss"].cpu().tolist(),
           "uplink_bits": float(mets["uplink_bits"]),
           "leaves": len(sizes), "shard_elements": sum(sizes),
           "batch": list(batch["tokens"].shape)}
    t0 = time.perf_counter()
    host = None
    if gather:
        cs_specs = [PM.Spec((None,) + tuple(sp)) for sp in T.leaves(specs)]
        host = {part: _whole_at_rank0(torch, T.leaves(getattr(st, part)),
                                      T.leaves(specs), mesh)
                if part in parts else [] for part in ("W", "M", "V")}
        cs = st.client_state
        host["err"] = [] if cs is None or "comp" not in cs else \
            _whole_at_rank0(torch, T.leaves(cs["comp"]["err"]), cs_specs,
                            mesh)
        if mesh.rank != 0:
            host = None
    rec["state_gather_s"] = time.perf_counter() - t0
    del st
    _free(torch)
    captured = None
    if capture is not None:
        cap = Capture() if mesh.rank == capture else None
        if cap is not None:
            entry = _lm_entry_points()
            for k in kernels:
                passes = len(LM_PASSES.get(k, ("",)))
                cap.wrap(*entry[k], k, LM_KERNELS[k][2], (max(sizes),),
                         passes)
        t0 = time.perf_counter()
        try:
            bundle.fn(state, batch)
            _sync(torch, dev)
        finally:
            if cap is not None:
                cap.restore()
        rec["wall_s_again"] = time.perf_counter() - t0
        if cap is not None:
            captured = {k: [(a, kw) for calls in cap.args[k].values()
                            for a, kw in calls] for k in cap.args}
    del state, bundle
    _free(torch)
    return rec, host, captured


def fsdp_whole_round(torch, cfg, seed, tokens, dev,
                     algorithm="fedadam_ssm", **build_kw):
    """The whole-leaf scan round of the same plan on one rank (a world-1
    virtual mesh, no collective), from the same weights (drawn whole on
    the card) and batch (``build_kw``: more keywords of the step): its
    record and its state (W, M, V on the card, the residuals on the
    host)."""
    import dataclasses as dc
    from repro_torch import tree as T
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import steps
    from repro_torch.models.model import init_params
    one = MM.ClientMesh(shape={"data": 1}, client_axes=(), rank=0,
                        device=dev)
    shape = dc.replace(steps.SHAPES["train_4k"], seq_len=tokens.shape[2],
                       global_batch=tokens.shape[1])
    bundle = steps.build_train_step(cfg, one, shape, algorithm=algorithm,
                                    error_feedback=True, plan=fsdp_plan(),
                                    **build_kw)
    state = bundle.init(init_params(cfg, seed=seed, device=dev))
    batch = {"tokens": tokens.to(dev)}
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    st, mets = bundle.fn(state, batch)
    _sync(torch, dev)
    rec = {"wall_s": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None, "launches": dict(LAUNCHES),
           "loss": mets["loss"].cpu().tolist(),
           "uplink_bits": float(mets["uplink_bits"])}
    whole = {p: T.leaves(getattr(st, p)) for p in ("W", "M", "V")}
    cs = st.client_state
    whole["err"] = [] if cs is None or "comp" not in cs else \
        [_pinned(torch, x) for x in T.leaves(cs["comp"]["err"])]
    del st, state, bundle
    _free(torch)
    return rec, whole


def fsdp_launches(L):
    """Launches per rank and round of the virtual/fsdp round: per client
    and leaf the selection on each shard (absmax, two counts) and the
    fused apply; no Adam kernel (unfused, as JAX's), no word kernel (no
    payload: the scan round hands over the encoder's carriers)."""
    C = FSDP_N_VIRTUAL
    return per_client_round(absmax=C * L, count_ge=2 * C * L,
                            ssm_apply_ef=C * L)


def fsdp_rank(rank, world, store, seed, device="cuda", smoke=False):
    """Phase 17 on one rank of a gloo group of CUDA tensors sharing the
    card, a (data 2, model 2) mesh with no client axes: (a) the
    virtual/fsdp round of starcoder2-3b in float32 against the whole-leaf
    round rank 0 runs after it, one bfloat16 round, the per-leaf kernels
    bitwise on the embedding's shard; (b) mistral-large-123b's FSDP+tp
    step at full width against the whole-leaf step, ``select_tau`` on its
    embedding gradient's shards bitwise the whole leaf's, and the
    selection and apply kernels bitwise on that shard with times.
    ``device``/``smoke``: a CPU rehearsal at the smoke configs."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.device import exact_float32
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import train

    exact_float32()
    dev = torch.device(device)
    mesh = MM.init(world, rank, store=store, device=dev, backend="gloo",
                   shape=FSDP_MESH, client_axes=(), timeout_s=180)
    out = {"rank": rank, "row": mesh.client_index,
           "model_index": mesh.model_index,
           "data_index": mesh.data.index}
    t_rank = time.perf_counter()
    card = torch.cuda.get_device_properties(0).total_memory \
        if dev.type == "cuda" else float("inf")
    try:
        out["a"] = fsdp_part_a(torch, dist, mesh, seed, card, smoke, train)
        _free(torch)
        out["b"] = fsdp_part_b(torch, dist, mesh, seed, card, smoke)
        out["rank_s"] = time.perf_counter() - t_rank
        return out
    finally:
        mesh.close()


def fsdp_part_a(torch, dist, mesh, seed, card, smoke, train):
    """(a) on this rank; rank 0 also runs the whole-leaf reference."""
    from repro_torch import tree as T
    dev = mesh.device
    cfg32 = _tensor_cfg(TENSOR_ARCH, TENSOR_REPEATS, "float32", smoke)
    local = fsdp_local_params(cfg32, mesh)
    params = sum(math.prod(p.shape) for p in
                 T.leaves(fsdp_specs(cfg32, mesh)[0]))
    pred = {"split_rank": FSDP_SPLIT_BYTES_PER_PARAM * max(local),
            "split_total": FSDP_SPLIT_BYTES_PER_PARAM * sum(local),
            "whole": FSDP_WHOLE_BYTES_PER_PARAM * params,
            "card_bytes": card, "params": params, "local_params": local}
    # the whole-leaf round runs after the split ranks' rounds, their
    # state on the host: each must fit alone
    require(max(pred["split_total"], pred["whole"]) <= FSDP_FIT * card,
            f"phase 17 (a) predicted not to fit: {pred}")
    seq = 32 if smoke else TENSOR_SEQ
    tokens = train.build_client_batches(
        cfg32, FSDP_N_VIRTUAL, FSDP_GLOBAL_BATCH, seq, seed=seed,
        device="cpu")["tokens"]
    rec, split, captured = fsdp_round(torch, mesh, cfg32, seed, tokens,
                                      capture=0)
    rec["predicted"] = pred
    L = rec["leaves"]
    dist.barrier()
    if mesh.rank == 0:
        log(f"phase 17 (a) float32 split round: {json.dumps(rec)}")
        wrec, whole = fsdp_whole_round(torch, cfg32, seed, tokens, dev)
        rec["whole_leaf"] = wrec
        rec["vs_whole_leaf"] = _tensor_vs_whole(torch, split, whole, [],
                                                "fsdp split vs whole")
        log(f"phase 17 (a) whole-leaf round: {json.dumps(wrec)}; split vs "
            f"whole: {json.dumps(rec['vs_whole_leaf'])}")
        # the bill is a float32 scalar, as JAX's
        bill = float(torch.tensor(8.0 * FSDP_BILL_BYTES,
                                  dtype=torch.float32))
        require(wrec["uplink_bits"] == rec["uplink_bits"] and (
                    smoke or rec["uplink_bits"] == bill),
                f"bill {rec['uplink_bits']} against the whole-leaf "
                f"round's {wrec['uplink_bits']} and {bill}")
        require(max(abs(a - b) for a, b in zip(rec["loss"], wrec["loss"]))
                <= 1e-5 * max(abs(b) for b in wrec["loss"]),
                f"losses {rec['loss']} against {wrec['loss']}")
        del whole
    require(rec["launches"] == fsdp_launches(L) or dev.type != "cuda",
            f"rank {mesh.rank} launches {rec['launches']}")
    del split
    _free(torch)
    dist.barrier()
    if captured is not None:
        t0 = time.perf_counter()
        rec["kernels"] = _replay_tensor_kernels(
            torch, captured, dev.type == "cuda", dev.type == "cuda")
        rec["kernels_s"] = time.perf_counter() - t0
        del captured
    dist.barrier()
    cfg16 = _tensor_cfg(TENSOR_ARCH, TENSOR_REPEATS, None, smoke)
    rec16, _, _ = fsdp_round(torch, mesh, cfg16, seed, tokens, gather=False)
    require(rec16["launches"] == fsdp_launches(rec16["leaves"])
            or dev.type != "cuda", f"bf16 launches {rec16['launches']}")
    if mesh.rank == 0:
        log(f"phase 17 (a) bfloat16: {json.dumps(rec16)}")
    return {"float32": rec, "bfloat16": rec16}


def _rel_block_err(torch, part, whole):
    """(largest |part - whole| over whole's largest element, the count of
    elements beyond ``FSDP_GRAD_TOL`` of it)."""
    d = (part.double() - whole.double()).abs()
    scale = max(float(whole.abs().max()), 1e-30)
    return float(d.max()) / scale, int((d > FSDP_GRAD_TOL * scale).sum())


def fsdp_part_b(torch, dist, mesh, seed, card, smoke):
    """(b) on this rank: the split step, then rank 0's whole-leaf step and
    the shard-by-shard comparison, ``select_tau`` over the leaf group on
    the embedding gradient's shard, the kernels on that shard."""
    import dataclasses as dc
    from repro_torch import tree as T
    from repro_torch.core import sparsify as S
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.topk_mask.ops import select_tau
    from repro_torch.models import model as Mdl
    from repro_torch.models import params as PM
    from repro_torch.models.tensor import FSDP
    dev = mesh.device
    cfg = _tensor_cfg(FSDP_STEP_ARCH, FSDP_STEP_REPEATS, "float32", smoke)
    seq = 64 if smoke else FSDP_STEP_SEQ
    pred = fsdp_step_bytes(cfg, mesh, seq, FSDP_STEP_PER_RANK)
    pred["card_bytes"] = card
    require(smoke or pred["params"] == FSDP_STEP_PARAMS,
            f"{FSDP_STEP_ARCH} at 1 repeat: {pred['params']} parameters")
    require(max(pred["split_total"], pred["whole"]) <= FSDP_FIT * card,
            f"phase 17 (b) predicted not to fit: {pred}")
    meta, specs = fsdp_specs(cfg, mesh)
    rows = mesh.world_size // mesh.model_size
    rng = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size,
                           (rows * FSDP_STEP_PER_RANK, seq), generator=rng,
                           dtype=torch.int32)
    lo = mesh.client_index * FSDP_STEP_PER_RANK
    local_tok = tokens[lo:lo + FSDP_STEP_PER_RANK].to(dev)
    fsdp = FSDP(mesh.data, specs, mesh.fsdp_axes)

    def step(params, toks, **kw):
        leaves, td = T.flatten(params)
        req = [x.requires_grad_(True) for x in leaves]
        loss = Mdl.loss_fn(cfg, td.unflatten(req), toks, **kw)
        grads = torch.autograd.grad(loss, req)
        return loss.detach(), list(grads)

    t0 = time.perf_counter()
    shards = PM.materialize_shards(meta, specs, mesh, seed, "float32", dev)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = step(shards, local_tok, tp=mesh.model, fsdp=fsdp)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    del shards
    _free(torch)
    rec = {"params": pred["params"], "predicted": pred, "init_s": init_s,
           "wall_s": wall, "peak_bytes": peak, "loss": float(loss),
           "batch": list(local_tok.shape)}
    # select_tau over the leaf group on the embedding gradient's shard
    leaves_meta = T.leaves(meta)
    ie = next(i for i, p in enumerate(leaves_meta)
              if p.axes == ("vocab", "embed"))
    g_emb = grads[ie]
    require(smoke or g_emb.numel() == FSDP_EMBED_SHARD,
            f"embed shard {g_emb.numel()}")
    n_emb = math.prod(leaves_meta[ie].shape)
    k = S.k_for(n_emb, 0.05)
    # rank 0 keeps the selection kernels' inputs on its shard for the
    # replay against their plain versions
    cap = Capture() if mesh.rank == 0 else None
    if cap is not None:
        entry = _lm_entry_points()
        for kname in ("absmax", "count_ge"):
            cap.wrap(*entry[kname], kname, LM_KERNELS[kname][2],
                     (g_emb.numel(),), len(LM_PASSES.get(kname, ("",))))
    reset_launches()
    try:
        tau, cnt = select_tau(g_emb, k, model=mesh.leaf, n=n_emb)
    finally:
        if cap is not None:
            cap.restore()
    rec["select_launches"] = {a: b for a, b in LAUNCHES.items() if b}
    rec["tau"], rec["count"] = float(tau), float(cnt)
    dist.barrier()
    # the whole-leaf step and the comparison on rank 0, leaf by leaf
    whole_grads = None
    if mesh.rank == 0:
        params = Mdl.init_params(cfg, seed=seed, device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wloss, whole_grads = step(params, tokens.to(dev))
        _sync(torch, dev)
        rec["whole_leaf"] = {
            "wall_s": time.perf_counter() - t0, "loss": float(wloss),
            "peak_bytes": torch.cuda.max_memory_allocated()
            if dev.type == "cuda" else None}
        del params
        _free(torch)
    t0 = time.perf_counter()
    errs, beyond, failures = [], [], []
    if mesh.rank == 0 and abs(float(loss) - float(wloss)) > FSDP_LOSS_TOL \
            * abs(float(wloss)):
        failures.append(f"loss {float(loss)} against the whole step's "
                        f"{float(wloss)}")
    for i, (g, sp, p) in enumerate(zip(grads, T.leaves(specs),
                                       leaves_meta)):
        parts = _to_first(torch, g, dist.group.WORLD)
        if parts is None:
            continue
        worst, n_bad = 0.0, 0
        for r, part in enumerate(parts):
            blk = PM.shard_block(sp, p.shape, dc.replace(mesh, rank=r))
            e, nb = _rel_block_err(torch, part.to(dev),
                                   whole_grads[i][blk])
            worst, n_bad = max(worst, e), n_bad + nb
        errs.append(worst)
        beyond.append(n_bad)
        if n_bad > TENSOR_SHARE * math.prod(p.shape):
            failures.append(f"grad[{i}] beyond {FSDP_GRAD_TOL} at {n_bad} "
                            f"of {math.prod(p.shape)} elements")
        if i == ie:
            # the whole embedding gradient from the same shards: its tau
            whole_emb = torch.empty(p.shape, dtype=g.dtype, device=dev)
            for r, part in enumerate(parts):
                blk = PM.shard_block(sp, p.shape, dc.replace(mesh, rank=r))
                whole_emb[blk] = part.to(dev)
            tau0, cnt0 = select_tau(whole_emb, k)
            rec["tau_bitwise"] = bool(torch.equal(
                tau.view(torch.int32), tau0.view(torch.int32))) and \
                bool(torch.equal(cnt, cnt0))
            rec["tau_whole"] = (float(tau0), float(cnt0))
            if not rec["tau_bitwise"]:
                failures.append(f"select_tau on the shards {float(tau)}/"
                                f"{float(cnt)} against the whole leaf's "
                                f"{float(tau0)}/{float(cnt0)}")
            del whole_emb
    if mesh.rank == 0:
        rec["vs_whole_leaf"] = {"max_rel_err": errs, "beyond": beyond,
                                "failures": failures,
                                "compare_s": time.perf_counter() - t0}
        log(f"phase 17 (b): {json.dumps(rec)}")
    del whole_grads
    _free(torch)
    dist.barrier()
    if mesh.rank == 0:
        # the selection's and the fused apply's kernels on the shard,
        # bitwise their plain versions, with times and bounds
        captured = {kk: [(a, kw) for calls in cap.args[kk].values()
                         for a, kw in calls] for kk in cap.args}
        dm, dv = 0.1 * g_emb, 1e-3 * g_emb * g_emb
        captured["ssm_apply_ef"] = [((tau, g_emb, dm, dv),
                                     {"with_residual": True})]
        t0 = time.perf_counter()
        rec["kernels"] = _replay_tensor_kernels(
            torch, captured, dev.type == "cuda", dev.type == "cuda")
        rec["kernels_s"] = time.perf_counter() - t0
        del captured, dm, dv
        require(not failures, "; ".join(failures))
    del grads, g_emb
    _free(torch)
    dist.barrier()
    return rec


def phase_fsdp(torch, seed):
    """Phase 17: 4 gloo processes with CUDA tensors on the one card
    (``fsdp_rank``); a failure in any rank fails the phase.  Also the
    predicted peak of mistral-large-123b's whole round at 1 repeat, in
    float32 and bfloat16, from (a)'s measured bytes per parameter (not
    run)."""
    import shutil
    import tempfile
    from repro_torch.launch import mesh as MM

    log("phase 17: the virtual clients and the FSDP leaves, "
        f"{FSDP_WORLD} gloo ranks on the card")
    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    try:
        ranks = MM.run_ranks(fsdp_rank, FSDP_WORLD,
                             store=os.path.join(tmp, "store"),
                             args=(seed,), timeout_s=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"ranks": ranks, "wall_s": time.perf_counter() - t0}
    dump = ROOT / "chiprun_out" / "phase17.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(json.dumps(ranks, indent=1))
    out["mistral_round_predicted"] = fsdp_round_prediction(ranks)
    r0 = ranks[0]
    log(f"phase 17: {FSDP_WORLD} gloo ranks on the card ({smi_line()}) in "
        f"{out['wall_s']:.1f} s: " + json.dumps({
            "a": {k: r0["a"]["float32"].get(k) for k in (
                "wall_s", "peak_bytes", "collective_bytes", "uplink_bits",
                "vs_whole_leaf")},
            "a_bfloat16": {k: r0["a"]["bfloat16"].get(k) for k in (
                "wall_s", "peak_bytes")},
            "b": {k: r0["b"].get(k) for k in (
                "wall_s", "peak_bytes", "predicted", "loss", "whole_leaf",
                "tau_bitwise", "vs_whole_leaf")},
            "mistral_round_predicted": out["mistral_round_predicted"]}))
    failures = r0["a"]["float32"]["vs_whole_leaf"]["failures"] \
        + r0["b"]["vs_whole_leaf"]["failures"]
    require(not failures, "; ".join(failures))
    return out


def fsdp_round_prediction(ranks) -> dict:
    """mistral-large-123b's virtual/fsdp round at 1 repeat, predicted (not
    run): (a)'s measured peak bytes per parameter a rank holds (split, in
    float32 and bfloat16) and per parameter of the whole-leaf round, times
    mistral's counts."""
    import dataclasses as dc
    from repro_torch.launch import mesh as MM
    view = MM.ClientMesh(shape=FSDP_MESH, client_axes=(), rank=0,
                         device=None)
    cfg = _tensor_cfg(FSDP_STEP_ARCH, FSDP_STEP_REPEATS, None, False)
    local = fsdp_local_params(dc.replace(cfg, dtype="float32"), view)
    out = {"params": FSDP_STEP_PARAMS, "local_params": local}
    if any(r["a"][d]["peak_bytes"] is None for r in ranks
           for d in ("float32", "bfloat16")):
        return {"not_measured": "no card"}
    for dtype in ("float32", "bfloat16"):
        per = max(r["a"][dtype]["peak_bytes"] / r["a"][dtype]["shard_elements"]
                  for r in ranks)
        out[dtype] = {"bytes_per_local_param": per,
                      "split_total": per * sum(local)}
    whole = ranks[0]["a"]["float32"]["whole_leaf"]
    per = whole["peak_bytes"] / ranks[0]["a"]["float32"]["predicted"]["params"]
    out["float32"]["whole_bytes_per_param"] = per
    out["float32"]["whole"] = per * FSDP_STEP_PARAMS
    return out


# ---------------------------------------------------------------------------
# Phase 18: sharded serving
# ---------------------------------------------------------------------------

SM_MESH = {"data": 2, "model": 2}
SM_MESH_TP = {"data": 1, "model": 2}
SM_WORLD = 4
#: (a) (name, mesh, global batch): each whole, a 32-token prompt through
#: the prefill step, then 16 greedy decode steps, in float32
SM_A = (("starcoder2-3b", SM_MESH, 4), ("deepseek-v2-lite-16b", SM_MESH_TP,
                                         2))
SM_PROMPT, SM_GEN = 32, 16
#: (b) gemma3-27b at full width, its first 6 specs (5 local, 1 global), 1
#: repeat, long_500k (batch 1, 524,288 positions, kv_seq over "data"), in
#: float32, decoding from seeded caches at positions in each data rank's
#: half of the global cache (and of the local rings)
SM_LONG_ARCH, SM_LONG_SPECS = "gemma3-27b", 6
SM_LONG_POS = (262142, 262143, 262144, 524287)
SM_CACHE_STD = 0.5
#: (c) kimi-k2-1t-a32b at full width, 1 of 61 repeats, the 2-D serving of
#: its fsdp plan, bfloat16: a 16-token prompt at batch 2, 16 greedy steps
SM_C_ARCH, SM_C_REPEATS, SM_C_BATCH, SM_C_PROMPT, SM_C_GEN = \
    "kimi-k2-1t-a32b", 1, 2, 16, 16
#: logits and cache blocks against the whole model's: within this share of
#: the whole's largest |element| (float32 parts), or SM_TOL_BF16 (c)
SM_TOL = 1e-4
SM_TOL_BF16 = 0.05
SM_FIT = 0.9
#: a rank's activations, collectives' staging and allocator slack beyond
#: its shards and caches (the prediction's margin)
SM_ACT_BYTES = 1 << 30
#: the seeded weights' and caches' chunk: each drawn from its own
#: generator, so that any block of a leaf is made without the whole
SEED_CHUNK = 1 << 24


def seeded_block(torch, p, block, seed, salt, dtype, dev, std=None):
    """The elements at ``block`` (slices) of the whole leaf ``p`` (a ``P``)
    drawn in flat chunks of ``SEED_CHUNK``, chunk j from a generator
    seeded by (``seed``, ``salt``, j): N(0, std^2) by the leaf's init rule
    (``std`` overrides it; zeros and ones otherwise as they are), cast to
    ``dtype``.  Any block of the leaf, the whole one included, holds the
    same numbers at the same places."""
    shape = p.shape
    bshape = tuple(s.stop - s.start for s in block)
    if std is None:
        if p.init in ("zeros", "ones"):
            return torch.full(bshape, float(p.init == "ones"), dtype=dtype,
                              device=dev)
        fan_in = p.fan_in or (shape[-2] if len(shape) >= 2 else shape[-1])
        std = 1.0 / math.sqrt(max(1, fan_in)) if p.init == "scaled" \
            else 0.02
    out = torch.empty(bshape, dtype=dtype, device=dev)
    flat = out.view(-1)
    n = math.prod(shape)
    whole = bshape == tuple(shape)

    def ravel(idx):
        r = 0
        for i, d in zip(idx, shape):
            r = r * d + i
        return r

    first = ravel([s.start for s in block])
    last = ravel([s.stop - 1 for s in block])
    for j in range((n + SEED_CHUNK - 1) // SEED_CHUNK):
        a, b = j * SEED_CHUNK, min(n, (j + 1) * SEED_CHUNK)
        if b <= first or a > last:
            continue
        gen = torch.Generator(device=dev).manual_seed(
            (seed * 1_000_003 + salt) * 1_000_003 + j)
        x = torch.randn(b - a, generator=gen, dtype=torch.float32,
                        device=dev).mul_(std).to(dtype)
        if whole:
            flat[a:b] = x
            continue
        idx = torch.arange(a, b, device=dev)
        keep = torch.ones(b - a, dtype=torch.bool, device=dev)
        local = torch.zeros_like(idx)
        stride = 1
        for d in reversed(range(len(shape))):
            c = idx % shape[d]
            idx = idx // shape[d]
            keep &= (c >= block[d].start) & (c < block[d].stop)
            local += (c - block[d].start) * stride
            stride *= bshape[d]
        flat[local[keep]] = x[keep]
    return out


def seeded_tree(torch, meta, specs, mesh, seed, dtype, dev, salt=0,
                std=None):
    """``seeded_block`` of every leaf of ``meta``: this rank's blocks under
    ``specs`` on ``mesh``, or the whole leaves with ``mesh`` None."""
    from repro_torch import tree as T
    from repro_torch.models import params as PM
    leaves, td = T.flatten(meta)
    spec_leaves = T.leaves(specs) if specs is not None else \
        [None] * len(leaves)
    out = []
    for i, (p, sp) in enumerate(zip(leaves, spec_leaves)):
        block = tuple(slice(0, n) for n in p.shape) if mesh is None else \
            PM.shard_block(sp, p.shape, mesh)
        out.append(seeded_block(torch, p, block, seed, salt + i,
                                PM.leaf_dtype(p, dtype), dev, std))
    return td.unflatten(out)


def _tree_bytes(meta, specs, shape, dtype) -> tuple:
    """(bytes, the largest leaf's bytes) of a rank's blocks of ``meta``
    under ``specs`` on a mesh of ``shape`` (the whole tree with ``specs``
    None)."""
    from repro_torch import tree as T
    from repro_torch.models import params as PM
    sizes = [math.prod(p.shape if specs is None else PM.shard_shape(
        sp, p.shape, shape)) * {"float32": 4, "bfloat16": 2}[p.dtype or dtype]
        for p, sp in zip(T.leaves(meta), T.leaves(specs) if specs is not None
                         else [None] * len(T.leaves(meta)))]
    return sum(sizes), max(sizes)


def sm_cfg(name, smoke, dtype):
    """The part's configuration: full width (the smoke config on the
    CPU), whole unless cut as the part says."""
    import dataclasses as dc
    from repro_torch.configs import get_config, reduce_for_smoke
    cfg = get_config(name)
    if smoke:
        cfg = reduce_for_smoke(cfg)
    if name == SM_LONG_ARCH:
        cfg = dc.replace(cfg, layer_pattern=cfg.layer_pattern[:SM_LONG_SPECS],
                         pattern_repeats=1)
    if name == SM_C_ARCH and not smoke:
        cfg = dc.replace(cfg, pattern_repeats=SM_C_REPEATS)
    return dc.replace(cfg, dtype=dtype)


def sm_predict(cfg, pspecs, cmeta, cspecs, shape, world) -> dict:
    """Predicted peak bytes of a rank: its parameter and cache blocks, two
    float32 copies of its largest cache block (the attention's scores
    read them so), and ``SM_ACT_BYTES``; and of the whole model on one
    process afterwards, the same whole."""
    from repro_torch import tree as T
    from repro_torch.models import model as Mdl
    meta = Mdl.abstract_params(cfg)
    def one(ps, cs):
        params, _ = _tree_bytes(meta, ps, shape, cfg.dtype)
        caches, big = _tree_bytes(cmeta, cs, shape, cfg.dtype)
        return {"params": params, "caches": caches,
                "peak": params + caches + 2 * 2 * big + SM_ACT_BYTES}

    rank, whole = one(pspecs, cspecs), one(None, None)
    return {"rank": rank, "ranks": world * rank["peak"], "whole": whole,
            "n_params": sum(math.prod(p.shape) for p in T.leaves(meta))}


def _np32(x):
    return x.detach().float().cpu().numpy()


def _peak(torch, dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _step_counts(MM, mesh, torch, fn):
    """``fn()``'s result, its wall (synchronised) and the bytes each group
    moved."""
    with _collectives(MM) as cnt:
        t0 = time.perf_counter()
        out = fn()
        _sync(torch, mesh.device)
        wall = time.perf_counter() - t0
    return out, wall, dict(cnt)


class RouteLog:
    """The MoE routings of the calls made while it is entered
    (``layers._route`` wrapped): each call's experts and probabilities,
    kept on the device until :meth:`take`."""

    def __init__(self):
        from repro_torch.models import layers as L
        self.L, self.calls = L, []

    def __enter__(self):
        fn = self.fn = self.L._route

        def rec(m, logits):
            r = fn(m, logits)
            self.calls.append((r.eidx, r.probs))
            return r

        self.L._route = rec
        return self

    def __exit__(self, *exc):
        self.L._route = self.fn

    def take(self):
        """``(experts (b, calls, s, k), probabilities (b, calls, s, E))``
        of the calls since the last take, on the host; ``(None, None)``
        without an MoE."""
        import numpy as np
        calls, self.calls = self.calls, []
        if not calls:
            return None, None
        return (np.stack([e.cpu().numpy() for e, _ in calls], 1),
                np.stack([p.float().cpu().numpy() for _, p in calls], 1))


def _mean_bytes(counts) -> dict:
    keys = sorted({k for c in counts for k in c})
    return {k: sum(c.get(k, 0) for c in counts) / len(counts) for k in keys}


def sm_prompt(torch, cfg, batch, n, seed):
    g = torch.Generator().manual_seed(seed + 11)
    return torch.randint(0, cfg.vocab_size, (batch, n), generator=g,
                         dtype=torch.int32)


def sm_greedy_part(torch, MM, mesh, cfg, batch, prompt, gen, seed, card,
                   world, cuts):
    """(a) and (c) on this rank: the prefill step over ``prompt`` tokens
    of this rank's rows, the caches seated in the serve step's, ``gen``
    greedy decode steps; the logits, picks and cache blocks for the
    comparison, walls, peak and bytes per group."""
    from repro_torch import tree as T
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import pick
    from repro_torch.models import model as Mdl
    from repro_torch.sharding import plan_for
    dev = mesh.device
    pre_shape = ST.ShapeSpec("prefill_32k", prompt, batch, "prefill")
    dec_shape = ST.ShapeSpec("decode_32k", prompt + gen, batch, "decode")
    # the model's own plan (a smoke config's name has none)
    plan = plan_for(cfg.name.removesuffix("-smoke"))
    prefill = ST.build_prefill_step(cfg, mesh, pre_shape, plan=plan)
    serve = ST.build_serve_step(cfg, mesh, dec_shape, plan=plan)
    pspecs, cspecs = serve.static["pspecs"], serve.static["cspecs"]
    cmeta = Mdl.cache_meta(cfg, batch, prompt + gen)
    pred = sm_predict(cfg, pspecs, cmeta, cspecs, mesh.shape, world)
    pred["card_bytes"] = card
    require(pred["ranks"] <= SM_FIT * card and pred["whole"]["peak"]
            <= SM_FIT * card, f"phase 18 {cfg.name} predicted not to fit: "
            f"{pred}")
    rec = {"cfg": cfg.name, "dtype": cfg.dtype, "cuts": cuts,
           "mesh": dict(mesh.shape), "predicted": pred,
           "two_d": serve.static["fsdp"] is not None}
    _reset_peak(torch, dev)
    t0 = time.perf_counter()
    params = seeded_tree(torch, Mdl.abstract_params(cfg), pspecs, mesh,
                         seed, cfg.dtype, dev)
    _sync(torch, dev)
    rec["init_s"] = time.perf_counter() - t0
    b_loc = serve.batch_shapes["token"][0]
    rows = mesh.axis_group("data")
    r0 = 0 if rows is None else rows.index * b_loc
    toks = sm_prompt(torch, cfg, batch, prompt, 0)[r0:r0 + b_loc].to(dev)
    routes = RouteLog()
    with routes:
        (logits, pre), rec["prefill_s"], rec["prefill_bytes"] = \
            _step_counts(MM, mesh, torch,
                         lambda: prefill.fn(params, {"tokens": toks}))
        route = [routes.take()]
        caches = Mdl.seat_caches(serve.new_caches(), pre)
        del pre
        rec["rows"] = [r0, b_loc]
        rec["prefill_logits"] = _np32(logits)
        picks, step_logits, walls, counts = [], [], [], []
        for i in range(gen):
            nxt = pick(logits, cfg.vocab_size)
            picks.append(nxt)
            (logits, _), wall, cnt = _step_counts(
                MM, mesh, torch, lambda: serve.fn(params, caches,
                                                  prompt + i, nxt))
            walls.append(wall)
            counts.append(cnt)
            step_logits.append(_np32(logits))
            route.append(routes.take())
    rec.update(route_e=[e for e, _ in route], route_p=[p for _, p in route])
    rec.update(peak_bytes=_peak(torch, dev), step_s=walls,
               step_bytes=_mean_bytes(counts),
               picks=torch.stack(picks, 1).cpu().numpy(),
               step_logits=step_logits,
               caches=[_np32(x) for x in T.leaves(caches)])
    del params, caches
    _free(torch)
    return rec


def sm_long_part(torch, MM, mesh, cfg, seed, card, world, cuts, seq):
    """(b) on this rank: the long shape's serve step from seeded caches
    (this rank's slots of each leaf), decoding at ``SM_LONG_POS``; the
    logits and the written slots it holds."""
    from repro_torch import tree as T
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as Mdl
    dev = mesh.device
    shape = ST.ShapeSpec("long_500k", seq, 1, "long")
    serve = ST.build_serve_step(cfg, mesh, shape)
    pspecs, cspecs = serve.static["pspecs"], serve.static["cspecs"]
    cmeta = Mdl.cache_meta(cfg, 1, seq, True)
    pred = sm_predict(cfg, pspecs, cmeta, cspecs, mesh.shape, world)
    pred["card_bytes"] = card
    require(pred["ranks"] <= SM_FIT * card and pred["whole"]["peak"]
            <= SM_FIT * card, f"phase 18 (b) predicted not to fit: {pred}")
    rec = {"cfg": cfg.name, "dtype": cfg.dtype, "cuts": cuts,
           "mesh": dict(mesh.shape), "predicted": pred,
           "kv_group": serve.static["kv"].group.size}
    _reset_peak(torch, dev)
    t0 = time.perf_counter()
    params = seeded_tree(torch, Mdl.abstract_params(cfg), pspecs, mesh,
                         seed, cfg.dtype, dev)
    caches = seeded_tree(torch, cmeta, cspecs, mesh, seed, cfg.dtype, dev,
                         salt=1 << 20, std=SM_CACHE_STD)
    _sync(torch, dev)
    rec["init_s"] = time.perf_counter() - t0
    positions = sm_long_positions(seq)
    toks = sm_prompt(torch, cfg, 1, len(positions), 0).to(dev)
    logits, walls, counts = [], [], []
    for i, pos in enumerate(positions):
        (lg, _), wall, cnt = _step_counts(
            MM, mesh, torch, lambda: serve.fn(params, caches, pos,
                                              toks[:, i]))
        logits.append(_np32(lg))
        walls.append(wall)
        counts.append(cnt)
    layout = Mdl.decode_layout(cfg, seq, True)
    held = {}
    leaves = T.leaves(caches)
    gi_of = [gi for gi, g in enumerate(caches) for _ in T.leaves(g)]
    for j, x in enumerate(leaves):
        _, ring, _, clen = layout[gi_of[j]]
        n_loc = x.shape[3]
        lo = 0 if n_loc == clen else \
            serve.static["kv"].group.index * n_loc
        for pos in positions:
            slot = pos % clen if ring else pos
            if lo <= slot < lo + n_loc:
                held[(j, slot)] = _np32(x[:, :, :, slot - lo])
    rec.update(peak_bytes=_peak(torch, dev), step_s=walls,
               step_bytes=_mean_bytes(counts), step_logits=logits,
               written=held, positions=positions)
    del params, caches, leaves
    _free(torch)
    return rec


def sm_long_positions(seq):
    """``SM_LONG_POS`` at the full sequence; at a cut one, the same places
    relative to its halves."""
    if seq == 524288:
        return SM_LONG_POS
    h = seq // 2
    return (h - 2, h - 1, h, seq - 1)


def serve_mesh_rank(rank, world, store, seed, part, device="cuda",
                    smoke=False):
    """Phase 18 on one rank of a gloo group of CUDA tensors sharing the
    card, a serving mesh (no client axes): ``part`` "a" (the 4 ranks'
    starcoder2-3b, (b) and (c)) or "a_tp" (deepseek-v2-lite-16b's 2
    ranks)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.device import exact_float32
    from repro_torch.launch import mesh as MM

    exact_float32()
    dev = torch.device(device)
    shape = SM_MESH if part == "a" else SM_MESH_TP
    mesh = MM.init(world, rank, store=store, device=dev, backend="gloo",
                   shape=shape, client_axes=(), timeout_s=300)
    card = torch.cuda.get_device_properties(0).total_memory \
        if dev.type == "cuda" else float("inf")
    from repro_torch.kernels import LAUNCHES, reset_launches
    out = {"rank": rank}
    reset_launches()
    try:
        t0 = time.perf_counter()
        if part == "a_tp":
            name, _, batch = SM_A[1]
            out["a"] = {name: sm_greedy_part(
                torch, MM, mesh, sm_cfg(name, smoke, "float32"), batch,
                SM_PROMPT, SM_GEN, seed, card, world,
                {"batch": batch, "prompt": SM_PROMPT, "gen": SM_GEN})}
        else:
            name, _, batch = SM_A[0]
            out["a"] = {name: sm_greedy_part(
                torch, MM, mesh, sm_cfg(name, smoke, "float32"), batch,
                SM_PROMPT, SM_GEN, seed, card, world,
                {"batch": batch, "prompt": SM_PROMPT, "gen": SM_GEN})}
            cfg = sm_cfg(SM_LONG_ARCH, smoke, "float32")
            seq = 256 if smoke else 524288
            out["b"] = sm_long_part(
                torch, MM, mesh, cfg, seed, card, world,
                {"specs": f"first {SM_LONG_SPECS} of 31 (5 local, 1 "
                 "global)", "repeats": "1 of 2",
                 "batch": 1, "seq": seq, "caches": "seeded, no prefill",
                 "steps": len(sm_long_positions(seq))}, seq)
            cfg = sm_cfg(SM_C_ARCH, smoke, "bfloat16")
            out["c"] = sm_greedy_part(
                torch, MM, mesh, cfg, SM_C_BATCH, SM_C_PROMPT, SM_C_GEN,
                seed, card, world,
                {"repeats": f"{cfg.pattern_repeats} of 61",
                 "batch": SM_C_BATCH, "prompt": SM_C_PROMPT,
                 "gen": SM_C_GEN})
        out["rank_s"] = time.perf_counter() - t0
        out["launches"] = dict(LAUNCHES)
        return out
    finally:
        mesh.close()


def _assemble_rows(ranks, key, i=None):
    """Every row of ``key`` from the ranks (model index 0 of each row)."""
    import numpy as np
    parts = {}
    for rk in ranks:
        x = rk[key] if i is None else rk[key][i]
        parts.setdefault(rk["rows"][0], x)
    return np.concatenate([parts[r] for r in sorted(parts)])


def _beyond(got, want, tol, rows=None) -> tuple:
    """(largest |got - want| over the largest |want|, elements beyond
    ``tol`` of it, elements), over the rows (first dim) ``rows`` selects
    (every row by default; the scale is every row's)."""
    import numpy as np
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    d = np.abs(got - want)
    if rows is not None:
        d = d[rows]
    if not d.size:
        return 0.0, 0, 0
    return float(d.max() / scale), int((d > tol * scale).sum()), int(d.size)


def _reroutes(recs, i, whole, res):
    """The batch rows whose MoE routing in phase ``i`` (0 the prefill,
    then each step) differs between the split run and the whole, bool
    (b,): a token whose set of experts differs at some layer.  Such a
    flip needs the whole's k-th and (k+1)-th probabilities of the token
    to lie within twice the largest difference between the two runs'
    probabilities of the token (the rounding of the split's other order
    of operations, a bfloat16 near-tie); ``res["rerouted"]`` counts the
    rows and, third, the flips that no such near-tie explains."""
    import numpy as np
    we, wp = whole
    if we is None:
        return np.zeros(sum({rk["rows"][0]: rk["rows"][1]
                             for rk in recs}.values()), bool)
    se = _assemble_rows(recs, "route_e", i)
    sp = _assemble_rows(recs, "route_p", i)
    k = we.shape[-1]
    differ = (np.sort(se, -1) != np.sort(we, -1)).any(-1)
    top = -np.sort(-wp, -1)
    gap = top[..., k - 1] - top[..., k]
    noise = np.abs(sp - wp).max(-1)
    res["rerouted"][2] += int((differ & (gap > 2 * noise)).sum())
    moved = differ.reshape(len(differ), -1).any(1)
    res["rerouted"][0] += int(moved.sum())
    return moved


def sm_whole_greedy(torch, recs, cfg, batch, prompt, gen, seed, dev, tol):
    """The whole model on this process from the same seeds, teacher-forced
    with the split run's picks, against the ranks' records: the prefill
    and step logits, the greedy picks where the whole's top two lie more
    than ``tol`` of its largest logit apart, each rank's cache blocks."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.launch import mesh as MM
    from repro_torch.models import model as Mdl
    from repro_torch.models import params as PM
    from repro_torch.sharding import cache_rules
    _reset_peak(torch, dev)
    t0 = time.perf_counter()
    params = seeded_tree(torch, Mdl.abstract_params(cfg), None, None, seed,
                         cfg.dtype, dev)
    _sync(torch, dev)
    out = {"init_s": time.perf_counter() - t0}
    toks = sm_prompt(torch, cfg, batch, prompt, 0).to(dev)
    picks = torch.from_numpy(_assemble_rows(recs, "picks")).to(dev)
    res = {"prefill": [], "steps": [], "picks_differ": 0,
           "picks_clear": 0, "caches": [], "rerouted": [0, 0, 0]}
    walls = []
    routes = RouteLog()

    def held(got, want, moved):
        # rows the split run routed as the whole did are held to ``tol``;
        # a rerouted row's elements beyond it are counted apart
        res["rerouted"][1] += _beyond(got, want, tol, moved)[1]
        return _beyond(got, want, tol, ~moved)

    with torch.inference_mode(), routes:
        t0 = time.perf_counter()
        lg, pre = Mdl.prefill(cfg, params, toks)
        _sync(torch, dev)
        out["prefill_s"] = time.perf_counter() - t0
        moved = _reroutes(recs, 0, routes.take(), res)
        res["prefill"] = held(_assemble_rows(recs, "prefill_logits"),
                              _np32(lg), moved)
        caches = Mdl.seat_caches(PM.materialize(
            Mdl.cache_meta(cfg, batch, prompt + gen), 0, cfg.dtype, dev),
            pre)
        del pre
        for i in range(gen):
            want = _np32(lg)
            top2 = np.sort(want, axis=-1)[:, -2:]
            clear = ((top2[:, 1] - top2[:, 0]) > tol * np.abs(want).max()) \
                & ~moved
            res["picks_clear"] += int(clear.sum())
            res["picks_differ"] += int((want.argmax(-1) != picks[:, i].cpu()
                                        .numpy())[clear].sum())
            t0 = time.perf_counter()
            lg, _ = Mdl.decode_step(cfg, params, caches, prompt + i,
                                    picks[:, i], seq_len=prompt + gen)
            _sync(torch, dev)
            walls.append(time.perf_counter() - t0)
            moved = _reroutes(recs, i + 1, routes.take(), res)
            res["steps"].append(held(
                _assemble_rows(recs, "step_logits", i), _np32(lg), moved))
        cspecs = PM.pspecs(Mdl.cache_meta(cfg, batch, prompt + gen),
                           cache_rules("decode", False), recs[0]["mesh"])
        whole = T.leaves(caches)
        for j, (w, sp) in enumerate(zip(whole, T.leaves(cspecs))):
            worst = [0.0, 0, 0]
            for rk in recs:
                view = MM.ClientMesh(shape=rk["mesh"], client_axes=(),
                                     rank=rk["rank"], device=dev)
                blk = PM.shard_block(sp, tuple(w.shape), view)
                e = _beyond(rk["caches"][j], _np32(w[blk]), tol)
                worst = [max(worst[0], e[0]), worst[1] + e[1],
                         worst[2] + e[2]]
            res["caches"].append(worst)
    out.update(peak_bytes=_peak(torch, dev), step_s=walls, vs_split=res)
    del params, caches
    _free(torch)
    return out


def sm_whole_long(torch, recs, cfg, seed, dev, seq, tol):
    """(b)'s whole step on this process from the same seeded params and
    caches: the logits at each position and the written slots against
    the ranks'."""
    from repro_torch import tree as T
    from repro_torch.launch import mesh as MM
    from repro_torch.models import model as Mdl
    from repro_torch.models import params as PM
    from repro_torch.sharding import cache_rules
    _reset_peak(torch, dev)
    params = seeded_tree(torch, Mdl.abstract_params(cfg), None, None, seed,
                         cfg.dtype, dev)
    cmeta = Mdl.cache_meta(cfg, 1, seq, True)
    caches = seeded_tree(torch, cmeta, None, None, seed, cfg.dtype, dev,
                         salt=1 << 20, std=SM_CACHE_STD)
    positions = sm_long_positions(seq)
    toks = sm_prompt(torch, cfg, 1, len(positions), 0).to(dev)
    res = {"steps": [], "written": [0.0, 0, 0]}
    walls = []
    with torch.inference_mode():
        for i, pos in enumerate(positions):
            t0 = time.perf_counter()
            lg, _ = Mdl.decode_step(cfg, params, caches, pos, toks[:, i],
                                    seq_len=seq, long_mode=True)
            _sync(torch, dev)
            walls.append(time.perf_counter() - t0)
            res["steps"].append(_beyond(recs[0]["step_logits"][i],
                                        _np32(lg), tol))
        leaves = T.leaves(caches)
        for rk in recs:
            view = MM.ClientMesh(shape=rk["mesh"], client_axes=(),
                                 rank=rk["rank"], device=dev)
            specs = T.leaves(PM.pspecs(cmeta, cache_rules("long", False),
                                       rk["mesh"]))
            for (j, slot), x in rk["written"].items():
                blk = PM.shard_block(specs[j], tuple(leaves[j].shape), view)
                w = leaves[j][:, :, :, slot][blk[:3] + blk[4:]]
                e = _beyond(x, _np32(w), tol)
                res["written"] = [max(res["written"][0], e[0]),
                                  res["written"][1] + e[1],
                                  res["written"][2] + e[2]]
    out = {"peak_bytes": _peak(torch, dev), "step_s": walls,
           "vs_split": res}
    del params, caches, leaves
    _free(torch)
    return out


def _sm_failures(label, res, tol) -> list:
    """The checks of a part's comparison: logits (of the rows routed as
    the whole routed them) and caches, no element beyond the tolerance;
    every routing flip explained by a near-tie; greedy picks."""
    out = []
    for what in ("prefill", "steps", "caches", "written"):
        items = res.get(what)
        if not items:
            continue
        items = [items] if isinstance(items[0], (int, float)) else items
        n_bad = sum(i[1] for i in items)
        n = sum(i[2] for i in items)
        if n_bad:
            out.append(f"{label} {what}: {n_bad} of {n} elements beyond "
                       f"{tol} of the whole's largest")
    if res.get("rerouted", [0, 0, 0])[2]:
        out.append(f"{label}: {res['rerouted'][2]} tokens routed to other "
                   f"experts than the whole's where no near-tie explains it")
    if res.get("picks_differ"):
        out.append(f"{label}: {res['picks_differ']} greedy picks differ "
                   f"where the whole's top two lie apart")
    return out


def phase_serve_mesh(torch, seed, device="cuda", smoke=False):
    """Phase 18: gloo ranks of CUDA tensors sharing the card run the
    sharded prefill and serve steps (``serve_mesh_rank``), then this
    process runs each whole model from the same seeds and compares."""
    import shutil
    import tempfile
    from repro_torch.launch import mesh as MM

    log("phase 18: sharded serving, gloo ranks on the card")
    t_phase = time.perf_counter()
    dev = torch.device(device)
    out = {}
    for part, world in (("a", SM_WORLD), ("a_tp", 2)):
        tmp = tempfile.mkdtemp()
        t0 = time.perf_counter()
        try:
            out[part] = MM.run_ranks(serve_mesh_rank, world,
                                     store=os.path.join(tmp, "store"),
                                     args=(seed, part, device, smoke),
                                     timeout_s=600)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(f"phase 18 spawn {part}: {world} ranks in "
            f"{time.perf_counter() - t0:.1f} s")
    _free(torch)
    failures, summary = [], {}
    for (name, _, batch), part in zip(SM_A, ("a", "a_tp")):
        recs = [rk["a"][name] | {"rank": rk["rank"]} for rk in out[part]]
        cfg = sm_cfg(name, smoke, "float32")
        whole = sm_whole_greedy(torch, recs, cfg, batch, SM_PROMPT, SM_GEN,
                                seed, dev, SM_TOL)
        failures += _sm_failures(f"(a) {name}", whole["vs_split"], SM_TOL)
        summary[f"a_{name}"] = _sm_summary(recs, whole)
    recs = [rk["b"] | {"rank": rk["rank"]} for rk in out["a"]]
    seq = recs[0]["cuts"]["seq"]
    whole = sm_whole_long(torch, recs, sm_cfg(SM_LONG_ARCH, smoke,
                                              "float32"), seed, dev, seq,
                          SM_TOL)
    failures += _sm_failures("(b)", whole["vs_split"], SM_TOL)
    summary["b"] = _sm_summary(recs, whole)
    recs = [rk["c"] | {"rank": rk["rank"]} for rk in out["a"]]
    require(all(r["two_d"] for r in recs), "(c) ran without the 2-D form")
    whole = sm_whole_greedy(torch, recs, sm_cfg(SM_C_ARCH, smoke,
                                                "bfloat16"),
                            SM_C_BATCH, SM_C_PROMPT, SM_C_GEN, seed, dev,
                            SM_TOL_BF16)
    failures += _sm_failures("(c)", whole["vs_split"], SM_TOL_BF16)
    summary["c"] = _sm_summary(recs, whole)
    launches = collections.Counter()
    for ranks in out.values():
        for rk in ranks:
            launches.update(rk["launches"])
    summary["launches_per_rank_max"] = {
        k: max(rk["launches"].get(k, 0) for ranks in out.values()
               for rk in ranks) for k in launches}
    wall = time.perf_counter() - t_phase
    dump = ROOT / "chiprun_out" / "phase18.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(json.dumps(summary, indent=1, default=str))
    log(f"phase 18 ({smi_line() if dev.type == 'cuda' else 'cpu'}) in "
        f"{wall:.1f} s: " + json.dumps(summary, default=str))
    require(not failures, "; ".join(failures))
    return {"summary": summary, "wall_s": wall,
            "launches": summary["launches_per_rank_max"]}


def _sm_summary(recs, whole) -> dict:
    """What phase 18 prints of a part: cuts, predicted and measured peaks
    per rank, walls per step, bytes per group and step, the comparison."""
    r0 = recs[0]
    return {
        "cfg": r0["cfg"], "dtype": r0["dtype"], "mesh": r0["mesh"],
        "cuts": r0["cuts"], "predicted": r0["predicted"],
        "peak_bytes": [r["peak_bytes"] for r in recs],
        "init_s": [r["init_s"] for r in recs],
        "prefill_s": r0.get("prefill_s"), "step_s": r0["step_s"],
        "step_bytes": r0["step_bytes"],
        "prefill_bytes": r0.get("prefill_bytes"),
        "whole": {k: whole[k] for k in ("peak_bytes", "step_s")
                  if k in whole},
        "vs_whole": whole["vs_split"]}


# ---------------------------------------------------------------------------
# Phase 19: the dry run's prediction, and rank 0's real step held to it
# ---------------------------------------------------------------------------

#: (a) the combos ``launch/dryrun.py`` predicts on ``DRY_MESH``, each in a
#: process of its own, all started together (``--all`` takes longer than
#: the phase may)
DRY_COMBOS = (("starcoder2-3b", "train_4k"), ("starcoder2-3b", "decode_32k"),
              ("mamba2-1-3b", "train_4k"),
              ("deepseek-v2-lite-16b", "decode_32k"),
              ("gemma3-27b", "long_500k"))
DRY_MESH = "pod1"
#: (b) a combo's rank 0 runs on the card where its predicted peak is at
#: most this
DRY_FIT_BYTES = 72 * 2 ** 30
#: its ``max_memory_allocated`` within the larger of these of the
#: predicted peak
DRY_PEAK_SHARE, DRY_PEAK_SLACK = 0.10, 2 * 2 ** 30
#: the kernels whose first inputs a train combo's step replays
DRY_KERNELS = ("absmax", "count_ge", "ssm_apply_ef")
#: how long (b) waits for a prediction
DRY_WAIT_S = 400


def _dry_name(arch, shape):
    return f"{arch}__{shape}__{DRY_MESH}"


def dry_card_step(torch, mesh, arch, shape_name, pred, seed, dev):
    """Rank 0's real step of a combo on the card, the fake world's
    collectives in stand-in mode with bounded sums, under the dry run's
    counters: its weights drawn by block from ``seed`` (``seeded_tree``),
    a train step's tokens in rank 0's vocabulary shard
    (``_rank_vocab_tokens``), its peak, FLOPs, kernel launches and
    collectives against the prediction ``pred``; a decode step again
    without counters for its wall (a train step's wall is the counted
    run's: ``wall_run``); a train step's kernels bitwise their plain
    versions on its first inputs at its largest leaf, which must be
    finite, as its loss and state must.  Returns the record and its
    failures."""
    from repro_torch import roofline as RL
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as Mdl
    cfg = get_config(arch)
    shape = ST.SHAPES[shape_name]
    t0 = time.perf_counter()
    bundle = D.build(cfg, shape, mesh)
    params = seeded_tree(torch, Mdl.abstract_params(cfg),
                         bundle.static["pspecs"], mesh, seed, cfg.dtype, dev)
    torch.manual_seed(seed)
    args = bundle.args(params, dev)
    del params
    train = shape.kind == "train"
    if train:
        args[1]["tokens"] = _rank_vocab_tokens(mesh, cfg, args[1]["tokens"])
    _free(torch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    cap = Capture(host=True) if train else None
    if cap is not None:
        # the first calls at the largest leaf this rank holds
        entry = _lm_entry_points()
        n = max(t.numel() for t in D._tensors(args[0].W))
        for k in DRY_KERNELS:
            cap.wrap(*entry[k], k, LM_KERNELS[k][2], (n,),
                     len(LM_PASSES.get(k, ("",))))
    try:
        with MM.stand_in(bounded=True):
            res = D.count_step(bundle.fn, args, device_type="cuda")
        torch.cuda.synchronize()
    finally:
        if cap is not None:
            cap.restore()
    peak = torch.cuda.max_memory_allocated()
    out = res.pop("out")
    # a decode step's logits, a train step's loss and state: finite
    finite = bool(torch.isfinite(
        (out[1]["loss"] if train else out[0]).float()).all())
    state_finite = all(bool(torch.isfinite(t.float()).all())
                        for t in D._tensors(out) if t.is_floating_point())
    del out
    _free(torch)
    wall = res["t_run_s"]
    if not train:
        # a decode step's counted run is the counters' host time; a train
        # step's is the card's (mamba2 on an H100 80GB: 25.6 s counted,
        # 21.6 s without), and a second one would not fit the phase
        with MM.stand_in(bounded=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = bundle.fn(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del out
    del args
    _free(torch)
    rec = {"predicted_peak_bytes": pred["memory"]["peak_per_device_bytes"],
           "peak_bytes": peak, "tracked_peak_bytes": res["peak_bytes"],
           "flops": res["flops"], "predicted_flops": pred["flops"],
           "launches": res["launches"],
           "launches_predicted": pred["launches_predicted"],
           "collective_bytes": res["collectives"]["total"],
           "init_s": init_s, "counted_step_s": res["t_run_s"],
           "wall_s": wall, "wall_run": "counted" if train else "uncounted",
           "finite": finite, "state_finite": state_finite,
           "flops_share_of_peak": res["flops"] / wall
           / RL.PEAK_FLOPS[cfg.dtype]}
    if cap is not None:
        captured = {k: [c for calls in cap.args[k].values() for c in calls]
                    for k in cap.args}
        require(sorted(captured) == sorted(DRY_KERNELS),
                f"{arch} {shape_name}: captured {sorted(captured)}")
        rec["kernel_inputs_finite"] = {
            k: all(bool(torch.isfinite(x.float()).all())
                   for args_, _ in calls for x in args_
                   if isinstance(x, torch.Tensor) and x.is_floating_point())
            for k, calls in captured.items()}
        rec["kernels"] = _replay_tensor_kernels(torch, captured, True,
                                                False)
        del captured
    tol = max(DRY_PEAK_SHARE * rec["predicted_peak_bytes"], DRY_PEAK_SLACK)
    failures = [f"{arch} {shape_name}: {what}" for what, bad in (
        (f"peak {peak} off the prediction "
         f"{rec['predicted_peak_bytes']} by more than {tol:.0f}",
         abs(peak - rec["predicted_peak_bytes"]) > tol),
        (f"FLOPs {res['flops']} != {pred['flops']}",
         res["flops"] != pred["flops"]),
        (f"launches {res['launches']} != {pred['launches_predicted']}",
         res["launches"] != pred["launches_predicted"]),
        ("collectives differ from the prediction's",
         res["collectives"] != pred["collectives"]),
        ("a kernel differs from its plain version", any(
            r["max_abs_err"] != 0 for r in rec.get("kernels", {}).values())),
        ("a non-finite loss or logits", not finite),
        ("a non-finite state", train and not state_finite),
        (f"non-finite kernel inputs {rec.get('kernel_inputs_finite')}",
         not all(rec.get("kernel_inputs_finite", {}).values()))) if bad]
    if train:
        require(rec["launches"], f"{arch} {shape_name}: no kernel launched")
    return rec, failures


def _rank_vocab_tokens(mesh, cfg, tokens):
    """``tokens`` folded into rank 0's vocabulary shard (the model
    group's first chunk; the whole vocabulary with no model axis).  Under
    the stand-in every rank holds rank 0's shard, so a token outside it
    embeds to zeros, and the RMS norm of a zero row scales its gradient
    by 1/sqrt(eps) at every layer: mamba2's 48 overflow."""
    lo, hi = mesh.model.chunk(cfg.vocab_size) if mesh.model is not None \
        else (0, cfg.vocab_size)
    return lo + tokens % (hi - lo)


def dryrun_card_rank(rank, world, store, seed, out_dir, combos):
    """(b) in a process of its own: rank 0 of the fake ``DRY_MESH`` world
    on the card; each combo whose prediction has appeared under
    ``out_dir`` (as they appear) and whose predicted peak fits
    ``DRY_FIT_BYTES`` through ``dry_card_step``; the others listed with
    their predictions."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.device import exact_float32
    from repro_torch.launch import dryrun as D
    torch.backends.cudnn.deterministic = True
    exact_float32()
    dev = torch.device("cuda", 0)
    mesh = D.world(DRY_MESH, dev)
    pending, out, failures = list(combos), {}, []
    deadline = time.perf_counter() + DRY_WAIT_S
    while pending:
        ready = [c for c in pending
                 if (Path(out_dir) / f"{_dry_name(*c)}.json").exists()]
        if not ready:
            require(time.perf_counter() < deadline,
                    f"no prediction for {pending} in {DRY_WAIT_S} s")
            time.sleep(0.2)
            continue
        arch, shape = ready[0]
        pending.remove(ready[0])
        pred = json.loads((Path(out_dir) / f"{_dry_name(arch, shape)}"
                           ".json").read_text())
        name = _dry_name(arch, shape)
        if pred["status"] != "ok":
            out[name] = {"ran": False, "status": pred["status"]}
            continue
        peak = pred["memory"]["peak_per_device_bytes"]
        if peak > DRY_FIT_BYTES:
            out[name] = {"ran": False, "predicted_peak_bytes": peak}
            continue
        rec, bad = dry_card_step(torch, mesh, arch, shape, pred, seed, dev)
        out[name] = {"ran": True, **rec}
        failures += bad
    return {"combos": out, "failures": failures}


def phase_dryrun(torch, seed):
    """Phase 19: (a) the dry run of ``DRY_COMBOS`` on ``DRY_MESH``, each
    combo in a process of its own, all started together; every record
    must be ok, or skip with the JAX package's reason.  (b) beside them,
    as the predictions appear, rank 0's real step of each combo that fits
    (``dryrun_card_rank``) held to its prediction."""
    import shutil
    import tempfile
    import threading
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import steps as ST
    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {c: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", c[0],
         "--shape", c[1], "--mesh", DRY_MESH, "--out", str(out_dir)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for c in DRY_COMBOS}
    card, errors = {}, []

    def run_card():
        tmp = tempfile.mkdtemp()
        try:
            card["res"] = MM.run_ranks(
                dryrun_card_rank, 1, store=os.path.join(tmp, "store"),
                args=(seed, str(out_dir), DRY_COMBOS),
                timeout_s=DRY_WAIT_S + 200)[0]
        except BaseException as e:      # re-raised below
            errors.append(e)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    thread = threading.Thread(target=run_card)
    thread.start()
    records, failures = {}, []
    try:
        for c, proc in procs.items():
            text, _ = proc.communicate(timeout=DRY_WAIT_S)
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("[dryrun]")]
            log("phase 19 (a) " + (lines[-1] if lines else
                                   f"{c}: no record line:\n{text[-2000:]}"))
            path = out_dir / f"{_dry_name(*c)}.json"
            rec = json.loads(path.read_text()) if path.exists() else \
                {"status": "missing"}
            records[_dry_name(*c)] = rec
            reason = ST.skip_reason(get_config(c[0]), ST.SHAPES[c[1]])
            if not (rec["status"] == "ok" or (rec["status"] == "skip"
                                               and rec["reason"] == reason)):
                failures.append(f"{c}: {rec['status']} "
                                f"{rec.get('error', '')[:300]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        thread.join()
    t_a = max(r.get("t_build_s", 0) + r.get("t_run_s", 0)
              for r in records.values())
    if errors:
        raise errors[0]
    res = card["res"]
    failures += res["failures"]
    ran = [n for n, r in res["combos"].items() if r["ran"]]
    kinds = {records[n]["shape"] for n in ran}
    require(any(ST.SHAPES[k].kind == "train" for k in kinds)
            and any(ST.SHAPES[k].kind in ("decode", "long") for k in kinds),
            f"phase 19 (b) ran no train or no decode combo: {ran}")
    summary = {}
    for name, rec in records.items():
        row = {"status": rec["status"]}
        if rec["status"] == "ok":
            roof = rec["roofline"]
            row.update(
                flops=rec["flops"],
                predicted_peak_bytes=rec["memory"]["peak_per_device_bytes"],
                argument_bytes=rec["memory"]["argument_bytes"],
                collectives={k: v["bytes"] for k, v in
                             rec["collectives"]["by_kind"].items()},
                launches_predicted=rec["launches_predicted"],
                t_compute=roof["t_compute"], t_memory=roof["t_memory"],
                t_collective=roof["t_collective"],
                bottleneck=roof["bottleneck"],
                trace_s=rec["t_build_s"] + rec["t_run_s"])
        row["card"] = res["combos"].get(name)
        summary[name] = row
        log(f"phase 19 {name}: {json.dumps(row, default=str)}")
    wall = time.perf_counter() - t_phase
    (ROOT / "chiprun_out" / "phase19.json").write_text(
        json.dumps(summary, indent=1, default=str))
    log(f"phase 19 ({smi_line()}) in {wall:.1f} s (the slowest trace "
        f"{t_a:.1f} s)")
    require(not failures, "; ".join(failures))
    launches = collections.Counter()
    for r in res["combos"].values():
        if r["ran"]:
            launches.update(r["launches"])
    return {"summary": summary, "wall_s": wall, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 20: every compressor on split leaves (gloo ranks on the card)
# ---------------------------------------------------------------------------

#: (a) the tp plan on a (data 2, model 2) mesh: starcoder2-3b at phase 16's
#: width and cut (float32, sequence 128, 2 sequences a client), one round
#: with error feedback of each baseline and of ``fairness_top``, each
#: against the whole-leaf round of the same 2 clients (``p20_tp_case``).
P20_TP = (("fedadam", {}), ("fedsgd", {}), ("efficient_adam", {}),
          ("onebit_adam", {}), ("fairness_top", {}))
#: (b) the virtual/fsdp plan at phase 17 (a)'s cut, against the
#: whole-leaf scan round rank 0 runs after the split ranks; FedAdam-Top
#: with the global mask scope (one tau over the whole model: the path of
#: kernel rows 6-8) here, where the fold is local, not on the tp plan,
#: whose dense fold would gather 5.9 GB a rank through gloo.
P20_FSDP = (("fedadam", {}), ("efficient_adam", {}),
            ("fedadam_top", {"mask_scope": "global"}))
#: One local epoch a round (phases 16-17 take the builder's 2): the split
#: rounds' and references' collectives and walls are what phase 20 pays.
P20_EPOCHS = 1
#: Bytes a client and round at the 2-repeat cut (PERF.md §2; FedSGD ships
#: FedAdam's W plane alone, a third of its bytes): the bills must be these.
P20_BILL_BYTES = {"fedadam": 5_926_735_872, "fedsgd": 1_975_578_624,
                  "efficient_adam": 495_824_956, "onebit_adam": 63_666_240,
                  "fairness_top": 375_854_948}
#: The repeats tried, most first: a case runs at the first whose peaks,
#: predicted by the dry run (``launch/dryrun.run_one`` on fake tensors:
#: 4 split ranks, and the whole-leaf round's 2 ranks (tp) or 1 (fsdp)),
#: fit ``P20_FIT`` of the card; widths are never cut.
P20_REPEATS = (2, 1)
P20_FIT = 0.9
#: A quantizer's split round against the whole-leaf one: a code may move
#: one step (or a 1-bit sign flip at an input within ulps of 0) where the
#: split products' other summation order moves its input by ulps, at no
#: more than this share of a leaf's elements besides ``TENSOR_SHARE``
#: (``_quant_vs_whole``).
P20_QUANT_SHARE = 5e-4
#: Efficient-Adam's residual against the whole-leaf one: a whole number
#: of its block's steps (a moved code) to within this share of a step
#: (the inputs' own difference), except at no more than the share of
#: W's (an input in Adam's eps region, where a gradient's last bits move
#: the update by up to a step: one element 0.31 of a step off on the
#: H100), as ``tests/test_torch_tensor.py``'s against JAX's.
P20_STEP_SLACK = 0.1
#: The cases whose round, run again, captures the per-leaf kernels'
#: first inputs (at the largest leaf's shard) for a replay against their
#: plain versions, and those kernels.
P20_CAPTURE = {"fairness_top": TENSOR_KERNELS,
               "fedadam_top": ("absmax", "count_ge", "apply_mask")}
#: How long a rank waits for a case's prediction.
P20_WAIT_S = 300


def p20_cases():
    """``(key, plan, algorithm, build keywords)`` of every case, in the
    order the ranks run them and the predictor predicts them."""
    return [(f"{plan}_{a}" + ("_global" if kw.get("mask_scope") ==
                              "global" else ""), plan, a,
             dict(kw, local_epochs=P20_EPOCHS))
            for plan, cases in (("tp", P20_TP), ("fsdp", P20_FSDP))
            for a, kw in cases]


def p20_predict(rank, world, store, out_dir, smoke=False):
    """In a process of its own: each case's dry run (``run_one`` on fake
    tensors, rank 0 of the fake (2, 2) world, then of the whole-leaf
    reference's mesh) at the most of ``P20_REPEATS`` that fits, written
    to ``out_dir/<key>.json`` as it is made: the repeats, the cuts made,
    each side's predicted peak, FLOPs, collectives and launches."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses as dc
    import torch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as ST
    # the references' mesh: the clients' scan round on one rank
    D.MESHES.update(p20_one={"data": 1, "model": 1})
    card = torch.cuda.get_device_properties(0).total_memory \
        if torch.cuda.is_available() else float("inf")
    seq = 32 if smoke else TENSOR_SEQ
    keep = ("memory", "flops", "collectives", "launches_predicted",
            "t_build_s", "t_run_s", "status", "error")
    for key, plan, alg, kw in p20_cases():
        tp = plan == "tp"
        shape = dc.replace(ST.SHAPES["train_4k"], seq_len=seq,
                           global_batch=(TENSOR_PER_CLIENT * 2 if tp
                                         else FSDP_GLOBAL_BATCH))
        build = dict(kw, algorithm=alg, error_feedback=True)
        if not tp:
            build["plan"] = fsdp_plan()
        # the whole-leaf reference: the clients' scan round on one rank
        ref = dict(build, plan=fsdp_plan(), aggregate="dense")
        ref_shape = dc.replace(shape, global_batch=TENSOR_PER_CLIENT) \
            if tp else shape
        cuts, rec = [], None
        for repeats in ((2,) if smoke else P20_REPEATS):
            cfg = _tensor_cfg(TENSOR_ARCH, repeats, "float32", smoke)
            split = D.run_one(TENSOR_ARCH, "train_4k", "test", cfg=cfg,
                              shape=shape, **build)
            whole = D.run_one(TENSOR_ARCH, "train_4k", "p20_one", cfg=cfg,
                              shape=ref_shape, **ref)
            peak = lambda r: r["memory"]["peak_per_device_bytes"] \
                if r["status"] == "ok" else float("inf")
            need = max(FSDP_WORLD * peak(split), peak(whole))
            rec = {"repeats": repeats, "card_bytes": card,
                   "needed_bytes": need, "fits": need <= P20_FIT * card,
                   "split": {k: split.get(k) for k in keep},
                   "whole": {k: whole.get(k) for k in keep}}
            if rec["fits"]:
                break
            cuts.append(f"{repeats} repeats: {need} bytes > {P20_FIT} of "
                        f"{card}")
        rec["cuts"] = cuts
        tmp = Path(out_dir) / f".{key}.json"
        tmp.write_text(json.dumps(rec, default=str))
        os.replace(tmp, Path(out_dir) / f"{key}.json")
    return True


def _p20_prediction(out_dir, key):
    path = Path(out_dir) / f"{key}.json"
    t0 = time.perf_counter()
    while not path.exists():
        require(time.perf_counter() - t0 < P20_WAIT_S,
                f"phase 20: no prediction of {key} in {P20_WAIT_S} s")
        time.sleep(0.5)
    return json.loads(path.read_text())


def _code_steps(torch, a, b, block=1024):
    """``(a - b) / step`` per element of a ``(C, ...)`` stack of client
    residuals (float64), each client's leaf on its quantizer blocks, the
    step of a block twice its largest ``|b|`` (the residual of a rounded
    code lies within half a step)."""
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    n = a.shape[1]
    pad = lambda t: torch.nn.functional.pad(t, (0, (-n) % block)) \
        .reshape(len(t), -1, block)
    ab, bb = pad(a), pad(b)
    step = 2 * bb.abs().amax(dim=2, keepdim=True)
    return ((ab - bb) / step.clamp_min(1e-30)).reshape(len(a), -1)[:, :n]


def _quant_vs_whole(torch, alg, split, whole, what):
    """A quantizer's split state against the whole-leaf one, leaf by
    leaf: W, M, V beyond ``TENSOR_TOL`` of the leaf's largest element at
    no more than ``P20_QUANT_SHARE + TENSOR_SHARE`` of its elements (a
    code moved one step, a sign flipped at a tie).  Efficient-Adam's
    residual differs by a whole number of its block's steps, at most
    one, to within ``P20_STEP_SLACK`` of a step at all but that share
    of its elements; 1-bit
    Adam's is within ``TENSOR_TOL`` of its largest except at no more
    elements than C times M's beyond (a flipped sign moves M, the
    clients' mean sign carrier), and within one flip (twice its largest)
    there.  Returns the counts, the largest errors and the failures."""
    dev = torch.device("cuda") if torch.cuda.is_available() else \
        torch.device("cpu")
    out = {"beyond": {}, "max_rel_err": {}, "failures": []}
    share = P20_QUANT_SHARE + TENSOR_SHARE
    for part in [p for p in ("W", "M", "V") if split[p]] + ["err"]:
        beyond, rel = [], []
        for i, (a, b) in enumerate(zip(split[part], whole[part])):
            a, b = a.to(dev).double(), b.to(dev).double()
            top = float(b.abs().max().clamp_min(1e-30))
            d = (a - b).abs() / top
            rel.append(float(d.max()))
            n = int((d > TENSOR_TOL).sum())
            beyond.append(n)
            if part != "err":
                if n > share * b.numel():
                    out["failures"].append(f"{what}: {part}[{i}] beyond "
                                           f"{TENSOR_TOL} at {n} of "
                                           f"{b.numel()}")
            elif alg == "onebit_adam":
                flips = out["beyond"]["M"][i]
                if n > len(b) * flips or rel[-1] > 2.02:
                    out["failures"].append(
                        f"{what}: err[{i}] beyond {TENSOR_TOL} at {n} "
                        f"with {flips} flips, {rel[-1]} of its largest")
            else:
                r = _code_steps(torch, a, b)
                off = int(((r - r.round()).abs() > P20_STEP_SLACK).sum())
                most = float(r.abs().max())
                out.setdefault("off_steps", []).append(off)
                if off > share * b.numel() or most > 1 + P20_STEP_SLACK:
                    out["failures"].append(
                        f"{what}: err[{i}] {off} of {b.numel()} off a "
                        f"whole number of steps, {most} steps at most")
        out["beyond"][part], out["max_rel_err"][part] = beyond, rel
    return out


def _p20_parts(alg):
    """The server state's parts a round of ``alg`` changes (the others
    stay the zeros they start as, and are not gathered)."""
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.fed import FedConfig
    return {"w_only": ("W",), "precond_m": ("W", "M")}.get(
        make_compressor(FedConfig(algorithm=alg)).server_update,
        ("W", "M", "V"))


def _p20_compare(torch, alg, split, whole, drops, what):
    if alg in ("efficient_adam", "onebit_adam"):
        return _quant_vs_whole(torch, alg, split, whole, what)
    return _tensor_vs_whole(torch, split, whole, drops, what)


def _p20_bill(alg, clients):
    """The bill of a round: ``clients`` x the client's bytes in bits, as
    the float32 scalar the round reports (None: no fixed number)."""
    import torch
    if alg not in P20_BILL_BYTES:
        return None
    return float(torch.tensor(8.0 * clients * P20_BILL_BYTES[alg],
                              dtype=torch.float32))


def _p20_check(rec, pred, card):
    """The launches against the prediction's, and the peak at most
    ``DRY_PEAK_SHARE`` or ``DRY_PEAK_SLACK`` above it (on the card)."""
    rec["predicted_peak_bytes"] = pred["memory"]["peak_per_device_bytes"]
    rec["launches_predicted"] = pred["launches_predicted"]
    if not card:
        return
    got = {k: v for k, v in rec["launches"].items() if v}
    require(got == pred["launches_predicted"],
            f"phase 20 {rec['case']}: launches {got} against the "
            f"prediction {pred['launches_predicted']}")
    p = rec["predicted_peak_bytes"]
    require(rec["peak_bytes"] - p <= max(DRY_PEAK_SHARE * p,
                                         DRY_PEAK_SLACK),
            f"phase 20 {rec['case']}: peak {rec['peak_bytes']} above "
            f"the predicted {p}")


def p20_tp_case(torch, dist, mesh, cfg, alg, kw, pred, params, tokens,
                seq, key, fixed_bill, seed):
    """(a): one split round of ``alg`` on the (data 2, model 2) mesh, then
    on global rank 0 the whole-leaf round of the same clients and the
    comparison; the kernels' first inputs at the largest leaf's shard
    replayed for ``P20_CAPTURE``.  The reference is the clients' scan
    round (``fsdp_whole_round`` on one rank): the spatial round's dense
    fold is bitwise its fold in client order, and what the split round's
    per-shard bitmap transport drops is counted; a whole-leaf spatial
    round would gather two whole models through gloo's host staging (10
    s a case, chip run 1 of PR 26)."""
    dev, card = mesh.device, mesh.device.type == "cuda"
    drops = []
    rec, split, captured = tensor_round(
        torch, mesh, cfg, alg, params, tokens, seq=seq,
        per_client=TENSOR_PER_CLIENT, drops=drops,
        capture=0 if alg in P20_CAPTURE else None, parts=_p20_parts(alg),
        **kw)
    rec["case"] = key
    _p20_check(rec, pred["split"], card)
    drops_all = _world_drops(torch, dist, drops, mesh.world_size) \
        if drops else []
    dist.barrier()
    if mesh.rank == 0:
        wrec, whole = fsdp_whole_round(
            torch, cfg, seed, tokens, dev, algorithm=alg,
            **{k: v for k, v in kw.items() if k != "aggregate"})
        wrec["case"] = key + "_whole"
        _p20_check(wrec, pred["whole"], card)
        rec["whole_leaf"] = wrec
        _p20_whole_checks(rec, wrec, alg, mesh.n_clients, fixed_bill, key)
        rec["vs_whole_leaf"] = _p20_compare(torch, alg, split, whole,
                                            drops_all,
                                            f"{key} split vs whole")
        del whole
    dist.barrier()
    if captured is not None:
        rec["kernels"] = _replay_tensor_kernels(torch, captured, card, False)
        if alg == "fairness_top":
            rec["kernels"].update(_replay_bf16_streams(torch, captured,
                                                       card))
    del split, captured
    _free(torch)
    return rec


def _replay_bf16_streams(torch, captured, on_card):
    """``fairness_top``'s fused apply as a bfloat16 model runs it: the
    captured first call's dw, dm and dv cast to bfloat16 beside its
    float32 score and tau, the kernel against its plain version,
    bitwise."""
    args, kw = captured["ssm_apply_ef"][0]
    if on_card:
        args = _on_card(args)
    tau, dw, dm, dv, score = args
    require(score is not None and score.dtype == torch.float32,
            "phase 20: fairness_top's fused apply took no float32 score")
    bf = [x.to(torch.bfloat16) for x in (dw, dm, dv)]
    fk, fp = lm_kernel(torch, "ssm_apply_ef", (tau, *bf, score), kw)[:2]
    err = max(max_abs_err(torch, x, y) for x, y in zip(fk(), fp()))
    return {"ssm_apply_ef/bfloat16_streams": {
        "elements": dw.numel(), "max_abs_err": err,
        "shape": list(dw.shape)}}


def _p20_whole_checks(rec, wrec, alg, clients, fixed_bill, key):
    """The split round's bill equal to the whole-leaf round's and (at the
    2-repeat cut) PERF.md §2's, its losses within 1e-5 of it."""
    bill = _p20_bill(alg, clients)
    require(wrec["uplink_bits"] == rec["uplink_bits"] and (
        bill is None or not fixed_bill or rec["uplink_bits"] == bill),
        f"{key}: bill {rec['uplink_bits']} against the whole-leaf "
        f"round's {wrec['uplink_bits']} and {bill}")
    require(max(abs(a - b) for a, b in zip(rec["loss"], wrec["loss"]))
            <= 1e-5 * max(abs(b) for b in wrec["loss"]),
            f"{key}: losses {rec['loss']} against {wrec['loss']}")


def p20_fsdp_case(torch, dist, mesh, cfg, alg, kw, pred, seed, seq, key,
                  fixed_bill):
    """(b): one virtual/fsdp round of ``alg``, then on global rank 0 the
    whole-leaf scan round and the comparison; the kernels' first inputs
    replayed for ``P20_CAPTURE``."""
    from repro_torch.launch import train
    dev, card = mesh.device, mesh.device.type == "cuda"
    tokens = train.build_client_batches(
        cfg, FSDP_N_VIRTUAL, FSDP_GLOBAL_BATCH, seq, seed=seed,
        device="cpu")["tokens"]
    rec, split, captured = fsdp_round(
        torch, mesh, cfg, seed, tokens, algorithm=alg,
        parts=_p20_parts(alg), capture=0 if alg in P20_CAPTURE else None,
        kernels=P20_CAPTURE.get(alg, ()), **kw)
    rec["case"] = key
    _p20_check(rec, pred["split"], card)
    dist.barrier()
    if mesh.rank == 0:
        wrec, whole = fsdp_whole_round(torch, cfg, seed, tokens, dev,
                                       algorithm=alg, **kw)
        wrec["case"] = key + "_whole"
        _p20_check(wrec, pred["whole"], card)
        rec["whole_leaf"] = wrec
        _p20_whole_checks(rec, wrec, alg, FSDP_N_VIRTUAL, fixed_bill, key)
        rec["vs_whole_leaf"] = _p20_compare(torch, alg, split, whole, [],
                                            f"{key} split vs whole")
        del whole
    dist.barrier()
    if captured is not None:
        rec["kernels"] = _replay_tensor_kernels(torch, captured, card, False)
    del split, captured
    _free(torch)
    return rec


#: (c) the buffered-async driver on split leaves (``make_async_round(...,
#: mesh=, pspecs=)``): FedAdam-SSM with error feedback on each plan's
#: view of the group, C = 2 clients (the tp plan's client axis, the fsdp
#: plan's ``n_virtual``), K = 2, staleness at most 2, churn with drops
#: and stragglers, 2 server steps; each against the port's whole-leaf
#: driver (``client_exec="scan"``, no mesh), run once on rank 0 from the
#: same weights, batches (2 sequences a client) and churn.  Seed 136's
#: schedule: 6 dispatches in 4 groups (a group of 2), a drop, a
#: staleness of 1, 4 landed.
P20_ASYNC = (("async_tp", "tp"), ("async_fsdp", "fsdp"))
P20_ASYNC_CLIENTS = 2
P20_ASYNC_CFG = dict(buffer_size=2, max_staleness=2)
P20_ASYNC_CHURN = dict(seed=136, jitter=3, straggler_prob=0.3, drop_prob=0.2)
P20_ASYNC_STEPS = 2
#: The async cases' cut: a tp rank's synchronous step alone peaks at 15
#: GB at 2 repeats (phase 16 (b)), and the driver adds every client's
#: residual shard and the records in flight; four such ranks ran the
#: card out at 2 repeats even with the records held as their nonzeros.
P20_ASYNC_REPEATS = 1


def _async_state_at_rank0(torch, parts, err, specs, mesh, plan):
    """A split state whole on global rank 0's card (``None`` elsewhere),
    where the comparison runs: ``parts`` (W, M, V: this rank's shards)
    and ``err``, this rank's residual shards of every client ``(C, ...)``
    (or ``None``).  The tp plan's ranks each hold every client's
    residual shard: each gives its client's (its client index's) to
    ``_state_at_rank0``, which gathers them over the client group.  Not
    through the host: pageable copies of a peer's shards run at 1-2
    GB/s, and pinned blocks stay cached in a process (with pinned
    gathers here the whole script ran out of a 96 GiB host beside one
    H100)."""
    import types
    from repro_torch import tree as T
    from repro_torch.models import params as PM
    if plan == "tp":
        i = mesh.client_index
        cs = None if err is None else {"comp": {"err": [
            x[i:i + 1] for x in err]}}
        return _state_at_rank0(torch, types.SimpleNamespace(
            **parts, client_state=cs), specs, mesh, to="card")
    whole = {p: _whole_at_rank0(torch, parts[p], T.leaves(specs), mesh,
                                to="card") for p in ("W", "M", "V")}
    cs_specs = [PM.Spec((None,) + tuple(sp)) for sp in T.leaves(specs)]
    whole["err"] = [] if err is None else \
        _whole_at_rank0(torch, err, cs_specs, mesh, to="card")
    return whole if mesh.rank == 0 else None


def _log_first_step(torch, run, names):
    """Wrap ``run``'s server steps ``names``: the first one's M copied to
    the host (pageable), leaf by leaf, into the returned list."""
    from repro_torch import tree as T
    first = []

    def wrap(inner):
        def apply(*args):
            out = inner(*args)
            if not first:
                first.extend(x.to("cpu", copy=True)
                             for x in T.leaves(out[1]))
            return out
        return apply

    for name in names:
        setattr(run, name, wrap(getattr(run, name)))
    return first


def _async_vs_whole(torch, first, wfirst, split, whole, what):
    """The split driver's state against the whole-leaf driver's: after
    the first server step (both drivers' clients trained from the same
    weights) M by ``_tensor_vs_whole``'s rule, the supports that differ
    read off M's zeros (M starts at zero); after the last, W, M, V and
    the residual by the same rule where no support differed at the first
    step, else (the later clients trained from a W that differs by a
    whole update where a support differed, and every gradient moves by a
    little) each part within ten times its bound (W, M, V
    ``TENSOR_ERR_TOL``, the residual ten times that) at all but those
    supports and ``TENSOR_SHARE`` of a leaf's elements."""
    s1 = _tensor_vs_whole(torch, {"W": [], "M": first, "V": [], "err": []},
                          {"W": [], "M": wfirst, "V": [], "err": []}, [],
                          f"{what} step 1", support_part="M")
    parted = s1["support_differs"] > 0
    out = _tensor_vs_whole(torch, split, whole, [], f"{what} final",
                           widen=10 if parted else 1)
    return dict(out, parted=parted, step1=s1,
                failures=s1["failures"] + out["failures"])


def _async_metrics(m):
    return {k: m[k] for k in ("events", "server_steps", "landed", "dropped",
                              "discarded", "buffer_pending",
                              "bits_per_step", "loss_per_step")} | {
        "uplink_bits": float(m["uplink_bits"])}


def _async_build(cfg, seq, plan):
    """``(shape, build keywords)`` of an async case's plan: FedAdam-SSM
    with error feedback, C clients of ``TENSOR_PER_CLIENT`` sequences."""
    import dataclasses as dc
    from repro_torch.launch import steps
    per = TENSOR_PER_CLIENT
    build = dict(algorithm="fedadam_ssm", error_feedback=True,
                 local_epochs=P20_EPOCHS)
    if plan != "tp":
        build["plan"] = fsdp_plan()
    return dc.replace(steps.SHAPES["train_4k"], seq_len=seq, global_batch=(
        per * P20_ASYNC_CLIENTS if plan == "tp" else per)), build


def p20_async_reference(torch, cfg, seed, seq, tokens, dev):
    """On global rank 0: the port's whole-leaf async driver
    (``client_exec="scan"``, no mesh; its payloads billed as measured)
    from ``cfg``'s weights drawn whole on the card, every client's
    ``tokens`` and the churn; both cases' reference.  Returns its record,
    M after its first server step and its final state (W, M, V, the
    clients' residuals), on the host."""
    from repro_torch import tree as T
    from repro_torch.core import AsyncConfig, fed_init, make_async_round
    from repro_torch.data import ChurnConfig, ChurnModel
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import steps
    from repro_torch.models.model import init_params
    one = MM.ClientMesh(shape={"data": 1}, client_axes=(), rank=0,
                        device=dev)
    shape, build = _async_build(cfg, seq, "fsdp")
    wb = steps.build_train_step(cfg, one, shape, **build)
    fed = wb.static["fed"]
    run = make_async_round(fed, wb.static["loss"],
                           AsyncConfig(**P20_ASYNC_CFG),
                           churn=ChurnModel(ChurnConfig(**P20_ASYNC_CHURN),
                                            P20_ASYNC_CLIENTS))
    state = fed_init(fed, init_params(cfg, seed=seed, device=dev))
    first = _log_first_step(torch, run, ("_apply", "_apply_wire"))
    _sync(torch, dev)
    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    st, m = run(state, {"tokens": tokens.to(dev)}, rounds=P20_ASYNC_STEPS)
    _sync(torch, dev)
    rec = {"wall_s": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated() if card
           else None, "launches": dict(LAUNCHES)} | _async_metrics(m)
    whole = {p: [x.cpu() for x in T.leaves(getattr(st, p))]
             for p in ("W", "M", "V")}
    whole["err"] = [x.cpu() for x in T.leaves(st.client_state["comp"]["err"])]
    del st, state, run, wb
    _free(torch)
    return rec, first, whole


def p20_async_case(torch, dist, mesh, plan, key, cfg, seed, seq, tokens,
                   ref):
    """(c): the split async driver on ``mesh`` (the tp plan's group
    cohort or the fsdp plan's virtual clients), its wall, peak, launches
    (exactly absmax L, count_ge 2L and ssm_apply_ef L per client step a
    rank runs: a group's lane on the tp plan, every dispatched client on
    the fsdp plan) and the bytes each group moves; the first dispatch's
    kernel inputs at the largest leaf's shard captured on rank 0 (pinned
    host copies, inside the timed run) and replayed against the plain
    versions; on rank 0 against ``ref`` (``p20_async_reference``'s): the
    event log, the counts and the bill equal, the state within
    ``_async_vs_whole``'s bounds."""
    from repro_torch import tree as T
    from repro_torch.core import AsyncConfig, fed_init, make_async_round
    from repro_torch.core.fed import local_batch
    from repro_torch.data import ChurnConfig, ChurnModel
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import steps
    from repro_torch.models import params as PM
    from repro_torch.models.model import abstract_params
    dev, card = mesh.device, mesh.device.type == "cuda"
    tp, C = plan == "tp", P20_ASYNC_CLIENTS
    shape, build = _async_build(cfg, seq, plan)
    bundle = steps.build_train_step(cfg, mesh, shape, **build)
    fed, specs = bundle.static["fed"], bundle.static["pspecs"]
    require(fed.n_clients == C, f"{key}: {fed.n_clients} clients")
    run = make_async_round(fed, bundle.static["loss"],
                           AsyncConfig(**P20_ASYNC_CFG),
                           churn=ChurnModel(ChurnConfig(**P20_ASYNC_CHURN),
                                            C),
                           client_exec="shardmap" if tp else "scan",
                           mesh=mesh, pspecs=specs)
    state = fed_init(fed, PM.materialize_shards(
        abstract_params(cfg), specs, mesh, seed, cfg.dtype, dev))
    batches = {"tokens": tokens.to(dev)}
    if not tp:
        batches = local_batch(batches, mesh)
    sizes = [x.numel() for x in T.leaves(state.W)]
    first = _log_first_step(torch, run, ("_apply",))
    cap = Capture(host=True) if mesh.rank == 0 else None
    if cap is not None:
        entry = _lm_entry_points()
        for k in FSDP_KERNELS:
            cap.wrap(*entry[k], k, LM_KERNELS[k][2], (max(sizes),),
                     len(LM_PASSES.get(k, ("",))))
    _sync(torch, dev)
    held = torch.cuda.memory_allocated() if card else None
    if card:
        torch.cuda.reset_peak_memory_stats()
    try:
        with _collectives(MM) as moved:
            reset_launches()
            t0 = time.perf_counter()
            st, m = run(state, batches, rounds=P20_ASYNC_STEPS)
            _sync(torch, dev)
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
    finally:
        if cap is not None:
            cap.restore()
    disp = [e for e in m["events"] if e[1] == "dispatch"]
    client_steps = len({e[0] for e in disp}) if tp else len(disp)
    L = len(sizes)
    want = {k: v * client_steps for k, v in per_client_round(
        absmax=L, count_ge=2 * L, ssm_apply_ef=L).items() if v}
    got = {k: v for k, v in launches.items() if v}
    require(not card or got == want, f"phase 20 {key}: launches {got} "
            f"against {want} ({client_steps} client steps a rank)")
    rec = {"case": key, "plan": plan, "wall_s": wall, "held_bytes": held,
           "peak_bytes": torch.cuda.max_memory_allocated() if card
           else None, "collective_bytes": dict(moved),
           "launches": launches, "launches_expected": want,
           "client_steps": client_steps, "dispatches": len(disp),
           "leaves": L, "shard_elements": sum(sizes)} | _async_metrics(m)
    t0 = time.perf_counter()
    # every rank's cache goes back before rank 0 holds whole leaves
    del state, run, bundle
    _free(torch)
    split = _async_state_at_rank0(
        torch, {p: T.leaves(getattr(st, p)) for p in ("W", "M", "V")},
        T.leaves(st.client_state["comp"]["err"]), specs, mesh, plan)
    del st
    first = _async_state_at_rank0(
        torch, {"W": [], "M": [x.to(dev) for x in first], "V": []}, None,
        specs, mesh, plan)
    rec["state_gather_s"] = time.perf_counter() - t0
    _free(torch)
    if cap is not None:
        captured = {k: [(a, kw) for calls in cap.args[k].values()
                        for a, kw in calls] for k in cap.args}
        rec["kernels"] = _replay_tensor_kernels(torch, captured, card,
                                                False)
        del captured, cap
    if mesh.rank == 0:
        wrec, wfirst, whole = ref
        rec["whole_leaf"] = {k: v for k, v in wrec.items() if k != "events"}
        for k in ("events", "server_steps", "landed", "dropped",
                  "discarded", "buffer_pending", "bits_per_step",
                  "uplink_bits"):
            require(rec[k] == wrec[k], f"{key}: {k} {rec[k]} against the "
                    f"whole-leaf driver's {wrec[k]}")
        require(rec["server_steps"] == P20_ASYNC_STEPS
                and rec["dropped"] >= 1
                and len({e[0] for e in disp}) < len(disp),
                f"{key}: the schedule lost its drop or its group of 2")
        a, b = rec["loss_per_step"], wrec["loss_per_step"]
        require(max(abs(x - y) for x, y in zip(a, b))
                <= 1e-5 * max(abs(y) for y in b),
                f"{key}: losses {a} against {b}")
        rec["vs_whole_leaf"] = _async_vs_whole(
            torch, first["M"], wfirst, split, whole,
            f"{key} split vs whole")
    del split, first
    _free(torch)
    dist.barrier()
    return rec


def p20_run(torch, dist, mesh, seed, pred_dir, smoke=False):
    """Phase 20's cases on this rank of a (data 2, model 2) gloo group
    (``mesh``: any view of it): (c) ``P20_ASYNC`` first, then (a)
    ``P20_TP`` on its spatial view (client axis "data"), (b) ``P20_FSDP``
    on its virtual view (no client axes: the client group is the data
    group).  Each case of (a) and (b) waits for its prediction and runs
    at its repeats.  Returns the cases' records and
    ``phase_s``."""
    import dataclasses as dc
    from repro_torch.launch import train
    tmesh = dc.replace(mesh, client_axes=("data",))
    vmesh = dc.replace(mesh, client_axes=())
    dev = mesh.device
    out = {}
    t_phase, t_wall = time.perf_counter(), time.time()
    C = tmesh.n_clients
    seq = 32 if smoke else TENSOR_SEQ
    repeats = 2 if smoke else P20_ASYNC_REPEATS
    cfg = _tensor_cfg(TENSOR_ARCH, repeats, "float32", smoke)
    # (c) first, while the predictor predicts (a) and (b)'s cuts
    t0 = time.perf_counter()
    tokens = train.build_client_batches(
        cfg, P20_ASYNC_CLIENTS, TENSOR_PER_CLIENT, seq, seed=seed,
        device="cpu")["tokens"]
    ref = p20_async_reference(torch, cfg, seed, seq, tokens, dev) \
        if mesh.rank == 0 else None
    dist.barrier()
    ref_s = time.perf_counter() - t0
    for key, plan in P20_ASYNC:
        t0 = time.perf_counter()
        rec = p20_async_case(torch, dist, tmesh if plan == "tp" else vmesh,
                             plan, key, cfg, seed, seq, tokens, ref)
        rec.update(repeats=repeats, case_s=time.perf_counter() - t0,
                   reference_s=ref_s)
        out[key] = rec
        if mesh.rank == 0:
            log(f"phase 20 {key}: " + json.dumps(
                {k: v for k, v in rec.items()
                 if k not in ("kernels", "events")}))
    del ref
    _free(torch)
    out["async_s"] = time.perf_counter() - t_phase
    host = {}
    for key, plan, alg, kw in p20_cases():
        pred = _p20_prediction(pred_dir, key)
        # (c)'s cost to the phase: the first case would otherwise start
        # when its prediction was written
        out.setdefault("first_prediction_s", (
            Path(pred_dir) / f"{key}.json").stat().st_mtime - t_wall)
        require(pred["fits"], f"phase 20 {key}: predicted not to fit at "
                f"any of {P20_REPEATS} repeats: {pred['cuts']}")
        cfg = _tensor_cfg(TENSOR_ARCH, pred["repeats"], "float32", smoke)
        # PERF.md §2's bills are the 2-repeat cut's
        fixed = not smoke and pred["repeats"] == 2
        t0 = time.perf_counter()
        if plan == "tp":
            if pred["repeats"] not in host:
                host.clear()
                host[pred["repeats"]] = (
                    _host_params(cfg, seed, dev),
                    train.build_client_batches(
                        cfg, C, TENSOR_PER_CLIENT, seq, seed=seed,
                        device="cpu")["tokens"])
            params, tokens = host[pred["repeats"]]
            rec = p20_tp_case(torch, dist, tmesh, cfg, alg, kw, pred,
                              params, tokens, seq, key, fixed, seed)
        else:
            host.clear()
            rec = p20_fsdp_case(torch, dist, vmesh, cfg, alg, kw, pred,
                                seed, seq, key, fixed)
        rec.update(repeats=pred["repeats"], cuts=pred["cuts"],
                   case_s=time.perf_counter() - t0)
        out[key] = rec
        if mesh.rank == 0:
            log(f"phase 20 {key}: " + json.dumps(
                {k: v for k, v in rec.items() if k != "kernels"}))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def p20_rank(rank, world, store, seed, pred_dir, device="cuda",
             smoke=False):
    """Phase 20 alone on one rank of a gloo group of CUDA tensors sharing
    the card, a (data 2, model 2) mesh (``p20_run``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.device import exact_float32
    from repro_torch.launch import mesh as MM

    exact_float32()
    mesh = MM.init(world, rank, store=store, device=torch.device(device),
                   backend="gloo", shape=FSDP_MESH, timeout_s=180)
    try:
        return p20_run(torch, dist, mesh, seed, pred_dir, smoke)
    finally:
        mesh.close()


def _p20_predictor(smoke):
    """The predictor (``p20_predict``) started in a thread: ``(pred_dir,
    join)``, ``join()`` waiting for it (and raising its failure)."""
    import shutil
    import tempfile
    import threading
    from repro_torch.launch import mesh as MM
    pred_dir = ROOT / "chiprun_out" / "phase20_pred"
    shutil.rmtree(pred_dir, ignore_errors=True)
    pred_dir.mkdir(parents=True)
    errors, tmp = [], tempfile.mkdtemp()

    def predict():
        try:
            MM.run_ranks(p20_predict, 1, store=os.path.join(tmp, "pred"),
                         args=(str(pred_dir), smoke),
                         timeout_s=P20_WAIT_S + 700)
        except BaseException as e:      # re-raised by join
            errors.append(e)

    thread = threading.Thread(target=predict)
    thread.start()

    def join():
        thread.join()
        shutil.rmtree(tmp, ignore_errors=True)
        if errors:
            raise errors[0]

    return pred_dir, join


def _p20_record(ranks, pred_dir, wall):
    """Phase 20's record from every rank's ``p20_run`` result
    (``chiprun_out/phase20.json``), its log line, and its checks."""
    preds = {k: json.loads((pred_dir / f"{k}.json").read_text())
             for k, *_ in p20_cases()}
    (ROOT / "chiprun_out" / "phase20.json").write_text(json.dumps(
        {"ranks": ranks, "predictions": preds}, indent=1, default=str))
    r0 = ranks[0]
    keys = [k for k, *_ in p20_cases()] + [k for k, _ in P20_ASYNC]
    summary = {k: {kk: r0[k].get(kk) for kk in (
        "repeats", "cuts", "wall_s", "peak_bytes", "predicted_peak_bytes",
        "uplink_bits", "collective_bytes", "launches_predicted",
        "case_s", "client_steps", "landed", "dropped", "held_bytes",
        "state_gather_s")} for k in keys}
    for k in keys:
        for kk in ("wall_s", "peak_bytes"):
            summary[k][f"whole_leaf_{kk}"] = r0[k].get(
                "whole_leaf", {}).get(kk)
        vs = r0[k].get("vs_whole_leaf", {})
        summary[k]["max_rel_err"] = vs.get("max_rel_err")
    # (c) ran while the predictor predicted (a) and (b): what it added to
    # the phase is the time past the first prediction's
    ready = max(0.0, r0["first_prediction_s"])
    summary["async"] = {"async_s": r0["async_s"], "first_prediction_s":
                        r0["first_prediction_s"], "added_s":
                        max(r0["async_s"], ready) - ready}
    log(f"phase 20: {FSDP_WORLD} gloo ranks on the card ({smi_line()}) "
        f"in {wall:.1f} s, cuts "
        f"{ {k: r0[k].get('cuts') for k in keys} }: " + json.dumps(summary))
    failures = [f for k in keys
                for f in r0[k].get("vs_whole_leaf", {}).get("failures", [])]
    require(not failures, "; ".join(failures))
    launches = {k: {n: v for n, v in r0[k]["launches"].items() if v}
                for k in keys}
    kernels = {k: r0[k]["kernels"] for k in keys if "kernels" in r0[k]}
    return {"summary": summary, "wall_s": wall, "launches": launches,
            "kernels": kernels, "predictions": preds}


def phase_compressors(torch, seed, device="cuda", smoke=False):
    """Phase 20 alone: the predictor beside 4 gloo processes of CUDA
    tensors on the one card (``p20_rank``), each rank's case waiting for
    its prediction; a failure in any fails the phase.  Returns
    ``_p20_record``'s."""
    import shutil
    import tempfile
    from repro_torch.launch import mesh as MM
    t_phase = time.perf_counter()
    pred_dir, join = _p20_predictor(smoke)
    tmp = tempfile.mkdtemp()
    try:
        ranks = MM.run_ranks(p20_rank, FSDP_WORLD,
                             store=os.path.join(tmp, "store"),
                             args=(seed, str(pred_dir), device, smoke),
                             timeout_s=900)
    finally:
        join()
        shutil.rmtree(tmp, ignore_errors=True)
    return _p20_record(ranks, pred_dir, time.perf_counter() - t_phase)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # deepseek's vmap round at its whole vocabulary fits the card only
    # without the caching allocator's fixed segments, which strand free
    # memory between them (on an H100 80GB: 13.49 GiB reserved but
    # unallocated when a 7.47 GiB request failed)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import numpy as np
    import torch

    t_start = time.perf_counter()
    phase(1, "device and build")
    smi, build_s = phase_device_and_build(torch)
    phase(2, "the CNN's main path")
    rounds, launches, captured, round_profile, payload_bytes = \
        phase_main_path(torch, args.seed)
    phase(3, "the CNN path's kernels against their plain versions")
    kernels = phase_kernels(torch, captured, launches, ROUNDS * CLIENTS,
                            args.seed)
    phase(2, "the CNN's FedAdam-Top round")
    cnn_top, captured = phase_cnn_top(torch, args.seed)
    phase_cnn_top_kernels(torch, captured, kernels)
    del captured
    phase(4, "CNN rounds card vs CPU")
    vs_cpu = {a: phase_card_vs_cpu(torch, np, args.seed, a)
              for a in ("fedadam_ssm", "fedadam_top")}
    phase(8, "the CNN's baselines")
    cnn_base = {a: phase_cnn_baseline(torch, args.seed, a)
                for a in CNN_BASELINES}
    phase(9, "exact top-k masks")
    exact = phase_exact_topk(torch, np, args.seed)
    vs_cpu["fedadam_ssm_exact_topk"] = phase_card_vs_cpu(
        torch, np, args.seed, "fedadam_ssm", exact_topk=True)
    for a in ("efficient_adam", "onebit_adam"):
        vs_cpu[a] = phase_card_vs_cpu(torch, np, args.seed, a)
    phase(11, "the CNN's drivers")
    cnn_drivers, captured = phase_cnn_drivers(torch, np, args.seed)
    phase_driver_kernels(torch, captured, kernels, "cnn_async_churn")
    del captured
    phase(5, "starcoder2-3b's FedAdam-SSM rounds")
    lm, captured = phase_transformer(torch, args.seed, "fedadam_ssm")
    # ssm_apply has no caller on any path: it replays ssm_apply_ef's
    # inputs, the transformer's deltas at the same leaves
    captured["ssm_apply"] = {n: [(calls[0][0][:4], {})] for n, calls
                             in captured["ssm_apply_ef"].items()}
    phase(6, "the per-leaf kernels against their plain versions")
    kernels += phase_lm_kernels(torch, captured, lm["launches"],
                                LM_PATHS["fedadam_ssm"]["replayed"]
                                + ("ssm_apply",))
    phase_lm_wire_kernels(torch, captured, kernels)
    host_cost = phase_host_cost(
        torch, captured["absmax"][LM_SHAPES["norm"]][0][0][0])
    del captured
    phase(6, "starcoder2-3b's FedAdam-Top rounds")
    lm_top, captured = phase_transformer(torch, args.seed, "fedadam_top")
    kernels += phase_lm_kernels(torch, captured, lm_top["launches"],
                                LM_PATHS["fedadam_top"]["replayed"])
    del captured
    phase(10, "starcoder2-3b's baselines")
    lm_base, captured = {}, {}
    for a in ("efficient_adam", "onebit_adam"):
        lm_base[a], cap = phase_lm_baseline(torch, args.seed, a)
        captured.update(cap)
    phase_lm_baseline_kernels(torch, captured, kernels)
    del captured, cap
    phase(12, "starcoder2-3b's drivers")
    lm_drivers, captured = phase_lm_drivers(torch, args.seed)
    phase_driver_kernels(torch, captured, kernels, "lm_vmap_wire")
    del captured
    # phase 13: each model built after the previous one is freed
    phase(13, "the zoo's models at full width")
    zoo = {}
    for name in ZOO:
        zoo[name], captured = phase_zoo(torch, args.seed, name)
        # the model's rounds leave the allocator holding nearly the whole
        # card: the cache goes back to the driver before the timings (the
        # empty profiler windows once blamed on it come from the process's
        # age, see device_ms)
        torch.cuda.empty_cache()
        phase_zoo_kernels(torch, name, captured, zoo[name]["launches"],
                          kernels)
        del captured
        zoo[name]["block_card_vs_cpu"] = phase_zoo_block_vs_cpu(
            torch, args.seed, name)
    # phase 14: each model served whole after the previous one is freed
    phase(14, "serving")
    t_serve = time.perf_counter()
    served = {name: phase_serve(torch, args.seed, name) for name in SERVE}
    for name in SERVE_CHECK:
        served[name]["decode_block_card_vs_cpu"] = serve_block_vs_cpu(
            torch, args.seed, name)
        served[name]["two_repeats_float32"] = serve_depth_check(
            torch, args.seed, name)
    log(f"phase 14 took {time.perf_counter() - t_serve:.1f} s")
    # phase 15: the multi-GPU spatial driver, (a) on a world-1 NCCL group,
    # (b) on gloo ranks sharing the card
    phase(15, "the multi-GPU spatial driver")
    t_spatial = time.perf_counter()
    torch.cuda.empty_cache()
    spatial, cnn_inputs, lm_inputs = phase_spatial(torch, args.seed)
    phase_driver_kernels(torch, cnn_inputs, kernels, "cnn_spatial")
    phase_driver_kernels(torch, lm_inputs, kernels, "lm_spatial")
    del cnn_inputs, lm_inputs
    torch.cuda.empty_cache()
    spatial["ranks"] = phase_spatial_ranks(torch, args.seed)
    rank0 = spatial["ranks"]["ranks"][0]
    for name, err in rank0["kernel_max_abs_err"].items():
        k = next(k for k in kernels if k["name"] == name)
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["at_cnn_spatial_ranks"] = {"max_abs_err": err}
    log(f"phase 15 took {time.perf_counter() - t_spatial:.1f} s")
    # phase 16: tensor parallelism on a model axis, gloo ranks on the card
    phase(16, "tensor parallelism on a model axis")
    t_tensor = time.perf_counter()
    torch.cuda.empty_cache()
    tensor = phase_tensor(torch, args.seed)
    tensor["wall_s"] = time.perf_counter() - t_tensor
    log(f"phase 16 took {tensor['wall_s']:.1f} s")
    a0, b0 = tensor["a"]["ranks"][0], tensor["b"]["ranks"][0]
    for label, rec in (("a_fedadam_ssm", a0["fedadam_ssm"]),
                       ("a_fedadam_top", a0["fedadam_top"]),
                       ("b_fedadam_ssm", b0["fedadam_ssm"])):
        for kname in TENSOR_KERNELS:
            shard = {lab: r for lab, r in rec["kernels"].items()
                     if lab.split("/")[0] == kname}
            if not shard:
                continue
            k = next(k for k in kernels if k["name"] == kname)
            k["max_abs_err"] = max(k["max_abs_err"], *(
                r["max_abs_err"] for r in shard.values()))
            k[f"at_tensor_{label}"] = shard
    for k in kernels:
        k["launches_serve"] = {n: r["launches"][k["name"]]
                               for n, r in served.items()}
        k["launches_fedadam_top"] = {"cnn": cnn_top["launches"][k["name"]],
                                     "lm": lm_top["launches"][k["name"]]}
        if k["name"] in ("pack_words", "unpack_words"):
            k["launches_transformer"] = lm["launches"][k["name"]]
        for a in ("efficient_adam", "onebit_adam"):
            k[f"launches_{a}"] = {
                run: sum(x["launches"][k["name"]] for x in res[a]["rounds"]
                         if x["algorithm"] == a)
                for run, res in (("cnn", cnn_base), ("lm", lm_base))}
        # the spatial driver's: per client of its rounds
        k["launches_spatial"] = {
            "cnn_world1": spatial["cnn"]["launches_per_client"][k["name"]],
            "lm_world1": spatial["lm"]["launches"][k["name"]],
            "cnn_gloo_ranks": rank0["round_launches"][k["name"]]}
        # the split rounds': per rank and round (each rank one half of a
        # client's leaves)
        k["launches_tensor"] = {
            "a_starcoder2_fedadam_ssm": a0["fedadam_ssm"]["launches"][
                k["name"]],
            "a_starcoder2_fedadam_top": a0["fedadam_top"]["launches"][
                k["name"]],
            "a_starcoder2_bfloat16": a0["bfloat16"]["launches"][k["name"]],
            "a_deepseek": a0["moe"]["launches"][k["name"]],
            "b_starcoder2_fedadam_ssm": b0["fedadam_ssm"]["launches"][
                k["name"]]}
        # the drivers' launches: per client of a vmap round, per dispatch
        # of an async run (its repacks and server decodes included)
        k["launches_drivers"] = {
            "cnn_vmap_wire_per_client":
                cnn_drivers["vmap_wire"]["launches_per_client"].get(
                    k["name"], 0),
            "cnn_async_churn": cnn_drivers["async_churn"]["launches"].get(
                k["name"], 0),
            "lm_vmap_wire_per_client":
                lm_drivers["vmap_wire"]["launches_per_client"].get(
                    k["name"], 0),
            "lm_async_trainer": lm_drivers["async_trainer"]["launches"].get(
                k["name"], 0)}
    # phase 17: the virtual clients and the FSDP leaves, gloo ranks on
    # the card
    phase(17, "the virtual clients and the FSDP leaves")
    t_fsdp = time.perf_counter()
    torch.cuda.empty_cache()
    fsdp = phase_fsdp(torch, args.seed)
    fsdp["phase_s"] = time.perf_counter() - t_fsdp
    log(f"phase 17 took {fsdp['phase_s']:.1f} s")
    fa, fa16, fb = (fsdp["ranks"][0]["a"]["float32"],
                    fsdp["ranks"][0]["a"]["bfloat16"], fsdp["ranks"][0]["b"])
    for label, rec in (("a_starcoder2", fa), ("b_mistral_embed", fb)):
        for kname in FSDP_KERNELS:
            shard = {lab: r for lab, r in rec["kernels"].items()
                     if lab.split("/")[0] == kname}
            k = next(k for k in kernels if k["name"] == kname)
            k["max_abs_err"] = max(k["max_abs_err"], *(
                r["max_abs_err"] for r in shard.values()))
            k[f"at_fsdp_{label}"] = shard
    for k in kernels:
        # per rank and round of the virtual/fsdp round (2 clients), and
        # of select_tau on the embedding gradient's shard
        k["launches_fsdp"] = {
            "a_starcoder2_float32": fa["launches"][k["name"]],
            "a_starcoder2_bfloat16": fa16["launches"][k["name"]],
            "b_mistral_select_tau": fb["select_launches"].get(k["name"],
                                                              0)}
    # phase 18: sharded serving, gloo ranks on the card
    phase(18, "sharded serving")
    torch.cuda.empty_cache()
    serve_mesh = phase_serve_mesh(torch, args.seed)
    log(f"phase 18 took {serve_mesh['wall_s']:.1f} s")
    for k in kernels:
        # per rank over phase 18's parts (serving launches none)
        k["launches_serve_mesh"] = serve_mesh["launches"].get(k["name"], 0)
    # phase 19: the dry run's prediction and rank 0's real step on the card
    phase(19, "the dry run and rank 0's step against it")
    _free(torch)
    dry = phase_dryrun(torch, args.seed)
    for k in kernels:
        # rank 0 of the production mesh, one step of each combo it ran
        k["launches_dryrun_rank0"] = dry["launches"].get(k["name"], 0)
    # phase 20: every compressor on split leaves, gloo ranks on the card
    phase(20, "every compressor on split leaves")
    _free(torch)
    compressors = phase_compressors(torch, args.seed)
    log(f"phase 20 took {compressors['wall_s']:.1f} s")
    for k in kernels:
        # per rank and round of each case (rank 0; every rank the same)
        k["launches_phase20"] = {c: n.get(k["name"], 0) for c, n in
                                 compressors["launches"].items()}
        for case, recs in compressors["kernels"].items():
            shard = {lab: r for lab, r in recs.items()
                     if lab.split("/")[0] == k["name"]}
            if shard:
                k["max_abs_err"] = max(k["max_abs_err"], *(
                    r["max_abs_err"] for r in shard.values()))
                label = case if case.startswith("async_") else \
                    f"phase20_{case}"
                k[f"at_{label}"] = shard
    require(sorted(k["name"] for k in kernels)
            == sorted((*KERNELS, *LM_KERNELS)), "a kernel was not measured")
    phase(7, "starcoder2 smoke rounds card vs CPU")
    lm_vs_cpu = phase_lm_card_vs_cpu(torch, np, args.seed, "fedadam_ssm")
    lm_top_vs_cpu = phase_lm_card_vs_cpu(torch, np, args.seed,
                                         "fedadam_top")

    record = {"card": smi, "host_cpu": host_cpu(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "rounds": rounds, "card_payload_bytes": payload_bytes,
              "round_profile": round_profile, "cnn_fedadam_top": cnn_top,
              "kernels": kernels, "card_vs_cpu": vs_cpu,
              "transformer": lm, "transformer_fedadam_top": lm_top,
              "host_cost_us": host_cost,
              "transformer_card_vs_cpu": lm_vs_cpu,
              "transformer_fedadam_top_card_vs_cpu": lm_top_vs_cpu,
              "cnn_baselines": cnn_base, "exact_topk_ties": exact,
              "transformer_baselines": lm_base,
              "cnn_drivers": cnn_drivers, "transformer_drivers": lm_drivers,
              "zoo": zoo, "serve": served, "spatial": spatial,
              "tensor": tensor, "fsdp": fsdp, "serve_mesh": serve_mesh,
              "dryrun": dry, "compressors": compressors,
              "total_s": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total {record['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
