"""Serving driver of the port: a batched prompt replayed through the
decode step, then greedy (or sampled) generation, for any zoo
architecture.

Counterpart of ``repro/launch/serve.py``.  Runs on the CUDA card (the
default) or on the CPU with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mamba2-1-3b --smoke --device cpu --batch 2 --prompt-len 32 \\
        --gen 16

and prints the reference's three ``[serve]`` lines.  Like the reference,
it never calls ``prefill``: the prompt goes through ``decode_step`` one
token at a time into caches of the prompt plus the generated length (plus
a VLM's prefix); a VLM's prefix embeddings are made (they set that
length) but ``decode_step`` does not read them, and an encoder's cross
keys and values stay the zeros that ``cache_meta`` allocates.  The tests
and ``chip_smoke.py`` seed those from ``prefill``.

Greedy by default; ``--temperature T > 0`` samples from ``softmax(logits
/ T)`` with a ``torch.Generator`` seeded 2 (not the reference's draws).
The caches are written in place, the positions are Python ints and the
picked tokens stay on the device until the end, so the decode loop makes
no stream synchronisation.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import synthetic_frontend_embeds, synthetic_tokens
from repro_torch.device import DeviceLike, exact_float32, resolve_device
from repro_torch.models.model import cache_meta, decode_step, init_params
from repro_torch.models.params import materialize


def setup(cfg, batch: int, prompt_len: int, gen: int, *,
          device: DeviceLike = None, seed: int = 0):
    """``(params, tokens, frontend_embeds, seq_len)``: random weights from
    ``seed``, the reference's Zipf prompt (b, prompt_len) on ``device``,
    a stub frontend's embeddings (the encoder's src_len frames, or at most
    16 patches; None without one) and the decode length."""
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev)
    toks = torch.from_numpy(synthetic_tokens(batch, prompt_len,
                                             cfg.vocab_size, seed=0)).to(dev)
    embeds = None
    if cfg.stub_frontend:
        n_front = cfg.encoder.src_len if cfg.encoder is not None else \
            min(cfg.stub_frontend_tokens, 16)
        embeds = torch.from_numpy(synthetic_frontend_embeds(
            batch, n_front, cfg.d_model)).to(dev)
    seq_len = prompt_len + gen + (
        embeds.shape[1] if embeds is not None and cfg.encoder is None
        else 0)
    return params, toks, embeds, seq_len


def new_caches(cfg, batch: int, seq_len: int, device: DeviceLike = None):
    """Zeroed decode caches of ``cache_meta(cfg, batch, seq_len)``."""
    return materialize(cache_meta(cfg, batch, seq_len), 0, cfg.dtype,
                       resolve_device(device))


@torch.inference_mode()
def replay(cfg, params, caches, tokens, *, seq_len: int):
    """Each prompt token through ``decode_step`` from position 0; returns
    the last step's logits (b, V) and the next position."""
    logits = None
    for pos in range(tokens.shape[1]):
        logits, caches = decode_step(cfg, params, caches, pos,
                                     tokens[:, pos], seq_len=seq_len)
    return logits, tokens.shape[1]


def pick(logits, vocab_size: int, temperature: float = 0.0,
         generator: Optional[torch.Generator] = None):
    """The next token per row, on the logits' device: the first largest
    logit, or with ``temperature > 0`` a draw from ``softmax(logits / T)``
    (``argmax(probs / E)``, E exponential from ``generator``); clipped to
    the vocabulary (the padded rows are never a token)."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        e = torch.empty_like(probs).exponential_(generator=generator)
        nxt = (probs / e).argmax(dim=-1)
    else:
        nxt = logits.argmax(dim=-1)
    return nxt.clamp_max(vocab_size - 1)


@torch.inference_mode()
def generate(cfg, params, caches, logits, pos: int, n: int, *,
             seq_len: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None):
    """``n`` tokens, each picked from the previous logits and fed through
    ``decode_step``: returns (tokens (b, n) on the device, the last
    logits)."""
    out = []
    for _ in range(n):
        nxt = pick(logits, cfg.vocab_size, temperature, generator)
        out.append(nxt)
        logits, caches = decode_step(cfg, params, caches, pos, nxt,
                                     seq_len=seq_len)
        pos += 1
    return torch.stack(out, dim=1), logits


def _wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[list] = None):
    """Run the command line ``argv``; returns the generated tokens (b,
    gen) as a CPU tensor."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    exact_float32()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    with torch.inference_mode():
        params, toks, _, seq_len = setup(cfg, args.batch, args.prompt_len,
                                         args.gen, device=dev)
        caches = new_caches(cfg, args.batch, seq_len, dev)
        gen = torch.Generator(device=dev).manual_seed(2)

        t0 = time.time()
        logits, pos = replay(cfg, params, caches, toks, seq_len=seq_len)
        _wait(dev)
        t_prefill = time.time() - t0

        t0 = time.time()
        out, _ = generate(cfg, params, caches, logits, pos, args.gen,
                          seq_len=seq_len, temperature=args.temperature,
                          generator=gen)
        out = out.cpu()
        t_gen = time.time() - t0

    print(f"[serve] {cfg.name}: batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"[serve] prompt replay {t_prefill:.2f}s, "
          f"decode {t_gen:.2f}s "
          f"({args.gen*args.batch/max(t_gen,1e-9):.1f} tok/s)")
    print("[serve] sample:", out[0][:12].tolist())
    return out


if __name__ == "__main__":
    main()
