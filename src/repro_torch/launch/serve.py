"""Serving launcher (counterpart of ``repro.launch.serve``): the
continuous-batching engine over a registry architecture, on the card unless
``--device`` says otherwise:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \\
        --smoke --requests 16 --slots 4

The prompts are the reference launcher's for the same ``--seed`` (the same
numpy draws); the weights are not (a ``torch.Generator`` is not a JAX key).
``main`` returns the served requests.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serve import Request, ServeConfig, ServingEngine


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def make_requests(n: int, vocab_size: int, max_new: int,
                  seed: int) -> list[Request]:
    """The reference launcher's requests: prompts of 2-11 tokens drawn from
    ``np.random.default_rng(seed)`` in its order."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(2, 12))
        reqs.append(Request(prompt=rng.integers(0, vocab_size, plen)
                            .astype(np.int32), max_new_tokens=max_new))
    return reqs


def main(argv: list[str] | None = None) -> list[Request]:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    pcfg = ParallelConfig(model_axis=1, remat="none", attn_chunk=64)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params, _ = tfm.init_params(cfg, pcfg, gen, dev)
    engine = ServingEngine(cfg, pcfg, params,
                           ServeConfig(batch_slots=args.slots,
                                       max_seq=args.max_seq), device=dev)
    reqs = make_requests(args.requests, cfg.vocab_size, args.max_new,
                         args.seed)
    for r in reqs:
        engine.submit(r)
    t0 = time.monotonic()
    engine.run_to_completion()
    dt = time.monotonic() - t0
    toks = sum(len(r.generated) for r in reqs)
    if not all(r.done for r in reqs):
        raise RuntimeError("run_to_completion returned with requests not done")
    print(f"served {len(reqs)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s, {args.slots} slots, continuous batching)")
    return reqs


if __name__ == "__main__":
    main()
