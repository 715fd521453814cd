"""Batched LM serving: continuous batching over one fixed-shape decode step.

Counterpart of ``repro.serve.engine``.  The engine leases the batch slots
of one ``decode_step`` to requests (continuous batching, slot recycling):

* a fixed ``(batch_slots, max_seq)`` cache is allocated once, on the
  engine's device, and updated in place by every step (``self.cache`` is
  the same tensors from tick to tick);
* a queued request claims a free slot (first in, first out, slots in
  order); its prompt is replayed into the slot's cache one decode step a
  token (``_admit``), every other slot fed token 0 at its own, unadvanced
  position;
* every tick decodes one token for all slots and reads the host once, the
  argmax over the real vocabulary;
* a request retires on its ``eos_id``, on ``max_new_tokens`` or when its
  slot reaches ``max_seq - 1``; its slot is reused at the next tick with
  ``pos`` reset to 0 and the cache not cleared.

Per-slot positions make this work: the step takes a ``(B,)`` position
vector, so each slot writes its cache at its own offset.

**What a slot shares.**  Attention caches are per slot, and the token-0
rows an admission writes at another slot's position are overwritten by that
slot's next real step.  A Mamba-2 layer's decode advances the recurrent
state of every row, with no mask and no reset (the reference's
``mamba2.py:155-166``): for SSM models an admission or an idle slot moves
every other slot's ``ssm``/``conv`` state, and a recycled slot inherits its
predecessor's.  The port keeps this as the reference has it.

**The host-to-device copies.**  ``self.pos`` is a numpy array updated in
place after every step.  Each step uploads fresh copies of the tokens and
of ``pos`` with ``torch.tensor(array, device=...)``: it copies the array
into a new host tensor, and the copy to the card from that pageable memory
is synchronous, so the upload has read ``pos`` before the call returns and
a later ``self.pos[...] += 1`` cannot race with it.  ``torch.from_numpy``
would alias the array, and a ``non_blocking=True`` copy from a pinned
buffer mutated after the call would race on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.measure import tree_leaves


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                   # int32[prompt_len]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine
    rid: int = -1
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8
    max_seq: int = 512
    greedy: bool = True                  # unread, as in the reference


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig, params,
                 sc: ServeConfig = ServeConfig(),
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        for leaf in tree_leaves(params):
            if not _same_device(leaf.device, self.device):
                raise ValueError(
                    f"params on {leaf.device}, engine on {self.device}: move "
                    f"the params or pass device={str(leaf.device)!r}")
        self.cfg, self.pcfg, self.sc = cfg, pcfg, sc
        self.params = params
        B, S = sc.batch_slots, sc.max_seq
        self.cache = tfm.init_cache(cfg, pcfg, B, S, device=self.device)
        self.pos = np.zeros(B, np.int32)              # per-slot next position
        self.active: list[Optional[Request]] = [None] * B
        self.queue: list[Request] = []
        self._next_rid = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        req.rid = self._next_rid
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    @torch.no_grad()
    def _step_raw(self, batch_tok: np.ndarray, update_only: Optional[int] = None):
        # fresh uploads of the tokens and of pos: see the module docstring
        toks = torch.tensor(batch_tok, device=self.device)
        pos = torch.tensor(self.pos, device=self.device)
        logits, _ = tfm.decode_step(self.params, self.cfg, self.pcfg, toks,
                                    self.cache, pos)
        if update_only is None:
            self.pos[[r is not None for r in self.active]] += 1
        else:
            self.pos[update_only] += 1
        return logits

    # ------------------------------------------------------------------
    def tick(self) -> int:
        """Admit queued requests, decode one token for all active slots.

        Returns the number of active requests after the tick."""
        for slot in range(self.sc.batch_slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.active[slot] = req
                self.pos[slot] = 0
                self._admit(slot, req)
        if not any(r is not None for r in self.active):
            return 0
        batch_tok = np.zeros((self.sc.batch_slots, 1), np.int32)
        for slot, req in enumerate(self.active):
            if req is not None:
                batch_tok[slot, 0] = req.generated[-1] if req.generated else req.prompt[-1]
        logits = self._step_raw(batch_tok)
        nxt = logits[:, 0, : self.cfg.vocab_size].argmax(-1).cpu().numpy()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.generated.append(tok)
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.generated) >= req.max_new_tokens or \
                    self.pos[slot] >= self.sc.max_seq - 1:
                req.done = True
                self.active[slot] = None       # slot recycled next tick
        return sum(r is not None for r in self.active)

    def _admit(self, slot: int, req: Request) -> None:
        """Write the prompt into the slot's cache (token-by-token replay)."""
        for t in np.asarray(req.prompt, np.int32)[:-1]:
            batch_tok = np.zeros((self.sc.batch_slots, 1), np.int32)
            batch_tok[slot, 0] = int(t)
            self._step_raw(batch_tok, update_only=slot)

    def run_to_completion(self, max_ticks: int = 10_000) -> None:
        """Drive ticks until every request resolves.

        Raises ``TimeoutError`` naming the stuck request ids if the budget
        runs out -- a serving loop that gives up must say which tenants it
        abandoned, never return as if it drained the queue.
        """
        for _ in range(max_ticks):
            if self.tick() == 0 and not self.queue:
                return
        stuck = sorted([r.rid for r in self.active if r is not None]
                       + [r.rid for r in self.queue])
        raise TimeoutError(
            f"serving engine exhausted max_ticks={max_ticks} with requests "
            f"still in flight: rids={stuck}")
