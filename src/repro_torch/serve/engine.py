"""Batched serving engine (counterpart of ``repro.serve.engine``).

Slot-based continuous batching over a fixed decode batch B:

  * requests (prompts) queue up; a free slot is filled by prefilling its
    prompt and splicing the prompt's cache (kv, or the recurrent state of
    RG-LRU, mLSTM and sLSTM layers) into slot b of the live batch cache;
  * one ``decode_step`` advances ALL slots a token per tick;
  * finished slots (EOS or ``max_new_tokens``) are harvested and recycled.

Prefill takes the model's attention route (the ``flash`` route runs the
CUDA ``flash_attention`` kernel on the card); decode is plain torch.
Prefill reads the prompt's tokens alone, as the JAX package's engine
does, so a family that needs more (a VLM's patch embeddings, audio's
conditioning) is served by ``Model.prefill`` and ``decode_step``.

:class:`CollabServeEngine` is the gossip-backed personalization service:
batched reads of users' personalized models from an agent-state store
that a scenario run commits to (DESIGN.md §16).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparse import personalized_predict
from repro_torch.models import Model

from .store import MixedModelCache, ServeReport


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Decode-serving knobs: batch geometry, sampling, cache layout."""

    batch_size: int = 4
    cache_len: int = 256
    max_new_tokens: int = 64
    temperature: float = 0.0       # 0 => greedy
    eos_id: Optional[int] = None
    ring: bool = False
    seed: int = 0


def sample_token(logits, generator: torch.Generator, temperature: float):
    """Greedy argmax (the first maximum) at temperature 0, else a draw
    from ``softmax(logits / temperature)`` on ``generator``.  (JAX's
    draws cannot be reproduced, so only greedy runs compare across the two
    frameworks.)"""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator) \
        .reshape(probs.shape[:-1]).to(torch.int32)


@dataclasses.dataclass
class _Slot:
    request_id: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    remaining: int = 0
    active: bool = False


class Engine:
    """Token-decode serving engine (slot-based continuous batching) over
    ``model``, which holds its weights.

    After :meth:`run` returns, ``self.exhausted`` records whether the
    tick budget ran out with work still queued or in flight — callers
    must check it before treating the returned dict as complete.
    """

    def __init__(self, model: Model, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        B = cfg.batch_size
        self.cache = model.init_cache(B, cfg.cache_len)
        self.slots = [_Slot() for _ in range(B)]
        self._results: Dict[int, List[int]] = {}
        self._next_id = 0
        self._gen = torch.Generator(device=model.device)
        self._gen.manual_seed(cfg.seed)
        self._pending: List[Tuple[int, np.ndarray]] = []
        self.exhausted = False
        # token fed to idle slots (content irrelevant — output discarded)
        self._last_tok = np.zeros(self._tok_shape(B), np.int32)

    def _tok_shape(self, B):
        if self.model.cfg.family == "audio":
            return (B, self.model.cfg.n_codebooks)
        return (B,)

    # -- public API ----------------------------------------------------------

    def submit(self, prompt_tokens) -> int:
        """Queue a prompt; returns the request id."""
        rid = self._next_id
        self._next_id += 1
        self._pending.append((rid, np.asarray(prompt_tokens, np.int32)))
        return rid

    def result(self, rid: int) -> Optional[List[int]]:
        """Decoded tokens for a finished request id (None if pending)."""
        return self._results.get(rid)

    def run(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        """Drive until all submitted requests finish, or ``max_ticks``
        ticks (then ``self.exhausted`` is set)."""
        ticks = 0
        while (self._pending or any(s.active for s in self.slots)) \
                and ticks < max_ticks:
            self._fill_slots()
            self._tick()
            ticks += 1
        self.exhausted = bool(self._pending
                              or any(s.active for s in self.slots))
        return dict(self._results)

    # -- internals -----------------------------------------------------------

    def _prefill_one(self, tokens):
        return self.model.prefill({"tokens": tokens},
                                  cache_len=self.cfg.cache_len)

    def _decode(self, token):
        return self.model.decode_step(self.cache, {"token": token},
                                      ring=self.cfg.ring)

    def _fill_slots(self):
        dev = self.model.device
        for b, slot in enumerate(self.slots):
            if slot.active or not self._pending:
                continue
            rid, prompt = self._pending.pop(0)
            tokens = torch.as_tensor(prompt[None], device=dev)
            logits, pcache = self._prefill_one(tokens)
            # splice this request's cache into slot b of the live batch:
            # every leaf of every layer's entry
            for live, new in zip(self.cache["layers"], pcache["layers"]):
                for name, leaf in live.items():
                    leaf[b] = new[name][0]
            self.cache["pos"][b] = pcache["pos"][0]
            first = int(sample_token(logits[:, 0], self._gen,
                                     self.cfg.temperature)[0])
            self._last_tok[b] = first
            slot.request_id = rid
            slot.generated = [first]
            slot.remaining = self.cfg.max_new_tokens - 1
            slot.active = True

    def _tick(self):
        tok = torch.as_tensor(self._last_tok, device=self.model.device)
        logits, self.cache = self._decode(tok)
        nxt = sample_token(logits, self._gen,
                           self.cfg.temperature).cpu().numpy()
        for b, slot in enumerate(self.slots):
            if not slot.active:
                continue
            t = int(nxt[b])
            slot.generated.append(t)
            slot.remaining -= 1
            self._last_tok[b] = t
            if slot.remaining <= 0 or (self.cfg.eos_id is not None
                                       and t == self.cfg.eos_id):
                self._results[slot.request_id] = slot.generated
                slot.active = False


class CollabServeEngine:
    """Personalization service over a gossip-backed agent-state store.

    The scenario run is the writer: it commits each record chunk's
    models, staleness and dirty set (:meth:`commit`).  Inference
    requests are readers: :meth:`serve` takes ``batch_size`` users at a
    time, gathers their rows through the :class:`MixedModelCache` (the
    store for misses) and predicts with ``personalized_predict`` over the
    whole (B, p) row block on the store's device.
    """

    def __init__(self, store, n: int, p: int, batch_size: int = 256):
        self.store = store
        self.n = int(n)
        self.p = int(p)
        self.batch_size = int(batch_size)
        self.cache = MixedModelCache(n, p, device=store.device)
        self._served_staleness: List[np.ndarray] = []
        self.requests = 0

    # -- writer side ---------------------------------------------------------

    def commit(self, round_: int, theta, staleness, dirty=None) -> int:
        """Publish a chunk's snapshot and void its dirty cache entries
        (``dirty`` an (n,) bool model-update delivery mask); returns how
        many live entries it voided."""
        self.store.commit(round_, theta, staleness)
        return self.cache.invalidate(dirty) if dirty is not None else 0

    # -- reader side ---------------------------------------------------------

    def serve(self, users, x=None):
        """Serve a batch of requests from the committed state.

        ``users`` (R,) user ids; ``x`` optional (R, p) feature rows (all
        ones by default: the prediction is the row sum, the linear model
        family of paper §5 with trivial features).  Returns ``(preds (R,)
        float32, staleness (R,) int32)`` as numpy; the staleness is kept
        for :meth:`report`.
        """
        dev = self.store.device
        users = torch.as_tensor(np.asarray(users, np.int64), device=dev)
        preds, stale = [], []
        for lo in range(0, users.shape[0], self.batch_size):
            u = users[lo:lo + self.batch_size]
            hit, rows, stl = self.cache.lookup(u, self.store.snapshot_round())
            if not bool(hit.all()):
                miss = ~hit
                read = self.store.read_rows(u[miss])
                rows[miss] = read.theta  # scatter: unique targets (mask)
                stl[miss] = read.staleness  # scatter: unique targets (mask)
                self.cache.fill(u[miss], read.theta, read.staleness,
                                read.round)
            xb = (torch.ones_like(rows) if x is None else torch.as_tensor(
                np.asarray(x[lo:lo + self.batch_size], np.float32),
                device=dev))
            preds.append(personalized_predict(rows, xb))
            stale.append(stl)
        R = int(users.shape[0])
        preds = torch.cat(preds).cpu().numpy() if preds else \
            np.zeros(0, np.float32)
        stale = torch.cat(stale).cpu().numpy() if stale else \
            np.zeros(0, np.int32)
        self.requests += R
        self._served_staleness.append(stale)
        return preds, stale

    def report(self, requests_c=None, hits_c=None, misses_c=None,
               invalidations_c=None) -> ServeReport:
        """The engine's accounting as a :class:`ServeReport`."""
        served = (np.concatenate(self._served_staleness)
                  if self._served_staleness else np.zeros(0, np.int32))

        def col(c):
            return np.asarray(c, np.int64) if c is not None \
                else np.zeros(0, np.int64)
        return ServeReport(
            requests=self.requests, hits=self.cache.hits,
            misses=self.cache.misses,
            invalidations=self.cache.invalidations,
            served_staleness=served, requests_c=col(requests_c),
            hits_c=col(hits_c), misses_c=col(misses_c),
            invalidations_c=col(invalidations_c))
