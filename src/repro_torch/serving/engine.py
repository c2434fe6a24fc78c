"""Continuous-batching serving engine (``repro.serving.engine``'s
counterpart).

Each decode request is a fine-grained task: one new token against that
request's KV cache.  The engine aggregates the active requests into
bucketed batched ``decode_step`` launches -- strategy 3 at the serving
layer:

* requests are admitted into free slots of a slot-array cache between
  steps (continuous batching), each prompt prefilled token by token through
  the bucket-1 launch;
* each engine step launches ONE aggregated ``decode_step`` over the
  smallest bucket of the ladder covering the active slots; pad lanes of a
  partial bucket target a spare free slot;
* per-request ``cache_len`` makes the aggregated batch ragged-correct.

Each launch is the engine bucket's program (``_decode_fn``, filed in
``_decode`` per bucket as the reference jits one per bucket): it gathers
the bucket's slots of every cache leaf, runs ``decode_step`` on them (24
decode-attention and 72 grouped-GEMM kernel launches per step for
qwen2-moe-a2.7b, 9 decode-attention launches for zamba2-2.7b's shared
block, none for xlstm-125m) and scatters the leaves that ``decode_step``
writes back, as the reference does: K and V, or the recurrent families'
mixer states.  On the CPU the program is that eager call; on the card it
is one CUDA graph per bucket
(:class:`~repro_torch.core.graphs.BucketProgram`), every bucket captured
when the engine is made (all slots are free then, and the warm calls'
writes into them are reset) in one memory pool the four graphs share, so
each launch, prefill included, is a replay: the slots and tokens are
copied into the graph, the cache leaves are read and written in place.
The vlm and audio families serve against a stub memory
(``model.stub_batch``: zero vision tokens or frames, as the reference's
engine); its cross-attention K and V
(``model.CROSS_LEAVES``) are computed once at construction, gathered with
the rest and never written back.  Admission resets a slot to the fresh
cache's values, not to zeros: an encoded stub memory is not zero once a
LayerNorm bias is not, mLSTM's stabiliser ``m`` starts at -1e30 and
sLSTM's normaliser ``n`` at ones.

Containment: a ``fault_injector`` poisons the logits rows of matched
requests (payload site ``"decode"``, keyed by request id, the launch
counter as the wave); under ``AggregationConfig(guard="finite")`` a
non-finite row evicts exactly its request and recycles its slot, while the
co-batched requests decode on.  The row flags come back in the same
device-to-host copy as the tokens.  ``healthz()["breakers"]`` reports a
shared ``executor``'s circuit breakers, and ``healthz()["tenants"]``
merges the engine's requests by tenant with an attached ``batcher``'s
(a :class:`~repro_torch.core.sharding.TenantBatcher`) scenario tenants.

Warm start: ``agg.tune_store`` (or ``REPRO_TUNE_STORE``) is opened and
reported in ``stats["tune_store"]`` and ``stats["warm_start"]``.  The
reference points JAX's compilation cache at it, so a restarted server's
bucket programs load instead of compiling; the port's kernels are built
once into the persistent build cache (``kernels._build``) whatever the
store says, and the engine keeps no tuned state of its own.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import AggregationConfig
from repro_torch.core import graphs
from repro_torch.core.faults import FaultInjector, poison_slots
from repro_torch.core.tunestore import TuneStore
from repro_torch.data.pipeline import length_bucket
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as model_mod


def _gather(cache: Dict[str, torch.Tensor],
            slot_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The bucket's slots of every cache leaf (``len`` along axis 0, the
    rest along axis 1), as a cache of its own (copies: ``decode_step``
    writes into them)."""
    with tracing.span("repro_torch.serving.gather"):
        return {name: t.index_select(0 if name == "len" else 1, slot_idx)
                for name, t in cache.items()}


def _scatter(cache: Dict[str, torch.Tensor], slot_idx: torch.Tensor,
             sub: Dict[str, torch.Tensor]) -> None:
    """Write a launch's cache back into its slots: every leaf
    ``decode_step`` writes (the cross K and V it only reads stay).  Pad
    lanes all name the same spare slot, so that slot receives one of them
    (any one: admission resets it)."""
    with tracing.span("repro_torch.serving.scatter"):
        cache["len"][slot_idx] = sub["len"]
        for name, t in sub.items():
            if name != "len" and name not in model_mod.CROSS_LEAVES:
                cache[name][:, slot_idx] = t


class EngineOverloaded(RuntimeError):
    """``submit`` rejected a request because the engine cannot take it:
    the bounded pending queue is full (backpressure), or the engine is
    draining or closed.  Typed so a load balancer can tell overload from
    bad input (``ValueError``)."""


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    # wall-clock budget in seconds from submit(): a request still pending or
    # decoding past its deadline is shed (failed, its slot recycled)
    deadline_s: Optional[float] = None
    tenant: Any = 0                   # healthz() groups queue depth by it
    output: List[int] = field(default_factory=list)
    done: bool = False
    failed: bool = False
    error: Optional[str] = None       # why, when failed
    _deadline: Optional[float] = field(default=None, repr=False)


class ServingEngine:
    def __init__(self, cfg, model: model_mod.Model, *, max_batch: int = 8,
                 max_len: int = 256, max_pending: int = 0,
                 agg: Optional[AggregationConfig] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 executor=None, batcher=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"runs on {self.device}")
        if model.cfg != cfg:
            raise ValueError(f"the model was built for {model.cfg.name}, "
                             f"not for the config given ({cfg.name})")
        self.cfg = cfg
        self.model = model
        # a shared AggregationExecutor whose breakers healthz() reports
        # (anything with ``breaker_states()``); decoding does not use it
        self._executor = executor
        # a TenantBatcher whose tenants healthz() merges into "tenants"
        self._batcher = batcher
        self._injector = fault_injector
        self.max_batch = max_batch
        self.max_len = max_len
        # backpressure: 0 = unbounded; > 0 bounds ``pending`` and submit()
        # rejects with EngineOverloaded
        self.max_pending = max(0, int(max_pending))
        self._draining = False
        self._closed = False
        self.agg = agg or AggregationConfig(max_aggregated=max_batch)
        self.guard = self.agg.guard
        self._store = TuneStore.open(self.agg.tune_store)
        self.buckets = tuple(b for b in self.agg.bucket_sizes()
                             if b <= max_batch) or (max_batch,)
        # a model whose weights require gradients (one a training run
        # holds) serves all the same: no autograd graph is recorded
        with torch.no_grad():
            self.cache = model_mod.init_cache(
                model, max_batch, max_len,
                model_mod.stub_batch(cfg, max_batch, self.device))
        # each leaf's fresh values where they are not all zero (the stub
        # memory's cross K and V, mlstm_m, slstm_n); admission resets the
        # others to zero
        self._fresh = {name: t.clone() for name, t in self.cache.items()
                       if name != "len" and bool(t.any())}
        self.slots_free = list(range(max_batch))
        self.active: Dict[int, Request] = {}     # slot -> request
        self.pending: List[Request] = []
        self.next_token = np.zeros((max_batch,), np.int32)
        self._step_no = 0                        # launch counter ("wave")
        self.stats = {"launches": 0, "tokens": 0, "aggregated_hist": {},
                      "warm_start": self._store is not None,
                      "tune_store": (self._store.root
                                     if self._store is not None else None),
                      "captures": 0, "graph_bytes": 0,
                      "faults": {"trips": 0, "evicted": 0, "shed": 0}}
        self._decode: Dict[int, Any] = {}        # bucket -> its program
        # one pool for every bucket's graph: the engine's launches run one
        # at a time on the caller's stream, each ending in the tokens'
        # device-to-host copy before the next starts, so no two of these
        # graphs ever run at once, each one's intermediates (the bucket's
        # gathered cache) are dead when it ends, and its static logits stay
        # allocated: the pool holds the largest bucket's gather, not all
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        if self.device.type == "cuda":
            self._capture_buckets()

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue one request, rejecting malformed input at submit time."""
        prompt = req.prompt
        if not isinstance(prompt, (list, tuple)) or not prompt:
            raise ValueError(
                f"request {req.rid}: prompt must be a non-empty list of "
                f"token ids, got {type(prompt).__name__}")
        vocab = int(self.cfg.vocab_size)
        for t in prompt:
            if isinstance(t, bool) or not isinstance(t, (int, np.integer)):
                raise ValueError(
                    f"request {req.rid}: prompt token {t!r} is not an int")
            if t < 0 or t >= vocab:
                raise ValueError(
                    f"request {req.rid}: prompt token {int(t)} outside "
                    f"[0, {vocab})")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}")
        if len(prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds the "
                f"engine's max_len {self.max_len}")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(
                f"request {req.rid}: deadline_s must be > 0, got "
                f"{req.deadline_s}")
        if self._closed or self._draining:
            raise EngineOverloaded(
                f"request {req.rid}: engine is "
                f"{'closed' if self._closed else 'draining'} — not "
                f"accepting new requests")
        if self.max_pending and len(self.pending) >= self.max_pending:
            raise EngineOverloaded(
                f"request {req.rid}: pending queue full "
                f"({len(self.pending)}/{self.max_pending}) — retry later")
        if req.deadline_s is not None:
            req._deadline = time.monotonic() + req.deadline_s
        self.pending.append(req)

    def _shed(self, req: Request, where: str) -> None:
        req.failed = True
        req.done = True
        req.error = (f"request {req.rid}: deadline_s={req.deadline_s} "
                     f"exceeded {where} — shed")
        self.stats["faults"]["shed"] += 1

    def _shed_expired(self) -> None:
        """A past-deadline request is failed and its queue entry or live
        slot recycled before the next admit/launch.  A freed slot's cache
        garbage is harmless: admission re-zeroes a slot before reuse."""
        now = time.monotonic()
        kept = []
        for req in self.pending:
            if req._deadline is not None and now > req._deadline:
                self._shed(req, "while queued")
            else:
                kept.append(req)
        self.pending = kept
        for slot, req in list(self.active.items()):
            if req._deadline is not None and now > req._deadline:
                self._shed(req, f"mid-decode (slot {slot})")
                del self.active[slot]
                self.slots_free.append(slot)

    def _admit(self) -> None:
        while self.pending and self.slots_free:
            slot = self.slots_free.pop()
            req = self.pending.pop(0)
            self.active[slot] = req
            self.cache["len"][slot] = 0
            self._zero_slot_states(slot)
            for tok in req.prompt[:-1]:
                self._prefill_token(slot, tok)
                if req.failed:        # the guard evicted it mid-prefill
                    break
            if req.failed:
                continue              # its slot is already recycled
            self.next_token[slot] = req.prompt[-1]

    def _zero_slot_states(self, slot: int) -> None:
        """Reset one slot of every cache leaf but ``len`` (slot axis 1) to
        its fresh values."""
        for name, t in self.cache.items():
            if name in self._fresh:
                t[:, slot] = self._fresh[name][:, slot]
            elif name != "len":
                t[:, slot] = 0

    def _prefill_token(self, slot: int, tok: int) -> None:
        """Single-slot prefill through the bucket-1 decode path."""
        self._launch(np.array([slot]), np.array([tok], np.int32))

    # -- the aggregated decode launch ---------------------------------------
    @torch.inference_mode()
    def _capture_buckets(self) -> None:
        """Capture every bucket's program while every slot is free (slots
        0 .. bucket-1, token 0), then reset each slot to its fresh values:
        the warm calls wrote into them, as pad lanes do."""
        for b in self.buckets:
            self._decode_fn(b)(torch.arange(b), torch.zeros((b, 1),
                                                            dtype=torch.long))
        for name, t in self.cache.items():
            if name in self._fresh:
                t.copy_(self._fresh[name])
            else:
                t.zero_()

    def _decode_fn(self, bucket: int):
        """The bucket's program ``(slot_idx, tokens) -> logits``: gather the
        slots, ``decode_step``, scatter back (``fwd``, as the reference's
        ``_decode_fn``).  On the card its slots and tokens are copied into
        the graph, and its logits are the graph's static output, returned
        without a copy: every launch reads them (argmax, the guard's row
        flags, an injected poison into a new tensor) and ends in the
        tokens' device-to-host copy before the next replay overwrites
        them."""
        fn = self._decode.get(bucket)
        if fn is None:
            # the cache dict and the model, not the engine: a program that
            # held the engine would keep it (and its graphs) alive in a
            # reference cycle
            cache, model, device = self.cache, self.model, self.device

            def fwd(slot_idx, tokens):
                # a graph's static inputs are on the card already
                slot_idx, tokens = slot_idx.to(device), tokens.to(device)
                sub = _gather(cache, slot_idx)
                logits, sub = model_mod.decode_step(model, sub, tokens)
                _scatter(cache, slot_idx, sub)
                return logits

            fn = self._decode[bucket] = graphs.make_program(
                fwd, self.device, copy_in="all", copy_out=False,
                pool=self._pool, stats=self.stats)
        return fn

    def _gather(self, slot_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        return _gather(self.cache, slot_idx)

    def _scatter(self, slot_idx: torch.Tensor,
                 sub: Dict[str, torch.Tensor]) -> None:
        _scatter(self.cache, slot_idx, sub)

    @torch.inference_mode()
    def _launch(self, slots: np.ndarray, toks: np.ndarray) -> np.ndarray:
        n = len(slots)
        bucket = length_bucket(n, self.buckets)
        pad = bucket - n
        if pad:
            # pad lanes target a FREE slot (one exists when n < bucket <=
            # max_batch): their garbage lands in a slot that admission
            # resets, never in a live request's chunk
            taken = set(slots.tolist())
            spare = next(s for s in range(self.max_batch) if s not in taken)
            slots_in = np.concatenate([slots, np.full(pad, spare, np.int64)])
            toks_in = np.concatenate([toks, np.zeros(pad, np.int32)])
        else:
            slots_in, toks_in = slots, toks
        # host tensors: a program on the card copies them into its graph
        slot_idx = torch.as_tensor(slots_in, dtype=torch.long)
        tokens = torch.as_tensor(toks_in, dtype=torch.long)[:, None]
        logits = self._decode_fn(bucket)(slot_idx, tokens)[:n]
        self._step_no += 1
        if self._injector is not None:
            # payload site: one request's logits row goes non-finite
            rids = [self.active[s].rid for s in slots.tolist()]
            hit = self._injector.poison_positions("decode", self._step_no,
                                                  rids)
            if hit:
                logits = poison_slots(logits, sorted(hit), hit)
        self.stats["launches"] += 1
        h = self.stats["aggregated_hist"]
        h[bucket] = h.get(bucket, 0) + 1
        toks_out = torch.argmax(logits, dim=-1)
        if self.guard != "finite":
            return toks_out.cpu().numpy()
        # the row flags ride in the tokens' device-to-host copy
        row_ok = torch.isfinite(logits.reshape(n, -1)).all(dim=1)
        both = torch.stack([toks_out, row_ok.to(toks_out.dtype)]).cpu()
        self._evict_rows(slots, both[1].numpy().astype(bool))
        return both[0].numpy()

    def _evict_rows(self, slots: np.ndarray, row_ok: np.ndarray) -> None:
        """A non-finite logits row belongs to exactly one request (the
        slot-array decode is exact per row): that request fails and is
        evicted, its slot recycled, while the co-batched requests decode
        on.  Its token is never delivered; its slot's cache is reset at the
        next admission."""
        if row_ok.all():
            return
        self.stats["faults"]["trips"] += 1
        for i, slot in enumerate(slots.tolist()):
            if row_ok[i]:
                continue
            req = self.active[slot]
            req.failed = True
            req.done = True
            req.error = (f"request {req.rid}: non-finite logits at decode "
                         f"step {self._step_no} (slot {slot}) — evicted")
            del self.active[slot]
            self.slots_free.append(slot)
            self.stats["faults"]["evicted"] += 1

    # -- engine loop ---------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: shed, admit, aggregate, launch, collect."""
        self._shed_expired()
        self._admit()
        if not self.active:
            return 0
        slots = np.array(sorted(self.active.keys()))
        toks = self.next_token[slots]
        out = self._launch(slots, toks)
        finished = []
        for i, slot in enumerate(slots):
            req = self.active.get(slot)
            if req is None:           # evicted by the guard in this launch
                continue
            tok = int(out[i])
            req.output.append(tok)
            self.next_token[slot] = tok
            if len(req.output) >= req.max_new_tokens:
                req.done = True
                finished.append(slot)
        for slot in finished:
            del self.active[slot]
            self.slots_free.append(slot)
        self.stats["tokens"] += len(slots)
        return len(slots)

    def run(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.pending and not self.active:
                break
            self.step()

    # -- health + lifecycle --------------------------------------------------
    def healthz(self) -> Dict[str, object]:
        """Capacity (free slots, queue depth against its bound), lifecycle
        state, the cumulative fault counters and a shared executor's
        per-family breaker states."""
        f = self.stats["faults"]
        return {
            "slots_free": len(self.slots_free),
            "active": len(self.active),
            "queue_depth": len(self.pending),
            "max_pending": self.max_pending,
            "max_batch": self.max_batch,
            "draining": self._draining,
            "closed": self._closed,
            "trips": f["trips"],
            "evicted": f["evicted"],
            "shed": f["shed"],
            "breakers": (self._executor.breaker_states()
                         if self._executor is not None else {}),
            "tenants": self._tenant_health(),
        }

    def _tenant_health(self) -> Dict[str, object]:
        """The engine's pending and active requests grouped by tenant,
        merged with an attached batcher's tenants (queue depths added,
        its shard occupancy)."""
        queue: Dict[object, int] = {}
        for r in self.pending:
            queue[r.tenant] = queue.get(r.tenant, 0) + 1
        active: Dict[object, int] = {}
        for r in self.active.values():
            active[r.tenant] = active.get(r.tenant, 0) + 1
        occupancy: List[int] = []
        if self._batcher is not None:
            bh = self._batcher.healthz()
            for tid, depth in bh.get("queue_depth", {}).items():
                queue[tid] = queue.get(tid, 0) + depth
            occupancy = bh.get("shard_occupancy", [])
        return {"count": len(set(queue) | set(active)), "queue_depth": queue,
                "active": active, "shard_occupancy": occupancy}

    def drain(self, max_steps: int = 10000) -> None:
        """Stop admitting new requests (submit raises EngineOverloaded) but
        run until everything accepted has finished or been shed."""
        self._draining = True
        self.run(max_steps)

    def close(self, max_steps: int = 10000) -> None:
        """Drain, then close permanently and drop the bucket programs (a
        closed engine rejects every submit)."""
        self.drain(max_steps)
        self._closed = True
        self._decode.clear()
