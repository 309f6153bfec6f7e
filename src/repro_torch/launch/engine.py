"""Continuous-batching serving engine over the SALR kernel path.

A fixed set of ``n_slots`` cache rows each hold one in-flight request at
its own absolute position, so one ``decode_step`` advances every active
request per tick and a finished request frees its slot at once.  Prompts
are right-padded to a small set of bucket lengths; the padded tail is
causally invisible during prefill and masked (then overwritten) by the
per-slot decode position, so padding changes no token.

KV storage is PAGED when the resolved plan's decode route says so (the
resolver default), at the decode route's KV precision (native, int8 or
NF4): each layer's K/V live in a global pool of
``page_size``-position pages with a per-slot ``page_table``.  A
host-side reference-counted ``PagePool`` hands out pages at admission,
and a ``RadixCache`` over prompt token ids lets a later request reuse the
full prompt pages an earlier one prefilled: the hit prefix is gathered
into a dense batch=1 cache and only the prompt suffix is prefilled
(native decode KV only: a quantized pool turns sharing off).
Admission is FIFO and memory-pressure aware (the head waits while free
pages, after LRU eviction of unreferenced radix leaves, do not suffice).

Every forward runs the execution plan resolved once at construction:
prefill ticks its prefill route, decode ticks its decode route (an MoE
layer's route from the largest bucket and the slot count).  Engine
tokens equal ``greedy_generate``'s for the same prompts and plan up to
floating-point ties (every linear and expert kernel reduces each row in
an order that does not depend on the batch, and the two MoE kernel
routes are bitwise equal per row, so the plans may even differ in their
MoE routes).
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import execplan
from repro_torch.models import model as M


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine shape/scheduling parameters."""
    n_slots: int = 4              # decode batch rows (max in-flight requests)
    max_ctx: int = 64             # per-slot positions (prompt + generated)
    buckets: tuple = ()           # prefill lengths; () -> powers of two
    backend: str = "kernel"       # execution-plan backend for all forwards
    plan: Optional[execplan.ExecutionPlan] = None   # overrides ``backend``
    max_prefills_per_tick: int = 1
    pad_id: int = 0
    page_size: int = 8            # cache positions per pool page
    # pool pages INCLUDING the null page 0; None: every slot can hold max_ctx
    n_pages: Optional[int] = None
    prefix_sharing: bool = True   # radix prefix cache


def default_buckets(max_ctx: int, lo: int = 8) -> tuple:
    """Powers of two in [lo, max_ctx] (plus max_ctx when not a power)."""
    out, b = [], lo
    while b < max_ctx:
        out.append(b)
        b *= 2
    out.append(max_ctx)
    return tuple(dict.fromkeys(out))


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length."""
    bs = sorted(buckets)
    i = bisect.bisect_left(bs, length)
    if i == len(bs):
        raise ValueError(f"prompt length {length} exceeds largest prefill "
                         f"bucket {bs[-1]}")
    return bs[i]


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: tuple                 # token ids
    max_new_tokens: int
    arrival: float = 0.0          # seconds on the engine clock


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: list
    arrival: float
    admitted_at: float
    first_token_at: float
    finished_at: float

    @property
    def ttft(self) -> float:
        return self.first_token_at - self.arrival

    @property
    def latency(self) -> float:
        return self.finished_at - self.arrival


@dataclasses.dataclass
class _Active:
    req: Request
    result: RequestResult
    slot: int
    pages: Optional[list] = None  # pool pages this request references


class PagePool:
    """Host-side reference-counted page allocator over a global pool.

    Page 0 is the reserved null page and is never handed out.  A page's
    refcount is the number of active requests reading it plus one if the
    radix tree holds it; it returns to the free list only at zero."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.refs = np.zeros((n_pages,), np.int32)
        self._free = list(range(n_pages - 1, 0, -1))  # pop() -> lowest first

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list]:
        """n fresh pages at refcount 1, or None if the pool can't cover."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        return pages

    def incref(self, pages) -> None:
        for p in pages:
            if self.refs[p] <= 0:
                raise RuntimeError(f"incref on free page {p}")
            self.refs[p] += 1

    def decref(self, pages) -> list:
        freed = []
        for p in pages:
            if self.refs[p] <= 0:
                raise RuntimeError(f"decref underflow on page {p}")
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed


class _RadixNode:
    __slots__ = ("children", "key", "page", "parent", "last_used")

    def __init__(self, key=None, page=None, parent=None):
        self.children: dict = {}
        self.key = key
        self.page = page
        self.parent = parent
        self.last_used = 0


class RadixCache:
    """Page-granularity radix tree over prompt token ids.

    A node is one FULL page keyed by its page_size-token tuple.  Holding a
    node counts as one pool reference on its page; eviction drops
    least-recently-used leaves whose page only the tree references."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.root = _RadixNode()
        self._clock = 0

    def match(self, page_keys) -> list:
        """Longest-prefix match; returns the hit pages (touches LRU)."""
        self._clock += 1
        node, pages = self.root, []
        for key in page_keys:
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock
            pages.append(child.page)
            node = child
        return pages

    def insert(self, page_keys, pages) -> None:
        """Register a prompt's full-page path; a key already present is
        only LRU-touched (the caller's duplicate page stays request-owned)."""
        self._clock += 1
        node = self.root
        for key, page in zip(page_keys, pages):
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key=key, page=page, parent=node)
                node.children[key] = child
                self.pool.incref([page])      # the tree's own reference
            child.last_used = self._clock
            node = child

    def evict(self, n: int) -> int:
        """Free up to n pages by dropping LRU leaves at refcount 1; returns
        the number freed."""
        freed = 0
        while freed < n:
            victim = None
            stack = [self.root]
            while stack:
                nd = stack.pop()
                for ch in nd.children.values():
                    if ch.children:
                        stack.append(ch)
                    elif self.pool.refs[ch.page] == 1 and (
                            victim is None or ch.last_used < victim.last_used):
                        victim = ch
            if victim is None:
                return freed
            del victim.parent.children[victim.key]
            self.pool.decref([victim.page])
            freed += 1
        return freed


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over one model's decode cache.

    Drive it with ``run(requests)`` (drains the queue, returns results and
    metrics) or ``submit`` + repeated ``step()``.  It runs on the device
    that holds ``params``, under ``torch.inference_mode()``."""

    @torch.inference_mode()
    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig = None,
                 time_fn: Callable[[], float] = time.perf_counter):
        ecfg = ecfg or EngineConfig()
        M.layer_kinds(cfg)                    # raises for unported families
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = M.params_device(params)
        self.buckets = tuple(sorted(ecfg.buckets or default_buckets(ecfg.max_ctx)))
        self._time = time_fn
        # one plan per engine: a prefill tick runs one request at bucket
        # scale (the largest bucket bounds the MoE crossover lookup), a
        # decode tick n_slots tokens; greedy_generate must be handed this
        # plan to take the same routes
        self.plan = ecfg.plan or execplan.resolve_plan(
            cfg, backend=ecfg.backend,
            phase_tokens={"prefill": max(self.buckets), "decode": ecfg.n_slots})
        self.paged = self.plan.kv_layout("decode") == "paged"
        self.page_size = ecfg.page_size
        self.max_pages = -(-ecfg.max_ctx // ecfg.page_size)
        self.n_pages = (ecfg.n_pages if ecfg.n_pages is not None
                        else ecfg.n_slots * self.max_pages + 1)
        # the decode cache is allocated at the decode route's KV
        # precision; a native prefill cache is quantized at insert.  Shared
        # prefix pages would have to be gathered back into a native prefix
        # cache, so sharing needs native decode KV
        kv_dt = self.plan.kv_dtype("decode")
        self.sharable = self.paged and ecfg.prefix_sharing and kv_dt == "native"
        if self.paged:
            self.cache = M.init_paged_slot_cache(
                cfg, ecfg.n_slots, ecfg.max_ctx, page_size=ecfg.page_size,
                n_pages=self.n_pages, device=self.device, kv_dtype=kv_dt)
        else:
            self.cache = M.init_slot_cache(cfg, ecfg.n_slots, ecfg.max_ctx,
                                           self.device, kv_dtype=kv_dt)
        self.reset()

    @torch.inference_mode()
    def reset(self) -> None:
        """Clear all scheduling state and metric accumulators; keep the
        cache buffers (stale rows are masked or overwritten by design)."""
        n = self.ecfg.n_slots
        self.slots: list = [None] * n         # Optional[_Active] per slot
        self._last_tok = np.zeros((n,), np.int32)
        self._pos = np.zeros((n,), np.int32)
        self.pending: list = []               # sorted by (arrival, rid)
        self.results: dict = {}
        self.now = 0.0
        self._queue_depths: list = []
        self._occupancy: list = []
        self._admit_waits: list = []
        self._bucket_counts: dict = {}
        self.n_prefills = 0
        self.n_decode_ticks = 0
        self.pool = PagePool(self.n_pages) if self.paged else None
        self.radix = RadixCache(self.pool) if self.paged else None
        self.n_evictions = 0
        self._pages_per_req: list = []
        self._shared_prompt_tokens = 0
        self._total_prompt_tokens = 0
        self._n_prefix_hits = 0
        if self.paged:
            self._page_table = np.zeros((n, self.max_pages), np.int32)
            self._push_page_table()

    def _push_page_table(self) -> None:
        self.cache["page_table"].copy_(torch.from_numpy(self._page_table))

    # ------------------------------------------------------------- intake

    def submit(self, req: Request) -> None:
        length = len(req.prompt)
        bucket = pick_bucket(length, self.buckets)
        last_pos = length + req.max_new_tokens - 1
        if max(bucket, last_pos) > self.ecfg.max_ctx:
            raise ValueError(
                f"request {req.rid}: prompt {length} + {req.max_new_tokens} "
                f"new tokens does not fit max_ctx={self.ecfg.max_ctx}")
        if self.paged:
            need = -(-max(bucket, last_pos + 1) // self.page_size)
            if need > self.n_pages - 1:
                raise ValueError(
                    f"request {req.rid}: needs {need} pages but the pool "
                    f"holds {self.n_pages - 1} (page 0 is reserved)")
        bisect.insort(self.pending, (req.arrival, req.rid, req))

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def free_slots(self) -> list:
        return [i for i, s in enumerate(self.slots) if s is None]

    # ---------------------------------------------------------- scheduler

    def _page_keys(self, prompt) -> list:
        ps = self.page_size
        return [tuple(prompt[i * ps:(i + 1) * ps]) for i in range(len(prompt) // ps)]

    def _page_plan(self, req: Request):
        """(hit_pages, n_new, bucket, lp): radix pages covering the first
        ``lp`` prompt tokens (leaving at least one suffix token, and a
        suffix bucket that fits the slot's page extent) and the fresh
        pages covering max(prefill write extent, prompt + generation)."""
        length = len(req.prompt)
        ps = self.page_size
        hit: list = []
        if self.sharable:
            hit = self.radix.match(self._page_keys(req.prompt))
            usable = min(len(hit), (length - 1) // ps)
            cap = self.max_pages * ps
            while usable and (usable * ps
                              + pick_bucket(length - usable * ps, self.buckets) > cap):
                usable -= 1
            hit = hit[:usable]
        lp = len(hit) * ps
        bucket = pick_bucket(length - lp, self.buckets)
        total_pos = max(lp + bucket, length + req.max_new_tokens)
        n_total = min(-(-total_pos // ps), self.max_pages)
        return hit, n_total - len(hit), bucket, lp

    def _pages_available(self, req: Request) -> bool:
        """Can the FIFO head be admitted now?  Tries LRU radix eviction to
        cover a shortfall; never touches referenced pages."""
        if not self.paged:
            return True
        hit, n_new, _, _ = self._page_plan(req)
        if n_new > self.pool.n_free:
            self.pool.incref(hit)             # shield the head's own hit path
            self.n_evictions += self.radix.evict(n_new - self.pool.n_free)
            self.pool.decref(hit)
        return n_new <= self.pool.n_free

    def _admit(self, req: Request, slot: int) -> None:
        length = len(req.prompt)
        hit: list = []
        lp = 0
        if self.paged:
            hit, n_new, bucket, lp = self._page_plan(req)
            new_pages = self.pool.alloc(n_new)
            if new_pages is None:
                raise RuntimeError("admission without free pages")
            self.pool.incref(hit)             # this request's ref on shared pages
            pages = hit + new_pages
            self._page_table[slot] = 0
            self._page_table[slot, :len(pages)] = pages
            self._push_page_table()
            self._pages_per_req.append(len(pages))
            self._shared_prompt_tokens += lp
            self._total_prompt_tokens += length
            self._n_prefix_hits += bool(lp)
        else:
            pages = None
            bucket = pick_bucket(length, self.buckets)
        suffix = req.prompt[lp:]
        padded = np.full((1, bucket), self.ecfg.pad_id, np.int32)
        padded[0, :len(suffix)] = np.asarray(suffix, np.int32)
        tokens = torch.from_numpy(padded).to(self.device)
        self._admit_waits.append(max(0.0, self.now - req.arrival))
        t0 = self._time()
        prefix_cache = None
        if lp:
            prefix_cache = M.gather_prefix_cache(
                self.cache, torch.tensor(hit, device=self.device))
        logits, rcache = M.prefill(self.params, self.cfg, tokens,
                                   logit_index=len(suffix) - 1, plan=self.plan,
                                   prefix_cache=prefix_cache, pos_offset=lp)
        if self.paged:
            M.insert_paged_cache_slot(self.cache, rcache, slot, lp)
        else:
            M.insert_cache_slot(self.cache, rcache, slot)
        tok0 = int(logits[0, -1].argmax())
        _sync(self.device)
        self.now += self._time() - t0
        self.n_prefills += 1
        self._bucket_counts[bucket] = self._bucket_counts.get(bucket, 0) + 1
        if self.sharable:
            keys = self._page_keys(req.prompt)
            self.radix.insert(keys, pages[:len(keys)])
        res = RequestResult(rid=req.rid, tokens=[tok0], arrival=req.arrival,
                            admitted_at=self.now, first_token_at=self.now,
                            finished_at=float("nan"))
        act = _Active(req=req, result=res, slot=slot, pages=pages)
        self._last_tok[slot] = tok0
        self._pos[slot] = length
        self.slots[slot] = act
        if len(res.tokens) >= req.max_new_tokens:
            self._finish(act)

    def _finish(self, act: _Active) -> None:
        act.result.finished_at = self.now
        self.results[act.req.rid] = act.result
        self.slots[act.slot] = None
        if self.paged and act.pages is not None:
            # the slot's row drops to the null page, so its stale decode
            # writes can never corrupt a reallocated page
            self.pool.decref(act.pages)
            self._page_table[act.slot] = 0
            self._push_page_table()

    def _decode_tick(self) -> None:
        tokens = torch.from_numpy(self._last_tok[:, None].copy()).to(self.device)
        pos = torch.from_numpy(self._pos.copy()).to(self.device)
        t0 = self._time()
        logits, self.cache = M.decode_step(self.params, self.cfg, self.cache,
                                           tokens, pos, plan=self.plan)
        nxt = logits[:, -1].argmax(dim=-1).cpu().numpy()   # waits for the step
        self.now += self._time() - t0
        self.n_decode_ticks += 1
        self._occupancy.append(self.n_active)
        for slot, act in enumerate(self.slots):
            if act is None:
                continue
            act.result.tokens.append(int(nxt[slot]))
            self._last_tok[slot] = nxt[slot]
            self._pos[slot] += 1
            if len(act.result.tokens) >= act.req.max_new_tokens:
                self._finish(act)

    @torch.inference_mode()
    def step(self) -> bool:
        """One tick: admit arrived requests into free slots, then advance
        every active slot by one token.  False when fully drained."""
        self._queue_depths.append(len(self.pending))
        admitted = 0
        while (self.pending and self.slots.count(None)
               and self.pending[0][0] <= self.now
               and admitted < self.ecfg.max_prefills_per_tick):
            if not self._pages_available(self.pending[0][2]):
                break                 # head-of-line blocks on page pressure
            _, _, req = self.pending.pop(0)
            self._admit(req, self.free_slots()[0])
            admitted += 1
        if self.n_active:
            self._decode_tick()
            return True
        if self.pending:                      # idle: jump to next arrival
            self.now = max(self.now, self.pending[0][0])
            return True
        return False

    def run(self, requests: Optional[Sequence[Request]] = None):
        """Drain the queue; returns ({rid: RequestResult}, metrics)."""
        for r in requests or ():
            self.submit(r)
        while self.step():
            pass
        return self.results, self.metrics()

    # ------------------------------------------------------------ metrics

    def metrics(self) -> dict:
        done = list(self.results.values())
        total_tok = sum(len(r.tokens) for r in done)
        ttfts = sorted(r.ttft for r in done) or [float("nan")]
        return {
            "requests": len(done),
            "total_tokens": total_tok,
            "wall_s": self.now,
            "tok_s": total_tok / self.now if self.now > 0 else float("nan"),
            "ttft_mean_s": float(np.mean(ttfts)),
            "ttft_p50_s": ttfts[len(ttfts) // 2],
            "ttft_max_s": ttfts[-1],
            "queue_depth_mean": (float(np.mean(self._queue_depths))
                                 if self._queue_depths else 0.0),
            "queue_depth_max": max(self._queue_depths, default=0),
            "slot_occupancy_mean": (float(np.mean(self._occupancy))
                                    if self._occupancy else 0.0),
            "admission_wait_mean_s": (float(np.mean(self._admit_waits))
                                      if self._admit_waits else 0.0),
            "prefills_per_bucket": dict(sorted(self._bucket_counts.items())),
            "n_prefills": self.n_prefills,
            "n_decode_ticks": self.n_decode_ticks,
            "n_slots": self.ecfg.n_slots,
            "buckets": self.buckets,
            "kv_layout": "paged" if self.paged else "dense",
            "page_size": self.page_size if self.paged else 0,
            "n_pages": self.n_pages if self.paged else 0,
            "pages_free": self.pool.n_free if self.paged else 0,
            "pages_per_request_mean": (float(np.mean(self._pages_per_req))
                                       if self._pages_per_req else 0.0),
            "prefix_hit_rate": (self._shared_prompt_tokens / self._total_prompt_tokens
                                if self._total_prompt_tokens else 0.0),
            # prefills that continued a shared prefix (their continuation
            # prefill reads the prefix's cache)
            "n_prefix_hits": self._n_prefix_hits,
            "evictions": self.n_evictions,
            "backend": self.ecfg.backend if self.ecfg.plan is None else "custom-plan",
            "plan": self.plan.describe(),
            # the precision each phase ran at (an explicit plan overrides
            # the config's knobs)
            "precision": {ph: {"repr": self.plan.base_repr(ph),
                               "kv_dtype": self.plan.kv_dtype(ph)}
                          for ph in execplan.PHASES},
            "device": str(self.device),
        }
