"""Continuous-batching scheduler: the serving plane's rank-0 brain.

Own copy of ``horovod_tpu/serving/scheduler.py`` (pure Python, no torch),
with the elastic reshape's ``reform``.  Iteration-level scheduling (Orca,
Yu et al., OSDI'22): every decode step the batch is re-formed from
whatever requests are live.  New requests join at step boundaries
(chunked prefill, so a long prompt cannot stall the running decodes),
finished ones retire at once and their KV blocks return to the pool (no
head-of-line blocking on the longest sequence).  Every policy decision
(admission, quotas, priority, block accounting, preemption, retirement)
is unit-testable in-process, and the engine consumes it only through
:class:`Plan`: a fixed-shape int32 array broadcast from rank 0 through the
ordinary named-collective path, so the engine's negotiation response
cache makes steady-state decode steps pay no coordinator round trip.

Admission is bounded end to end: a global queue cap and a per-tenant
in-flight cap shed load with a typed rejection (the HTTP front door turns
it into a 429) instead of growing queues without bound.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from horovod_tpu_torch.common import metrics
from horovod_tpu_torch.serving.kv_cache import BlockPool

# Batch-plan opcodes (plan[0]); workers follow rank 0's broadcast.
OP_IDLE = 0   # nothing to run this tick (workers just loop)
OP_STEP = 1   # run the decode step described by the slot records
OP_STOP = 2   # orderly shutdown: every rank leaves the serve loop

# Typed admission-rejection reasons (HTTP 429 / 400 bodies).
REJECT_QUEUE_FULL = "queue_full"
REJECT_TENANT_QUOTA = "tenant_quota"
REJECT_TOO_LONG = "too_long"

# Request-trace bounds:
# per-request span cap (a 100k-token decode must not grow a span list
# unboundedly — overflow is counted, terminal events always land) and the
# completed-trace store size served by GET /v1/trace?id=.
_MAX_SPANS = 512
_MAX_TRACES = 256
_TERMINAL_SPANS = ("retired", "preempted", "failed")


class AdmissionError(Exception):
    """A request was shed at admission.  ``reason`` is one of the
    ``REJECT_*`` constants; the front door maps it to a typed 429 (or 400
    for ``too_long``, which retrying cannot fix)."""

    def __init__(self, reason: str, tenant: str, detail: str):
        super().__init__(detail)
        self.reason = reason
        self.tenant = tenant


class ServingUnavailableError(Exception):
    """The serving plane lost its engine (fatal collective error,
    shutdown): in-flight and new requests fail typed, never hang."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-plane shape knobs (env: ``HVD_TPU_SERVE_*``)."""

    max_batch: int = 8             # decode batch slots
    prefill_chunk: int = 16        # prompt tokens consumed per step/slot
    block_tokens: int = 16         # tokens per KV block
    num_blocks: int = 128          # KV block pool size (all layers share)
    max_blocks_per_seq: int = 16   # per-request context cap, in blocks
    queue_limit: int = 64          # global admission queue bound
    tenant_max_inflight: int = 16  # per-tenant queued+active cap
    eos_id: int = -1               # stop token (< 0: length-only stop)
    idle_sleep_sec: float = 0.005  # rank-0 throttle between idle ticks
    request_timeout_sec: float = 300.0  # front-door long-poll bound
    ring_min_tokens: int = 0       # >=: bulk ring-prefill (0 = chunked)
    port: int = 8780               # HTTP front door (rank 0)

    @property
    def max_seq(self) -> int:
        """Per-request context ceiling (prompt + generated), tokens."""
        return self.block_tokens * self.max_blocks_per_seq

    @staticmethod
    def from_env() -> "ServeConfig":
        def _int(name, default):
            return int(os.environ.get(f"HVD_TPU_SERVE_{name}") or default)

        def _float(name, default):
            return float(os.environ.get(f"HVD_TPU_SERVE_{name}") or default)

        d = ServeConfig()
        return ServeConfig(
            max_batch=_int("MAX_BATCH", d.max_batch),
            prefill_chunk=_int("PREFILL_CHUNK", d.prefill_chunk),
            block_tokens=_int("BLOCK_TOKENS", d.block_tokens),
            num_blocks=_int("KV_BLOCKS", d.num_blocks),
            max_blocks_per_seq=_int("MAX_BLOCKS_PER_SEQ",
                                    d.max_blocks_per_seq),
            queue_limit=_int("QUEUE", d.queue_limit),
            tenant_max_inflight=_int("TENANT_INFLIGHT",
                                     d.tenant_max_inflight),
            eos_id=_int("EOS", d.eos_id),
            idle_sleep_sec=_float("IDLE_SLEEP_SEC", d.idle_sleep_sec),
            request_timeout_sec=_float("REQUEST_TIMEOUT_SEC",
                                       d.request_timeout_sec),
            ring_min_tokens=_int("RING_MIN_TOKENS", d.ring_min_tokens),
            port=_int("PORT", d.port),
        )


# Request lifecycle states.
QUEUED, ACTIVE, DONE, FAILED = "queued", "active", "done", "failed"


class Request:
    """One generate request.  The front door blocks on ``event``; the
    scheduler owns every other field under its lock."""

    _ids = itertools.count()

    def __init__(self, tenant: str, prompt_ids: Sequence[int],
                 max_new_tokens: int, priority: int = 0):
        self.id = next(Request._ids)
        self.tenant = tenant
        self.prompt_ids = [int(t) for t in prompt_ids]
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.state = QUEUED
        self.generated: List[int] = []
        self.blocks: List[int] = []
        self.slot: Optional[int] = None
        # Tokens already written to the KV cache.  The feed (prompt, then
        # generated tokens re-fed one per decode step) restarts from 0
        # after a preemption — generated tokens are kept, so generation
        # resumes exactly where it stopped once re-prefilled.
        self.filled = 0
        self.finish_seq: Optional[int] = None  # retirement order stamp
        self.error: Optional[Exception] = None
        self.event = threading.Event()
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        # Request trace: ordered span records through the lifecycle,
        # served by GET /v1/trace?id= and kept in a bounded store at
        # retirement.  Bounded; terminal events always record.
        self.spans: List[dict] = [{"event": "submitted", "t_ms": 0.0}]
        self.dropped_spans = 0

    def span(self, event: str, now: Optional[float] = None,
             **fields) -> None:
        if len(self.spans) >= _MAX_SPANS and event not in _TERMINAL_SPANS:
            self.dropped_spans += 1
            return
        rec = {"event": event,
               "t_ms": round(((now if now is not None else time.monotonic())
                              - self.t_submit) * 1e3, 3)}
        rec.update(fields)
        self.spans.append(rec)

    @property
    def feed(self) -> List[int]:
        """The token stream that must reach the cache: the prompt, then
        every generated token except the last (which only needs to be fed
        back if generation continues)."""
        return self.prompt_ids + self.generated

    def to_result(self) -> dict:
        return {
            "id": self.id,
            "tenant": self.tenant,
            "prompt_tokens": len(self.prompt_ids),
            "tokens": list(self.generated),
            "finish_seq": self.finish_seq,
            "ttft_ms": (round((self.t_first_token - self.t_submit) * 1e3, 3)
                        if self.t_first_token else None),
            "latency_ms": (round((self.t_done - self.t_submit) * 1e3, 3)
                           if self.t_done else None),
        }


@dataclasses.dataclass
class SlotPlan:
    slot: int
    request_id: int
    tokens: List[int]      # tokens to embed this step (<= prefill_chunk)
    n_new: int             # how many of `tokens` are real
    length: int            # cache length BEFORE this step
    table: List[int]       # allocated block ids, cache order
    bulk_len: int = 0      # > 0: bulk (ring) prefill of this many tokens
    samples: bool = False  # does this step's last logit produce a token?


@dataclasses.dataclass
class Plan:
    opcode: int
    step: int
    slots: List[SlotPlan] = dataclasses.field(default_factory=list)


def plan_size(cfg: ServeConfig) -> int:
    """int32 words in a packed plan — fixed for a given config, so the
    broadcast signature never changes and the negotiation response cache
    hits on every steady-state step."""
    return 2 + cfg.max_batch * (5 + cfg.prefill_chunk
                                + cfg.max_blocks_per_seq)


def pack_plan(cfg: ServeConfig, plan: Plan) -> np.ndarray:
    arr = np.zeros(plan_size(cfg), np.int32)
    arr[0] = plan.opcode
    arr[1] = plan.step
    width = 5 + cfg.prefill_chunk + cfg.max_blocks_per_seq
    for sp in plan.slots:
        base = 2 + sp.slot * width
        arr[base] = 1
        arr[base + 1] = sp.n_new
        arr[base + 2] = sp.length
        arr[base + 3] = sp.bulk_len
        arr[base + 4] = int(sp.samples)
        arr[base + 5:base + 5 + len(sp.tokens)] = sp.tokens
        tab = base + 5 + cfg.prefill_chunk
        arr[tab:tab + cfg.max_blocks_per_seq] = -1
        arr[tab:tab + len(sp.table)] = sp.table
    return arr


def unpack_plan(cfg: ServeConfig, arr: np.ndarray) -> Plan:
    plan = Plan(opcode=int(arr[0]), step=int(arr[1]))
    width = 5 + cfg.prefill_chunk + cfg.max_blocks_per_seq
    for slot in range(cfg.max_batch):
        base = 2 + slot * width
        if not arr[base]:
            continue
        n_new = int(arr[base + 1])
        tab = base + 5 + cfg.prefill_chunk
        table = [int(b) for b in arr[tab:tab + cfg.max_blocks_per_seq]]
        plan.slots.append(SlotPlan(
            slot=slot, request_id=-1,
            tokens=[int(t) for t in arr[base + 5:base + 5 + n_new]],
            n_new=n_new, length=int(arr[base + 2]),
            table=table, bulk_len=int(arr[base + 3]),
            samples=bool(arr[base + 4])))
    return plan


def pack_control(cfg: ServeConfig, opcode: int, step: int = 0) -> np.ndarray:
    arr = np.zeros(plan_size(cfg), np.int32)
    arr[0] = opcode
    arr[1] = step
    return arr


class Scheduler:
    """The continuous-batching core.  Thread-safe: the front door submits
    from HTTP handler threads while the engine loop calls
    ``step_plan``/``complete_step``; one lock covers all state."""

    def __init__(self, cfg: ServeConfig, pool: Optional[BlockPool] = None):
        self.cfg = cfg
        self.pool = pool or BlockPool(cfg.num_blocks, cfg.block_tokens)
        self._lock = threading.Lock()
        self._queue: List[tuple] = []      # heap of (-priority, seq, req)
        self._submit_seq = itertools.count()
        self._slots: List[Optional[Request]] = [None] * cfg.max_batch
        self._by_id: Dict[int, Request] = {}
        self._step = 0
        self._finish_seq = itertools.count()
        self._failed: Optional[Exception] = None
        self._reg = metrics.registry
        # Completed-request traces (retired/failed), bounded FIFO — the
        # /v1/trace route serves live requests from _by_id and finished
        # ones from here.
        self._traces: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()

    # -- admission --------------------------------------------------------

    def submit(self, tenant: str, prompt_ids: Sequence[int],
               max_new_tokens: int, priority: int = 0) -> Request:
        """Admit a request or shed it with a typed
        :class:`AdmissionError`.  Records per-tenant counters either way.
        """
        tenant = str(tenant)
        req = Request(tenant, prompt_ids, max_new_tokens, priority)
        with self._lock:
            if self._failed is not None:
                # Not counted as a request: the lifecycle invariant is
                # requests == admitted + rejected, and a down plane is
                # neither.
                raise ServingUnavailableError(
                    f"serving plane is down: {self._failed}")
            self._reg.record_serving("requests", tenant)
            if not req.prompt_ids or req.max_new_tokens < 1:
                self._reg.record_serving("rejected", tenant)
                raise AdmissionError(
                    REJECT_TOO_LONG, tenant,
                    "need a non-empty prompt and max_new_tokens >= 1")
            total = len(req.prompt_ids) + req.max_new_tokens
            if (total > self.cfg.max_seq
                    or self.pool.blocks_for_tokens(total)
                    > self.pool.num_blocks):
                # The pool check prevents a livelock: a request the WHOLE
                # pool cannot hold would preempt everything and still
                # never finish.
                self._reg.record_serving("rejected", tenant)
                raise AdmissionError(
                    REJECT_TOO_LONG, tenant,
                    f"prompt ({len(req.prompt_ids)}) + max_new_tokens "
                    f"({req.max_new_tokens}) exceeds the context cap "
                    f"(max_seq {self.cfg.max_seq}, pool "
                    f"{self.pool.num_blocks} blocks)")
            if len(self._queue) >= self.cfg.queue_limit:
                self._reg.record_serving("rejected", tenant)
                raise AdmissionError(
                    REJECT_QUEUE_FULL, tenant,
                    f"admission queue is full ({self.cfg.queue_limit})")
            inflight = sum(1 for r in self._by_id.values()
                           if r.tenant == tenant
                           and r.state in (QUEUED, ACTIVE))
            if inflight >= self.cfg.tenant_max_inflight:
                self._reg.record_serving("rejected", tenant)
                raise AdmissionError(
                    REJECT_TENANT_QUOTA, tenant,
                    f"tenant '{tenant}' already has {inflight} requests "
                    f"in flight (cap {self.cfg.tenant_max_inflight})")
            self._by_id[req.id] = req
            heapq.heappush(self._queue,
                           (-req.priority, next(self._submit_seq), req))
            req.span("admitted")
            self._reg.record_serving("admitted", tenant)
            self._reg.record_serving_tokens(tenant, "prompt",
                                            len(req.prompt_ids))
            self._update_gauges()
        return req

    # -- step planning ----------------------------------------------------

    def step_plan(self) -> Optional[Plan]:
        """Form the next iteration's batch: join queued requests into
        free slots (priority order, chunked or bulk prefill), then emit
        one :class:`SlotPlan` per live slot.  Returns None when there is
        nothing to run (idle tick).  Re-entrant: a re-issued call plans
        the identical step (block allocation only ever covers the
        shortfall)."""
        with self._lock:
            if self._failed is not None:
                return None
            self._join_locked()
            slots = []
            bulk_used = False
            for slot, req in enumerate(self._slots):
                if req is None:
                    continue
                feed = req.feed
                remaining = len(feed) - req.filled
                assert remaining >= 1, (req.id, req.state)
                bulk = (not bulk_used and req.filled == 0
                        and self.cfg.ring_min_tokens > 0
                        and remaining >= self.cfg.ring_min_tokens)
                n_new = remaining if bulk else min(self.cfg.prefill_chunk,
                                                  remaining)
                if not self._ensure_blocks_locked(req, req.filled + n_new):
                    continue  # stayed short of blocks (or got preempted)
                if req.slot is None:
                    continue  # preempted while making room for others
                samples = req.filled + n_new == len(feed)
                slots.append(SlotPlan(
                    slot=slot, request_id=req.id,
                    tokens=[] if bulk else feed[req.filled:
                                               req.filled + n_new],
                    n_new=0 if bulk else n_new,
                    length=req.filled, table=list(req.blocks),
                    bulk_len=n_new if bulk else 0, samples=samples))
                bulk_used = bulk_used or bulk
            if not slots:
                return None
            self._step += 1
            return Plan(opcode=OP_STEP, step=self._step, slots=slots)

    def bulk_tokens(self, request_id: int) -> List[int]:
        """The full feed of a bulk-prefill slot (rank 0 broadcasts it to
        the workers outside the fixed-size plan)."""
        with self._lock:
            return list(self._by_id[request_id].feed)

    def _join_locked(self) -> None:
        while self._queue and None in self._slots:
            _, _, req = self._queue[0]
            if req.state != QUEUED:     # preempt-requeue left a stale entry
                heapq.heappop(self._queue)
                continue
            first = min(self.cfg.prefill_chunk, len(req.feed))
            need = self.pool.blocks_for_tokens(first)
            blocks = self.pool.alloc(need)
            if blocks is None:
                break                   # pool exhausted: stays queued
            heapq.heappop(self._queue)
            req.blocks = blocks
            req.state = ACTIVE
            req.slot = self._slots.index(None)
            self._slots[req.slot] = req
            req.span("activated", slot=req.slot)
            self._update_gauges()

    def _ensure_blocks_locked(self, req: Request, want_tokens: int) -> bool:
        """Grow ``req``'s block table to cover ``want_tokens`` cache
        entries, preempting lower-priority work if the pool is dry.
        Only ever allocates the shortfall, so replanning the same step
        is idempotent."""
        need = self.pool.blocks_for_tokens(want_tokens) - len(req.blocks)
        if need <= 0:
            return True
        while True:
            got = self.pool.alloc(need)
            if got is not None:
                req.blocks.extend(got)
                return True
            victim = self._preempt_candidate_locked(req)
            if victim is None:
                return False
            self._preempt_locked(victim)
            if victim is req:
                return False

    def _preempt_candidate_locked(self, needer: Request):
        """Lowest-priority, youngest active request — the needer itself
        is a legal victim only if nothing ranks below it."""
        active = [r for r in self._slots if r is not None]
        if not active:
            return None
        victim = min(active, key=lambda r: (r.priority, -r.t_submit,
                                            -r.id))
        if victim is needer and len(active) == 1:
            return None  # alone and starved: stay put, retry next step
        return victim

    def _preempt_locked(self, req: Request) -> None:
        self.pool.free(req.blocks)
        req.blocks = []
        req.filled = 0
        self._slots[req.slot] = None
        req.slot = None
        req.state = QUEUED
        heapq.heappush(self._queue,
                       (-req.priority, next(self._submit_seq), req))
        req.span("preempted")
        self._reg.record_serving("preempted", req.tenant)
        self._update_gauges()

    # -- step completion --------------------------------------------------

    def complete_step(self, plan: Plan,
                      sampled: Sequence[int]) -> List[Request]:
        """Fold a completed step back in: advance fill positions, append
        sampled tokens where the step produced one, retire finished
        requests (freeing their blocks immediately).  ``sampled`` is
        indexed by batch slot.  Returns the requests retired this step."""
        finished = []
        now = time.monotonic()
        with self._lock:
            # Step accounting lives HERE, not in step_plan: a re-planned
            # step must count once — steps means steps EXECUTED.
            self._reg.record_serving_step(len(plan.slots),
                                          self.cfg.max_batch)
            for sp in plan.slots:
                req = self._slots[sp.slot]
                if req is None or req.id != sp.request_id:
                    continue  # retired/preempted under a replan
                was_prefill = req.filled < len(req.prompt_ids)
                req.filled += sp.n_new or sp.bulk_len
                req.span("prefill_chunk" if was_prefill else "decode_step",
                         now, step=plan.step,
                         tokens=sp.n_new or sp.bulk_len)
                if not sp.samples:
                    continue
                tok = int(sampled[sp.slot])
                if req.t_first_token is None:
                    req.t_first_token = now
                    self._reg.observe("serving_ttft_sec",
                                      now - req.t_submit)
                req.generated.append(tok)
                self._reg.record_serving_tokens(req.tenant, "generated", 1)
                eos = self.cfg.eos_id >= 0 and tok == self.cfg.eos_id
                if (eos or len(req.generated) >= req.max_new_tokens
                        or len(req.feed) >= self.cfg.max_seq):
                    self._retire_locked(req, now)
                    finished.append(req)
            self._update_gauges()
        return finished

    def _retire_locked(self, req: Request, now: float) -> None:
        self.pool.free(req.blocks)
        req.blocks = []
        self._slots[req.slot] = None
        req.slot = None
        req.state = DONE
        req.t_done = now
        req.finish_seq = next(self._finish_seq)
        req.span("retired", now, generated=len(req.generated))
        self._store_trace_locked(req)
        self._reg.record_serving("retired", req.tenant)
        self._reg.observe("serving_token_sec",
                          (now - req.t_submit)
                          / max(len(req.generated), 1))
        del self._by_id[req.id]
        req.event.set()

    def _store_trace_locked(self, req: Request) -> None:
        self._traces[req.id] = {
            "id": req.id, "tenant": req.tenant, "state": req.state,
            "finish_seq": req.finish_seq,
            "spans": [dict(s) for s in req.spans],
            "dropped_spans": req.dropped_spans,
        }
        while len(self._traces) > _MAX_TRACES:
            self._traces.popitem(last=False)

    def trace(self, request_id: int) -> Optional[dict]:
        """Ordered span records for one request — live (still queued or
        decoding) or finished (bounded store).  None when unknown (never
        admitted, or evicted from the store)."""
        with self._lock:
            req = self._by_id.get(request_id)
            if req is not None:
                return {"id": req.id, "tenant": req.tenant,
                        "state": req.state, "finish_seq": req.finish_seq,
                        "spans": [dict(s) for s in req.spans],
                        "dropped_spans": req.dropped_spans}
            entry = self._traces.get(request_id)
            if entry is None:
                return None
            return dict(entry, spans=[dict(s) for s in entry["spans"]])

    # -- robustness -------------------------------------------------------

    def reform(self, lost_ranks: Sequence[int]) -> None:
        """A membership reshape cancelled the step in flight.  The
        survivors' KV pages and the scheduler's state are both intact
        (the state only advances in ``complete_step``), so nothing is
        dropped: the next ``step_plan`` forms the identical batch again
        and the requests in flight resume."""
        with self._lock:
            self._reg.record_serving("reformed")
            for req in self._slots:
                if req is not None:
                    req.span("reformed")

    def fail_all(self, exc: Exception) -> None:
        """The plane is down (fatal collective error or shutdown): fail
        every in-flight request typed and reject future submissions."""
        with self._lock:
            self._failed = exc
            for req in list(self._by_id.values()):
                req.state = FAILED
                req.error = ServingUnavailableError(
                    f"request {req.id} aborted: {exc}")
                if req.blocks:
                    self.pool.free(req.blocks)
                    req.blocks = []
                if req.slot is not None:
                    self._slots[req.slot] = None
                    req.slot = None
                req.span("failed", error=str(exc)[:200])
                self._store_trace_locked(req)
                self._reg.record_serving("failed", req.tenant)
                req.event.set()
            self._by_id.clear()
            self._queue.clear()
            self._update_gauges()

    # -- introspection ----------------------------------------------------

    @property
    def failed(self) -> Optional[Exception]:
        return self._failed

    def idle(self) -> bool:
        with self._lock:
            return not self._queue and not any(self._slots)

    def _update_gauges(self) -> None:
        self._reg.set_serving_gauges(
            queue_depth=len([e for e in self._queue
                             if e[2].state == QUEUED]),
            active=sum(1 for r in self._slots if r is not None),
            batch_slots=self.cfg.max_batch,
            kv_blocks_in_use=self.pool.blocks_in_use,
            kv_blocks_total=self.pool.num_blocks)
