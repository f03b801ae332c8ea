"""Pipeline parallelism: 1F1B schedules over the engine's point-to-point
plane (``docs/pipeline.md``).

Counterpart of ``horovod_tpu/parallel/pipeline.py``, in four layers:

- the schedules (pure Python, the port's own copy): :func:`schedule_1f1b`,
  :func:`schedule_interleaved`, :func:`bubble_fraction`,
  :func:`simulate_schedule` (a schedule's cross-stage dependencies
  model-checked in one process) and :class:`PipelineGrid`, the rank layout
  of a ``stages x data-parallel`` job;
- the model: :class:`TransformerStage`, a layer range of
  ``models.TransformerLM`` under the full model's parameter names, so
  :func:`partition_params` slices a full ``state_dict`` into the stages'
  by name;
- the transports: :class:`LocalTransport` (in-process queues, for tests)
  and :class:`EngineTransport` (``send``/``recv`` through the engine;
  CUDA activations cross in pinned host buckets);
- the runner: :class:`PipelineRunner` executes one rank's schedule over
  torch autograd, and :func:`run_local_pipeline` drives every stage of a
  pipeline in one process.

Activations and their gradients travel as float32 buckets of one fixed
shape, (micro-batch, seq, d_model): every step announces the same
(name, shape, dtype) stream, so after the first step the engine's
response cache serves the negotiation.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "PipeAction", "schedule_1f1b", "schedule_interleaved",
    "bubble_fraction", "simulate_schedule", "PipelineGrid",
    "TransformerStage", "partition_transformer", "partition_params",
    "LocalTransport", "EngineTransport", "PipelineRunner",
    "run_local_pipeline",
]


class PipeAction(NamedTuple):
    """One slot of a stage's schedule: run ``kind`` ("fwd"/"bwd") for
    micro-batch ``microbatch`` of model chunk ``chunk`` (always 0 without
    interleaving)."""

    kind: str
    microbatch: int
    chunk: int = 0


def schedule_1f1b(stage: int, n_stages: int, n_micro: int) -> List[PipeAction]:
    """The non-interleaved 1F1B schedule of one stage: ``n_stages - 1 -
    stage`` warm-up forwards, then one forward and one backward in turn
    (at most ``warmup + 1`` micro-batches in flight), then the remaining
    backwards."""
    if not (0 <= stage < n_stages):
        raise ValueError(f"stage {stage} out of range for {n_stages} stages")
    if n_micro < 1:
        raise ValueError(f"need at least one micro-batch, got {n_micro}")
    warmup = min(n_stages - 1 - stage, n_micro)
    actions = [PipeAction("fwd", i) for i in range(warmup)]
    fwd, bwd = warmup, 0
    for _ in range(n_micro - warmup):
        actions.append(PipeAction("fwd", fwd))
        fwd += 1
        actions.append(PipeAction("bwd", bwd))
        bwd += 1
    for _ in range(warmup):
        actions.append(PipeAction("bwd", bwd))
        bwd += 1
    return actions


def schedule_interleaved(stage: int, n_stages: int, n_micro: int,
                         n_chunks: int) -> List[PipeAction]:
    """The interleaved (virtual-stage) 1F1B schedule: each rank holds
    ``n_chunks`` chunks, virtual stage ``chunk * n_stages + stage``.
    Micro-batches advance in groups of ``n_stages`` per chunk (the
    Megatron-LM order), so ``n_micro`` must divide by ``n_stages``."""
    if n_chunks == 1:
        return schedule_1f1b(stage, n_stages, n_micro)
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if n_micro % n_stages:
        raise ValueError(
            f"interleaved schedule needs n_micro ({n_micro}) divisible by "
            f"n_stages ({n_stages})")
    total = n_micro * n_chunks
    group = n_stages * n_chunks

    def fwd_at(k: int) -> PipeAction:
        chunk = (k // n_stages) % n_chunks
        mb = (k // group) * n_stages + k % n_stages
        return PipeAction("fwd", mb, chunk)

    def bwd_at(k: int) -> PipeAction:
        chunk = n_chunks - 1 - (k // n_stages) % n_chunks
        mb = (k // group) * n_stages + k % n_stages
        return PipeAction("bwd", mb, chunk)

    warmup = min((n_stages - stage - 1) * 2 + (n_chunks - 1) * n_stages,
                 total)
    actions = [fwd_at(k) for k in range(warmup)]
    fwd, bwd = warmup, 0
    for _ in range(total - warmup):
        actions.append(fwd_at(fwd))
        fwd += 1
        actions.append(bwd_at(bwd))
        bwd += 1
    for _ in range(warmup):
        actions.append(bwd_at(bwd))
        bwd += 1
    return actions


def bubble_fraction(n_stages: int, n_micro: int, n_chunks: int = 1) -> float:
    """Idle fraction of the 1F1B pipeline, ``(S-1) / (S-1 + M*V)``."""
    ramp = n_stages - 1
    return ramp / (ramp + n_micro * n_chunks)


def simulate_schedule(n_stages: int, n_micro: int, n_chunks: int = 1,
                      schedule_fn: Optional[Callable] = None) -> int:
    """Model-check a schedule's cross-stage dependencies in one process:
    a forward needs the previous virtual stage's forward of its
    micro-batch, a backward its own forward and the next virtual stage's
    backward.  Raises ``AssertionError`` on a deadlock, an action run
    twice or one never run; returns the number of lock-step ticks (each
    tick every stage runs at most one ready action)."""
    if schedule_fn is None:
        schedule_fn = (schedule_1f1b if n_chunks == 1 else
                       lambda s, S, M: schedule_interleaved(s, S, M,
                                                            n_chunks))
    plans = [schedule_fn(s, n_stages, n_micro) for s in range(n_stages)]
    cursor = [0] * n_stages
    done = set()  # (kind, microbatch, virtual_stage)
    last_virtual = n_stages * n_chunks - 1
    ticks = 0
    while any(cursor[s] < len(plans[s]) for s in range(n_stages)):
        progressed = False
        for s in range(n_stages):
            if cursor[s] >= len(plans[s]):
                continue
            kind, mb, chunk = plans[s][cursor[s]]
            v = chunk * n_stages + s
            if kind == "fwd":
                ready = v == 0 or ("fwd", mb, v - 1) in done
            else:
                ready = ("fwd", mb, v) in done and (
                    v == last_virtual or ("bwd", mb, v + 1) in done)
            if not ready:
                continue
            key = (kind, mb, v)
            if key in done:
                raise AssertionError(f"duplicate action {key} at stage {s}")
            done.add(key)
            cursor[s] += 1
            progressed = True
        if not progressed:
            stuck = {s: plans[s][cursor[s]] for s in range(n_stages)
                     if cursor[s] < len(plans[s])}
            raise AssertionError(f"schedule deadlock; blocked on {stuck}")
        ticks += 1
    expected = 2 * n_micro * n_chunks * n_stages
    if len(done) != expected:
        raise AssertionError(
            f"schedule executed {len(done)} actions, expected {expected}")
    return ticks


class PipelineGrid:
    """Rank layout of a ``stages x data-parallel`` job, stage-major: stage
    ``s`` owns global ranks ``[s*dp, (s+1)*dp)``, and the pipeline peer
    at the same DP index is ``rank +- dp``."""

    def __init__(self, n_stages: int, world: int, rank: int):
        if n_stages < 1:
            raise ValueError(f"n_stages must be >= 1, got {n_stages}")
        if world % n_stages:
            raise ValueError(
                f"world size {world} does not divide into {n_stages} "
                f"pipeline stages")
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} out of range for world {world}")
        self.n_stages = n_stages
        self.world = world
        self.rank = rank
        self.dp = world // n_stages
        self.stage = rank // self.dp
        self.dp_index = rank % self.dp

    def stage_ranks(self, stage: Optional[int] = None) -> List[int]:
        stage = self.stage if stage is None else stage
        return list(range(stage * self.dp, (stage + 1) * self.dp))

    def rank_of(self, stage: int, dp_index: Optional[int] = None) -> int:
        dp_index = self.dp_index if dp_index is None else dp_index
        return stage * self.dp + dp_index

    def stage_of(self, rank: int) -> int:
        return rank // self.dp

    @property
    def next_rank(self) -> int:
        """The peer holding the next stage (wrapping: in the interleaved
        schedule the last stage's forward feeds stage 0's next chunk)."""
        return self.rank_of((self.stage + 1) % self.n_stages)

    @property
    def prev_rank(self) -> int:
        return self.rank_of((self.stage - 1) % self.n_stages)


# ---------------------------------------------------------------------------
# TransformerLM partitioning.
# ---------------------------------------------------------------------------


def _split_layers(n_layers: int, n_virtual: int) -> List[List[int]]:
    """Contiguous, near-even layer ranges: the first ``n_layers %
    n_virtual`` virtual stages take one layer more."""
    if n_virtual > n_layers:
        raise ValueError(
            f"cannot split {n_layers} layers over {n_virtual} virtual "
            f"stages (stages x chunks)")
    base, extra = divmod(n_layers, n_virtual)
    out, at = [], 0
    for v in range(n_virtual):
        n = base + (1 if v < extra else 0)
        out.append(list(range(at, at + n)))
        at += n
    return out


class TransformerStage(nn.Module):
    """One virtual stage of ``TransformerLM``: the blocks ``layer_ids``,
    with the embedding on the first virtual stage and the final norm and
    head on the last, whose logits are float32 (the reference's
    ``preferred_element_type=float32``: the head multiplies operands
    rounded to ``dtype`` in f32).  The blocks sit in a ``ModuleDict``
    under their global index, so the parameter names are the full
    model's (``embed.weight``, ``layers.5.attn.qkv_kernel``,
    ``final_norm.weight``, ``lm_head_kernel``).  A stage after the first
    takes the float32 activation of the wire, so its residual stream is
    float32, as in the reference.  The weights it draws (from a generator
    seeded 0) are placeholders for a slice of :func:`partition_params`;
    ``device="meta"`` builds the shapes only (then ``to_empty`` and
    ``load_state_dict``)."""

    def __init__(self, vocab_size: int, d_model: int, n_heads: int,
                 layer_ids: Sequence[int], d_ff: Optional[int] = None,
                 dtype=torch.bfloat16, is_first: bool = False,
                 is_last: bool = False, use_flash: bool = True, device=None):
        super().__init__()
        from horovod_tpu_torch.common import resolve_device
        from horovod_tpu_torch.models.layers import lecun_normal
        from horovod_tpu_torch.models.transformer import Block, RMSNorm

        device = resolve_device(device)
        generator = torch.Generator().manual_seed(0)
        d_ff = d_ff or 4 * d_model
        self.vocab_size, self.d_model, self.dtype = vocab_size, d_model, dtype
        self.layer_ids = tuple(layer_ids)
        self.is_first, self.is_last = is_first, is_last
        if is_first:
            self.embed = nn.Embedding(vocab_size, d_model, device=device)
            if device.type != "meta":
                with torch.no_grad():  # flax Embed: variance 1 / d_model
                    self.embed.weight.copy_(torch.randn(
                        vocab_size, d_model, generator=generator).mul_(
                            d_model ** -0.5).to(device))
        self.layers = nn.ModuleDict({
            str(i): Block(d_model, n_heads, d_ff, dtype, use_flash,
                          generator, device) for i in self.layer_ids})
        if is_last:
            self.final_norm = RMSNorm(d_model, dtype, device=device)
            self.lm_head_kernel = nn.Parameter(lecun_normal(
                (d_model, vocab_size), d_model, generator, device))

    def forward(self, x):
        """Token ids ``(batch, seq)`` on the first virtual stage, else the
        residual stream ``(batch, seq, d_model)``; returns the stream, or
        float32 logits on the last virtual stage."""
        if self.is_first:
            x = F.embedding(x, self.embed.weight.to(self.dtype))
        for layer in self.layers.values():
            x = layer(x)
        if self.is_last:
            xw = self.final_norm(x).to(self.dtype)
            x = torch.matmul(xw.float(),
                             self.lm_head_kernel.to(self.dtype).float())
        return x


def partition_transformer(vocab_size: int, d_model: int, n_layers: int,
                          n_heads: int, n_stages: int, n_chunks: int = 1,
                          d_ff: Optional[int] = None, dtype=None,
                          use_flash: bool = True, device=None
                          ) -> List[List[TransformerStage]]:
    """Stage modules of a ``TransformerLM`` split over ``n_stages x
    n_chunks`` virtual stages, as ``modules[stage][chunk]`` (virtual
    stage ``chunk * n_stages + stage``, the interleaved schedule's
    order).  Their weights are placeholders: load a slice of
    :func:`partition_params` into each.  ``device="meta"`` allocates
    nothing."""
    dtype = torch.bfloat16 if dtype is None else dtype
    n_virtual = n_stages * n_chunks
    layers = _split_layers(n_layers, n_virtual)
    out: List[List[TransformerStage]] = [[] for _ in range(n_stages)]
    for stage in range(n_stages):
        for chunk in range(n_chunks):
            v = chunk * n_stages + stage
            out[stage].append(TransformerStage(
                vocab_size, d_model, n_heads, layers[v], d_ff=d_ff,
                dtype=dtype, is_first=(v == 0),
                is_last=(v == n_virtual - 1), use_flash=use_flash,
                device=device))
    return out


def partition_params(full_state: dict, n_layers: int, n_stages: int,
                     n_chunks: int = 1) -> List[List[dict]]:
    """A full ``TransformerLM`` ``state_dict`` sliced by name into the
    virtual stages' (``params[stage][chunk]``), by the split
    :func:`partition_transformer` uses: each slice loads into its stage
    with ``strict=True``."""
    n_virtual = n_stages * n_chunks
    layers = _split_layers(n_layers, n_virtual)
    out: List[List[dict]] = [[] for _ in range(n_stages)]
    for stage in range(n_stages):
        for chunk in range(n_chunks):
            v = chunk * n_stages + stage
            prefixes = tuple(f"layers.{i}." for i in layers[v])
            part = {k: t for k, t in full_state.items()
                    if k.startswith(prefixes)}
            if v == 0:
                part["embed.weight"] = full_state["embed.weight"]
            if v == n_virtual - 1:
                part["final_norm.weight"] = full_state["final_norm.weight"]
                part["lm_head_kernel"] = full_state["lm_head_kernel"]
            out[stage].append(part)
    return out


# ---------------------------------------------------------------------------
# Transports: where activations and their gradients travel.
# ---------------------------------------------------------------------------


class LocalTransport:
    """In-process transport for tests: every stage's runner shares one
    instance; a send appends a float32 CPU copy to the queue of its name,
    a receive takes the oldest.  Peers are ignored: the names are unique
    per step, as on the wire."""

    def __init__(self):
        self._queues = defaultdict(deque)

    def send(self, tensor, peer: int, name: str) -> None:
        self._queues[name].append(
            tensor.detach().to("cpu", torch.float32, copy=True))

    def can_recv(self, name: str) -> bool:
        return bool(self._queues.get(name))

    def recv(self, shape, peer: int, name: str, device) -> torch.Tensor:
        got = self._queues[name].popleft()
        if tuple(got.shape) != tuple(shape):
            raise ValueError(f"'{name}': sent shape {tuple(got.shape)}, "
                             f"bucket shape {tuple(shape)}")
        return got.to(device)

    def flush(self) -> None:
        pass


class EngineTransport:
    """``send``/``recv`` through the engine's point-to-point plane.

    Sends are enqueued asynchronously and completed by :meth:`flush` at
    the end of the step: a blocking send would deadlock against the
    blocking receive that 1F1B's steady state puts beside it; the
    engine's paired negotiation orders the transfers.

    On the wire every tensor is float32 (the reference upcasts the same
    way).  A CUDA tensor is copied into a pinned host buffer of its wire
    name, and the engine is handed the buffer only once the copy's event
    has completed; the buffer stays referenced until :meth:`flush`.  A
    receive lands in one pinned bucket per shape (the fixed-shape bucket
    contract), which is copied into a fresh device tensor: the returned
    tensor never aliases the bucket, and the next receive into the bucket
    first waits for that copy's event.  On CPU modules the buffers are
    ordinary host tensors."""

    def __init__(self, tag: int = 0):
        self.tag = tag
        self._pending: list = []   # (handle, buffer) until flush
        self._send_bufs: dict = {}  # wire name -> pinned f32 buffer
        self._buckets: dict = {}    # shape -> (bucket, event of its copy)

    def send(self, tensor, peer: int, name: str) -> None:
        from horovod_tpu_torch import common as hvd

        t = tensor.detach()
        if t.device.type == "cuda":
            buf = self._send_bufs.get(name)
            if buf is None or buf.shape != t.shape:
                buf = torch.empty(t.shape, dtype=torch.float32,
                                  pin_memory=True)
                self._send_bufs[name] = buf
            buf.copy_(t, non_blocking=True)  # upcasts on the device
            landed = torch.cuda.Event()
            landed.record()
            landed.synchronize()
        else:
            buf = t.to(torch.float32, copy=True).contiguous()
        self._pending.append((hvd.send_async(buf, peer, self.tag, name),
                              buf))

    def can_recv(self, name: str) -> bool:
        return True  # recv() blocks; the engine thread makes progress

    def recv(self, shape, peer: int, name: str, device) -> torch.Tensor:
        from horovod_tpu_torch import common as hvd

        device = torch.device(device)
        key = tuple(shape)
        bucket, copied = self._buckets.get(key, (None, None))
        if bucket is None:
            bucket = torch.empty(key, dtype=torch.float32,
                                 pin_memory=device.type == "cuda")
        elif copied is not None:
            copied.synchronize()  # the last copy out of it has read it
        hvd.recv(bucket, peer, self.tag, name)
        if device.type == "cuda":
            out = torch.empty(key, dtype=torch.float32, device=device)
            out.copy_(bucket, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
        else:
            out, copied = bucket.clone(), None
        self._buckets[key] = (bucket, copied)
        return out

    def flush(self) -> None:
        pending, self._pending = self._pending, []
        for handle, _ in pending:
            handle.wait()


# ---------------------------------------------------------------------------
# The runner: one rank's schedule execution.
# ---------------------------------------------------------------------------


class PipelineRunner:
    """Execute a 1F1B (or interleaved) schedule for one rank's stage.

    ``stages`` is this rank's chunks (one module without interleaving),
    holding their parameters.  Per in-flight micro-batch the stash keeps
    the received input (a leaf with ``requires_grad``) and the output;
    the backward is ``torch.autograd.backward(output, seed)``, the seed
    ``1/n_micro`` on the last virtual stage (the step's loss is the
    micro-batches' mean) and the received gradient elsewhere, so the
    parameters' ``.grad`` accumulate the full-batch mean gradient per
    chunk.  The input's gradient goes upstream in float32.
    ``loss_fn(logits, targets)`` runs on the last virtual stage only.

    A stage that dies mid-schedule surfaces from the engine as a
    :class:`~horovod_tpu_torch.common.RanksDownError`, re-raised naming
    the dead *stage*."""

    def __init__(self, stages: Sequence[nn.Module], grid: PipelineGrid,
                 n_micro: int, transport, loss_fn=None,
                 prefix: str = "pipe"):
        self.stages = list(stages)
        if not self.stages:
            raise ValueError("a pipeline rank needs at least one chunk")
        self.grid = grid
        self.n_chunks = len(self.stages)
        self.n_micro = n_micro
        self.transport = transport
        self.loss_fn = loss_fn
        if grid.stage == grid.n_stages - 1 and loss_fn is None:
            raise ValueError(
                "the last pipeline stage computes the loss: pass loss_fn=")
        self.prefix = prefix
        self.schedule = schedule_interleaved(
            grid.stage, grid.n_stages, n_micro, self.n_chunks)
        self.device = next(self.stages[0].parameters()).device
        self._n_virtual = grid.n_stages * self.n_chunks
        self._bucket_shape = None
        self._reset()

    def _reset(self):
        self._cursor = 0
        self._stash = {}  # (mb, chunk) -> (received input or None, output)
        self._losses: list = []
        self._inputs = None
        self._targets = None

    def _virtual(self, chunk: int) -> int:
        return chunk * self.grid.n_stages + self.grid.stage

    def _fwd_name(self, v: int, mb: int) -> str:
        # Named by the receiving virtual stage: both ends derive it.
        return f"{self.prefix}.fwd.v{v}.mb{mb}"

    def _bwd_name(self, v: int, mb: int) -> str:
        return f"{self.prefix}.bwd.v{v}.mb{mb}"

    def _needed_recv(self, action: PipeAction) -> Optional[str]:
        v = self._virtual(action.chunk)
        if action.kind == "fwd":
            return None if v == 0 else self._fwd_name(v, action.microbatch)
        return (None if v == self._n_virtual - 1
                else self._bwd_name(v, action.microbatch))

    def _split(self, batch, what: str):
        if batch.shape[0] % self.n_micro:
            raise ValueError(
                f"{what} dim {batch.shape[0]} does not split into "
                f"{self.n_micro} micro-batches")
        t = torch.as_tensor(batch).to(self.device)
        if not t.is_floating_point():
            t = t.long()
        return list(torch.split(t, t.shape[0] // self.n_micro))

    # -- stepping -----------------------------------------------------------

    def begin_step(self, inputs=None, targets=None) -> None:
        """Arm one step: zero the chunks' gradients and split ``inputs``
        (first stage) and ``targets`` (last stage), this DP rank's whole
        batches (numpy or torch), into ``n_micro`` micro-batches."""
        self._reset()
        for stage in self.stages:
            stage.zero_grad(set_to_none=True)
        if inputs is not None:
            self._inputs = self._split(inputs, "batch")
        if targets is not None:
            self._targets = self._split(targets, "target")

    @property
    def done(self) -> bool:
        return self._cursor >= len(self.schedule)

    def try_next(self) -> bool:
        """Run the next action if its input is available (the in-process
        harness's round-robin); False when blocked or done."""
        if self.done:
            return False
        action = self.schedule[self._cursor]
        needed = self._needed_recv(action)
        if needed is not None and not self.transport.can_recv(needed):
            return False
        self._execute(action)
        self._cursor += 1
        return True

    def finish_step(self):
        """``(loss, grads)`` once the schedule has drained: the mean
        micro-batch loss on the last virtual stage (None elsewhere), and
        per chunk ``{parameter name: .grad}``."""
        if not self.done:
            raise RuntimeError(
                f"schedule not drained: {self._cursor}/"
                f"{len(self.schedule)} actions done")
        self.transport.flush()
        loss = (float(np.mean([float(lo) for lo in self._losses]))
                if self._losses else None)
        grads = [{n: p.grad for n, p in stage.named_parameters()}
                 for stage in self.stages]
        return loss, grads

    def step(self, inputs=None, targets=None):
        """One whole step over a blocking transport: run the schedule and
        return :meth:`finish_step`'s ``(loss, grads)``."""
        from horovod_tpu_torch.common import RanksDownError

        self.begin_step(inputs, targets)
        try:
            while not self.done:
                if not self.try_next():
                    raise RuntimeError(
                        "pipeline blocked with a non-blocking transport; "
                        "use run_local_pipeline to drive multiple stages "
                        "in one process")
            return self.finish_step()
        except RanksDownError as exc:
            raise RanksDownError(
                f"pipeline aborted mid-schedule at action "
                f"{self._cursor}/{len(self.schedule)}: "
                f"{_dead_stages(self.grid, exc.ranks)} died: {exc}",
                exc.ranks) from exc

    # -- action execution ---------------------------------------------------

    def _execute(self, action: PipeAction) -> None:
        mb, chunk = action.microbatch, action.chunk
        v = self._virtual(chunk)
        first_v, last_v = v == 0, v == self._n_virtual - 1
        if action.kind == "fwd":
            if first_v:
                if self._inputs is None:
                    raise ValueError(
                        "first pipeline stage needs inputs= in begin_step")
                x = self._inputs[mb]
            else:
                x = self.transport.recv(
                    self._recv_shape_hint(), self._fwd_peer(recv=True),
                    self._fwd_name(v, mb), self.device).requires_grad_()
            out = self.stages[chunk](x)
            if last_v:
                if self._targets is None:
                    raise ValueError(
                        "last pipeline stage needs targets= in begin_step")
                out = self.loss_fn(out, self._targets[mb])
                self._losses.append(out.detach())
            else:
                self.transport.send(out, self._fwd_peer(recv=False),
                                    self._fwd_name(v + 1, mb))
            self._stash[(mb, chunk)] = (None if first_v else x, out)
        else:
            x, out = self._stash.pop((mb, chunk))
            if last_v:
                seed = self._loss_seed(out)
            else:
                seed = self.transport.recv(
                    self._recv_shape_hint(), self._bwd_peer(recv=True),
                    self._bwd_name(v, mb), self.device).to(out.dtype)
            torch.autograd.backward(out, seed)
            if not first_v:
                self.transport.send(x.grad, self._bwd_peer(recv=False),
                                    self._bwd_name(v - 1, mb))

    def _loss_seed(self, loss):
        """The backward's seed on the last virtual stage: the step's loss
        is the micro-batches' mean, so each contributes ``1/n_micro``."""
        return torch.full_like(loss, 1.0 / self.n_micro)

    def _recv_shape_hint(self):
        """The buckets' (micro-batch, seq, d_model): declared by
        :meth:`set_bucket_shape`, or on the first stage read off its
        inputs."""
        if self._bucket_shape is not None:
            return self._bucket_shape
        if self._inputs is not None:
            src = self._inputs[0]
            return (src.shape[0], src.shape[1], self.stages[0].d_model)
        raise ValueError(
            "pipeline stage needs set_bucket_shape(micro_batch, seq, "
            "d_model) before stepping (fixed-shape bucket contract)")

    def set_bucket_shape(self, micro_batch: int, seq: int,
                         d_model: Optional[int] = None) -> None:
        """Declare the activation buckets' fixed geometry: required on
        stages that never see ``inputs=``.  The shape is part of the p2p
        contract; the coordinator fails a sender/receiver mismatch with a
        typed precondition error."""
        d_model = d_model if d_model is not None else self.stages[0].d_model
        self._bucket_shape = (micro_batch, seq, d_model)

    def _fwd_peer(self, recv: bool) -> int:
        return self.grid.prev_rank if recv else self.grid.next_rank

    def _bwd_peer(self, recv: bool) -> int:
        return self.grid.next_rank if recv else self.grid.prev_rank


def _dead_stages(grid: PipelineGrid, ranks) -> str:
    """``"stage s (ranks [...])"`` for each stage holding a dead rank."""
    stages = sorted({grid.stage_of(r) for r in ranks})
    return ", ".join(f"stage {s} (ranks {grid.stage_ranks(s)})"
                     for s in stages) or "unknown stage"


def run_local_pipeline(runners: Sequence[PipelineRunner], inputs,
                       targets) -> tuple:
    """Drive every stage of a pipeline in one process over a shared
    :class:`LocalTransport`: round-robin until every schedule drains, a
    deadlock raised when no stage can move.  Returns ``(loss, [per-stage
    grads])``."""
    for r in runners:
        r.begin_step(inputs if r.grid.stage == 0 else None,
                     targets if r.grid.stage == r.grid.n_stages - 1
                     else None)
        if r.grid.stage != 0:
            r.set_bucket_shape(inputs.shape[0] // r.n_micro, inputs.shape[1])
    while not all(r.done for r in runners):
        progressed = False
        for r in runners:
            if r.try_next():
                progressed = True
        if not progressed:
            stuck = {r.grid.stage: r.schedule[r._cursor]
                     for r in runners if not r.done}
            raise AssertionError(
                f"pipeline deadlock; stages blocked on {stuck}")
    results = [r.finish_step() for r in runners]
    loss = next((lo for lo, _ in results if lo is not None), None)
    return loss, [g for _, g in results]
