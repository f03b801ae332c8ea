"""Per-rank serving engine: the decode loop under the batch-plan broadcast.

Own copy of ``horovod_tpu/serving/engine.py`` on the port's model and
engine.  Every rank runs the same loop: receive rank 0's packed batch plan
through the ordinary named-collective path (a broadcast of one
fixed-shape int32 tensor named ``serve.plan``, so after the first step the
engine's negotiation response cache replays the agreement), run the
decode step against its own page tensor, and loop.  Rank 0 also owns the
scheduler and samples the next token from its own logits; the sample
reaches the workers inside the next plan (they never sample), so every
rank's KV pages stay bit-identical by construction.

The step runs on the model's device (the card unless ``ModelSpec.device``
names the CPU): the paged gather, the decode forward, the in-place
scatter and the greedy argmax.  A bulk prefill is one full forward of the
prompt, whose attention on the card is the flash forward kernel (K1).  A
fatal collective error fails every in-flight request typed, never hangs.
An elastic reshape (``--min-np``) that cancels the plan's broadcast or a
step's own broadcast (``MembershipChangedError``) is acknowledged and the
step planned again (``Scheduler.reform``): it never ran anywhere, or its
page writes repeat the same values at the same positions, and the
scheduler advances only in ``complete_step``.  Not ported: the timeline
markers at retirement.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from horovod_tpu_torch import common as _common
from horovod_tpu_torch.common import metrics
from horovod_tpu_torch.models import DecodeContext, TransformerLM
from horovod_tpu_torch.models.convert import from_flax_params
from horovod_tpu_torch.serving import kv_cache, scheduler as sched
from horovod_tpu_torch.state import flatten_tree
from horovod_tpu_torch.torch import mpi_ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The served TransformerLM's shape (env: ``HVD_TPU_SERVE_*``).
    Defaults are a test-scale model; ``ckpt`` points at a checkpoint of
    either package, legacy or sharded (a ``ckpt-*.pkl`` file, a
    ``ckpt-*/`` directory, or a directory of them: the newest).
    ``device``: empty for this rank's CUDA device, ``"cpu"`` for the CPU,
    or ``"cuda:N"``."""

    vocab: int = 512
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 2
    dtype: str = "float32"
    seed: int = 0
    ckpt: str = ""
    device: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @staticmethod
    def from_env() -> "ModelSpec":
        d = ModelSpec()

        def _get(name, default):
            return os.environ.get(f"HVD_TPU_SERVE_{name}") or default

        return ModelSpec(
            vocab=int(_get("VOCAB", d.vocab)),
            d_model=int(_get("D_MODEL", d.d_model)),
            n_layers=int(_get("LAYERS", d.n_layers)),
            n_heads=int(_get("HEADS", d.n_heads)),
            dtype=_get("DTYPE", d.dtype),
            seed=int(_get("SEED", d.seed)),
            ckpt=_get("CKPT", d.ckpt),
            device=_get("DEVICE", d.device),
        )


def build_model(spec: ModelSpec, device=None) -> TransformerLM:
    """The served model, float32 logits, weights drawn from
    ``torch.Generator().manual_seed(spec.seed)``, on ``device`` (default:
    the spec's).  Its full forward's attention is ``flash_attention``:
    K1 on the card, the blockwise plain version on the CPU."""
    return TransformerLM(
        vocab_size=spec.vocab, d_model=spec.d_model,
        n_layers=spec.n_layers, n_heads=spec.n_heads,
        dtype=spec.torch_dtype, logits_dtype=torch.float32,
        generator=torch.Generator().manual_seed(spec.seed),
        device=device or spec.device or None).eval()


def load_params(path: str) -> dict:
    """The served ``params`` of a checkpoint of either package, legacy or
    sharded (the newest in the directory ``path``, or the file or
    checkpoint directory ``path`` itself), read by this process alone, as
    the port's float32 CPU ``state_dict``: the JAX package's tree holds
    flax ``params`` (or is them), the port's a ``state_dict`` under
    ``model`` (or is one)."""
    from horovod_tpu_torch.torch.train import (load_checkpoint,
                                               load_latest_checkpoint)

    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, "manifest.json")):
        _, tree = load_latest_checkpoint(path, collective=False)
        if tree is None:
            raise FileNotFoundError(f"{path}: no committed checkpoint")
    else:
        _, tree = load_checkpoint(path, collective=False)
    tree = tree.get("model", tree.get("params", tree))
    if "embed.weight" in tree:
        return {k: v.float().contiguous() for k, v in tree.items()}
    leaves, rebuild = flatten_tree(tree)
    return from_flax_params(rebuild([
        v.float().numpy() if torch.is_tensor(v) else v for v in leaves]))


def init_params(spec: ModelSpec) -> dict:
    """Deterministic parameters as a float32 CPU ``state_dict``: from
    ``spec.ckpt`` when set, else the seeded initialisation.  Identical on
    every rank, and root-broadcast after anyway."""
    if spec.ckpt:
        return load_params(spec.ckpt)
    return build_model(spec, device="cpu").state_dict()


def broadcast_params(params: dict) -> dict:
    """Root-broadcast every tensor of ``params`` from rank 0 in place,
    under numbered names (stable signatures, cached after the first)."""
    for i, t in enumerate(params.values()):
        mpi_ops.broadcast_(t, 0, name=f"serve.param.{i}")
    return params


def make_step_fn(model: TransformerLM, cfg: sched.ServeConfig) -> Callable:
    """The decode step: gather each slot's paged KV context, run the
    model's decode mode over the fixed-shape token chunk, write the fresh
    K/V into the pages in place, and pick each slot's greedy token at its
    last real position.  ``step(pages, tokens, n_new, lengths, tables)``
    returns ``(sampled, logits)``; every operand is a tensor on the
    pages' device."""
    ctx_len = cfg.max_blocks_per_seq * cfg.block_tokens

    @torch.no_grad()
    def step(pages, tokens, n_new, lengths, tables):
        k_ctx, v_ctx = kv_cache.gather_context(pages, tables)
        dev = pages.device
        ctx_mask = torch.arange(ctx_len, device=dev)[None] < lengths[:, None]
        positions = lengths[:, None] + torch.arange(tokens.shape[1],
                                                    device=dev)[None]
        logits, (k_new, v_new) = model(
            tokens, decode_ctx=DecodeContext(k_ctx, v_ctx, ctx_mask,
                                             positions))
        kv_cache.scatter_new(pages, k_new, v_new, tables, lengths, n_new)
        idx = torch.clamp(n_new - 1, 0, tokens.shape[1] - 1)
        sampled = torch.take_along_dim(logits.argmax(-1), idx[:, None],
                                       dim=1)[:, 0]
        return sampled, logits

    return step


@torch.no_grad()
def reference_decode(model: TransformerLM, prompt_ids, max_new_tokens: int,
                     eos_id: int = -1) -> List[int]:
    """Greedy decode by repeated full-context forward: the ground truth
    the paged path must reproduce.  The buffer is padded to the final
    length once (causal attention hides trailing padding from earlier
    positions)."""
    device = model.embed.weight.device
    total = len(prompt_ids) + max_new_tokens
    tokens = [int(t) for t in prompt_ids]
    out = []
    for _ in range(max_new_tokens):
        buf = torch.tensor([tokens + [0] * (total - len(tokens))],
                           device=device)
        tok = int(model(buf)[0, len(tokens) - 1].argmax())
        out.append(tok)
        if eos_id >= 0 and tok == eos_id:
            break
        tokens.append(tok)
    return out


class ServingEngine:
    """One rank's serving loop.  Rank 0 owns ``scheduler`` (the HTTP front
    door sits on top of it); workers pass ``scheduler=None``."""

    def __init__(self, spec: ModelSpec, cfg: sched.ServeConfig, params,
                 scheduler: Optional[sched.Scheduler] = None):
        from horovod_tpu_torch.serving import prefill

        self.spec = spec
        self.cfg = cfg
        self.model = build_model(spec)
        self.model.load_state_dict(params)
        self.device = self.model.embed.weight.device
        self.scheduler = scheduler
        self._step_fn = make_step_fn(self.model, cfg)
        self._stop = threading.Event()
        self._trash = cfg.num_blocks  # the page index masked writes land in
        self.pages = kv_cache.init_pages(
            spec.n_layers, spec.n_heads, spec.head_dim, cfg.num_blocks,
            cfg.block_tokens, spec.torch_dtype, self.device)
        # Built up front, so a mesh the port cannot prefill over raises
        # at start-up rather than on the first long prompt.
        self._prefill = (prefill.RingPrefill(self.model)
                         if cfg.ring_min_tokens > 0 else None)

    def request_stop(self) -> None:
        """Ask the loop to broadcast OP_STOP at the next tick (rank 0; on
        workers it only exits the local loop — the plan broadcast is what
        releases them)."""
        self._stop.set()

    # -- plan execution ---------------------------------------------------

    def _tables_array(self, plan: sched.Plan) -> np.ndarray:
        tables = np.full((self.cfg.max_batch, self.cfg.max_blocks_per_seq),
                         self._trash, np.int64)
        for sp in plan.slots:
            for i, b in enumerate(sp.table):
                if b >= 0:
                    tables[sp.slot, i] = b
        return tables

    def _execute(self, plan: sched.Plan) -> np.ndarray:
        """Run one planned step; returns per-slot sampled tokens."""
        cfg = self.cfg
        tokens = np.zeros((cfg.max_batch, cfg.prefill_chunk), np.int64)
        n_new = np.zeros(cfg.max_batch, np.int64)
        lengths = np.zeros(cfg.max_batch, np.int64)
        tables = self._tables_array(plan)
        for sp in plan.slots:
            lengths[sp.slot] = sp.length
            if sp.bulk_len:
                continue  # handled by the bulk-prefill path below
            tokens[sp.slot, :sp.n_new] = sp.tokens
            n_new[sp.slot] = sp.n_new
        dev = self.device
        sampled, _ = self._step_fn(
            self.pages, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(n_new).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.from_numpy(tables).to(dev))
        sampled = sampled.cpu().numpy()
        for sp in plan.slots:
            if sp.bulk_len:
                sampled[sp.slot] = self._bulk_prefill(sp, tables[sp.slot])
        return sampled

    def _bulk_prefill(self, sp: sched.SlotPlan, table: np.ndarray) -> int:
        """Whole-prompt prefill of one slot in one forward instead of
        chunk by chunk: the prompt travels in a side broadcast (bucketed
        length, so only a handful of extra cache signatures exist), every
        rank writes the captured K/V into its pages, and the logit of the
        last real position gives the first sampled token."""
        from horovod_tpu_torch.serving import prefill

        feed = (self.scheduler.bulk_tokens(sp.request_id)
                if self.scheduler is not None else [])
        buf, real_len = prefill.broadcast_prompt(feed, sp.bulk_len)
        k_all, v_all, sampled = self._prefill(buf, real_len)
        prefill.scatter_bulk(self.pages, k_all, v_all, table, real_len,
                             self._trash)
        return sampled

    # -- the loop ---------------------------------------------------------

    def _broadcast_plan(self, buf: np.ndarray) -> np.ndarray:
        """Rank 0's packed plan on every rank (one fixed-shape int32
        tensor through the engine, named ``serve.plan``)."""
        wire = torch.from_numpy(buf)
        mpi_ops.broadcast_(wire, 0, name="serve.plan")
        return buf

    def run(self) -> None:
        """One rank's serve loop.  Any exception that ends it fails the
        in-flight requests typed first (never hang)."""
        try:
            self._loop()
        except Exception as exc:
            if self.scheduler is not None:
                self.scheduler.fail_all(exc)
            raise

    def _loop(self) -> None:
        cfg = self.cfg
        rank0 = _common.rank() == 0
        plan_shape = sched.plan_size(cfg)
        registry = metrics.registry
        while True:
            plan = None
            if rank0 and self._stop.is_set():
                buf = sched.pack_control(cfg, sched.OP_STOP)
            elif rank0:
                plan = (self.scheduler.step_plan()
                        if self.scheduler else None)
                buf = (sched.pack_plan(cfg, plan) if plan
                       else sched.pack_control(cfg, sched.OP_IDLE))
            else:
                buf = np.zeros(plan_shape, np.int32)
            try:
                wire = self._broadcast_plan(buf)
            except _common.MembershipChangedError:
                # A reshape mid-decode: the step never ran; plan again.
                _common.membership_ack()
                if rank0 and self.scheduler:
                    self.scheduler.reform([])
                continue
            opcode = int(wire[0])
            if opcode == sched.OP_STOP:
                return
            if opcode == sched.OP_IDLE:
                if rank0:
                    time.sleep(cfg.idle_sleep_sec)
                continue
            if not rank0:
                plan = sched.unpack_plan(cfg, wire)
            t0 = time.perf_counter()
            try:
                sampled = self._execute(plan)
            except _common.MembershipChangedError:
                # The bulk prefill's broadcast was cancelled: the page
                # writes already made repeat on the replay.
                _common.membership_ack()
                if rank0 and self.scheduler:
                    self.scheduler.reform([])
                continue
            if registry.enabled:
                registry.observe("step_sec", time.perf_counter() - t0)
            if rank0 and self.scheduler:
                self.scheduler.complete_step(plan, sampled)
