"""Sharded durable checkpoints: ``ckpt-<step>/rank-N.pkl`` + manifest.

Own copy of ``horovod_tpu/state/checkpoint.py`` on torch tensors, in the
same format, so each package reads the other's checkpoints.  Every rank
writes only the leaves it owns (``partition.owner``: leaf ``i`` goes to
rank ``i % size``), O(model/size) a rank, and rank 0 commits
``manifest.json`` atomically once a named barrier has seen every shard
land.

Commit protocol:

1. every rank writes ``rank-<r>.pkl`` (a temporary file, then a rename);
2. barrier ``__ckpt.<step>.barrier``: every shard is on disk;
3. rank 0 writes ``manifest.json`` (temporary file, rename), the commit
   point: a directory without a manifest is torn and invisible to
   :func:`scan_checkpoints`;
4. barrier ``__ckpt.<step>.commit``: no rank returns before the commit;
5. the caller prunes past ``keep`` (``torch/train.py::save_checkpoint``).

A shard document holds ``format``, ``step``, ``rank``, ``size``, the
``skeleton`` (the tree with each leaf replaced by its index), the
``objects`` (non-array leaves, replicated into every shard verbatim) and
the ``leaves`` this rank owns.  Array leaves are ``torch.Tensor`` or
numpy arrays; only owned ones are copied to the host, the rest give only
shape and dtype to the manifest.  Shards hold numpy arrays, never torch
objects, so the JAX package unpickles them.  A bfloat16 leaf is written
in numpy's own pickle form of an ``ml_dtypes.bfloat16`` array
(:class:`_Bf16Array`) without importing ``ml_dtypes``, and read back,
from either package's files, as a ``torch.bfloat16`` tensor bit for bit
by :class:`_Unpickler`, which needs no ``ml_dtypes`` either.

Reading: with the engine up at the manifest's world size, each rank reads
only its own shard and every other array leaf arrives by broadcast from
its owner under ``__ckpt.load.<step>.<i>`` (the bytes of the leaf, so any
dtype goes; on CUDA staged through pinned memory by ``torch/mpi_ops.py``);
any other reader assembles all shards itself.  Array leaves come back as
torch tensors on the reader's device (the CPU unless one is named).
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import shutil
import tempfile
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common import metrics as _metrics
from horovod_tpu_torch.state import _tree, partition

MANIFEST = "manifest.json"
SHARD_FORMAT = "hvd-tpu-sharded-v1"
CKPT_PREFIX = "ckpt-"
CKPT_SUFFIX = ".pkl"


def shard_file(rank: int) -> str:
    return f"rank-{rank}.pkl"


def is_array_leaf(leaf: Any) -> bool:
    """Array leaves shard and broadcast; any other leaf (python scalars,
    strings) is replicated into every shard verbatim."""
    return torch.is_tensor(leaf) or isinstance(leaf, np.ndarray)


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype.name
    return leaf.dtype.name


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=name)).dtype


# --- bfloat16 without ml_dtypes -------------------------------------------


class _Reduce:
    """Pickles as ``fn(*args)``: a call the reader makes as it loads."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


# ``numpy.dtype(ml_dtypes.bfloat16)`` as the reader will compute it.
_BF16_DTYPE = _Reduce(np.dtype, _Reduce(
    getattr, _Reduce(importlib.import_module, "ml_dtypes"), "bfloat16"),
    False, True)


class _Bf16Array:
    """A bfloat16 array's bits (int16 or uint16) that pickle exactly as
    numpy pickles an ``ml_dtypes.bfloat16`` array of that shape: the JAX
    package loads an ``ml_dtypes`` array, and :class:`_Unpickler` a
    ``torch.bfloat16`` tensor."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.ascontiguousarray(bits).view(np.uint16)

    def __reduce__(self):
        fn, args, (version, shape, _, fortran, raw) = self.bits.__reduce__()
        return fn, args, (version, shape, _BF16_DTYPE, fortran, raw)


class _Bf16Type:
    """Stands for ``ml_dtypes.bfloat16`` while loading."""


class _Bf16DType:
    """Stands for ``numpy.dtype(ml_dtypes.bfloat16)`` while loading."""

    def __setstate__(self, state):
        pass


_BF16_MARK = _Bf16DType()
_ML_DTYPES = types.SimpleNamespace(bfloat16=_Bf16Type)


class _LoadedArray(np.ndarray):
    """An array being unpickled; ``bf16`` when it holds bfloat16 bits
    (kept as uint16 until :func:`_as_tensor` views them)."""

    def __setstate__(self, state):
        version, shape, dtype, fortran, raw = state
        self.bf16 = dtype is _BF16_MARK
        if self.bf16:
            dtype = np.dtype(np.uint16)
        super().__setstate__((version, shape, dtype, fortran, raw))


def _reconstruct(subtype, shape, dtype):
    return np.ndarray.__new__(_LoadedArray, shape, dtype)


def _frombuffer(buf, dtype, shape, order):
    bf16 = dtype is _BF16_MARK
    arr = np.frombuffer(buf, np.uint16 if bf16 else dtype).reshape(
        shape, order=order).view(_LoadedArray)
    arr.bf16 = bf16
    return arr


def _dtype(obj, align=False, copy=False):
    if obj is _Bf16Type:
        return _BF16_MARK
    return np.dtype(obj, align, copy)


def _import_module(name: str):
    return _ML_DTYPES if name == "ml_dtypes" else importlib.import_module(
        name)


class _Missing(tuple):
    """Stand-in for a class whose module cannot be imported here (the
    JAX package's optax states where JAX is absent): a tuple of its
    constructor's arguments, so a namedtuple's leaves walk as a tuple's,
    with any pickled state kept beside."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        self.state = state


_NUMPY_HOOKS = {
    ("numpy", "dtype"): _dtype,
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy._core.numeric", "_frombuffer"): _frombuffer,
    ("numpy.core.numeric", "_frombuffer"): _frombuffer,
    ("importlib", "import_module"): _import_module,
}


class _Unpickler(pickle.Unpickler):
    """Loads either package's checkpoints: numpy arrays as
    :class:`_LoadedArray`, bfloat16 ones without ``ml_dtypes``, and a
    class whose module does not import here as a :class:`_Missing`."""

    def find_class(self, module, name):
        hook = _NUMPY_HOOKS.get((module, name))
        if hook is not None:
            return hook
        if module.split(".")[0] == "ml_dtypes":
            if name != "bfloat16":
                raise pickle.UnpicklingError(
                    f"ml_dtypes.{name} arrays are not supported")
            return _Bf16Type
        try:
            return super().find_class(module, name)
        except ImportError:
            return type(name, (_Missing,), {"__module__": module})


def load_pickle(f) -> Any:
    """Unpickle a checkpoint file object with :class:`_Unpickler`."""
    return _Unpickler(f).load()


def _to_host(leaf: Any) -> Any:
    """An array leaf as what a shard holds: a numpy array (bfloat16 as
    :class:`_Bf16Array`); any other leaf as it is."""
    if not torch.is_tensor(leaf):
        return leaf
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return _Bf16Array(t.view(torch.int16).numpy())
    return t.numpy()


def host_tree(tree: Any) -> Any:
    """``tree`` as a checkpoint holds it: tensors as numpy arrays."""
    leaves, rebuild = partition.flatten_tree(tree)
    return rebuild([_to_host(x) for x in leaves])


def _as_tensor(arr: Any, device=None) -> torch.Tensor:
    """A loaded array (or a tensor) as a torch tensor on ``device``."""
    if not torch.is_tensor(arr):
        bf16 = getattr(arr, "bf16", False)
        arr = arr.view(np.ndarray)
        if not (arr.flags.c_contiguous and arr.flags.writeable):
            arr = arr.copy(order="C")
        arr = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
        if bf16:
            arr = arr.view(torch.bfloat16)
    return arr.to(device) if device is not None else arr


def tensors(tree: Any, device=None) -> Any:
    """``tree`` with every array leaf a torch tensor on ``device`` (the
    CPU by default)."""
    leaves, rebuild = partition.flatten_tree(tree)
    return rebuild([_as_tensor(x, device) if is_array_leaf(x) else x
                    for x in leaves])


def atomic_write(path: str, write_fn) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# --- save -------------------------------------------------------------------


def save_sharded(directory: str, step: int, tree: Any, rank: int,
                 size: int, barrier=None) -> str:
    """Write this rank's shard of ``ckpt-<step>/`` and (rank 0) commit the
    manifest; returns the checkpoint directory.  ``barrier(name)`` is the
    named-collective barrier (None for a single writer)."""
    ckpt_dir = os.path.join(directory, f"{CKPT_PREFIX}{int(step):08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    names: List[str] = []
    leaves, rebuild = _tree.flatten(tree, names)
    # Stored in every shard, so any one shard explains the structure.
    skeleton = rebuild(list(range(len(leaves))))
    own_idx = set(partition.shard_indices(rank, size, len(leaves)))
    array_meta: List[Optional[dict]] = []
    objects: Dict[int, Any] = {}
    own: Dict[int, Any] = {}
    for i, leaf in enumerate(leaves):
        if is_array_leaf(leaf):
            shape = [int(s) for s in leaf.shape]
            itemsize = (leaf.element_size() if torch.is_tensor(leaf)
                        else leaf.dtype.itemsize)
            array_meta.append({"shape": shape, "dtype": _dtype_name(leaf),
                               "nbytes": int(itemsize * int(np.prod(shape)))})
            if i in own_idx:
                own[i] = _to_host(leaf)
        else:
            array_meta.append(None)
            objects[i] = leaf
    shard_doc = {"format": SHARD_FORMAT, "step": int(step), "rank": rank,
                 "size": size, "skeleton": skeleton, "objects": objects,
                 "leaves": own}
    path = os.path.join(ckpt_dir, shard_file(rank))
    atomic_write(path, lambda f: pickle.dump(
        shard_doc, f, protocol=pickle.HIGHEST_PROTOCOL))
    shard_nbytes = os.path.getsize(path)
    if barrier is not None:
        barrier(f"__ckpt.{int(step)}.barrier")
    if rank == 0:
        manifest = {
            "format": SHARD_FORMAT,
            "step": int(step),
            "size": size,
            "leaf_count": len(leaves),
            "leaves": [
                {"index": i, "name": names[i] or f"leaf.{i}",
                 "shard": partition.owner(i, size),
                 **(array_meta[i] if array_meta[i] is not None
                    else {"object": True})}
                for i in range(len(leaves))],
            "shards": [{"rank": r, "file": shard_file(r)}
                       for r in range(size)],
        }
        atomic_write(os.path.join(ckpt_dir, MANIFEST), lambda f: f.write(
            (json.dumps(manifest, indent=2) + "\n").encode()))
    if barrier is not None:
        barrier(f"__ckpt.{int(step)}.commit")
    _metrics.registry.record_state_ckpt("sharded_saves", nbytes=shard_nbytes)
    return ckpt_dir


# --- load -------------------------------------------------------------------


def read_manifest(ckpt_dir: str) -> dict:
    """The committed manifest of a sharded checkpoint directory;
    ``ValueError`` when missing (torn) or malformed."""
    path = os.path.join(ckpt_dir, MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except OSError:
        raise ValueError(
            f"torn sharded checkpoint {ckpt_dir}: no committed "
            f"{MANIFEST} (the writer died before the commit point)")
    except ValueError as exc:
        raise ValueError(f"corrupt manifest in {ckpt_dir}: {exc}")
    if manifest.get("format") != SHARD_FORMAT:
        raise ValueError(f"unknown checkpoint format in {ckpt_dir}: "
                         f"{manifest.get('format')!r}")
    return manifest


def read_shard(ckpt_dir: str, manifest: dict, rank: int) -> dict:
    """Rank ``rank``'s shard document, checked against the manifest; a
    missing, unreadable or mismatched shard raises ``ValueError``."""
    path = os.path.join(ckpt_dir, shard_file(rank))
    try:
        with open(path, "rb") as f:
            doc = load_pickle(f)
    except OSError:
        raise ValueError(
            f"torn sharded checkpoint {ckpt_dir}: missing shard "
            f"{shard_file(rank)} (manifest expects {manifest['size']} "
            f"shards)")
    except Exception as exc:  # a truncated or corrupt pickle is torn too
        raise ValueError(
            f"torn sharded checkpoint {ckpt_dir}: shard "
            f"{shard_file(rank)} is unreadable "
            f"({type(exc).__name__}: {exc})")
    if not isinstance(doc, dict):
        raise ValueError(
            f"torn sharded checkpoint {ckpt_dir}: shard "
            f"{shard_file(rank)} does not hold a shard document")
    if doc.get("step") != manifest["step"] \
            or doc.get("size") != manifest["size"]:
        raise ValueError(
            f"torn sharded checkpoint {ckpt_dir}: shard "
            f"{shard_file(rank)} is step {doc.get('step')} / size "
            f"{doc.get('size')}, manifest says step {manifest['step']} / "
            f"size {manifest['size']}")
    return doc


def load_sharded(ckpt_dir: str, collective: bool = True,
                 device=None) -> Tuple[int, Any]:
    """``(step, tree)`` from a committed sharded checkpoint, array leaves
    as tensors on ``device`` (the CPU by default).

    With ``collective=True`` and the engine up at the manifest's world
    size, each rank reads only its own shard and receives the other
    array leaves by broadcast (every rank must call).  Otherwise every
    shard is read here: any world size, engine or not."""
    from horovod_tpu_torch import common as _common

    manifest = read_manifest(ckpt_dir)
    size = manifest["size"]
    if (collective and size > 1 and _common.is_initialized()
            and _common.size() == size):
        tree = _load_collective(ckpt_dir, manifest, device)
    else:
        tree = _load_local(ckpt_dir, manifest, device)
    _metrics.registry.record_state_ckpt("loads")
    return int(manifest["step"]), tree


def _assemble(skeleton: Any, objects: Dict[int, Any],
              arrays: Dict[int, Any], n: int) -> Any:
    order, rebuild = partition.flatten_tree(skeleton)
    values: List[Any] = []
    for idx in order:
        idx = int(idx)
        if idx in objects:
            values.append(objects[idx])
        elif idx in arrays:
            values.append(arrays[idx])
        else:
            raise ValueError(f"sharded checkpoint reassembly missing leaf "
                             f"{idx} of {n}")
    return rebuild(values)


def _load_local(ckpt_dir: str, manifest: dict, device) -> Any:
    arrays: Dict[int, Any] = {}
    objects: Dict[int, Any] = {}
    skeleton = None
    for r in range(manifest["size"]):
        doc = read_shard(ckpt_dir, manifest, r)
        skeleton = doc["skeleton"] if skeleton is None else skeleton
        objects.update(doc.get("objects", {}))
        arrays.update({i: _as_tensor(a, device)
                       for i, a in doc.get("leaves", {}).items()})
    return _assemble(skeleton, objects, arrays, manifest["leaf_count"])


def _load_collective(ckpt_dir: str, manifest: dict, device) -> Any:
    from horovod_tpu_torch import common as _common
    from horovod_tpu_torch.torch import mpi_ops

    rank = _common.rank()
    doc = read_shard(ckpt_dir, manifest, rank)
    own = doc.get("leaves", {})
    step = manifest["step"]
    prefix = f"__ckpt.load.{step}."
    dev = torch.device(device) if device is not None else torch.device(
        "cpu")
    arrays: Dict[int, torch.Tensor] = {}
    handles = []
    for meta in manifest["leaves"]:
        if meta.get("object"):
            continue  # replicated into every shard
        i, root = meta["index"], meta["shard"]
        if root == rank:
            t = _as_tensor(own[i], dev).contiguous()
        else:
            t = torch.empty(meta["shape"], dtype=_torch_dtype(meta["dtype"]),
                            device=dev)
        arrays[i] = t
        # The leaf's bytes: a broadcast moves them whatever the dtype.
        if t.numel():
            handles.append(mpi_ops.broadcast_async_(
                t.view(-1).view(torch.uint8), root, name=f"{prefix}{i}"))
    try:
        for h in handles:
            h.synchronize()
    finally:
        mpi_ops.release_buffers(prefix)
    return _assemble(doc["skeleton"], dict(doc.get("objects", {})), arrays,
                     manifest["leaf_count"])


# --- scanning and retention ---------------------------------------------------


def scan_checkpoints(directory: str) -> List[Tuple[int, str, str]]:
    """Every committed checkpoint under ``directory``, ``[(step, path,
    kind)]`` by step, kind ``"legacy"`` (one pickle) or ``"sharded"`` (a
    directory with a committed manifest).  Torn directories are
    invisible."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    found = []
    for name in names:
        if not name.startswith(CKPT_PREFIX):
            continue
        path = os.path.join(directory, name)
        if name.endswith(CKPT_SUFFIX):
            try:
                step = int(name[len(CKPT_PREFIX):-len(CKPT_SUFFIX)])
            except ValueError:
                continue
            found.append((step, path, "legacy"))
        elif os.path.isdir(path):
            try:
                step = int(name[len(CKPT_PREFIX):])
            except ValueError:
                continue
            if os.path.exists(os.path.join(path, MANIFEST)):
                found.append((step, path, "sharded"))
    return sorted(found)


def retention_keep() -> Optional[int]:
    """``HVD_TPU_CKPT_KEEP``: how many committed checkpoints to keep
    (unset or <= 0: all)."""
    raw = os.environ.get("HVD_TPU_CKPT_KEEP")
    if not raw:
        return None
    try:
        keep = int(raw)
    except ValueError:
        raise ValueError(f"HVD_TPU_CKPT_KEEP must be an integer, got "
                         f"{raw!r}")
    return keep if keep > 0 else None


def prune_checkpoints(directory: str, keep: Optional[int],
                      protect_step: Optional[int] = None) -> List[str]:
    """Delete the oldest committed checkpoints past the newest ``keep``;
    ``protect_step`` (the one just written) and torn directories are never
    touched.  Returns the pruned paths."""
    if keep is None or keep <= 0:
        return []
    entries = scan_checkpoints(directory)
    pruned = []
    for step, path, kind in entries[:-keep]:
        if protect_step is not None and step == int(protect_step):
            continue
        try:
            if kind == "sharded":
                # The manifest first: a concurrent reader sees a torn
                # directory, never a half-deleted committed one.
                os.unlink(os.path.join(path, MANIFEST))
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.unlink(path)
        except OSError:
            continue
        pruned.append(path)
        _metrics.registry.record_state_ckpt("pruned")
    return pruned
