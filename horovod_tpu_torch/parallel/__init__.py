"""Parallelism layouts of the port: the sequence-parallel ring mesh."""

from horovod_tpu_torch.parallel.mesh import RingMesh  # noqa: F401

__all__ = ["RingMesh"]
