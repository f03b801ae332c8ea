"""Parallelism layouts of the port: the sequence-parallel ring mesh and
pipeline parallelism (schedules, stage partitioning, transports and the
runner)."""

from horovod_tpu_torch.parallel.mesh import RingMesh  # noqa: F401
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    EngineTransport,
    LocalTransport,
    PipeAction,
    PipelineGrid,
    PipelineRunner,
    TransformerStage,
    bubble_fraction,
    partition_params,
    partition_transformer,
    run_local_pipeline,
    schedule_1f1b,
    schedule_interleaved,
    simulate_schedule,
)

__all__ = [
    "RingMesh", "PipeAction", "schedule_1f1b", "schedule_interleaved",
    "bubble_fraction", "simulate_schedule", "PipelineGrid",
    "TransformerStage", "partition_transformer", "partition_params",
    "LocalTransport", "EngineTransport", "PipelineRunner",
    "run_local_pipeline",
]
