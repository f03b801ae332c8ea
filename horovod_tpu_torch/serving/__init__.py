"""Serving plane of the port: multi-tenant continuous-batching inference
of the TransformerLM over the collective engine.

Counterpart of ``horovod_tpu/serving/``: a rank-0 HTTP/JSON front door
with per-tenant admission quotas and typed load shedding
(``server.py``); an iteration-level continuous-batching scheduler over a
block-granular KV cache pool (``scheduler.py``, ``kv_cache.py``), whose
batch plan is broadcast each step through the engine's named-collective
path; and a per-rank decode engine over the model's cached-KV decode mode
with a paged KV store on the card and bulk prefill of long prompts
(``engine.py``, ``prefill.py``).

``python -m horovod_tpu_torch.serving`` (or ``python -m
horovod_tpu_torch.runner -np N --serve``) is the server entry point.  The
scheduler and pool import no torch.
"""

from horovod_tpu_torch.serving.kv_cache import BlockPool  # noqa: F401
from horovod_tpu_torch.serving.scheduler import (  # noqa: F401
    AdmissionError,
    Plan,
    Scheduler,
    ServeConfig,
    ServingUnavailableError,
)

__all__ = [
    "AdmissionError",
    "BlockPool",
    "Plan",
    "Scheduler",
    "ServeConfig",
    "ServingUnavailableError",
]
