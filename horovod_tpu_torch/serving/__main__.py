"""Serving-rank entry point: ``python -m horovod_tpu_torch.runner -np N
--serve`` starts this module on every rank (``python -m
horovod_tpu_torch.serving``).

Rank 0 opens the HTTP front door (``HVD_TPU_SERVE_PORT``) over the
scheduler; every rank joins the decode loop on its device
(``HVD_TPU_SERVE_DEVICE``: this rank's card by default, ``cuda:N`` to put
several ranks on one card, ``cpu``).  The model's widths come from
``HVD_TPU_SERVE_*`` (``engine.ModelSpec``, ``scheduler.ServeConfig``).
The process exits 0 on an orderly ``POST /shutdown`` drain; a fatal
collective error exits non-zero.
"""

from __future__ import annotations

import os
import sys


def serve(spec, cfg):
    """One serving rank: ``init()`` on ``spec.device``, the parameters
    root-broadcast, the engine, and on rank 0 the scheduler and the front
    door; runs the decode loop until the drain and returns the engine
    (the caller shuts the engine down)."""
    from horovod_tpu_torch import common as hvd
    from horovod_tpu_torch.serving import server as _server
    from horovod_tpu_torch.serving.engine import (ServingEngine,
                                                  broadcast_params,
                                                  init_params)
    from horovod_tpu_torch.serving.scheduler import (Scheduler,
                                                     ServingUnavailableError)

    hvd.init(device=spec.device or None)
    params = broadcast_params(init_params(spec))
    rank0 = hvd.rank() == 0
    scheduler = Scheduler(cfg) if rank0 else None
    engine = ServingEngine(spec, cfg, params, scheduler)
    if rank0:
        port = _server.start_server(scheduler, cfg, engine=engine)
        print(f"horovod_tpu_torch.serving: listening on port {port} "
              f"(size {hvd.size()}, model {spec.n_layers}L/"
              f"{spec.d_model}d/vocab {spec.vocab}, {spec.dtype}, "
              f"{engine.device})", flush=True)
    try:
        engine.run()
    finally:
        if rank0:
            if scheduler.failed is None:
                scheduler.fail_all(ServingUnavailableError("server shut down"))
            _server.stop_server()
    return engine


def main() -> int:
    from horovod_tpu_torch import common as hvd
    from horovod_tpu_torch.serving.engine import ModelSpec
    from horovod_tpu_torch.serving.scheduler import ServeConfig

    if os.environ.get("HVD_TPU_RESTART_EPOCH", "0") not in ("", "0") or \
            os.environ.get("HVD_TPU_REJOIN"):
        # A relaunched or standby rank cannot recover the in-flight KV
        # state of the job it would join.
        print("horovod_tpu_torch.serving: standby/restarted serve ranks are "
              "not supported; launch fresh", file=sys.stderr)
        return 3
    serve(ModelSpec.from_env(), ServeConfig.from_env())
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
