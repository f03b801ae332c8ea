"""The port's launcher (the reference's ``hvdrun``, one host).

CLI:  ``python -m horovod_tpu_torch.runner -np 2 -- python train.py``
API:  :func:`run_command`, :func:`launch_fn`
"""

from horovod_tpu_torch.runner.launch import (  # noqa: F401
    RankResult,
    failure_report,
    launch_fn,
    make_rank_env,
    run_command,
    signal_name,
)
