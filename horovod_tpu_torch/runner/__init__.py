"""The port's launcher (the reference's ``hvdrun``, one host).

CLI:  ``python -m horovod_tpu_torch.runner -np 2 -- python train.py``
      (``--min-np``/``--max-np`` elastic, ``--max-restarts``,
      ``--state-dir``, ``--timeline``, ``--postmortem-dir``, ``--serve``)
API:  :func:`run_command`, :func:`launch_fn`, :func:`run_membership`,
      :func:`run_elastic`, :func:`membership_succeeded`
"""

from horovod_tpu_torch.runner.launch import (  # noqa: F401
    RankResult,
    failure_report,
    launch_fn,
    make_rank_env,
    membership_succeeded,
    run_command,
    run_elastic,
    run_membership,
    signal_name,
)
