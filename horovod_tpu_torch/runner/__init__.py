"""The port's launcher (the reference's ``hvdrun``).

CLI:  ``python -m horovod_tpu_torch.runner -np 2 -- python train.py``
      (``-H``/``--port-base`` multi-host, ``--min-np``/``--max-np``
      elastic, ``--max-restarts``, ``--state-dir``, ``--timeline``,
      ``--postmortem-dir``, ``--net-fault-spec``, ``--serve``)
API:  :func:`run_command`, :func:`run_hosts`, :func:`launch_fn`,
      :func:`run_membership`, :func:`run_elastic`,
      :func:`membership_succeeded`
"""

from horovod_tpu_torch.runner.launch import (  # noqa: F401
    RankResult,
    failure_report,
    launch_fn,
    make_rank_env,
    membership_succeeded,
    run_command,
    run_elastic,
    run_hosts,
    run_membership,
    signal_name,
)
