"""``python -m paddle_tpu_torch.distributed.launch [--nproc_per_node N]
script.py [args...]``

Parity: ``python -m paddle.distributed.launch`` (reference:
fleet/launch.py).  Without ``--nproc_per_node`` the script runs in this
process under the launch environment (``PADDLE_TRAINER_*`` /
``COORDINATOR_ADDRESS``, one process per rank wired by the caller); with
it, N ranks start here (:func:`~.parallel.spawn`).
"""
from .parallel import launch

if __name__ == "__main__":
    raise SystemExit(launch())
