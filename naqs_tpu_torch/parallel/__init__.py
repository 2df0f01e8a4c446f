"""Data parallelism over `torch.distributed`, one process a rank: the port
of `naqs_tpu/parallel/` (`multihost.py`, `step.py`), with the collectives
in `comm.py` and the launcher of rank processes in `launch.py`."""

from naqs_tpu_torch.parallel.multihost import (initialize_distributed,  # noqa: F401
                                               rank_device, rank_generator)
