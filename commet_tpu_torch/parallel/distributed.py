"""More than one process: each rank runs the same CLI command on a shared
filesystem, and the commet driver strides its comparison rounds across the
ranks (rank r runs rounds r, r + P, ...), deferring the matrices to a
commet_analysis run once every rank has finished, as the reference's SGE
mode does (Commet.py:119,204-236,580-586). Counterpart of
commet_tpu/parallel/distributed.py.

Activation is environment-driven, with commet_tpu's names:

    COMMET_TPU_COORDINATOR=host0:8476   # rank 0's address and a free port
    COMMET_TPU_NUM_PROCESSES=4          # world size
    COMMET_TPU_PROCESS_ID=0..3          # this process's rank

or COMMET_TPU_DISTRIBUTED=1 alone, which takes torchrun's variables
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). The process group uses the
gloo backend: the only thing that crosses processes is the barrier after
rank 0 has filtered the reads; no tensor does, so ranks may share a card.
Within a process, COMMET_TPU_DEVICES selects a mesh over its local devices
(sharded.auto_mesh). A rank that cannot join its coordinator raises.
"""

from __future__ import annotations

import atexit
import os

_initialized = False


def init_distributed() -> bool:
    """Join the process group the COMMET_TPU_* variables describe. Returns
    True when a multi-process run was (or already had been) set up; without
    the variables a no-op that returns False."""
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get("COMMET_TPU_COORDINATOR")
    auto = os.environ.get("COMMET_TPU_DISTRIBUTED") == "1"
    if not coord and not auto:
        return False
    import torch.distributed as dist

    if coord:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["COMMET_TPU_NUM_PROCESSES"]),
            rank=int(os.environ["COMMET_TPU_PROCESS_ID"]))
    else:
        dist.init_process_group("gloo", init_method="env://")
    atexit.register(dist.destroy_process_group)
    _initialized = True
    return True


def process_count() -> int:
    if not _initialized:
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def process_index() -> int:
    if not _initialized:
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def is_primary() -> bool:
    """True on the process that writes shared files (rank 0)."""
    return process_index() == 0


def barrier() -> None:
    """Wait until every rank has reached this point (no-op alone)."""
    if _initialized:
        import torch.distributed as dist
        dist.barrier()
