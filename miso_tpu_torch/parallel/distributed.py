"""Multi-host execution: the port of ``miso_tpu/parallel/distributed.py``,
the replacement for the reference's qsub/SGE cluster layer
(misopy/cluster_utils.py:63-300).

Every host runs the SAME ``miso_torch --run`` command with its host
coordinates: a coordinator address, the number of hosts and its own id,
all three.  The hosts rendezvous over a ``torch.distributed`` gloo group
(TCP), as ``jax.distributed.initialize`` does in the JAX package, so a
host that was started with the wrong address, count or id fails at the
start and not after its shard has run.  Nothing is reduced over the
group: each host takes a static round-robin shard of the gene list
(``host_shard``), runs it on its own device and writes only its shard's
``.miso`` files and its own ``<label>.host<k>.miso_summary`` into the
shared output tree, which stays reference-layout compatible.  ``shutdown`` destroys
the group at the end of the run.

The rank and the count live in this module (``process_index``,
``process_count``); ``pipeline.py`` reads them for the per-host summary
label and for the host axis of the chunk seeds.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

# seconds a host waits for the others at the rendezvous
# (jax.distributed.initialize's initialization_timeout default)
RENDEZVOUS_TIMEOUT = 300

_STATE = {"rank": 0, "count": 1, "group": False}


def process_index() -> int:
    """This host's id, 0 where no multi-host run was formed."""
    return _STATE["rank"]


def process_count() -> int:
    """The number of hosts of this run, 1 where none was formed."""
    return _STATE["count"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Form the multi-host run.  Arguments fall back to the env vars
    MISO_COORDINATOR_ADDRESS, MISO_NUM_HOSTS and MISO_HOST_ID.  Returns
    True if the run has more than one host."""
    coordinator_address = coordinator_address or os.environ.get(
        "MISO_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("MISO_NUM_HOSTS")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("MISO_HOST_ID")
        process_id = int(env) if env else None
    if coordinator_address is None and num_processes is None:
        return False  # single host
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-host run needs --coordinator, --num-hosts "
                         "and --host-id (or MISO_COORDINATOR_ADDRESS, "
                         "MISO_NUM_HOSTS and MISO_HOST_ID)")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError("--host-id %d is outside 0 ... %d (--num-hosts %d)"
                         % (process_id, num_processes - 1, num_processes))
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method="tcp://%s" % coordinator_address,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT))
    _STATE.update(rank=process_id, count=num_processes, group=True)
    return num_processes > 1


def shutdown() -> None:
    """Leave the multi-host run: destroy the rendezvous group, if one was
    formed, and forget the rank and the count."""
    if _STATE["group"]:
        import torch.distributed as dist

        dist.destroy_process_group()
    _STATE.update(rank=0, count=1, group=False)


def host_shard(items, process_id: Optional[int] = None,
               process_count: Optional[int] = None):
    """Static round-robin shard of a work list for this host.  Each host
    ingests only its own genes' reads (host-side IO parallelism) and runs
    its device-side batches locally."""
    pid = _STATE["rank"] if process_id is None else process_id
    n = _STATE["count"] if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % n == pid]
