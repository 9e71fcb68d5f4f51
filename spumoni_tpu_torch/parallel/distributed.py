"""Multi-host runs of the port on torch.distributed (gloo).

Counterpart of `spumoni_tpu/parallel/distributed.py`. Every host runs the
same program with its own copy of the index; hosts stream disjoint slices
of the query file (round-robin by record index: host p owns the records
i with i % P == p), write per-host shard files and a per-host cursor, and
meet once, at the end of the run, in one collective: the all-gather of
their (found, total) counts, which is also the barrier after which process
0 merges the shard files into the single-process layout. No collective
runs inside the streaming loop, so the CPU backend gloo serves any card.

The same code runs in one process (P = 1: no process group, identity
merges), so a 2-host run can be simulated file by file in one process
(host 1, then host 0, which merges), as the JAX package's tests do.

    SPUMONI_COORDINATOR=host0:29500 SPUMONI_NUM_PROCESSES=2 \\
        SPUMONI_PROCESS_ID=p python -m spumoni_tpu_torch run ...
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as tdist

#: seconds a host waits for its peers, at the rendezvous and in the
#: end-of-run all-gather: a dead peer fails the run instead of hanging it;
#: a live one must finish its slice within it
DEFAULT_TIMEOUT_S = 1800


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Joins the gloo process group when the environment (or the
    arguments) names more than one process: SPUMONI_COORDINATOR (host:port
    of process 0's rendezvous), SPUMONI_NUM_PROCESSES and SPUMONI_PROCESS_ID.
    Returns (process_index, process_count), (0, 1) with no such
    environment. Raises where P > 1 lacks the coordinator or the id."""
    coordinator = coordinator or os.environ.get("SPUMONI_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SPUMONI_NUM_PROCESSES", "1"))
    if process_id is None and "SPUMONI_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SPUMONI_PROCESS_ID"])
    if num_processes <= 1:
        return 0, 1
    if not coordinator or process_id is None:
        raise ValueError(f"SPUMONI_NUM_PROCESSES={num_processes} needs "
                         f"SPUMONI_COORDINATOR (host:port) and "
                         f"SPUMONI_PROCESS_ID")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"SPUMONI_PROCESS_ID={process_id} is not in "
                         f"[0, {num_processes})")
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return tdist.get_rank(), tdist.get_world_size()


def finalize() -> None:
    """Leaves the process group, where initialize joined one."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def host_shard_reads(reads_iter, process_index: int, process_count: int):
    """Deterministic round-robin host sharding of a query stream: host p
    processes records with index % process_count == p."""
    for i, item in enumerate(reads_iter):
        if i % process_count == process_index:
            yield i, item


def shard_path(base_path: str, process_index: int, process_count: int) -> str:
    if process_count == 1:
        return base_path
    return f"{base_path}.shard{process_index:04d}"


def merge_shards(base_path: str, process_count: int,
                 header: str | None = None) -> None:
    """Process-0 merge: interleaves per-host shard files back into the global
    record order (hosts wrote records i with i % P == p, in order)."""
    if process_count == 1:
        return
    readers = [open(shard_path(base_path, p, process_count))
               for p in range(process_count)]
    with open(base_path, "w") as out:
        if header is not None:
            out.write(header)
        records = [_read_records(r) for r in readers]
        done = False
        while not done:
            done = True
            for p in range(process_count):
                rec = next(records[p], None)
                if rec is not None:
                    out.write(rec)
                    done = False
    for p, r in enumerate(readers):
        r.close()
        os.remove(shard_path(base_path, p, process_count))


def _read_records(f):
    """Yields one output record at a time: either a '>id' line plus its value
    line, or a single report line."""
    while True:
        line = f.readline()
        if not line:
            return
        if line.startswith(">"):
            vals = f.readline()
            yield line + vals
        else:
            yield line


def global_found_counts(local_found: int, local_total: int):
    """Sums the hosts' (found, total) classification tallies: an all-gather
    of an int64 CPU tensor over the process group, which is also the
    end-of-run barrier; the identity without a process group (one process,
    or the file-level simulation of several)."""
    if not tdist.is_initialized():
        return local_found, local_total
    mine = torch.tensor([local_found, local_total], dtype=torch.int64)
    every = [torch.zeros_like(mine) for _ in range(tdist.get_world_size())]
    tdist.all_gather(every, mine)
    total = torch.stack(every).sum(dim=0)
    return int(total[0]), int(total[1])
