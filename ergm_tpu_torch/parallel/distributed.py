"""Several processes, one per device (counterpart of
``ergm_tpu/parallel/distributed.py``).

JAX runs one process per host and ``jax.distributed.initialize`` joins
the hosts; PyTorch runs one process per device and joins them into a
``torch.distributed`` process group. The two counts compose so:

- ``ERGM_COORDINATOR`` / ``ERGM_NUM_PROCESSES`` / ``ERGM_PROCESS_ID``
  keep JAX's meaning: the address of host 0, the number of hosts and
  this host's index.
- ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` (torchrun's names) say which of
  this host's devices the process drives and how many processes the
  host runs. The local rank picks ``cuda:<local_rank>``.
- The global rank is ``process_id * local_world_size + local_rank`` and
  the world holds ``num_processes * local_world_size`` ranks, so the
  ranks of one host are consecutive (a mesh's model axis, the minor
  one, stays inside a host).

The backend follows the device: NCCL for CUDA tensors, gloo for CPU
tensors. Another backend is used only when the caller names it
(``backend="gloo"`` for CUDA tensors that cross the host).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_KEYS = ("ERGM_COORDINATOR", "ERGM_NUM_PROCESSES", "ERGM_PROCESS_ID")


def _summary(process_index: int, process_count: int, local: int) -> dict:
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": process_index, "process_count": process_count,
            "local_devices": local, "global_devices": world,
            "rank": dist.get_rank() if dist.is_initialized() else 0,
            "backend": dist.get_backend() if dist.is_initialized() else None}


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:<LOCAL_RANK>``, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


def _init(init_method: str, rank: int, world: int, device, backend: Optional[str]) -> None:
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if (backend or backend_for(device)) == "nccl":
            kw["device_id"] = device  # binds the communicator to this card eagerly
    dist.init_process_group(backend or backend_for(device), init_method=init_method,
                            world_size=world, rank=rank, **kw)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> dict:
    """Join this process to the world; a no-op for a world of one.

    ``coordinator_address`` (``host:port`` of host 0), ``num_processes``
    (hosts) and ``process_id`` (this host) are JAX's. ``local_rank`` and
    ``local_world_size`` (default: ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``,
    else 0 and 1) place the process among its host's. ``device``
    (default ``cuda:<local_rank>``) picks the backend, NCCL or gloo,
    unless ``backend`` names one. Returns JAX's summary dict
    (``process_index``, ``process_count``, ``local_devices``,
    ``global_devices``) with the global ``rank`` and the ``backend``."""
    hosts = int(num_processes or 1)
    host = int(process_id or 0)
    lr = int(os.environ.get("LOCAL_RANK", "0") if local_rank is None else local_rank)
    lw = int(os.environ.get("LOCAL_WORLD_SIZE", "1") if local_world_size is None
             else local_world_size)
    world = hosts * lw
    if world > 1 or coordinator_address:
        if not coordinator_address:
            raise ValueError("a world of several processes needs coordinator_address")
        if not 0 <= host < hosts or not 0 <= lr < lw:
            raise ValueError(f"process {host} of {hosts}, local rank {lr} of {lw}")
        if device is None:
            device = local_device("cuda")
        _init(f"tcp://{coordinator_address}", host * lw + lr, world, device, backend)
    return _summary(host, hosts, lw)


def initialize_from_env(environ=None, device=None, backend: Optional[str] = None
                        ) -> Optional[dict]:
    """Join the world the launcher environment describes, or return None.

    ``ERGM_COORDINATOR`` / ``ERGM_NUM_PROCESSES`` / ``ERGM_PROCESS_ID``
    (JAX's contract: all three or none; a partial set raises, since a
    pod that silently trains host by host duplicates data) with
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; else an external launcher's
    ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``
    (torchrun's, a world of one included). ``device`` defaults to
    ``cuda:<LOCAL_RANK>``."""
    env = os.environ if environ is None else environ
    present = [k for k in _KEYS if env.get(k)]
    if present and len(present) < len(_KEYS):
        missing = sorted(set(_KEYS) - set(present))
        raise ValueError(
            f"Partial multi-host environment: {present} set but {missing} "
            f"missing; export all of {_KEYS} (or none).")
    if present:
        return initialize(
            coordinator_address=env["ERGM_COORDINATOR"],
            num_processes=int(env["ERGM_NUM_PROCESSES"]),
            process_id=int(env["ERGM_PROCESS_ID"]),
            local_rank=int(env.get("LOCAL_RANK", "0")),
            local_world_size=int(env.get("LOCAL_WORLD_SIZE", "1")),
            device=device, backend=backend)
    if env.get("WORLD_SIZE") is None:
        return None
    world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
    lw = int(env.get("LOCAL_WORLD_SIZE", world))
    addr = f"{env.get('MASTER_ADDR', 'localhost')}:{env.get('MASTER_PORT', '29500')}"
    _init(f"tcp://{addr}", rank, world, local_device("cuda") if device is None else device,
          backend)
    return _summary(rank // max(lw, 1), max(world // max(lw, 1), 1), lw)


def shutdown() -> None:
    """Leaves the world (a no-op outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
