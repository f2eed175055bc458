"""Device meshes for row-sharded rendering (port of
mc_path_tracer_tpu/parallel/mesh.py).

The film's pixel rows are the data-parallel axis: each shard path-traces
its own block of rows against its own copy of the scene, and a train step
sums the parameter gradients over the shards.  JAX builds a
`jax.sharding.Mesh` and lets XLA place arrays; here a `Mesh` is the
ordered list of this process's shard devices (repeats allowed, so one card
or the CPU can hold n shards, as XLA's virtual host devices do), plus the
torch.distributed process group when one is initialised.  Globally the
shards are numbered rank-major, then shard-major: process r's i-th shard
is shard r * len(devices) + i of rank_count * len(devices).  As JAX's
addressable devices are a process's own, a process in a group owns one
card, cuda:LOCAL_RANK (torchrun's numbering of the processes on a host).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device

TILE_AXIS = "tiles"


@dataclass(frozen=True)
class Mesh:
    """This process's shard devices and, under torch.distributed, the
    process group with this process's rank in it."""

    devices: tuple[torch.device, ...]
    group: object = None      # a torch.distributed ProcessGroup, or None
    world_size: int = 1
    rank: int = 0

    @property
    def size(self) -> int:
        """Shards over all processes (JAX's mesh.devices.size)."""
        return self.world_size * len(self.devices)

    def local_shards(self) -> range:
        """Global indices of this process's shards."""
        first = self.rank * len(self.devices)
        return range(first, first + len(self.devices))


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_card() -> int:
    """This process's card in a group: LOCAL_RANK as torchrun sets it, else
    the rank modulo the host's cards (processes numbered host by host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the film-row axis.  `devices` lists the shards' devices
    (repeats allowed, e.g. ["cuda:0"] * 2); without it the mesh takes the
    first `n_devices` cards (all of them by default), and raises if there
    are fewer.  On the CPU pass devices=["cpu"] * n.  The mesh spans every
    process of the default torch.distributed group when one is
    initialised (init_distributed); without `devices` each process then
    takes its own card (local_card()), one shard, as JAX's addressable
    devices."""
    count = torch.cuda.device_count()
    if devices is None and _grouped():
        first, n = local_card(), 1 if n_devices is None else n_devices
        if n != 1:
            raise ValueError(f"make_mesh: a process of a group owns one card, {n} asked "
                             "for; pass devices=[...] to give it others")
    elif devices is None:
        first, n = 0, count if n_devices is None else n_devices
    if devices is None:
        if n < 1 or first + n > count:
            raise ValueError(
                f"make_mesh: {n} CUDA devices asked for from cuda:{first}, {count} available; "
                "pass devices=['cpu'] * n for a CPU mesh or repeat a card for several shards")
        devices = [f"cuda:{i}" for i in range(first, first + n)]
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    if _grouped():
        return Mesh(devices, dist.group.WORLD, dist.get_world_size(), dist.get_rank())
    return Mesh(devices)


def tile_sharding(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """This process's row blocks of a [R, ...] tensor that every process
    holds whole, each on its shard's device.  R must divide by mesh.size."""
    if x.shape[0] % mesh.size != 0:
        raise ValueError(f"{x.shape[0]} rows not divisible by mesh size {mesh.size}")
    rows = x.shape[0] // mesh.size
    return [x[g * rows : (g + 1) * rows].to(dev)
            for g, dev in zip(mesh.local_shards(), mesh.devices)]


def to_device(tree, device: torch.device):
    """A NamedTuple tree (SceneData, CameraParams, ...) with every tensor
    moved to `device`; tensors already there, and non-tensor leaves (None,
    ints) are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    return tree


def replicated(mesh: Mesh, tree) -> list:
    """One copy of a NamedTuple tree per local shard, on the shard's
    device; shards on one device share one copy."""
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = to_device(tree, dev)
    return [copies[dev] for dev in mesh.devices]


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device=DEFAULT_DEVICE) -> None:
    """Join `num_processes` processes at `coordinator` ("host:port") with
    torch.distributed; a no-op for one process.  Called with no coordinator
    it reads torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), as jax.distributed.initialize() detects its cluster; a
    no-op when WORLD_SIZE is unset or 1.  The backend is NCCL for a mesh on
    the card (`device`, the card by default), one process per card, and
    gloo for a CPU mesh, unless `backend` names one; several processes on
    one card must pass backend="gloo" (NCCL refuses two ranks on one GPU),
    and nothing switches backend by itself.  Under NCCL the process's card
    (local_card()) becomes its current device."""
    if coordinator is None and num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        init = dict(init_method="env://")
    else:
        init = dict(init_method=f"tcp://{coordinator}", world_size=num_processes,
                    rank=process_id)
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, **init)
    if backend == "nccl":
        torch.cuda.set_device(local_card())
