"""Device mesh construction and memory accounting (twin of
``gpusimilarity_tpu/parallel/mesh.py``).

A library is cut into contiguous row spans, one per shard, in mesh order.
:class:`Mesh` holds the shards this process serves, each on a
``torch.device``, and every process's shard count, so every process derives
the same global layout without communicating. A device may appear more
than once: several shards on one card (the smoke run on one H100), or
``["cpu"] * 4`` for the CPU tests, the torch counterpart of the JAX tests'
fake host devices. A CUDA device that is not there raises: nothing quietly
falls back to the CPU or to fewer shards. Processes may share a card (two
server processes on one H100); the mesh records every process's cards, so
memory counts each physical card once over the whole job.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass(frozen=True)
class Mesh:
    """The shards of a library: this process's devices, one per local
    shard in mesh order, this process's index, every process's shard count
    (a one-process mesh by default) and every process's distinct cards, by
    identity (:func:`card_ids`; only a multi-process mesh of cards needs
    them)."""

    devices: tuple[torch.device, ...]
    process_index: int = 0
    process_shards: tuple[int, ...] = ()
    process_cards: tuple[tuple[str, ...], ...] = ()

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)
        if not self.process_shards:
            object.__setattr__(self, "process_shards", (len(devices),))
        if self.process_shards[self.process_index] != len(devices):
            raise ValueError(
                f"process {self.process_index} has {len(devices)} shards, "
                f"the mesh says {self.process_shards[self.process_index]}"
            )

    @property
    def n_shards(self) -> int:
        """Shards over every process."""
        return sum(self.process_shards)

    @property
    def n_processes(self) -> int:
        return len(self.process_shards)

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return sum(self.process_shards[: self.process_index])

    @property
    def distinct_devices(self) -> tuple[torch.device, ...]:
        """This process's devices, each once, in first-seen order."""
        return tuple(dict.fromkeys(self.devices))


def device_count() -> int:
    """The CUDA cards this process sees."""
    return torch.cuda.device_count()


def card_ids(devices: Sequence[torch.device]) -> tuple[str, ...]:
    """The identity of each distinct card among ``devices``: its UUID, the
    same in every process that sees the card."""
    return tuple(
        str(torch.cuda.get_device_properties(d).uuid)
        for d in dict.fromkeys(devices) if d.type == "cuda"
    )


def make_mesh(devices: Optional[Sequence[torch.device | str]] = None) -> Mesh:
    """A mesh over ``devices``, by default every visible card (raises
    without one). Inside a multi-process job (:func:`multihost.initialize`)
    the processes exchange their shard counts and card identities, so every
    process must call it at the same point."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass --cpu_only to run the plain "
                "PyTorch path on the host"
            )
        devices = [torch.device("cuda", i) for i in range(device_count())]
    devices = tuple(torch.device(d) for d in devices)
    from . import multihost

    if multihost.process_count() == 1:
        return Mesh(devices)
    every = multihost.all_gather_object((len(devices), card_ids(devices)))
    return Mesh(devices, multihost.process_index(),
                tuple(n for n, _ in every), tuple(ids for _, ids in every))


def resolve_mesh(mesh: Mesh | None = None,
                 device: torch.device | str | None = None) -> Mesh:
    """An entry point's ``mesh``/``device`` arguments: the mesh when given,
    else a one-shard mesh on ``device``, else :func:`make_mesh`."""
    if mesh is not None:
        if device is not None:
            raise ValueError("give a mesh or a device, not both")
        return mesh
    return make_mesh() if device is None else Mesh((torch.device(device),))


def select_device(cpu_only: bool = False) -> torch.device:
    """``cuda`` (the first card) unless ``cpu_only``; raises without a GPU."""
    if cpu_only:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass --cpu_only to run the plain "
            "PyTorch path on the host"
        )
    return torch.device("cuda", 0)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """An entry point's ``device`` argument: the card (:func:`select_device`,
    which raises without one) when None, else the device asked for."""
    return select_device() if device is None else torch.device(device)


def available_device_memory(mesh: Mesh) -> Optional[int]:
    """Free device memory in bytes under the whole mesh, or None on the CPU
    (no meaningful cap).

    Each physical card counts once, however many shards and processes it
    holds (summing per shard or per process would multiply one card's
    memory and choose too small a fold). The cards of the other processes
    cannot be asked; each one this process does not hold is extrapolated
    from this process's free memory per card, as the JAX
    ``available_device_memory`` extrapolates remote devices.
    """
    if any(d.type != "cuda" for d in mesh.devices):
        return None
    cards = mesh.distinct_devices
    local = sum(int(torch.cuda.mem_get_info(d)[0]) for d in cards)
    if mesh.n_processes == 1:
        return local
    if len(mesh.process_cards) != mesh.n_processes:
        raise ValueError("a multi-process mesh of cards needs every "
                         "process's card identities (make_mesh exchanges them)")
    ours = set(mesh.process_cards[mesh.process_index])
    remote = set().union(*mesh.process_cards) - ours
    return local + local // len(cards) * len(remote)


def auto_fold_factor(
    db_bytes: int, mesh: Mesh, reserve_fraction: float = 0.25
) -> int:
    """Smallest fold factor that fits ``db_bytes`` into the mesh's free
    device memory, keeping ``reserve_fraction`` for workspace (reference
    ``gpusim.cpp:119-143``)."""
    free = available_device_memory(mesh)
    if free is None or db_bytes == 0:
        return 1
    usable = int(free * (1.0 - reserve_fraction))
    if usable <= 0:
        raise MemoryError("no usable device memory for fingerprint data")
    return max(1, -(-db_bytes // usable))
