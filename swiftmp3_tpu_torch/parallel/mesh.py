"""The data mesh: positions on one flat batch axis, and the split of a
batch over them (twin of `swiftmp3_tpu.parallel.mesh`).

MP3 batch encoding has no cross-stream communication, so a flat data axis
is the whole story: the stream batch is cut into equal contiguous spans, one
a mesh position, and each position runs the chunk program on its own rows
on its own device. No collective runs in the numeric path; a multi-process
deployment extends the same axis over more processes (each feeding and
rendering only its own span), joined by `initialize_multihost`.

A position is (process index, torch.device). `make_mesh()` orders them
process-major, so each process holds one contiguous span
(`process_batch_bounds`). `put_global` and `batch_sharding` split this
process's rows over its local positions, in position order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"

# the cards initialize_multihost chose for this process (None: all of them)
_local_device_ids: Optional[list] = None


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    return torch.distributed.get_rank() if _distributed() else 0


def process_count() -> int:
    """The processes of the group (1 without one)."""
    return torch.distributed.get_world_size() if _distributed() else 1


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of positions on the data axis, each (process index,
    torch.device)."""

    positions: tuple

    def __post_init__(self):
        object.__setattr__(
            self, "positions", tuple((int(p), torch.device(d)) for p, d in self.positions)
        )

    @property
    def devices(self) -> tuple:
        return tuple(d for _, d in self.positions)

    @property
    def size(self) -> int:
        return len(self.positions)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size}

    def local_positions(self) -> list:
        """Indices on the data axis of this process's positions."""
        me = process_index()
        return [i for i, (p, _) in enumerate(self.positions) if p == me]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh, axis name 'data'.

    devices=None: every card of every process, process-major. Under a
    process group (`initialize_multihost`) one all_gather_object shares each
    process's cards (those it chose, else all); without one, this process's
    `torch.cuda.device_count()` cards. Raises when this process has no card:
    the mesh never falls back to the CPU.

    A list: those devices, all of this process. It may name one device more
    than once (`["cpu"] * 4`, `["cuda:0"] * 4`), the counterpart of XLA's
    virtual host devices (--xla_force_host_platform_device_count), which
    tests and smoke runs use to drive several positions on one device.
    """
    if devices is not None:
        me = process_index()
        return Mesh(tuple((me, d) for d in devices))
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "make_mesh() needs a CUDA card; pass devices (e.g. ['cpu']) to "
            "build a mesh on the CPU"
        )
    ids = _local_device_ids if _local_device_ids is not None else range(torch.cuda.device_count())
    local = [f"cuda:{i}" for i in ids]
    if not local:
        raise RuntimeError("make_mesh(): this process chose no card")
    if process_count() == 1:
        return Mesh(tuple((0, d) for d in local))
    lists = [None] * process_count()
    torch.distributed.all_gather_object(lists, local)
    return Mesh(tuple((p, d) for p, names in enumerate(lists) for d in names))


def initialize_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join this process to the group of `num_processes` processes at
    `coordinator_address` ("host:port"), as rank `process_id`; afterwards
    `make_mesh()` builds one flat data axis over every process's cards,
    process-major. `local_device_ids` picks this process's cards (default:
    all of them). A no-op for num_processes <= 1 and when a group is up.

    The group is gloo, not NCCL: the only collectives are host integers (the
    longest stream in `encode_batch_multihost`) and the mesh's device lists,
    never device data, and NCCL refuses two ranks on one card, the one
    multi-process layout a one-card host can run.
    """
    global _local_device_ids
    if num_processes <= 1 or _distributed():
        return
    torch.distributed.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    if local_device_ids is not None:
        _local_device_ids = [int(i) for i in local_device_ids]


def process_batch_bounds(mesh: Mesh, global_batch: int) -> tuple:
    """[lo, hi) rows of the global stream batch fed by THIS process: its
    positions' contiguous span of the data axis ((0, 0) when it has none)."""
    n_dev = mesh.size
    if global_batch % n_dev:
        raise ValueError(f"global batch {global_batch} not divisible by mesh size {n_dev}")
    per_dev = global_batch // n_dev
    local = mesh.local_positions()
    if not local:
        return (0, 0)
    if local != list(range(local[0], local[0] + len(local))):
        raise ValueError(
            "this process's devices are not contiguous on the data axis; "
            "build the mesh in make_mesh() order (process-major)"
        )
    return (local[0] * per_dev, (local[-1] + 1) * per_dev)


@dataclass(frozen=True)
class BatchSharding:
    """How an array whose axis `batch_axis` is the stream batch lies on a
    mesh: this process's rows, cut into equal contiguous spans, one a local
    position in position order (the counterpart of a NamedSharding over the
    data axis)."""

    mesh: Mesh
    batch_axis: int = 0

    def spans(self, rows: int) -> list:
        """(device, lo, hi) of each local position over `rows` rows."""
        local = self.mesh.local_positions()
        if not local:
            return []
        if rows % len(local):
            raise ValueError(
                f"{rows} rows do not split evenly over this process's {len(local)} mesh positions"
            )
        per = rows // len(local)
        return [(self.mesh.devices[p], k * per, (k + 1) * per) for k, p in enumerate(local)]


def batch_sharding(mesh: Mesh, batch_axis: int = 0) -> BatchSharding:
    """The split of arrays whose axis `batch_axis` is the stream batch."""
    return BatchSharding(mesh, batch_axis)


def carry_sharding(mesh: Mesh) -> BatchSharding:
    """Carry tensors are batch-leading."""
    return batch_sharding(mesh, 0)


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on `device`; a numpy array bound for a card
    goes through pinned memory with a non-blocking copy, so the upload
    overlaps other work."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def put_global(mesh: Mesh, local_rows, batch_axis: int = 0) -> list:
    """This process's rows (its `process_batch_bounds` span; all rows in one
    process), split over its local positions: one tensor a position, on
    that position's device."""
    lead = (slice(None),) * batch_axis
    spans = batch_sharding(mesh, batch_axis).spans(local_rows.shape[batch_axis])
    return [to_device(local_rows[lead + (slice(lo, hi),)], dev) for dev, lo, hi in spans]
