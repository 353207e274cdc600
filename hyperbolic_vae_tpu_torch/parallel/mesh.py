"""Meshes of ranks over ``torch.distributed``: data and seed parallelism.

Port of ``hyperbolic_vae_tpu/parallel/mesh.py``. JAX's single controller
sees every device from one process and partitions one program over a
``jax.sharding.Mesh``. The port follows PyTorch's idiom instead: one
process a card (``torchrun --nproc_per_node=N``), NCCL between cards and
gloo on the CPU, every rank running the same program on its share. The
semantics are JAX's, rank by rank:

  * ``make_mesh(n_data, n_model)``: a (data, model) grid of ranks. Under
    ``Trainer(mesh=...)`` each data rank takes its rows of every global
    batch, its gradients are summed over the data axis, and the
    parameters stay replicated (``parallel/data_parallel.py``); the model
    axis only replicates until parameter sharding is ported.
  * ``make_seed_mesh(n)``: a 1-D grid over the seed axis; a sweep trains
    S / n lanes a rank and gathers them once at the end
    (``train/ensemble.py``).
  * ``data_sharding``, ``seed_sharding``, ``replicated`` and
    ``shard_batch`` name a layout, and give this rank's piece of a tensor.

``Mesh`` is a small class of the port's own rather than
``torch.distributed.device_mesh.DeviceMesh``: the replicated-parameter
half needs only the axes' names and sizes, this rank's coordinate and one
process group an axis, while DeviceMesh carries DTensor's placement
machinery, which nothing here uses, and builds its groups in ways that
have changed across torch releases (the card's torch and a CPU host's may
differ).

``init_distributed`` joins the default process group that ``torchrun``
describes in the environment, or else starts a world of size 1 on a
``FileStore``. The backend is NCCL for a CUDA device and gloo for the
CPU unless the caller names it; the choice is logged. At world size 1 a
mesh still issues its collectives (an NCCL all-reduce on one rank is
what the card can run).
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import tempfile
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEED_AXIS = "seed"

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _rank_device(device: DeviceLike) -> torch.device:
    """This rank's device: ``device`` if named; else ``cuda:LOCAL_RANK``
    under torchrun, the current card without it."""
    if device is None and "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_distributed(device: DeviceLike = None) -> torch.device:
    """Join (or start) the default process group and return this rank's
    device. Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT`` set) it joins that world; otherwise it starts a world
    of size 1 on a ``FileStore`` in a temporary directory. The backend is
    ``nccl`` for a CUDA device and ``gloo`` for the CPU; a group that
    already exists must offer the device's backend."""
    dev = _rank_device(device)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = str(dist.get_backend())
        if want not in have:
            raise ValueError(f"the process group's backend is {have!r}; a mesh on {dev} needs "
                             f"{want!r}")
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    path = None
    if all(v in os.environ for v in _TORCHRUN_VARS):
        logger.info("joining the torchrun world (rank %s of %s) with backend %s on %s",
                    os.environ["RANK"], os.environ["WORLD_SIZE"], want, dev)
        dist.init_process_group(want, init_method="env://")
    else:
        path = tempfile.mkdtemp(prefix="hvae-store-")
        logger.info("no torchrun world: a world of size 1 with backend %s on %s", want, dev)
        dist.init_process_group(want, store=dist.FileStore(os.path.join(path, "store"), 1),
                                rank=0, world_size=1)
    atexit.register(_leave, path)
    return dev


def _leave(store_dir: Optional[str]) -> None:
    """At exit: the process group this module started is destroyed (NCCL's
    watchdog would otherwise outlive its store), then its store removed."""
    if dist.is_initialized():
        dist.destroy_process_group()
    if store_dir is not None:
        shutil.rmtree(store_dir, ignore_errors=True)


def share(n: int, parts: int, i: int) -> tuple:
    """Rows [lo, hi) of n that part i of ``parts`` takes: contiguous, the
    first n % parts parts one row longer (``numpy.array_split``'s cut)."""
    base, extra = divmod(int(n), int(parts))
    lo = i * base + min(i, extra)
    return lo, lo + base + (1 if i < extra else 0)


class Mesh:
    """A grid of ranks with named axes. ``shape`` maps each axis to its
    size (as JAX's ``Mesh.shape``), ``devices`` is the grid of global
    ranks, ``device`` this rank's device; ``coord(axis)`` is this rank's
    index along an axis and ``group(axis)`` the process group of the ranks
    that differ from it only along that axis."""

    def __init__(self, axis_names: Sequence[str], ranks: np.ndarray, device: torch.device,
                 groups: Dict[str, object]):
        self.axis_names = tuple(axis_names)
        self.devices = np.asarray(ranks)
        self.device = device
        self.rank = dist.get_rank()
        self._groups = groups
        where = np.argwhere(self.devices == self.rank)
        if len(where) == 0:
            raise ValueError(f"rank {self.rank} is not in the mesh {self.devices.tolist()}")
        self._coords = dict(zip(self.axis_names, (int(c) for c in where[0])))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coord(self, axis: str) -> int:
        return self._coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    @property
    def is_writer(self) -> bool:
        """True on the rank that writes logs and checkpoints (global rank 0)."""
        return self.rank == 0

    def any(self, flag: bool) -> bool:
        """True when ``flag`` is True on any rank of the mesh (a collective)."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._whole)
        return bool(t.item() > 0)

    def barrier(self) -> None:
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self._whole)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def _whole(self):
        return self._groups["*"]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self._coords}, {self.device})"


def _groups_along(arr: np.ndarray, names: Sequence[str]) -> Dict[str, object]:
    """One process group a line of ``arr`` along each axis (every rank of
    the world makes every group, as torch requires), and ``"*"``, the
    whole mesh; the world's own group where a line is the whole world."""
    world = dist.get_world_size()
    me = dist.get_rank()
    made: dict = {}

    def make(ranks):
        key = tuple(sorted(int(r) for r in ranks))
        if key not in made:
            made[key] = dist.group.WORLD if key == tuple(range(world)) else dist.new_group(key)
        return made[key]

    groups = {"*": make(arr.reshape(-1))}
    for ax, name in enumerate(names):
        lines = np.moveaxis(arr, ax, -1).reshape(-1, arr.shape[ax])
        for line in lines:
            g = make(line)
            if me in line:
                groups[name] = g
    return groups


def _ranks(devices, n: int) -> list:
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if n > len(ranks):
        raise ValueError(f"the mesh needs {n} ranks but the world has {len(ranks)}: run under "
                         f"torchrun --nproc_per_node={n}")
    return ranks[:n]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[int]] = None, device: DeviceLike = None) -> Mesh:
    """A (data, model) mesh over the first n_data * n_model ranks of
    ``devices`` (global ranks; default the world); ``n_data`` defaults to
    the ranks over ``n_model``. Joins or starts the process group
    (``init_distributed``) on ``device``."""
    dev = init_distributed(device)
    avail = dist.get_world_size() if devices is None else len(devices)
    n_data = int(n_data) if n_data is not None else max(avail // int(n_model), 1)
    arr = np.array(_ranks(devices, n_data * int(n_model))).reshape(n_data, int(n_model))
    names = (DATA_AXIS, MODEL_AXIS)
    return Mesh(names, arr, dev, _groups_along(arr, names))


def make_seed_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[int]] = None,
                   device: DeviceLike = None) -> Mesh:
    """A 1-D mesh over the seed axis: a sweep's lanes are spread over its
    ranks with no collective until one gather at the end."""
    dev = init_distributed(device)
    n = int(n_devices) if n_devices else (dist.get_world_size() if devices is None
                                          else len(devices))
    arr = np.array(_ranks(devices, n))
    return Mesh((SEED_AXIS,), arr, dev, _groups_along(arr, (SEED_AXIS,)))


class Sharding(NamedTuple):
    """A layout over a mesh: ``spec[i]`` names the axis that splits
    dimension i, or None (JAX's ``PartitionSpec``)."""

    mesh: Mesh
    spec: tuple

    def shard(self, t):
        """This rank's piece of ``t``: dimension 0 cut evenly along its
        axis (an uneven cut raises, as JAX's ``device_put`` does); the
        whole of ``t`` when replicated."""
        if not self.spec or self.spec[0] is None:
            return t
        axis = self.spec[0]
        n = self.mesh.shape[axis]
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not split evenly over the {n} ranks of "
                             f"the {axis!r} axis")
        lo, hi = share(t.shape[0], n, self.mesh.coord(axis))
        return t[lo:hi]


def data_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """The leading (batch) dimension split over 'data'."""
    return Sharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def seed_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """The leading (lane) dimension split over 'seed'."""
    return Sharding(mesh, (SEED_AXIS,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of ``batch`` under ``data_sharding``."""
    return data_sharding(mesh, batch.ndim).shard(batch)
