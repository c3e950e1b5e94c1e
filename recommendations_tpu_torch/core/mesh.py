"""The device mesh over ``torch.distributed`` ranks.

Port of ``recommendations_tpu/core/mesh.py``. A JAX process drives every
device of its host; here each process drives one device and is one rank,
so the mesh is an array of ranks with the JAX package's axes:

- ``data``: batch sharding;
- ``model``: the row-sharded product-embedding table, and the sequence
  blocks of ring attention;
- ``expert``: the MoE rotator's expert stacks.

The rank layout is JAX's: ``dcn_data`` granules (one a node, as JAX takes
one a host) multiply the ``data`` axis and sit outermost on it, so that
``model`` and ``expert`` stay inside a node (``rank_layout``, a pure
function of the config, the world size and the ranks a node holds).

``init_distributed`` forms the process group from the environment that
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``): NCCL for ranks on cards, gloo for
``--device cpu``; in one process it does nothing, as JAX's does.
``build_mesh`` makes one process group for every set of axes (each with
the given timeout, so a hung collective fails instead of waiting for
torch's default of many minutes) and returns a :class:`Mesh`, which
carries torch's ``DeviceMesh`` over the same groups (``device_mesh``).
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES: Tuple[str, ...] = ("data", "model", "expert")
GROUP_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape; -1 for ``data`` means all remaining ranks.
    ``dcn_data``: data-parallel granules across nodes; None detects one a
    node when more than one node is present, 1 forces a flat mesh."""

    data: int = -1
    model: int = 1
    expert: int = 1
    dcn_data: Optional[int] = None
    axis_names: Tuple[str, ...] = AXES

    def resolved_shape(self, n_devices: int) -> Tuple[int, ...]:
        fixed = self.model * self.expert
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by model*expert={fixed}")
            data = n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(f"mesh shape {data}x{self.model}x{self.expert} != {n_devices} devices")
        return (data, self.model, self.expert)


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def ranks_per_node() -> int:
    """``LOCAL_WORLD_SIZE`` (torchrun's), else every rank on one node."""
    return _env_int("LOCAL_WORLD_SIZE", world_size())


def init_distributed(
    device="cuda",
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = GROUP_TIMEOUT_S,
) -> None:
    """Form the default process group: from the arguments, else from the
    environment ``torchrun`` sets. One process (no ``WORLD_SIZE`` above 1,
    no ``world`` given) forms none. ``backend`` defaults to NCCL for a CUDA
    device and gloo for the CPU; a caller overrides it (a gloo group over
    ranks that share one card)."""
    if dist.is_initialized():
        return
    world = _env_int("WORLD_SIZE", 1) if world is None else world
    if world <= 1:
        return
    rank = _env_int("RANK", 0) if rank is None else rank
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None:
        init_method = "env://"
    kw = {}
    if backend == "nccl":
        local = _env_int("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1))
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw,
    )


def local_device(device="cuda") -> torch.device:
    """``cuda:{LOCAL_RANK}`` for a card (``cuda`` without an index), the
    given device otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", _env_int("LOCAL_RANK", 0) % max(torch.cuda.device_count(), 1))
    return dev


def rank_layout(config: MeshConfig, n_ranks: int, per_node: Optional[int] = None) -> np.ndarray:
    """The (data, model, expert) array of ranks: JAX ``build_mesh``'s device
    order, with nodes as its granules (rank r on node r // per_node)."""
    per_node = n_ranks if per_node is None else per_node
    ranks = list(range(n_ranks))
    granules = [ranks[i:i + per_node] for i in range(0, n_ranks, per_node)]
    n_g = config.dcn_data if config.dcn_data is not None else (len(granules) if len(granules) > 1 else 1)
    if n_g > 1:
        if n_ranks % n_g:
            raise ValueError(f"{n_ranks} devices not divisible by dcn_data={n_g}")
        per_slice = n_ranks // n_g
        slice_data = config.data
        if slice_data != -1:
            if slice_data % n_g:
                raise ValueError(f"data={slice_data} not divisible by dcn_data={n_g}")
            slice_data //= n_g
        ici_shape = dataclasses.replace(config, data=slice_data, dcn_data=1).resolved_shape(per_slice)
        gs = granules if len(granules) == n_g else [ranks[i * per_slice:(i + 1) * per_slice] for i in range(n_g)]
        return np.concatenate([np.asarray(g).reshape(ici_shape) for g in gs], axis=0)
    return np.asarray(ranks).reshape(config.resolved_shape(n_ranks))


class Mesh:
    """A rank's view of the mesh: the rank array, this rank's coordinates,
    its process group over every set of axes (None where that set spans one
    rank) and torch's ``DeviceMesh`` over the one-axis groups (None in one
    process)."""

    def __init__(self, ranks: np.ndarray, rank: int, groups: Dict[Tuple[str, ...], object],
                 device: torch.device, device_mesh=None, axis_names: Tuple[str, ...] = AXES,
                 host_group=None):
        self.ranks, self.rank, self.device = ranks, rank, device
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, ranks.shape))
        coords = np.argwhere(ranks == rank)
        if len(coords) != 1:
            raise ValueError(f"rank {rank} is not in the mesh {ranks.tolist()}")
        self.coords: Dict[str, int] = dict(zip(axis_names, (int(c) for c in coords[0])))
        self._groups = groups
        self._unit_group = None
        self.device_mesh = device_mesh
        # every rank on gloo, for host-side flags that must not wait for a card
        self.host_group = host_group

    @classmethod
    def one_rank(cls, group, device) -> "Mesh":
        """A mesh of this one rank whose every set of axes runs its
        collectives over ``group`` (a process group of one rank): the code
        path of several ranks, moving no data."""
        mesh = cls(np.zeros((1, 1, 1), dtype=np.int64), 0, {}, torch.device(device))
        mesh._unit_group = group
        return mesh

    def size(self, *axes: str) -> int:
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, *axes: str):
        """The process group of this rank's peers along ``axes`` (None when
        they are this rank alone)."""
        if self._unit_group is not None:
            return self._unit_group
        axes = tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)
        return self._groups.get(axes) if axes else None


def build_mesh(
    config: MeshConfig = MeshConfig(),
    device="cuda",
    timeout_s: float = GROUP_TIMEOUT_S,
    per_node: Optional[int] = None,
) -> Mesh:
    """The mesh over every rank of the default process group (one rank when
    there is none). Every rank must call it, in the same order as any other
    group it makes."""
    n = world_size()
    ranks = rank_layout(config, n, ranks_per_node() if per_node is None else per_node)
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = local_device(device)
    groups: Dict[Tuple[str, ...], object] = {}
    device_mesh = host_group = None
    if n > 1:
        timeout = datetime.timedelta(seconds=timeout_s)
        host_group = dist.new_group(list(range(n)), timeout=timeout, backend="gloo")
        names = config.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                moved = np.moveaxis(ranks, [names.index(a) for a in axes], list(range(k)))
                members = moved.reshape(int(np.prod([ranks.shape[names.index(a)] for a in axes])), -1)
                for col in range(members.shape[1]):
                    g = dist.new_group([int(r) for r in members[:, col]], timeout=timeout)
                    if rank in members[:, col]:
                        groups[axes] = g
        from torch.distributed.device_mesh import DeviceMesh

        device_mesh = DeviceMesh.from_group(
            [groups[(a,)] for a in names], dev.type, mesh=torch.as_tensor(ranks), mesh_dim_names=names,
        )
        groups = {axes: g for axes, g in groups.items()
                  if all(ranks.shape[names.index(a)] > 1 for a in axes)}
    return Mesh(ranks, rank, groups, dev, device_mesh, config.axis_names, host_group)


def local_batch_slice(mesh: Mesh, global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's rows of the global batch: its ``data``
    index's shard, shared by the ranks of its ``model`` and ``expert``
    group (JAX's ``make_array_from_process_local_data`` layout)."""
    n = mesh.size("data")
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data={n}")
    per = global_batch // n
    return mesh.index("data") * per, per


def node_index(per_node: Optional[int] = None) -> int:
    """This process's node: ``GROUP_RANK`` (torchrun's), else its rank //
    the ranks a node holds. A node is a JAX host: it reads its own files
    and its own ``batch_size`` rows."""
    per_node = ranks_per_node() if per_node is None else per_node
    rank = dist.get_rank() if dist.is_initialized() else 0
    return _env_int("GROUP_RANK", rank // max(per_node, 1))


def num_nodes(per_node: Optional[int] = None) -> int:
    per_node = ranks_per_node() if per_node is None else per_node
    return max(1, world_size() // max(per_node, 1))


def mesh_config(strategy_config) -> MeshConfig:
    """The strategy config's mesh fields as a :class:`MeshConfig`."""
    return MeshConfig(
        data=getattr(strategy_config, "mesh_data", -1),
        model=getattr(strategy_config, "mesh_model", 1),
        expert=getattr(strategy_config, "mesh_expert", 1),
        dcn_data=getattr(strategy_config, "mesh_dcn_data", None),
    )
