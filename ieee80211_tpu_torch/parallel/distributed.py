"""Multi-process launch scaffolding on `torch.distributed`.

Port of ieee80211_tpu/parallel/distributed.py (`init_distributed` :40,
`make_global_phy_mesh` :71, `process_summary` :103). The JAX package joins
one process per host into one runtime; here each rank is one process with
one device (a card under NCCL, or the CPU under gloo), as torchrun starts
them:

    torchrun --nproc-per-node N -m <module that calls init_distributed()>

Mesh layout rule: the *sp* (time-shard, halo-exchange) axis stays inside a
node, so its point-to-point halos ride the node's own links (NVLink between
the cards of one host); the *dp* axis (batch of captures or packets) is the
one to stretch across nodes, since it needs no per-step communication.
`make_global_phy_mesh` encodes that rule: sp divides the ranks per node.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import entry_device
from .mesh import check_cards, ensure_process_group


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, *, device=None) -> bool:
    """Join this process into a multi-process `torch.distributed` group.

    Arguments come explicitly or from torchrun's environment
    (MASTER_ADDR / MASTER_PORT for the coordinator "host:port", WORLD_SIZE,
    RANK, LOCAL_RANK). The card's rank uses NCCL on `cuda:LOCAL_RANK`
    (local_device_ids[0] when given), a CPU rank (`device="cpu"`) gloo.
    Returns True if a multi-process group was initialized, False for a
    single process (nothing to join). Idempotent.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False                       # single process
    dev = entry_device(device)
    kw = {}
    if dev.type == "cuda":
        idx = (local_device_ids[0] if local_device_ids
               else int(os.environ.get("LOCAL_RANK", "0")))
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)         # before NCCL initialises
        kw["device_id"] = dev
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw)
    return dist.get_world_size() > 1


def _local_world_size() -> int:
    """Ranks on this node: torchrun's LOCAL_WORLD_SIZE, else the world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def make_global_phy_mesh(sp: int = 1, devices=None, *,
                         device=None) -> DeviceMesh:
    """("dp", "sp") DeviceMesh over every rank of every node (or the global
    ranks in `devices`), laid out node-major: the sp axis is carved out of
    the ranks of one node, so sp must divide the per-node rank count and
    halo exchange never leaves a node. dp spans the rest, including the
    cross-node direction. Every rank of the world calls it. Runs on the
    card unless `device="cpu"`; without a group, a 1-rank one is made. On
    the card no two ranks of a host may share one (`check_cards`).
    """
    ensure_process_group(entry_device(device))
    world = dist.get_world_size()
    if dist.get_backend() == "nccl" and world > 1:
        check_cards()
    ranks = list(range(world)) if devices is None else sorted(devices)
    n_local = max(1, _local_world_size())
    if sp > 1:
        assert n_local % sp == 0, (
            f"sp={sp} must divide the ranks per node ({n_local}) so halo "
            f"exchange stays inside a node")
    n = len(ranks)
    assert n % sp == 0
    # every rank's node; launchers number ranks node-major, so ordering by
    # (node, rank) must give the ranks in order
    nodes = [None] * world
    dist.all_gather_object(nodes, socket.gethostname())
    first = {}
    for r, h in enumerate(nodes):
        first.setdefault(h, r)
    order = sorted(ranks, key=lambda r: (first[nodes[r]], r))
    assert order == ranks, f"ranks {ranks} are not node-major ({nodes})"
    grid = torch.tensor(order).reshape(n // sp, sp)
    # enforce the documented invariant: every sp row lives on ONE node
    for row in grid.tolist():
        hosts = {nodes[r] for r in row}
        assert len(hosts) == 1, (
            f"sp row {row} spans nodes {hosts}; halo would leave the node")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, grid, mesh_dim_names=("dp", "sp"))


def process_summary() -> dict:
    """Small observability record for launch logs."""
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": 1,                # one device per rank
        "local_processes": _local_world_size() if up else 1,
        "global_devices": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
    }
