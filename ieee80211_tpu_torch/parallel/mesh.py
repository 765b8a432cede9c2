"""Mesh construction for the PHY's parallel axes.

Port of ieee80211_tpu/parallel/mesh.py (`make_phy_mesh` :18). The JAX
package's device mesh becomes a `torch.distributed` DeviceMesh with one
rank per device and axes:

  dp — batch of packets (data parallel)
  sp — time-blocks of a capture with overlap-save halos (sequence parallel)

Antenna/stream and MU-user axes stay within a shard (they are size <= 4 and
need no distribution). The collectives run on NCCL on the card and on gloo
on the CPU.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import entry_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def ensure_process_group(dev: torch.device) -> None:
    """Make sure a process group exists whose backend serves `dev`: NCCL
    for the card, gloo for the CPU. Without one, this process becomes a
    1-rank group of its own (an in-process store, no address needed), so
    that every sharded function goes through real collectives even on one
    card. An existing group of the other backend raises."""
    want = _BACKEND[dev.type]
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise ValueError(f"the process group runs {have}, but {dev} "
                             f"needs {want}")
        return
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(want, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)


def check_cards() -> None:
    """Raise unless every rank of the world runs on a card of its own:
    every rank's (host, current card), all-gathered. Only
    `init_distributed` sets a rank's card (`torch.cuda.set_device`); a
    process that starts NCCL without it stays on cuda:0, beside every other
    rank of its host. Every rank of the world calls it."""
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (socket.gethostname(),
                                  torch.cuda.current_device()))
    ranks = {}
    for r, key in enumerate(seen):
        ranks.setdefault(key, []).append(r)
    for (host, card), rs in ranks.items():
        if len(rs) > 1:
            raise RuntimeError(
                f"ranks {rs} of host {host} all run on cuda:{card}: give "
                f"each rank its card with torch.cuda.set_device(LOCAL_RANK) "
                f"before the process group starts (init_distributed does)")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's shard: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_phy_mesh(n_devices: int | None = None, sp: int = 1, *,
                  device=None) -> DeviceMesh:
    """("dp", "sp") DeviceMesh over the first n_devices ranks of the world
    (all by default); sp divides n_devices. Every rank of the world calls
    it (the sub-groups are made collectively); a rank outside the first
    n_devices gets a mesh whose `get_coordinate()` is None. Runs on the card
    unless `device="cpu"` asks for the CPU; creates a 1-rank group where
    none exists (`ensure_process_group`). On the card, `device` must be
    this rank's current card, and no two ranks of a host may share one
    (`check_cards`)."""
    dev = entry_device(device)
    ensure_process_group(dev)
    world = dist.get_world_size()
    if dev.type == "cuda":
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"the mesh of this rank runs on cuda:"
                             f"{torch.cuda.current_device()}, not {dev}")
        if world > 1:
            check_cards()
    n = n_devices or world
    assert n <= world, f"need {n} devices, have {world}"
    assert n % sp == 0
    return DeviceMesh(dev.type, torch.arange(n).reshape(n // sp, sp),
                      mesh_dim_names=("dp", "sp"))
