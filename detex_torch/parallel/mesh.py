"""
Device-mesh helpers.

Namesake of detex_tpu/parallel/mesh.py. detex_tpu shards the chunk axis
of its scans over a 1-D JAX mesh; here a mesh is an ordered tuple of
torch devices, and a sharded scan gives each entry an equal run of rows
of the chunk batch (``shard_chunks``) and a copy of the bank on that
entry's device (``replicated``). Entries may repeat: ``[cpu] * 8`` runs
the sharded code on the CPU, ``[cuda:0] * 4`` on one card.
"""
from __future__ import annotations

import torch


def _indexed(d):
    """torch.device(d), a CUDA device without an index as the current
    one: the device a tensor made there reports."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh(tuple):
    """A 1-D mesh: an ordered tuple of torch devices with the name of its
    axis. ``size`` is its number of entries, ``devices`` the tuple
    itself."""

    def __new__(cls, devices, axis="chunks"):
        self = super().__new__(cls, (_indexed(d) for d in devices))
        if not len(self):
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        return self

    @property
    def size(self):
        return len(self)

    @property
    def devices(self):
        return tuple(self)

    def __repr__(self):
        return "Mesh(%s, axis=%r)" % (list(map(str, self)), self.axis)


def make_mesh(n_devices=None, axis="chunks", devices=None):
    """A 1-D mesh over ``devices`` (repeats allowed), or by default over
    every CUDA device of the host; ``n_devices`` keeps the first n."""
    if devices is None:
        devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, axis)


def shard_chunks(mesh, B):
    """The row range [r0, r1) of each mesh entry over a batch of B chunks,
    B a multiple of mesh.size (the counterpart of splitting the leading
    axis across the mesh)."""
    n = len(mesh)
    if B % n:
        raise ValueError("batch of %d chunks is not a multiple of the mesh "
                         "size %d" % (B, n))
    Bs = B // n
    return [(i * Bs, (i + 1) * Bs) for i in range(n)]


def _to(v, dev):
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return v


def replicated(mesh, bank):
    """The bank as each mesh entry sees it: a list of banks, one per entry,
    the bank itself on its own device and otherwise a copy of its tensors
    on the entry's device, made once per device and cached on the bank
    (the counterpart of a replicated sharding). Derived arrays the scans
    cache on a bank (keys starting with "_") are not copied: each copy
    derives its own."""
    home = bank["sum_u"].device
    reps = bank.setdefault("_replicas", {})
    out = []
    for dev in mesh:
        if dev == home:
            out.append(bank)
            continue
        key = str(dev)
        if key not in reps:
            reps[key] = {k: _to(v, dev) for k, v in bank.items()
                         if not k.startswith("_")}
        out.append(reps[key])
    return out
