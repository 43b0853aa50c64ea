"""The 1-D mesh of the sharded paths, and process-group set-up.

Port of binius_ntt_tpu/parallel/mesh.py on torch.distributed.  A sharded
class splits its data into D shards, shard d holding the d-th block (the
NTTs) or the rows r with r mod D == d (the provers), and talks between
shards through two operations only:

  * ``exchange(parts, mask)``: shard d receives shard d ^ mask's list of
    tensors (the reference's ``ppermute`` over the pairs (d, d ^ mask)).
    ``exchange_async`` issues every tensor's transfer and returns a handle
    a tensor, whose ``wait()`` gives the received tensor, so that a caller
    works on the first while the others are still in flight;
  * ``all_gather(vals)``: every shard receives all D shards' tensors, in
    shard order.

Two meshes offer them, so that each sharded body is written once, as a
loop over the shards its process owns (``mesh.shards``):

  * ``DistMesh``, when a process group is initialised: one shard a rank,
    shard = rank, the operations are ``dist.batch_isend_irecv`` (one batch
    a tensor, each waited for on its own) and ``dist.all_gather`` (NCCL on
    the card, gloo on the CPU);
  * ``LocalMesh``, otherwise: D shards held in one process on one device,
    the operations hand tensors over in memory.  It is the counterpart of
    the reference's virtual 8-device CPU mesh, and how one card runs D
    shards (one H100 cannot hold two NCCL ranks).

Both count their operations (``exchanges``: one for each tensor a shard
sends, ``exchange_bytes``: the bytes of those tensors, ``all_gathers``:
one for each call), so that a test can hold the schedule to the
reference's (tests/test_comm_volume.py).

Process groups: ``initialize_distributed()`` reads torchrun's
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; a launch is

    torchrun --nproc_per_node=<gpus> prove.py

or, with no launcher, an explicit ``init_method`` (``tcp://host:port`` or
``file:///path``), ``world_size`` and ``rank`` in every process.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils.capabilities import default_device

__all__ = ["LocalMesh", "DistMesh", "make_mesh", "rank_device",
           "initialize_distributed", "shutdown_distributed", "cyclic_shards",
           "gather_cyclic"]

def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None) -> bool:
    """Initialise the default process group; returns True if one is set up.

    Arguments default to torchrun's environment: ``init_method`` to
    ``env://`` where ``MASTER_ADDR`` and ``MASTER_PORT`` are set,
    ``world_size`` and ``rank`` to ``WORLD_SIZE`` and ``RANK``.  With no
    configuration (no init method and a world size of None or 1) it does
    nothing and returns False: one process, LocalMesh.  The backend
    defaults to NCCL where a CUDA device is present and gloo otherwise.
    Where a process group is already set up (by an earlier call, or by the
    caller's own ``dist.init_process_group``) it returns True and sets up
    nothing.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    if world_size is None and os.environ.get("WORLD_SIZE") is not None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK") is not None:
        rank = int(os.environ["RANK"])
    if (init_method is None and os.environ.get("MASTER_ADDR")
            and os.environ.get("MASTER_PORT")):
        init_method = "env://"
    if init_method is None and world_size in (None, 1):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def shutdown_distributed() -> None:
    """Destroy the default process group, so that a later call may set up
    another."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class _Arrived:
    """A received tensor whose transfer may still be in flight: ``wait()``
    waits for it (and for the matching send) and returns it."""

    def __init__(self, tensor: torch.Tensor, works=(), sent=None):
        self.tensor = tensor
        self.works = works
        self.sent = sent            # the send buffer, alive until the wait

    def wait(self) -> torch.Tensor:
        for work in self.works:
            work.wait()
        self.works, self.sent = (), None
        return self.tensor


class _Mesh:
    """The operation counters, and ``exchange`` on top of each mesh's
    ``exchange_async``."""

    def _reset_counts(self) -> None:
        self.exchanges = 0
        self.exchange_bytes = 0
        self.all_gathers = 0

    def _count_sent(self, sent) -> None:
        self.exchanges += len(sent)
        self.exchange_bytes += sum(t.numel() * t.element_size() for t in sent)

    def exchange(self, parts: dict, mask: int) -> dict:
        """{d: [tensors]} -> {d: shard d ^ mask's tensors}, all arrived."""
        return {d: [a.wait() for a in arr]
                for d, arr in self.exchange_async(parts, mask).items()}


class LocalMesh(_Mesh):
    """``size`` shards, all in this process, on ``device``."""

    def __init__(self, size: int, device):
        if size < 1 or size & (size - 1):
            raise ValueError(f"the shard count {size} is not a power of two")
        self.size = size
        self.device = torch.device(device)
        self.shards = tuple(range(size))
        self._reset_counts()

    def exchange_async(self, parts: dict, mask: int) -> dict:
        """{d: [tensors]} -> {d: [handle of each of shard d ^ mask's
        tensors]}.  The tensors are handed over, not copied: callers make
        new tensors from them.  Nothing is in flight here."""
        self._count_sent([t for p in parts.values() for t in p])
        return {d: [_Arrived(t) for t in parts[d ^ mask]] for d in parts}

    def all_gather(self, vals: dict) -> list:
        """{d: tensor} -> [tensor of shard 0, ..., of shard size-1]."""
        self.all_gathers += 1
        return [vals[d] for d in range(self.size)]


class DistMesh(_Mesh):
    """One shard a rank of the default process group, on ``device``."""

    def __init__(self, device):
        self.size = dist.get_world_size()
        if self.size & (self.size - 1):
            raise ValueError(f"the world size {self.size} is not a power "
                             f"of two")
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)     # NCCL's device
        self.shards = (self.rank,)
        self._reset_counts()

    def exchange_async(self, parts: dict, mask: int) -> dict:
        """Send this rank's tensors to rank ^ mask and receive its: every
        transfer is issued before this returns, each tensor as a batch of
        its own, so that waiting for the first leaves the others in flight
        (under NCCL a batch is one group launch, done only as a whole; its
        wait holds the current stream, not the host)."""
        partner = self.rank ^ mask
        mine = [t.contiguous() for t in parts[self.rank]]
        self._count_sent(mine)
        arrived = []
        for t in mine:
            r = torch.empty_like(t)
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, partner),
                dist.P2POp(dist.irecv, r, partner)])
            arrived.append(_Arrived(r, works, t))
        return {self.rank: arrived}

    def all_gather(self, vals: dict) -> list:
        t = vals[self.rank].contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t)
        self.all_gathers += 1
        return out


def cyclic_shards(arr: torch.Tensor, n_dev: int, shards) -> dict:
    """(X, B, Y) with rows on axis 1 -> {d: (X, B/D, Y), rows r = j D + d}
    for the shards d given, each a new tensor (the provers fold in place)."""
    x, b, y = arr.shape
    cyc = arr.reshape(x, b // n_dev, n_dev, y)
    return {d: cyc[:, :, d].contiguous() for d in shards}


def gather_cyclic(mesh, shards: dict, rows: int) -> torch.Tensor:
    """The first ``rows`` rows of every shard's (X, J, Y) tensor ->
    (X, rows D, Y) in the global row order, on every shard (one
    all_gather): the inverse of :func:`cyclic_shards`."""
    g = torch.stack(mesh.all_gather({d: t[:, :rows]
                                     for d, t in shards.items()}))
    return g.permute(1, 2, 0, 3).reshape(g.shape[1], -1, g.shape[3])


def rank_device() -> torch.device:
    """The device of this rank under an initialised process group: the CPU
    under gloo; under NCCL ``cuda:<LOCAL_RANK>`` (torchrun numbers the
    processes of a node by it), or ``cuda:<rank % gpus>`` without it."""
    if dist.get_backend() != "nccl":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, device=None):
    """A 1-D mesh of ``n_devices`` shards.  Under an initialised process
    group: a DistMesh over its ranks (``n_devices`` None or the world size;
    ``device`` defaults to :func:`rank_device`).  Otherwise a LocalMesh of
    ``n_devices`` (default 1) shards on ``device`` (default ``cuda:0``; off
    the card pass ``"cpu"``)."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices not in (None, world):
            raise ValueError(f"a mesh of {n_devices} under a process group "
                             f"of {world} ranks")
        return DistMesh(rank_device() if device is None else device)
    return LocalMesh(1 if n_devices is None else n_devices,
                     default_device(device))
