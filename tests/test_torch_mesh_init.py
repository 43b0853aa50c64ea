"""initialize_distributed() of the port: which configuration reaches
torch.distributed.init_process_group.

init_process_group is monkeypatched to a recorder, as tests/test_mesh_init.py
does for the JAX package's jax.distributed.initialize: these tests pin the
configuration, not the runtime (tests/test_torch_distributed.py runs real
process groups).  No process group is set up in this process.
"""

import pytest
import torch.distributed as dist

from binius_ntt_tpu_torch.parallel import mesh as pm

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """The recorded calls; a recorded call counts as a process group set
    up, as dist.is_initialized() sees it, until ``calls.clear()``."""
    calls = []

    def fake_init(*a, **kw):
        calls.append((a, kw))

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(calls))
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    yield calls


def test_single_process_noop(_fresh):
    assert pm.initialize_distributed() is False
    assert _fresh == []


def test_world_size_one_in_the_env_is_a_noop(_fresh, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert pm.initialize_distributed() is False
    assert _fresh == []


def test_env_explicit_config(_fresh, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "host0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert pm.initialize_distributed(backend="gloo") is True
    (a, kw), = _fresh
    assert kw == dict(backend="gloo", init_method="env://", world_size=4,
                      rank=2)


def test_args_override_env(_fresh, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "host0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    assert pm.initialize_distributed("file:///tmp/store", world_size=2,
                                     rank=1, backend="gloo") is True
    (a, kw), = _fresh
    assert kw == dict(backend="gloo", init_method="file:///tmp/store",
                      world_size=2, rank=1)


def test_default_backend_follows_the_device(_fresh, monkeypatch):
    monkeypatch.setattr(pm.torch.cuda, "is_available", lambda: False)
    assert pm.initialize_distributed("tcp://localhost:1", world_size=2,
                                     rank=0) is True
    backends = [kw["backend"] for _, kw in _fresh]
    _fresh.clear()                       # the group is gone again
    monkeypatch.setattr(pm.torch.cuda, "is_available", lambda: True)
    assert pm.initialize_distributed("tcp://localhost:1", world_size=2,
                                     rank=0) is True
    backends += [kw["backend"] for _, kw in _fresh]
    assert backends == ["gloo", "nccl"]


def test_idempotent(_fresh, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "host0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    assert pm.initialize_distributed() is True
    assert pm.initialize_distributed() is True
    assert len(_fresh) == 1


def test_a_group_set_up_by_the_caller_is_kept(_fresh, monkeypatch):
    """A program that called dist.init_process_group itself (as under
    torchrun) gets True and no second set-up."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setenv("MASTER_ADDR", "host0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert pm.initialize_distributed() is True
    assert _fresh == []


@pytest.mark.parametrize("backend, local_rank, rank, want", [
    ("gloo", "1", 3, "cpu"),
    ("nccl", "1", 3, "cuda:1"),      # torchrun's LOCAL_RANK
    ("nccl", None, 5, "cuda:1"),     # no LOCAL_RANK: rank % 4 cards
])
def test_rank_device(monkeypatch, backend, local_rank, rank, want):
    monkeypatch.setattr(dist, "get_backend", lambda: backend)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(pm.torch.cuda, "device_count", lambda: 4)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert pm.rank_device() == pm.torch.device(want)


def test_make_mesh_without_a_group_is_local(_fresh):
    mesh = pm.make_mesh(4, "cpu")
    assert isinstance(mesh, pm.LocalMesh)
    assert mesh.size == 4 and mesh.shards == (0, 1, 2, 3)
    assert pm.make_mesh(device="cpu").size == 1
