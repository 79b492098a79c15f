"""Device meshes of the port: the production meshes (16×16 and 2×16×16) and
the debug mesh over the devices that exist.

The counterpart of :mod:`repro.launch.mesh`.  A production mesh has no
cards behind it here: it lies over a *fake* process group of 256 or 512
ranks (this process is rank 0), on which DTensor propagates placements and
issues its collectives as fake operations, so that the dry-run
(:mod:`.dryrun`) can describe what every card of the mesh would run
without any card.  The debug mesh lies over a real process group, one
process per card.

Functions only: importing this module touches no device and no process
group state.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _fake_world(size: int, rank: int = 0) -> None:
    """A fake default process group of ``size`` ranks, this process being
    ``rank`` (replacing an earlier fake group of another size or rank)."""
    # FakeStore's module registers the "fake" backend when imported.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is already initialized; "
                               "a fake mesh needs a process of its own")
        if dist.get_world_size() == size and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)


def make_fake_mesh(shape: tuple[int, ...], names: tuple[str, ...],
                   device_type: str = "cuda", rank: int = 0) -> DeviceMesh:
    """A mesh of ``shape`` named ``names`` over a fake process group of as
    many ranks, this process being ``rank``, of ``device_type`` whether or
    not such a device exists."""
    size = 1
    for n in shape:
        size *= n
    _fake_world(size, rank)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The 16×16 single-pod (256 cards) or 2×16×16 two-pod (512 cards) mesh,
    over a fake process group."""
    shape, names = PRODUCTION[multi_pod]
    return make_fake_mesh(shape, names)


def mesh_name(mesh: DeviceMesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def destroy_fake_world() -> None:
    """Tear down the fake process group, if one is up."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_debug_mesh(n_devices: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the real devices of the process group
    (one process per device; a group of one, made here on a free localhost
    port, when none is up), with ``model`` the largest of 4, 2, 1 that
    divides the device count, as the reference's.  On one card it is
    (1, 1)."""
    if not dist.is_initialized():
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass device_type='cpu'")
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
    if dist.get_backend() == "fake":
        raise RuntimeError("a fake process group is up: the debug mesh lies over real devices")
    n = n_devices or dist.get_world_size()
    model = next(c for c in (4, 2, 1) if n % c == 0)
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))
