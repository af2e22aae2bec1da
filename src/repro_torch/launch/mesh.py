"""Device meshes over the default ``torch.distributed`` process group.

Counterpart of ``repro.launch.mesh``.  Meshes are built by FUNCTIONS, never
at import: importing this module touches no device and no process group.
Each rank of the default group is one device of the mesh
(``init_device_mesh``); the axis names are the reference's:
``("data", "model")`` for one pod, ``("pod", "data", "model")`` for two,
``("items",)`` for the retrieval index.  A cuda mesh over a gloo group
runs DTensor's all-gather and reduce-scatter through host memory
(:func:`stage_collectives`), counted in :data:`STAGED`.

:class:`MeshShape` is the shape-only description of a mesh (axis names and
sizes, no devices), the counterpart of ``jax.sharding.AbstractMesh``: the
spec functions of ``sharding.specs`` read nothing else of a mesh, so they
take either.

:func:`fake_mesh` and :func:`abstract_production_mesh` build a mesh of
any size in one process for the cost analysis: a ``"fake"`` group (every
collective returns at once, moving nothing) at rank 0, created inside the
``with`` and destroyed at its end.  DTensors of meta tensors on it run a
step's per-rank program without a device.
"""
from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["MeshShape", "make_mesh", "make_production_mesh",
           "make_index_mesh", "data_axes", "model_axis", "mesh_axes",
           "stage_collectives", "STAGED", "fake_mesh",
           "abstract_production_mesh", "production_shape"]

# Collectives this process runs through host memory, by name: calls, bytes
# moved and seconds (see stage_collectives).
STAGED: dict[str, dict[str, int]] = {}
_staged_libs: dict = {}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names without devices.  Its two fields read
    as a ``DeviceMesh``'s attributes of the same names do."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.mesh_dim_names} differ in length")


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _staged(name: str, nbytes: int, t0: float) -> None:
    import time
    stat = STAGED.setdefault(name, {"calls": 0, "bytes": 0, "seconds": 0.0})
    stat["calls"] += 1
    stat["bytes"] += int(nbytes)
    stat["seconds"] += time.perf_counter() - t0


_pinned: dict = {}          # reused page-locked host buffers, by role


def _host_buffer(role: str, nbytes: int):
    """A page-locked uint8 host buffer of ``nbytes`` for ``role`` ("send",
    "recv"), grown as needed and reused: copies to and from the card run
    at the link's rate, and gloo reads and writes it in place."""
    import torch

    buf = _pinned.get(role)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                          pin_memory=torch.cuda.is_available())
        _pinned[role] = buf
    return buf[:nbytes]


def _host_bytes(x):
    """``x``'s bytes in the send buffer (a flat uint8 host tensor)."""
    import torch

    raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
    return _host_buffer("send", raw.numel()).copy_(raw)


def _to_device(raw, dtype, shape, device):
    """Host bytes -> a tensor of ``dtype`` and ``shape`` on ``device``."""
    return raw.view(dtype).reshape(shape).to(device, copy=True)


def _gathered(x, group, group_size: int):
    """(G, *x.shape): every rank's ``x``, through the host, on x's
    device."""
    import torch.distributed as dist

    raw = _host_bytes(x)
    out = _host_buffer("recv", group_size * raw.numel())
    dist.all_gather_into_tensor(out, raw, group=group)
    return (_to_device(out, x.dtype, (group_size,) + tuple(x.shape),
                       x.device), out.numel())


def _reduce(stack, op: str):
    """The reduction ``op`` of the functional collectives over dim 0."""
    if op == "sum":
        return stack.sum(0)
    if op == "avg":
        return stack.sum(0) / stack.shape[0]
    if op == "max":
        return stack.amax(0)
    if op == "min":
        return stack.amin(0)
    if op == "product":
        return stack.prod(0)
    raise ValueError(f"no staged reduction {op!r}")


def _group(group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name)


def _host_all_gather(x, group_size, group_name):
    """``all_gather_into_tensor``: the ranks' blocks concatenated on dim
    0."""
    import time
    if group_size == 1:
        return x.clone()
    t0 = time.perf_counter()
    out, n = _gathered(x, _group(group_name), group_size)
    _staged("all_gather_into_tensor", n, t0)
    return out.reshape((-1,) + tuple(x.shape[1:]))


def _host_reduce_scatter(x, op, group_size, group_name):
    """``reduce_scatter_tensor``: block r of dim 0 goes to rank r (one
    ``all_to_all`` of bytes on the host), reduced on the card."""
    import time

    import torch.distributed as dist
    if group_size == 1:
        return x.clone()
    t0 = time.perf_counter()
    raw = _host_bytes(x)
    out = _host_buffer("recv", raw.numel())
    dist.all_to_all_single(out, raw, group=_group(group_name))
    rows = x.shape[0] // group_size
    stack = _to_device(out, x.dtype, (group_size, rows) + tuple(x.shape[1:]),
                       x.device)
    _staged("reduce_scatter_tensor", out.numel(), t0)
    return _reduce(stack, op).to(x.dtype)


def _host_reduce_scatter_coalesced(xs, op, group_size, group_name):
    return [_host_reduce_scatter(x, op, group_size, group_name) for x in xs]


def stage_collectives(device_type: str = "cuda") -> None:
    """Run DTensor's all-gather and reduce-scatter of ``device_type``
    tensors through host memory, counted (calls, bytes, seconds) in
    :data:`STAGED`.

    Over gloo on CUDA tensors (torch 2.11, H100) the functional all-gather
    that DTensor calls crashes the process, and gloo's reduce-scatter sums
    bf16 on the host: staged, the all-gather moves the blocks' bytes over
    the group's CPU backend, and the reduce-scatter sends each rank its
    block (an all-to-all of bytes) and sums on the card (64 MB of bf16
    between two ranks on one H100: 44 ms against gloo's 59).  gloo's own
    all-reduce (faster than a staged one) and all-to-all stay.  The
    kernels of those two ops are replaced for ``device_type``.
    Idempotent."""
    import torch

    if device_type in _staged_libs:
        return
    key = device_type.upper()
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _host_all_gather, key)
    lib.impl("reduce_scatter_tensor", _host_reduce_scatter, key)
    lib.impl("reduce_scatter_tensor_coalesced",
             _host_reduce_scatter_coalesced, key)
    _staged_libs[device_type] = lib


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device_type: str = "cuda"):
    """A mesh of ``shape`` with axes ``names``: ``init_device_mesh`` over
    the default group, after checking that the group has one rank per
    device of ``shape`` and that ``device_type`` exists here."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a card and none is available; "
                           "pass device_type='cpu' to build it on the CPU")
    need = 1
    for n in shape:
        need *= n
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if need != world:
        dims = " x ".join(str(n) for n in shape)
        raise ValueError(f"mesh {dims} {names} needs {need} ranks, the "
                         f"process group has {world}")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised torch.distributed "
                           "process group (launch.procs.init_process_group)")
    if device_type == "cuda" and "nccl" not in dist.get_backend():
        stage_collectives("cuda")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def production_shape(multi_pod: bool = False):
    """The production mesh's shape and axis names: 16 x 16 ("data",
    "model"), or 2 x 16 x 16 ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 ranks ("data", "model"); two pods = 512 ranks
    ("pod", "data", "model")."""
    return make_mesh(*production_shape(multi_pod), device_type)


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A cpu-typed mesh of ``shape`` over a ``"fake"`` process group of as
    many ranks, this process rank 0, for tracing (the cost analysis): the
    group exists only inside the ``with`` and is destroyed at its end.
    Raises if a group is already initialised here or if this torch has no
    fake backend (``torch.testing._internal.distributed.fake_pg``)."""
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("the cost analysis needs torch.distributed, which "
                           "this torch lacks")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process; the fake mesh needs its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "this torch has no fake process-group backend "
            "(torch.testing._internal.distributed.fake_pg), which the cost "
            f"analysis's abstract mesh needs: {e}") from e
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield make_mesh(tuple(shape), tuple(names), "cpu")
    finally:
        dist.destroy_process_group()


def abstract_production_mesh(*, multi_pod: bool = False):
    """:func:`make_production_mesh`'s mesh (256 or 512 ranks) over a fake
    group, for tracing: a context manager (:func:`fake_mesh`)."""
    return fake_mesh(*production_shape(multi_pod))


def make_index_mesh(n_devices: int | None = None, *,
                    device_type: str = "cuda"):
    """1-D mesh over the ``items`` axis for the retrieval index's shards:
    posting tables and item factors partition along it, so catalog capacity
    scales with the rank count.  ``n_devices`` defaults to the group's
    world size."""
    import torch.distributed as dist

    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return make_mesh((int(n),), ("items",), device_type)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes the batch dim shards over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def model_axis(mesh) -> str:
    return "model"
