"""Production mesh construction, as the JAX package's
``repro.launch.mesh``, on ``torch.distributed``'s ``DeviceMesh``.

Functions (not module-level constants) so importing this module never
touches device or process-group state.  Single pod: (data=16, model=16) =
256 devices; multi-pod: (pod=2, data=16, model=16) = 512 devices, where
the ``pod`` axis carries only data-parallel gradient traffic.

Neither function initialises a process group: the caller does (the dry
run a ``fake`` one, a trainer ``nccl``), with at least as many ranks as
the mesh has devices.  The device type defaults to ``cuda``.
"""
from __future__ import annotations


def _mesh(shape, axes, device_type):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("initialise a process group before making a "
                           "mesh (the mesh functions never do)")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(device_type=None):
    """A 1-device mesh (same axis names, size 1)."""
    return _mesh((1, 1), ("data", "model"), device_type)
