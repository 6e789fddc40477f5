"""Production mesh builders.

Port of ``repro.launch.mesh``: a pod is 16x16 (256 ranks); multi-pod is 2
pods = 512 ranks with a leading ``pod`` axis.  Functions, not module
constants: importing this module never touches a process group.  Each
builds a ``torch.distributed`` ``DeviceMesh`` over the default process
group, which must hold as many ranks as the mesh.
"""
from __future__ import annotations


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda",
                         pod_data_as_one: bool = False):
    """The 16x16 ``(data, model)`` mesh, or the 2x16x16 ``(pod, data,
    model)`` one; with ``pod_data_as_one``, the 2x16x16 mesh's ranks as a
    32x16 mesh whose first axis is ``pod`` and ``data`` taken as one
    (named ``data``: rules that name ``("pod", "data")`` resolve to it,
    as the 3-D mesh's pod-major split of the same 32)."""
    if multi_pod and pod_data_as_one:
        return _mesh(device_type, (32, 16), ("data", "model"))
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(device_type="cuda"):
    """Single-host debug mesh (1x1) with the same axis names."""
    return _mesh(device_type, (1, 1), ("data", "model"))
