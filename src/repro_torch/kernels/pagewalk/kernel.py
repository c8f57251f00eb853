"""Wrapper of the CUDA two-stage table walk (``csrc/pagewalk.cu``).

Replaces the TPU kernel ``two_stage_translate_kernel``
(``src/repro/kernels/pagewalk/kernel.py:53``).  It is bound by the bytes
each query streams — 13 B of coordinates in, 9 B of results out, and the
table entries it touches, served from L2 — at 3.35 TB/s; one thread per
query (see the note in the CUDA source).

``two_stage_translate_kernel.launches`` counts the launches this process
made; the wrapper adds one where it launches the kernel and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _launcher():
    fn = build.load("pagewalk").pagewalk_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, x, dtype, ndim, device):
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype or x.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-d {dtype}, got "
                         f"{x.ndim}-d {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def two_stage_translate_kernel(vs_table, vs_perm, g_table, tenant, req,
                               page, want_write):
    """CUDA launch; same contract as ``ref.two_stage_translate_ref``."""
    dev = tenant.device
    for name, x, dt, nd in (("vs_table", vs_table, torch.int32, 3),
                            ("vs_perm", vs_perm, torch.int32, 3),
                            ("g_table", g_table, torch.int32, 2),
                            ("tenant", tenant, torch.int32, 1),
                            ("req", req, torch.int32, 1),
                            ("page", page, torch.int32, 1),
                            ("want_write", want_write, torch.bool, 1)):
        _check(name, x, dt, nd, dev)
    T, R, P = vs_table.shape
    G = g_table.shape[1]
    B = tenant.shape[0]
    if vs_perm.shape != vs_table.shape or g_table.shape[0] != T:
        raise ValueError("table shapes disagree")
    if not (req.shape[0] == page.shape[0] == want_write.shape[0] == B):
        raise ValueError("query vectors differ in length")
    if min(T, R, P, G) < 1:
        raise ValueError("empty table")
    slot = torch.empty(B, dtype=torch.int32, device=dev)
    fault = torch.empty(B, dtype=torch.bool, device=dev)
    stage = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return slot, fault, stage
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(
        vs_table.data_ptr(), vs_perm.data_ptr(), g_table.data_ptr(),
        tenant.data_ptr(), req.data_ptr(), page.data_ptr(),
        want_write.data_ptr(), slot.data_ptr(), fault.data_ptr(),
        stage.data_ptr(), B, T, R, P, G, stream)
    if rc != 0:
        raise RuntimeError(f"pagewalk kernel launch failed: CUDA error {rc}")
    two_stage_translate_kernel.launches += 1
    return slot, fault, stage


two_stage_translate_kernel.launches = 0
