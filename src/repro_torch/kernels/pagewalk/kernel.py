"""Wrapper of the CUDA two-stage table walk (``csrc/pagewalk.cu``).

Replaces the TPU kernel ``two_stage_translate_kernel``
(``src/repro/kernels/pagewalk/kernel.py:53``).  One kernel, two entries:

* ``two_stage_translate_kernel`` — the TPU kernel's contract: contiguous
  1-d coordinate vectors;
* ``translate_kernel`` — the whole of JAX's ``page_table.translate`` in
  one launch: coordinates as values or strided tensors over an
  [outer, inner] grid of queries (``ref.Coord``), and the fused cache as
  optional tables.

At the table sweep it is bound by its scattered table gathers; at its
consumers' small shapes by one launch's latency (see the note in the CUDA
source).  Its grid comes from ``grid_size``, a pure function the CPU
tests reach.

``two_stage_translate_kernel.launches`` counts the walks this process
launched, through either entry; the wrappers add one where they launch
the kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pagewalk.ref import Coord

THREADS = 256
MAX_CTAS_PER_SM = 4
MAX_QUERIES = 1 << 30


def grid_size(n: int, n_sms: int) -> int:
    """CTAs of ``THREADS`` threads (one query a thread at a time) for
    ``n`` queries: what the work needs, at most ``MAX_CTAS_PER_SM`` an SM;
    the kernel strides over the rest."""
    return max(1, min(-(-n // THREADS), n_sms * MAX_CTAS_PER_SM))


class _CoordArg(ctypes.Structure):
    """``struct Coord`` of ``csrc/pagewalk.cu``."""
    _fields_ = [("ptr", ctypes.c_void_p), ("s_outer", ctypes.c_longlong),
                ("s_inner", ctypes.c_longlong), ("value", ctypes.c_int),
                ("bytes", ctypes.c_int)]


_ARGTYPES = ([ctypes.c_void_p] * 8 + [_CoordArg] * 4 + [ctypes.c_int] * 7 +
             [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("pagewalk").pagewalk_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _coord_arg(name, c: Coord, dtypes, device, outer,
               inner) -> _CoordArg:
    if c.tensor is None:
        return _CoordArg(None, c.s_outer, c.s_inner, c.value, 0)
    x = c.tensor
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {x.dtype}")
    # every offset the grid reads lies inside the tensor's storage
    held = x.untyped_storage().nbytes() // x.element_size() - \
        x.storage_offset()
    if min(c.s_outer, c.s_inner) < 0 or \
            (outer - 1) * c.s_outer + (inner - 1) * c.s_inner >= held:
        raise ValueError(f"{name}: strides ({c.s_outer}, {c.s_inner}) "
                         f"over [{outer}, {inner}] leave its storage")
    return _CoordArg(x.data_ptr(), c.s_outer, c.s_inner, 0,
                     x.element_size())


def _launch(vs_table, vs_perm, g_table, coords, outer, inner, fused,
            fused_ok):
    """Check the tables, allocate the flat outputs and launch."""
    dev = vs_table.device
    for name, x, dt, nd in (("vs_table", vs_table, torch.int32, 3),
                            ("vs_perm", vs_perm, torch.int32, 3),
                            ("g_table", g_table, torch.int32, 2)):
        _check(name, x, dt, nd, dev)
    T, R, P = vs_table.shape
    G = g_table.shape[1]
    if vs_perm.shape != vs_table.shape or g_table.shape[0] != T:
        raise ValueError("table shapes disagree")
    if min(T, R, P, G) < 1:
        raise ValueError("empty table")
    if (fused is None) != (fused_ok is None):
        raise ValueError("fused and fused_ok go together")
    if fused is not None:
        _check("fused", fused, torch.int32, 3, dev)
        _check("fused_ok", fused_ok, torch.bool, 3, dev)
        if fused.shape != vs_table.shape or fused_ok.shape != vs_table.shape:
            raise ValueError("fused tables must have vs_table's shape")
    n = outer * inner
    if not 0 <= n <= MAX_QUERIES:
        raise ValueError(f"{n} queries: at most {MAX_QUERIES} a launch")
    args = [_coord_arg(name, c, dts, dev, outer, inner)
            for name, c, dts in zip(
                ("tenant", "req", "page", "want_write"), coords,
                [(torch.int32, torch.int64)] * 3 + [(torch.bool,)])]
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    fault = torch.empty(n, dtype=torch.bool, device=dev)
    stage = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return slot, fault, stage
    n_sms = _n_sms(dev.index if dev.index is not None else
                   torch.cuda.current_device())
    rc = _launcher()(
        vs_table.data_ptr(), vs_perm.data_ptr(), g_table.data_ptr(),
        None if fused is None else fused.data_ptr(),
        None if fused_ok is None else fused_ok.data_ptr(),
        slot.data_ptr(), fault.data_ptr(), stage.data_ptr(), *args,
        outer, inner, T, R, P, G, grid_size(n, n_sms),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pagewalk kernel launch failed: CUDA error {rc}")
    two_stage_translate_kernel.launches += 1
    return slot, fault, stage


def translate_kernel(vs_table, vs_perm, g_table, tenant: Coord, req: Coord,
                     page: Coord, want_write: Coord, outer: int, inner: int,
                     fused=None, fused_ok=None):
    """CUDA launch; same contract as ``ref.translate_ref``."""
    return _launch(vs_table, vs_perm, g_table,
                   (tenant, req, page, want_write), outer, inner, fused,
                   fused_ok)


def two_stage_translate_kernel(vs_table, vs_perm, g_table, tenant, req,
                               page, want_write):
    """CUDA launch; same contract as ``ref.two_stage_translate_ref``."""
    dev = vs_table.device
    for name, x, dt in (("tenant", tenant, torch.int32),
                        ("req", req, torch.int32),
                        ("page", page, torch.int32),
                        ("want_write", want_write, torch.bool)):
        _check(name, x, dt, 1, dev)
    B = tenant.shape[0]
    if not (req.shape[0] == page.shape[0] == want_write.shape[0] == B):
        raise ValueError("query vectors differ in length")
    coords = tuple(Coord(x, 0, 0, 1) for x in (tenant, req, page,
                                               want_write))
    return _launch(vs_table, vs_perm, g_table, coords, 1, B, None, None)


two_stage_translate_kernel.launches = 0
