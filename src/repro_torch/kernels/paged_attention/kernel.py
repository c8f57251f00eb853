"""Wrapper of the CUDA paged decode attention (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``paged_attention_kernel``
(``src/repro/kernels/paged_attention/kernel.py:75``).  It is bound by the
K/V bytes below each request's length, read once, at 3.35 TB/s.  The
request's pages are cut into ``n_splits`` runs (``choose_splits``), one CTA
per (request, KV head, run) keeps its online softmax in registers and
writes a partial (m, l, acc) to fp32 scratch, and a second kernel combines
the partials: one call is two CUDA launches (see the note in the CUDA
source).

``paged_attention_kernel.launches`` counts the wrapper's calls that
launched the kernels (the split kernel and its combine count as one); the
wrapper adds one where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
POOL_DTYPES = (torch.float32, torch.bfloat16)
# the split rule: enough CTAs for WAVES waves of CTAS_PER_SM on every SM,
# at least MIN_SPLIT_TOKENS tokens a split, at most MAX_SPLIT_TOKENS tokens
# a split where the page allows (the split's token rows sit in shared
# memory, 4 bytes a token)
WAVES, CTAS_PER_SM = 4, 2
MIN_SPLIT_TOKENS = 64
MAX_SPLIT_TOKENS = 4096
MAX_GRID_Y = 65535


def choose_splits(B: int, KV: int, page: int, n_pages: int,
                  n_sms: int) -> int:
    """Splits of each request's pages, from B * KV and the longest length
    a page-table row can name (n_pages * page: the lengths stay on the
    card, unread).  One split when B * KV alone fills the waves."""
    want = -(-WAVES * CTAS_PER_SM * n_sms // (B * KV))
    most = max(1, n_pages * page // MIN_SPLIT_TOKENS)
    n = max(min(want, most),
            -(-n_pages // max(1, MAX_SPLIT_TOKENS // page)))
    return max(1, min(n, n_pages, MAX_GRID_Y))


def _lib():
    lib = build.load("paged_attention")
    lib.paged_attention_launch.argtypes = ([ctypes.c_void_p] * 8 +
                                           [ctypes.c_int] * 10 +
                                           [ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(name, x, dtypes, ndim, device):
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes or x.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-d of {dtypes}, got "
                         f"{x.ndim}-d {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_attention_kernel(q, k_pool, v_pool, page_map, lengths, scale,
                           unmapped_reads_zero: int = 0):
    """CUDA launch; same contract as ``ref.paged_attention_ref`` except on
    a row with no valid token, which gives zeros (the TPU kernel's
    contract; with ``unmapped_reads_zero=1`` only a length <= 0 leaves a
    row without one, and it gets the plain version's uniform mean)."""
    dev = q.device
    _check("q", q, POOL_DTYPES, 3, dev)
    _check("k_pool", k_pool, POOL_DTYPES, 4, dev)
    _check("v_pool", v_pool, (k_pool.dtype,), 4, dev)
    _check("page_map", page_map, (torch.int32,), 2, dev)
    _check("lengths", lengths, (torch.int32,), 1, dev)
    B, H, hd = q.shape
    n_slots, page, KV, hd_kv = k_pool.shape
    n_pages = page_map.shape[1]
    if v_pool.shape != k_pool.shape or hd_kv != hd:
        raise ValueError("q, k_pool and v_pool shapes disagree")
    if H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if page_map.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("page_map / lengths do not have B rows")
    if min(n_slots, page, hd, n_pages) < 1:
        raise ValueError("empty pool, page or page table")
    if max(n_pages, n_slots) * page >= 2 ** 31:
        raise ValueError(f"{max(n_pages, n_slots)} pages of {page} tokens "
                         f"overflow int32 token indices")
    G = H // KV
    if B == 0:
        return torch.empty((0, H, hd), dtype=q.dtype, device=dev)
    pool_bf16 = int(k_pool.dtype == torch.bfloat16)
    n_splits = choose_splits(
        B, KV, page, n_pages,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _lib()
    smem = lib.paged_attention_smem_bytes(page, hd, G, n_pages, n_splits,
                                          pool_bf16)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"page={page}, hd={hd}, G={G} need {smem} B of "
                         f"shared memory per block, above {MAX_SMEM_BYTES}")
    # q prescaled in its own dtype, as the TPU kernel does; read as fp32
    qs = (q.float() * scale).to(q.dtype).float().contiguous()
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, H, n_splits, hd), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.paged_attention_launch(
        qs.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_map.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), B, n_slots, page, KV, hd,
        G, n_pages, n_splits, int(bool(unmapped_reads_zero)), pool_bf16,
        stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention_kernel.launches += 1
    return out.to(q.dtype)


paged_attention_kernel.launches = 0
