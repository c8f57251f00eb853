#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root

Phases, one line each; any failure raises and the script exits non-zero:

1. environment — torch/CUDA versions and the card's name and power limit;
2. build       — every CUDA kernel of the port, from ``src/repro_torch/csrc``;
3. pagewalk    — the two-stage table walk at 8 tenants x 64 requests x 512
                 pages (G = 4096): its own path (``ops.two_stage_translate``
                 over every page of every request once, shuffled) is driven
                 with the launch count set to 0 just before and read just
                 after; then the kernel is held bit-exact against the plain
                 version on the card at B in {1, 7, 512, 513, 262144} and on
                 4096 out-of-range coordinates, and timed (CUDA events,
                 median) beside its byte bound;
4. hext        — ``Fleet.boot`` of sha, crc32, basicmath, stringsearch and
                 fft x {native, guest} on the card (10 harts, 256 KiB each)
                 run to completion; every counter of every hart must equal
                 ``benchmarks/results/hext_runs.json`` (read, never written);
5. vmem        — the two-stage paged KV cache at one attention layer of
                 Qwen3-30B-A3B (H=32, KV=4, hd=128, bf16 pools of 32768
                 slots x 16 tokens, 512 MiB each): 8 tenants x 16 requests
                 of up to 4096 tokens mapped by ``ensure_mapped`` (the
                 control plane, ``pagewalk`` under ``translate``), one
                 ``write_token`` per request read back, then the path:
                 128 ``paged_decode_attention`` calls (``pagewalk`` +
                 ``paged_attention`` kernels) with the counts set to 0 just
                 before and read just after, each held against the plain
                 route (by element and by row norm); pagewalk bit-exact at
                 the path's coordinates; the batched decode (B=128) on the
                 path's page map and on one where every request owns its
                 slots, held against its plain version in bf16 and on fp32
                 copies, and timed beside its byte bound; the fp32 shapes
                 of ``tests/test_kernels.py`` and an all-unmapped row; and
                 ``evict_tenant`` with the pool invariants checked;
6. model       — the dense LM serving path at H2O-Danube-3-4B's full
                 width and depth (24 layers, d 3840, H 32, KV 8, hd 120,
                 window 4096; seeded bf16 weights): the flash_attention
                 kernel against its plain version at the shapes of
                 ``tests/test_kernels.py`` (fp32 2e-5, bf16 2e-2), at a
                 ragged S with hd 120, and one KV head at a time at the
                 model's prefill shape, B = 1 and the path's B = 4; then
                 the path: ``prefill`` of 4 seeded 8192-token prompts
                 (every kernel count set to 0 just before it and read just
                 after: exactly 24 flash launches) and 16 greedy
                 ``decode_step``s; at B = 1 the kernel against its plain
                 version on every layer's own q, k, v inside one prefill,
                 that prefill's logits against a prefill through the plain
                 version, and decode at position 8192 against a fresh
                 8193-token prefill (both by logit row norm), each beside
                 controls (a window off by one, attention_core's bf16
                 numerics, a decode position off by one) that show what
                 the logit checks can and cannot see; times of the kernel
                 at S = 8192 and 32768 beside its bound, of SDPA and of the
                 plain version, the prefill wall, decode ms per step over
                 16 steps and the device idle share of a decode step;
7. kernels     — one JSON line listing each ported kernel.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 2026
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)

KERNEL_SOURCES = ("pagewalk", "paged_attention", "flash_attention")
BF16_PEAK_FLOPS = 989e12           # H100 SXM dense bf16 tensor cores

# pagewalk at the realistic size of its docstring: 1 MiB stage-1 tables
T, R, P, G = 8, 64, 512, 4096
PAGEWALK_BATCHES = (1, 7, 512, 513, T * R * P)
# coordinates in [-2n, 2n) of each dimension, (-1, 0, -1) first: a negative
# one wraps once, then everything is clamped (JAX's gather rule)
PAGEWALK_OUT_OF_RANGE = 4096

HEXT_WORKLOADS = ("sha", "crc32", "basicmath", "stringsearch", "fft")
HEXT_FIELDS = ("done", "exit_code", "instret", "instret_virt", "ticks",
               "exc_by_level", "int_by_level", "pagefaults", "walks",
               "timer_irqs", "ctx_switches", "ok")
HEXT_MAX_TICKS = 4096
HEXT_CHUNK = 32

# vmem: one attention layer of Qwen3-30B-A3B
# (src/repro/configs/qwen3_moe_30b_a3b.py) over a decode batch of 8 tenants
# x 16 requests of up to 4096 tokens
VM_H, VM_KV, VM_HD = 32, 4, 128
VM_PAGE = 16
VM_TENANTS, VM_REQS = 8, 16
VM_PAGES = 256                      # logical pages per request
VM_TENANT_PAGES = 4096
VM_SLOTS = 32768
BF16_TOL = 2e-2
# bf16 outputs are also held per (request, head) row by
# ||got - want|| / ||want||: on long requests the outputs are small
# (softmax-weighted means of ~2k rows), so the element tolerance alone
# would let a dropped page or a wrong rescale through
BF16_ROW_REL_TOL = 1e-2
FP32_TOL = 3e-5
# the shapes of tests/test_kernels.py::test_paged_attention_matches_ref
FP32_SHAPES = ((2, 4, 1, 16, 8, 4), (3, 8, 2, 32, 16, 6),
               (1, 16, 8, 64, 8, 3))

# model: H2O-Danube-3-4B (src/repro/configs/h2o_danube_3_4b.py) at full
# width and depth, serving 4 requests of 8192 tokens (a multiple of the
# 4096 window, so the ring slabs stay position-congruent: ROADMAP R6)
LM_ARCH = "h2o_danube_3_4b"
LM_B, LM_S, LM_STEPS = 4, 8192, 16
# the flash shapes of tests/test_kernels.py (B, S, H, KV, hd, window, dtype)
# and a ragged S at hd = 120
FLASH_SHAPES = ((1, 64, 2, 1, 16, 0, "float32"),
                (2, 128, 4, 2, 32, 0, "float32"),
                (1, 128, 4, 4, 32, 32, "float32"),
                (2, 256, 8, 2, 64, 0, "bfloat16"),
                (1, 100, 8, 2, 120, 32, "float32"),
                (1, 100, 8, 2, 120, 32, "bfloat16"))
FLASH_FP32_TOL = 2e-5
# logits of the whole 24-layer model, by row: ||got - want|| / ||want||.
# Any bf16-level difference in one layer's output grows through the 24
# random-weight layers to ~2e-2 in the logits: the kernel against its
# plain version (fp32 sums in another order) reads 1.821e-2, the kernel
# with a window one key short 1.924e-2, attention_core's bf16 numerics
# 1.866e-2, decode against prefill 1.941e-2.  So the logit route check
# stops gross faults only, and the gate of the kernel's numerics is the
# per-layer check (bf16 element and row tolerances above, on each layer's
# own q, k, v), whose control (a window one key short) must exceed its
# row tolerance or the script fails.  The decode check's control (one
# position too far) must exceed its limit likewise.
ROUTE_TOL = 2e-2
DECODE_TOL = 2.5e-2


def phase(name: str, **kv) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, torch, iters: int = 50, warmup: int = 5,
              flush=None) -> float:
    """Median milliseconds of ``fn`` by CUDA events, one event pair per
    call; ``flush`` (untimed) runs before each call.  A ~1 ms device spin
    is queued ahead of each start event, so the pair times the device
    work and not the host's launch latency."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pagewalk_phase(torch, np, dev) -> dict:
    from repro_torch.kernels.pagewalk import kernel as K
    from repro_torch.kernels.pagewalk import ops
    from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref

    rng = np.random.default_rng(SEED)
    vs = rng.integers(-1, G, size=(T, R, P), dtype=np.int32)
    perm = rng.integers(0, 4, size=(T, R, P), dtype=np.int32)
    g = rng.integers(-1, T * G, size=(T, G), dtype=np.int32)
    tables = [torch.as_tensor(x, device=dev) for x in (vs, perm, g)]

    def queries(b: int):
        if b == T * R * P:       # every page of every request, shuffled
            flat = rng.permutation(b)
            t, r, p = flat // (R * P), (flat // P) % R, flat % P
        else:
            t = rng.integers(0, T, b)
            r = rng.integers(0, R, b)
            p = rng.integers(0, P, b)
        w = rng.integers(0, 2, b).astype(bool)
        return [torch.as_tensor(x.astype(np.int32), device=dev)
                for x in (t, r, p)] + [torch.as_tensor(w, device=dev)]

    qs = {b: queries(b) for b in PAGEWALK_BATCHES}
    big = qs[T * R * P]
    n = PAGEWALK_OUT_OF_RANGE
    wild = [rng.integers(-2 * d, 2 * d, n).astype(np.int32)
            for d in (T, R, P)]
    for c, v in zip(wild, (-1, 0, -1)):
        c[0] = v
    qs["out-of-range"] = [torch.as_tensor(x, device=dev) for x in wild] + [
        torch.as_tensor(rng.integers(0, 2, n).astype(bool), device=dev)]

    # ---- the path: the entry point a user calls, counts read around it --
    K.two_stage_translate_kernel.launches = 0
    path_out = ops.two_stage_translate(*tables, *big[:3], big[3],
                                       device=dev)
    torch.cuda.synchronize()
    launches = K.two_stage_translate_kernel.launches
    if launches < 1:
        raise RuntimeError("pagewalk path ran without launching its kernel")

    # ---- kernel vs plain version on the card, bit-exact ------------------
    max_err = 0
    for b, q in qs.items():
        got = K.two_stage_translate_kernel(*tables, *q)
        want = two_stage_translate_ref(*tables, *q)
        torch.cuda.synchronize()
        for name, x, y in zip(("slot", "fault", "stage"), got, want):
            if not torch.equal(x, y):
                raise RuntimeError(f"pagewalk B={b}: {name} differs from "
                                   f"the plain version")
            max_err = max(max_err, int((x.long() - y.long()).abs().max()))
        phase("pagewalk", B=b, bit_exact=True)
    for x, y in zip(path_out, two_stage_translate_ref(*tables, *big)):
        if not torch.equal(x, y):
            raise RuntimeError("pagewalk path output differs from the "
                               "plain version")

    # ---- time at the path's shape, L2 flushed before every call ----------
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    k_ms = time_cuda(lambda: K.two_stage_translate_kernel(*tables, *big),
                     torch, flush=flush)
    k_warm_ms = time_cuda(lambda: K.two_stage_translate_kernel(*tables, *big),
                          torch)
    plain_ms = time_cuda(lambda: two_stage_translate_ref(*tables, *big),
                         torch, flush=flush)
    # bytes this run's data needs: coordinates in (3 x int32 + bool), results
    # out (int32 + bool + int32), each touched stage-1 entry of both tables,
    # each touched stage-2 entry
    t, r, p, w = (x.long() for x in big)
    flat1 = (t * R + r) * P + p
    s1 = two_stage_translate_ref(*tables, *big)[2] == 1
    tp = tables[0].view(-1)[flat1].clamp(0, G - 1)
    n1 = int(torch.unique(flat1).numel())
    n2 = int(torch.unique((t * G + tp)[~s1]).numel())
    b = big[0].numel()
    nbytes = b * (3 * 4 + 1) + b * (4 + 1 + 4) + n1 * 2 * 4 + n2 * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    phase("pagewalk", B=b, kernel_us=f"{k_ms * 1e3:.2f}",
          kernel_warm_l2_us=f"{k_warm_ms * 1e3:.2f}",
          plain_us=f"{plain_ms * 1e3:.2f}", bytes=nbytes,
          bound_us=f"{bound_ms * 1e3:.3f}", own_path_launches=launches)
    return {"name": "pagewalk", "route": "cuda",
            "source": "src/repro_torch/csrc/pagewalk.cu",
            "replaces": "src/repro/kernels/pagewalk/kernel.py:53",
            "launches": launches, "max_abs_err": max_err, "ms": k_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


def hext_phase(torch, dev) -> None:
    from repro_torch.core.hext import programs
    from repro_torch.core.hext.sim import Fleet
    from repro_torch.kernels.pagewalk import kernel as K

    golden = json.loads((ROOT / "benchmarks/results/hext_runs.json")
                        .read_text())["workloads"]
    by_name = {w.name: w for w in programs.WORKLOADS}
    wls = [by_name[n] for n in HEXT_WORKLOADS]
    fleet = Fleet.boot(wls * 2, guest=[False] * len(wls) + [True] * len(wls),
                       device=dev)
    torch.cuda.synchronize()
    # no kernel of the port lies on this path; the counts are read around
    # it all the same
    K.two_stage_translate_kernel.launches = 0
    t0 = time.perf_counter()
    fleet.run(HEXT_MAX_TICKS, chunk=HEXT_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phase("hext", path_kernel_launches=K.two_stage_translate_kernel.launches)
    report = fleet.report()
    for label, entry in report.items():
        name, mode = label.split("/")
        want = golden[name][mode]
        bad = {f: (entry[f], want[f]) for f in HEXT_FIELDS
               if entry[f] != want[f]}
        if bad:
            raise RuntimeError(f"hext {label}: counters differ from "
                               f"hext_runs.json (got, want): {bad}")
    lockstep = max(e["ticks"] for e in report.values())
    hart_ticks = sum(e["ticks"] for e in report.values())
    phase("hext", harts=len(report), all_counters_match=True,
          wall_s=f"{wall:.3f}", lockstep_ticks=lockstep,
          lockstep_ticks_per_s=f"{lockstep / wall:.1f}",
          hart_ticks_per_s=f"{hart_ticks / wall:.1f}")


def close(got, want, tol, what) -> float:
    """Max |got - want| in fp32; raises unless within atol = rtol = tol."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not bool(((g - w).abs() <= tol + tol * w.abs()).all()):
        raise RuntimeError(f"{what}: differs from the plain version "
                           f"(max abs err {err:.3e}, tol {tol})")
    return err


def row_rel_err(got, want, tol, what) -> float:
    """Max over the last-dimension rows of ||got - want|| / ||want||;
    raises above ``tol``."""
    g, w = got.float(), want.float()
    err = float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
    if not err <= tol:
        raise RuntimeError(f"{what}: row relative error {err:.3e} above "
                           f"{tol}")
    return err


def plain_page_map(torch, tables, tenant, req, pages):
    """The decode path's page map by its plain route: the walk's plain
    version, then the fused-TLB select, -1 where a page faults.  The
    coordinates broadcast; the page map has their shape."""
    from repro_torch.indexing import take
    from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref

    t, r, p = (x.expand(torch.broadcast_shapes(tenant.shape, req.shape,
                                               pages.shape)).reshape(-1)
               for x in (tenant, req, pages))
    slot, fault, _ = two_stage_translate_ref(
        tables.vs_table, tables.vs_perm, tables.g_table, t, r, p,
        torch.zeros_like(t, dtype=torch.bool))
    hit = take(tables.fused_ok, t, r, p)
    slot = torch.where(hit, take(tables.fused, t, r, p), slot)
    page_map = torch.where(fault & ~hit, -1, slot.clamp(min=0))
    return page_map.to(torch.int32).reshape(
        torch.broadcast_shapes(tenant.shape, req.shape, pages.shape))


def valid_rows(torch, page_map, lengths, page):
    """Rows with at least one token below the length on a mapped page."""
    tok = (page_map >= 0).repeat_interleave(page, dim=1)
    t = torch.arange(tok.shape[1], device=tok.device)
    return (tok & (t[None] < lengths[:, None])).any(dim=1)


def attention_fp32_checks(torch, np, dev, PAK, paged_attention_ref) -> float:
    """The kernel against its plain version in fp32 at the shapes of the
    JAX tests, plus a row whose pages are all unmapped (the kernel gives
    zeros there, the plain version the uniform mean)."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for B, H, KV, hd, page, n_pages in FP32_SHAPES:
        slots = n_pages * B + 2
        q = rng.standard_normal((B + 1, H, hd))
        kp = rng.standard_normal((slots, page, KV, hd))
        vp = rng.standard_normal((slots, page, KV, hd))
        pm = rng.integers(0, slots, (B + 1, n_pages))
        pm[-1] = -1
        lengths = rng.integers(1, n_pages * page, B + 1)
        x = [torch.as_tensor(a, dtype=torch.float32, device=dev)
             for a in (q, kp, vp)] + [
            torch.as_tensor(a.astype(np.int32), device=dev)
            for a in (pm, lengths)]
        got = PAK.paged_attention_kernel(*x, hd ** -0.5)
        want = paged_attention_ref(*x, hd ** -0.5)
        rows = valid_rows(torch, x[3], x[4], page)
        if int(rows.sum()) != B:
            raise RuntimeError("fp32 check: a row meant to be valid is not")
        err = close(got[rows], want[rows], FP32_TOL,
                    f"paged_attention fp32 {(B, H, KV, hd, page, n_pages)}")
        if not torch.equal(got[~rows], torch.zeros_like(got[~rows])):
            raise RuntimeError("paged_attention: an all-unmapped row is "
                               "not zero")
        worst = max(worst, err)
        phase("vmem", fp32_shape=(B, H, KV, hd, page, n_pages),
              max_abs_err=f"{err:.3e}", all_unmapped_row_zero=True)
    return worst


def vmem_phase(torch, np, dev) -> list:
    from repro_torch.core.vmem import allocator as AL
    from repro_torch.core.vmem import kvcache as KC
    from repro_torch.core.vmem import page_table as PT
    from repro_torch.kernels.paged_attention import kernel as PAK
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.pagewalk import kernel as PWK
    from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref

    B = VM_TENANTS * VM_REQS
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, VM_PAGES * VM_PAGE, B)        # [1, 4095]
    tenant_of = [b // VM_REQS for b in range(B)]
    req_of = [b % VM_REQS for b in range(B)]

    # ---- 1-2. the cache and its control plane ----------------------------
    kv = KC.PagedKVCache.create(VM_SLOTS, VM_PAGE, VM_KV, VM_HD, VM_TENANTS,
                                VM_REQS, VM_PAGES, VM_TENANT_PAGES,
                                device=dev)
    PWK.two_stage_translate_kernel.launches = 0
    t0 = time.perf_counter()
    calls = 0
    for b in range(B):
        for p in range(int(lengths[b]) // VM_PAGE + 1):   # below length + 1
            kv, ok = KC.ensure_mapped(kv, tenant_of[b], req_of[b], p)
            calls += 1
            if not ok:
                raise RuntimeError(f"ensure_mapped failed at request {b} "
                                   f"page {p}")
    torch.cuda.synchronize()
    phase("vmem", ensure_mapped_calls=calls,
          wall_s=f"{time.perf_counter() - t0:.3f}",
          pagewalk_launches=PWK.two_stage_translate_kernel.launches,
          slots_in_use=VM_SLOTS - int(kv.pool.top))

    # ---- 3. seeded bf16 data in one write (it stands in for weights) -----
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kv.k_pool.normal_(generator=gen)
    kv.v_pool.normal_(generator=gen)

    # ---- 4. one new token per request at pos = length, read back ---------
    new = torch.randn((2, B, VM_KV, VM_HD), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    for b in range(B):
        pos = int(lengths[b])
        kv, fault = KC.write_token(kv, tenant_of[b], req_of[b], pos,
                                   new[0, b], new[1, b])
        slot = int(PT.translate(kv.tables, tenant_of[b], req_of[b],
                                pos // VM_PAGE).slot)
        if bool(fault) or slot < 0 or not (
                torch.equal(kv.k_pool[slot, pos % VM_PAGE], new[0, b]) and
                torch.equal(kv.v_pool[slot, pos % VM_PAGE], new[1, b])):
            raise RuntimeError(f"write_token of request {b} did not land")
    phase("vmem", write_token_read_back=B)

    # ---- 5. the path: one decode per request, counts read around it ------
    q = torch.randn((B, VM_H, VM_HD), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    scale = VM_HD ** -0.5
    torch.cuda.synchronize()
    PAK.paged_attention_kernel.launches = 0
    PWK.two_stage_translate_kernel.launches = 0
    t0 = time.perf_counter()
    outs = [KC.paged_decode_attention(kv, tenant_of[b], req_of[b], q[b],
                                      int(lengths[b]) + 1, scale)
            for b in range(B)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pa_launches = PAK.paged_attention_kernel.launches
    pw_launches = PWK.two_stage_translate_kernel.launches
    phase("vmem", path="paged_decode_attention x B", B=B,
          paged_attention_launches=pa_launches,
          pagewalk_launches=pw_launches, wall_s=f"{wall:.3f}")
    if pa_launches != B or pw_launches < B:
        raise RuntimeError("the decode path did not go through both "
                           "kernels once per request")

    # ---- 6. each output against the plain route: the walk's and the
    # attention's plain versions on the same card tensors -------------------
    cols = torch.arange(VM_PAGES, dtype=torch.int32, device=dev)
    tt = torch.as_tensor(tenant_of, dtype=torch.int32, device=dev)[:, None]
    rr = torch.as_tensor(req_of, dtype=torch.int32, device=dev)[:, None]
    plain_map = plain_page_map(torch, kv.tables, tt, rr, cols[None, :])
    path_err = path_rel = 0.0
    for b in range(B):
        want = paged_attention_ref(
            q[b:b + 1], kv.k_pool, kv.v_pool, plain_map[b:b + 1],
            torch.tensor([int(lengths[b]) + 1], dtype=torch.int32,
                         device=dev), scale, unmapped_reads_zero=1)[0]
        if outs[b].shape != (VM_H, VM_HD) or outs[b].dtype != q.dtype or \
                not bool(torch.isfinite(outs[b]).all()):
            raise RuntimeError(f"decode of request {b}: bad output")
        path_err = max(path_err, close(outs[b], want, BF16_TOL,
                                       f"decode of request {b}"))
        path_rel = max(path_rel, row_rel_err(outs[b], want, BF16_ROW_REL_TOL,
                                             f"decode of request {b}"))
    phase("vmem", path_vs_plain_max_abs_err=f"{path_err:.3e}", tol=BF16_TOL,
          path_vs_plain_max_row_rel_err=f"{path_rel:.3e}",
          row_rel_tol=BF16_ROW_REL_TOL)

    # ---- 7. batched decode: one translate, one kernel call ---------------
    # the walk alone at the path's coordinates (no fused select to hide
    # it), bit for bit against its plain version
    before = PWK.two_stage_translate_kernel.launches
    walk = PT.translate(kv.tables, tt, rr, cols[None, :], use_fused=False)
    flat = [x.expand(B, VM_PAGES).reshape(-1) for x in (tt, rr, cols[None])]
    walk_want = two_stage_translate_ref(
        kv.tables.vs_table, kv.tables.vs_perm, kv.tables.g_table, *flat,
        torch.zeros_like(flat[0], dtype=torch.bool))
    for name, x, y in zip(("slot", "fault", "stage"), walk, walk_want):
        if not torch.equal(x.reshape(-1), y):
            raise RuntimeError(f"pagewalk on the decode path's coordinates: "
                               f"{name} differs from the plain version")
    tr = PT.translate(kv.tables, tt, rr, cols[None, :])
    if PWK.two_stage_translate_kernel.launches != before + 2:
        raise RuntimeError("a batched translate was not one launch")
    page_map = torch.where(tr.fault, -1, tr.slot).to(torch.int32)
    if not torch.equal(page_map, plain_map):
        raise RuntimeError("the batched page map differs from its plain "
                           "route")
    phase("vmem", pagewalk_decode_coords=B * VM_PAGES, bit_exact=True,
          page_map_bit_exact=True)
    lens = torch.as_tensor(lengths + 1, dtype=torch.int32, device=dev)
    got = pa_ops.paged_attention(q, kv.k_pool, kv.v_pool, page_map, lens,
                                 scale, device=dev)
    if not torch.equal(got, torch.stack(outs)):
        raise RuntimeError("batched decode differs from the per-request "
                           "path")

    # the same lengths over a page map in which every request owns its
    # slots (a seeded permutation of the pool): what a cache whose requests
    # do not share pages reads
    n_read = (lens.long() + VM_PAGE - 1) // VM_PAGE
    p_idx = torch.arange(VM_PAGES, device=dev)[None, :]
    live = p_idx < n_read[:, None]
    own_map = torch.full_like(page_map, -1)
    own_map[live] = torch.as_tensor(
        rng.permutation(VM_SLOTS)[:int(live.sum())].astype(np.int32),
        device=dev)

    # the kernel against its plain version on both maps: in bf16 by
    # element and by row, then on fp32 copies of q and the pools
    batch_err = batch_rel = fp32_path_err = 0.0
    q32 = q.float()
    pools32 = (kv.k_pool.float(), kv.v_pool.float())
    for label, pm in (("shared", page_map), ("own", own_map)):
        got = PAK.paged_attention_kernel(q, kv.k_pool, kv.v_pool, pm, lens,
                                         scale)
        want = paged_attention_ref(q, kv.k_pool, kv.v_pool, pm, lens, scale)
        err = close(got, want, BF16_TOL, f"batched decode, {label} slots")
        rel = row_rel_err(got, want, BF16_ROW_REL_TOL,
                          f"batched decode, {label} slots")
        got32 = PAK.paged_attention_kernel(q32, *pools32, pm, lens, scale)
        want32 = paged_attention_ref(q32, *pools32, pm, lens, scale)
        err32 = close(got32, want32, FP32_TOL,
                      f"batched decode fp32, {label} slots")
        phase("vmem", batched_B=B, slots=label, bf16_max_abs_err=f"{err:.3e}",
              bf16_max_row_rel_err=f"{rel:.3e}",
              fp32_max_abs_err=f"{err32:.3e}", fp32_tol=FP32_TOL)
        batch_err, batch_rel = max(batch_err, err), max(batch_rel, rel)
        fp32_path_err = max(fp32_path_err, err32)
    del q32, pools32, got32, want32
    args = (q, kv.k_pool, kv.v_pool, page_map, lens, scale)
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    own_args = (q, kv.k_pool, kv.v_pool, own_map, lens, scale)
    k_ms = time_cuda(lambda: PAK.paged_attention_kernel(*args), torch,
                     flush=flush)
    k_warm_ms = time_cuda(lambda: PAK.paged_attention_kernel(*args), torch)
    plain_ms = time_cuda(lambda: paged_attention_ref(*args), torch,
                         flush=flush, iters=10)
    own_k_ms = time_cuda(lambda: PAK.paged_attention_kernel(*own_args),
                         torch, flush=flush)
    own_plain_ms = time_cuda(lambda: paged_attention_ref(*own_args), torch,
                             flush=flush, iters=10)
    # bytes this run's lengths need: every K and V row below the length,
    # once per distinct (slot, row) (requests of one tenant share tenant
    # pages, so they share rows), q and the output, and the page-table
    # entries and lengths read
    row_bytes = VM_KV * VM_HD * 2
    rows_in_page = (lens.long()[:, None] - p_idx * VM_PAGE).clamp(0, VM_PAGE)
    per_slot = torch.zeros(VM_SLOTS, dtype=torch.long, device=dev)
    per_slot.scatter_reduce_(0, page_map.long()[live], rows_in_page[live],
                             "amax")
    distinct_rows = int(per_slot.sum())
    request_rows = int(lens.sum())
    qo_bytes = 2 * B * VM_H * VM_HD * 2
    nbytes = (2 * distinct_rows * row_bytes + qo_bytes +
              int(live.sum()) * 4 + B * 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    own_bytes = (2 * request_rows * row_bytes + qo_bytes +
                 int(live.sum()) * 4 + B * 4)
    own_bound_ms = own_bytes / HBM_BYTES_PER_S * 1e3
    phase("vmem", batched_B=B, slots="shared", equal_to_path=True,
          kernel_us=f"{k_ms * 1e3:.2f}",
          kernel_warm_l2_us=f"{k_warm_ms * 1e3:.2f}",
          plain_us=f"{plain_ms * 1e3:.2f}", bytes=nbytes,
          bound_us=f"{bound_ms * 1e3:.3f}", distinct_kv_rows=distinct_rows,
          request_kv_rows=request_rows)
    phase("vmem", batched_B=B, slots="own",
          kernel_us=f"{own_k_ms * 1e3:.2f}",
          plain_us=f"{own_plain_ms * 1e3:.2f}", bytes=own_bytes,
          bound_us=f"{own_bound_ms * 1e3:.3f}", kv_rows=request_rows)

    # context, not a library version of the kernel: SDPA over the same
    # tokens pre-gathered into dense K/V (GQA heads repeated), key mask
    T = VM_PAGES * VM_PAGE
    G = VM_H // VM_KV
    dense = [p[page_map.long().clamp(min=0)].reshape(B, T, VM_KV, VM_HD)
             .permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
             for p in (kv.k_pool, kv.v_pool)]
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None,
                                                                  None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = q[:, :, None, :]
    sdpa_out = sdpa(q4, *dense, attn_mask=mask, scale=scale)[:, :, 0]
    sdpa_err = close(sdpa_out, paged_attention_ref(*args), BF16_TOL,
                     "SDPA over dense K/V")
    sdpa_ms = time_cuda(lambda: sdpa(q4, *dense, attn_mask=mask,
                                     scale=scale), torch, flush=flush)
    phase("vmem", sdpa_dense_masked_us=f"{sdpa_ms * 1e3:.2f}",
          sdpa_max_abs_err=f"{sdpa_err:.3e}")
    del dense, mask, sdpa_out

    # ---- 8. fp32 at the JAX tests' shapes, an all-unmapped row -----------
    fp32_err = attention_fp32_checks(torch, np, dev, PAK,
                                     paged_attention_ref)

    # ---- 9. teardown of tenant 0 ------------------------------------------
    mine = torch.as_tensor([b for b in range(B) if tenant_of[b] == 0],
                           device=dev)
    kv = KC.evict_tenant(kv, 0)
    inv = AL.check_invariants(kv.pool)
    after = PT.translate(kv.tables, 0, rr[mine], cols[None, :])
    if not all(inv.values()) or not bool(after.fault.all()):
        raise RuntimeError(f"evict_tenant: invariants {inv}, every former "
                           f"page faults: {bool(after.fault.all())}")
    phase("vmem", evict_tenant=0, invariants=inv, former_pages_fault=True,
          slots_in_use=VM_SLOTS - int(kv.pool.top))

    return [pw_launches, {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:75",
        "launches": pa_launches,
        "max_abs_err": max(path_err, batch_err, fp32_path_err, fp32_err),
        "ms": k_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None}]


# ---------------------------------------------------------------------------
# model: the dense LM serving path with the flash_attention kernel
# ---------------------------------------------------------------------------

def flash_bound(B, S, H, KV, hd, window, itemsize):
    """(bound ms, "bytes" or "operations", flops, bytes) of causal
    attention: 4 * hd flops per query head and visible (query, key) pair
    at the bf16 tensor-core peak, against q, k, v and out moved once."""
    w = window if window else S
    pairs = sum(min(q + 1, w) for q in range(S))
    flops = 4 * hd * H * B * pairs
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * itemsize
    t_ops, t_bytes = flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def flash_inputs(torch, gen, dev, B, S, H, KV, hd, dtype):
    q = torch.randn((B, S, H, hd), generator=gen, device=dev) * 0.5
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev) * 0.5
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev)
    return [x.to(dtype) for x in (q, k, v)]


def plain_by_kv_head(torch, ref):
    """The plain version one KV head (and its G query heads) at a time:
    the same function at 1/KV of the plain version's score memory."""
    def attend(q, k, v, scale, window):
        KV = k.shape[2]
        G = q.shape[2] // KV
        return torch.cat([ref(q[:, :, h * G:(h + 1) * G], k[:, :, h:h + 1],
                              v[:, :, h:h + 1], scale, window)
                          for h in range(KV)], dim=2)
    return attend


def flash_checks(torch, dev, gen, FAK, ref) -> float:
    """The kernel against its plain version at the JAX tests' shapes."""
    worst = 0.0
    for B, S, H, KV, hd, window, dt in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = flash_inputs(torch, gen, dev, B, S, H, KV, hd, dtype)
        got = FAK.flash_attention_kernel(q, k, v, hd ** -0.5, window)
        want = ref(q, k, v, hd ** -0.5, window)
        tol = BF16_TOL if dtype == torch.bfloat16 else FLASH_FP32_TOL
        shape = (B, S, H, KV, hd, window, dt)
        err = close(got, want, tol, f"flash_attention {shape}")
        worst = max(worst, err)
        phase("model", flash_shape=shape,
              max_abs_err=f"{err:.3e}", tol=tol)
    return worst


def check_by_kv_head(torch, ref, got, q, k, v, scale, window, what,
                     controls=()):
    """(max abs error, max row relative error, [max row relative error of
    each control]) of the kernel's output ``got`` against the plain
    version, one KV head (and its G query heads) at a time; raises above
    the bf16 element or row tolerance.  ``controls`` are other outputs
    held against the same plain version without a limit."""
    KV = k.shape[2]
    G = q.shape[2] // KV
    err = rel = 0.0
    ctrl = [0.0] * len(controls)
    for h in range(KV):
        sl = slice(h * G, (h + 1) * G)
        want = ref(q[:, :, sl], k[:, :, h:h + 1], v[:, :, h:h + 1], scale,
                   window)
        err = max(err, close(got[:, :, sl], want, BF16_TOL,
                             f"{what}, KV head {h}"))
        rel = max(rel, row_rel_err(got[:, :, sl], want, BF16_ROW_REL_TOL,
                                   f"{what}, KV head {h}"))
        ctrl = [max(c, rel_rows(torch, o[:, :, sl], want))
                for c, o in zip(ctrl, controls)]
        del want
    return err, rel, ctrl


def flash_full_width(torch, dev, gen, cfg, FAK, ref, flush) -> dict:
    """The kernel at the model's prefill shape (B = 1, and the path's
    B = LM_B at S = 8192), held against its plain version one KV head at a
    time, then timed beside its bound, the plain version and SDPA (at
    S = 8192 and at SHAPES["prefill_32k"])."""
    from repro_torch.configs import SHAPES

    H, KV, hd, window = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                         cfg.window)
    G, scale = H // KV, hd ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for S in (LM_S, SHAPES["prefill_32k"].seq_len):
        q, k, v = flash_inputs(torch, gen, dev, 1, S, H, KV, hd,
                               torch.bfloat16)
        got = FAK.flash_attention_kernel(q, k, v, scale, window)
        if S == LM_S:
            err, rel, _ = check_by_kv_head(torch, ref, got, q, k, v,
                                           scale, window,
                                           f"flash_attention S={S}")
            phase("model", flash_full_width=(1, S, H, KV, hd, window),
                  vs_plain_by_kv_head_max_abs_err=f"{err:.3e}", tol=BF16_TOL,
                  max_row_rel_err=f"{rel:.3e}", row_rel_tol=BF16_ROW_REL_TOL)
            out.update(max_abs_err=err)
        k_ms = time_cuda(lambda: FAK.flash_attention_kernel(
            q, k, v, scale, window), torch, iters=10 if S > LM_S else 20,
            warmup=2, flush=flush)
        bound_ms, bound_by, flops, nbytes = flash_bound(1, S, H, KV, hd,
                                                        window, 2)
        # the library yardstick: SDPA with the window as a boolean mask,
        # K/V heads repeated to H outside the timed call
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        qh, kh, vh = (x.transpose(1, 2) for x in
                      (q, k.repeat_interleave(G, dim=2),
                       v.repeat_interleave(G, dim=2)))
        lib_out = sdpa(qh, kh, vh, attn_mask=mask, scale=scale)
        lib_err = float((lib_out.transpose(1, 2).float() - got.float())
                        .abs().max())
        lib_ms = time_cuda(lambda: sdpa(qh, kh, vh, attn_mask=mask,
                                        scale=scale), torch,
                           iters=10 if S > LM_S else 20, warmup=2,
                           flush=flush)
        del lib_out, qh, kh, vh, mask
        line = dict(S=S, kernel_ms=f"{k_ms:.4f}",
                    bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                    flops=flops, bytes=nbytes,
                    kernel_over_bound=f"{k_ms / bound_ms:.1f}",
                    sdpa_masked_ms=f"{lib_ms:.4f}",
                    sdpa_vs_kernel_max_abs=f"{lib_err:.3e}")
        if S == LM_S:
            # the path's own shape: the prefill's B = LM_B requests, held
            # against the plain version before it is timed
            qb, kb, vb = flash_inputs(torch, gen, dev, LM_B, S, H, KV, hd,
                                      torch.bfloat16)
            gb = FAK.flash_attention_kernel(qb, kb, vb, scale, window)
            b_err, b_rel, _ = check_by_kv_head(torch, ref, gb, qb, kb, vb,
                                            scale, window,
                                            f"flash_attention B={LM_B} "
                                            f"S={S}")
            del gb
            phase("model", flash_path_shape=(LM_B, S, H, KV, hd, window),
                  vs_plain_by_kv_head_max_abs_err=f"{b_err:.3e}",
                  tol=BF16_TOL, max_row_rel_err=f"{b_rel:.3e}",
                  row_rel_tol=BF16_ROW_REL_TOL)
            out["max_abs_err"] = max(err, b_err)
            path_ms = time_cuda(lambda: FAK.flash_attention_kernel(
                qb, kb, vb, scale, window), torch, iters=5, warmup=1,
                flush=flush)
            del qb, kb, vb
            line[f"kernel_ms_at_B{LM_B}"] = f"{path_ms:.4f}"
            plain = plain_by_kv_head(torch, ref)
            plain_ms = time_cuda(lambda: plain(q, k, v, scale, window),
                                 torch, iters=5, warmup=1, flush=flush)
            line["plain_by_kv_head_ms"] = f"{plain_ms:.4f}"
            out.update(ms=k_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms, path_ms=path_ms)
        phase("model", **line)
        del q, k, v, got
    return out


@contextlib.contextmanager
def prefill_attention(fn):
    """Inside the block, ``attn_prefill`` attends through ``fn(q, k, v,
    scale, window)`` in place of ``ops.flash_attention``."""
    from repro_torch.models import attention as AT

    saved = AT.flash_attention
    AT.flash_attention = fn
    try:
        yield
    finally:
        AT.flash_attention = saved


def teed_flash(torch, FAK, ref):
    """An attention for ``attn_prefill`` that launches the kernel, holds
    its output against the plain version (one KV head at a time) on the
    same q, k, v, and passes the kernel's output on; ``.errs`` keeps each
    call's (max abs, max row relative, [control's max row relative])
    error.  The control is the kernel with a window one key short, which
    the row tolerance must see."""
    def attend(q, k, v, scale, window):
        got = FAK.flash_attention_kernel(q, k, v, scale, window)
        short = FAK.flash_attention_kernel(q, k, v, scale, window - 1)
        attend.errs.append(check_by_kv_head(
            torch, ref, got, q, k, v, scale, window,
            f"flash_attention, layer {len(attend.errs)}", controls=(short,)))
        return got
    attend.errs = []
    return attend


def core_by_kv_head(torch, AT):
    """``attention_core`` (QK^T and the weights rounded to bf16, as the JAX
    prefill computes) one KV head at a time, in the kernel's contract."""
    def attend(q, k, v, scale, window):
        pos = torch.arange(q.shape[1], device=q.device)
        mask = AT._causal_mask(pos, pos, window)[None, None]
        KV = k.shape[2]
        G = q.shape[2] // KV
        return torch.cat([AT.attention_core(q[:, :, h * G:(h + 1) * G],
                                            k[:, :, h:h + 1],
                                            v[:, :, h:h + 1], mask, scale)
                          for h in range(KV)], dim=2)
    return attend


def busy_us(kernels) -> float:
    """µs covered by the union of the kernels' [start, end) intervals."""
    spans = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def decode_busy(torch, step):
    """(device busy ms, profiled step ms, top kernels) of one ``step()``
    under ``torch.profiler``: the union of its kernels' device intervals,
    the step's host wall (launch to synchronise) under the profiler, and
    the six kernels with the most device time as (name, launches, µs).
    The busy time is None if the trace holds no device kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, wall_us / 1e3, []
    per_name = {}
    for k in kernels:
        n, us = per_name.get(k.name, (0, 0.0))
        per_name[k.name] = (n + 1, us + k.time_range.end - k.time_range.start)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:6]
    return (busy_us(kernels) / 1e3, wall_us / 1e3,
            [(name[:60], n, round(us, 1)) for name, (n, us) in top])


def rel_rows(torch, got, want) -> float:
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def serve(torch, dev, cfg, lm, TF, prompts, counts):
    """The path: one prefill of the prompts, then LM_STEPS greedy decode
    steps; every kernel count is set to 0 just before the prefill and the
    launches of the prefill and of the decode steps are read after each."""
    B, S = prompts.shape
    cache = TF.init_cache(cfg, B, S, device=dev)
    torch.cuda.synchronize()
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    logits, cache = TF.prefill(lm, cfg, prompts, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    at_prefill = [c.launches for c in counts]
    tokens, step_ms = [], []
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    for _ in range(LM_STEPS):
        nxt = logits.float().argmax(dim=-1)
        tokens.append(nxt)
        t0 = time.perf_counter()
        logits, cache = TF.decode_step(lm, cfg, nxt, pos, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        pos = pos + 1
        if logits.shape != (B, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise RuntimeError("decode_step: bad logits")
    return (prefill_s, at_prefill, [c.launches for c in counts],
            torch.stack(tokens, dim=1), step_ms, cache, pos, logits)


def model_phase(torch, np, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FAK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import kernel as PAK
    from repro_torch.kernels.pagewalk import kernel as PWK
    from repro_torch.models import attention as AT
    from repro_torch.models import transformer as TF

    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_

    # ---- 1-2. the kernel alone ---------------------------------------------
    test_err = flash_checks(torch, dev, gen, FAK, flash_attention_ref)
    kernel = flash_full_width(torch, dev, gen, cfg, FAK, flash_attention_ref,
                              flush)

    # ---- 3. the path: full model, 4 requests -------------------------------
    t0 = time.perf_counter()
    lm = TF.init_lm(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    phase("model", arch=cfg.name, layers=cfg.n_layers, params=n_params,
          weight_bytes=sum(p.numel() * p.element_size()
                           for p in lm.parameters()),
          init_s=f"{time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (LM_B, LM_S + 1)), device=dev)
    counts = (FAK.flash_attention_kernel, PAK.paged_attention_kernel,
              PWK.two_stage_translate_kernel)
    torch.cuda.reset_peak_memory_stats(dev)
    (prefill_s, at_prefill, at_end, tokens, step_ms, cache, _, _) = serve(
        torch, dev, cfg, lm, TF, prompts[:, :LM_S], counts)
    launches = at_prefill[0]
    phase("model", path=f"prefill {LM_B} x {LM_S} + {LM_STEPS} decode steps",
          flash_launches_prefill=launches,
          flash_launches_total=at_end[0],
          paged_attention_launches=at_end[1], pagewalk_launches=at_end[2],
          prefill_wall_s=f"{prefill_s:.3f}",
          peak_mem_gb=f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}")
    if launches != cfg.n_layers or at_end[0] != cfg.n_layers:
        raise RuntimeError(f"the prefill launched the flash kernel "
                           f"{launches} times (decode: "
                           f"{at_end[0] - launches}), not once per layer")
    tok = tokens.cpu().numpy()
    checksum = int((tok * np.arange(1, tok.size + 1).reshape(tok.shape))
                   .sum() % 1_000_000_007)
    phase("model", greedy_tokens=tok.tolist(), checksum=checksum)

    # steady-state times: a second serve (prefill and decode window), then
    # one profiled decode step on its cache
    (prefill2_s, _, _, tokens2, step2_ms, cache, pos, _) = serve(
        torch, dev, cfg, lm, TF, prompts[:, :LM_S], counts)
    decode_ms = sum(step2_ms) / len(step2_ms)
    nxt = tokens2[:, -1]
    busy_ms, prof_ms, top = decode_busy(
        torch, lambda: TF.decode_step(lm, cfg, nxt, pos, cache))
    # the kernel's share of the prefill, from its time at the path's shape
    flash_share = cfg.n_layers * kernel["path_ms"] / (prefill2_s * 1e3)
    phase("model", prefill_wall_s=f"{prefill2_s:.3f}",
          prefill_tok_per_s=f"{LM_B * LM_S / prefill2_s:.0f}",
          flash_share_of_prefill=f"{flash_share:.3f}",
          decode_steps=len(step2_ms),
          decode_ms_per_step=f"{decode_ms:.3f}",
          decode_ms_median=f"{statistics.median(step2_ms):.3f}",
          decode_ms_min_max=f"{min(step2_ms):.3f}/{max(step2_ms):.3f}",
          decode_tok_per_s=f"{LM_B * 1e3 / decode_ms:.1f}",
          same_tokens_as_first_serve=bool(torch.equal(tokens2, tokens)))
    if busy_ms is None:
        phase("model", decode_device_idle_share="not measured",
              decode_step_profiled_ms=f"{prof_ms:.3f}")
    else:
        # idle against the unprofiled step (the decode window's mean) and,
        # for reference, against the profiled step's own wall
        phase("model", decode_device_busy_ms=f"{busy_ms:.3f}",
              decode_device_idle_share=f"{1.0 - busy_ms / decode_ms:.4f}",
              decode_step_profiled_ms=f"{prof_ms:.3f}",
              idle_share_of_profiled_step=f"{1.0 - busy_ms / prof_ms:.4f}")
    phase("model", decode_step_top_kernels=top)
    del cache

    # ---- 4. two checks at B = 1, each beside its controls -------------------
    one = prompts[:1]

    def prefill_logits(attend, tokens):
        with prefill_attention(attend):
            return TF.prefill(lm, cfg, tokens,
                              TF.init_cache(cfg, 1, LM_S, device=dev))[0]

    plain = plain_by_kv_head(torch, flash_attention_ref)
    teed = teed_flash(torch, FAK, flash_attention_ref)
    via_kernel = prefill_logits(teed, one[:, :LM_S])
    if len(teed.errs) != cfg.n_layers:
        raise RuntimeError("the route prefill did not attend once per layer")
    layer_err = max(e for e, _, _ in teed.errs)
    layer_rel = max(r for _, r, _ in teed.errs)
    short_rel = [c[0] for _, _, c in teed.errs]
    phase("model", route="kernel vs plain flash on each layer's q, k, v",
          layers=len(teed.errs), max_abs_err=f"{layer_err:.3e}",
          tol=BF16_TOL, max_row_rel_err=f"{layer_rel:.3e}",
          row_rel_tol=BF16_ROW_REL_TOL)
    phase("model", layer_control="kernel with window - 1 vs plain flash "
          "on each layer's q, k, v", max_row_rel_err=f"{max(short_rel):.3e}",
          must_exceed=BF16_ROW_REL_TOL,
          layers_above_tol=sum(r > BF16_ROW_REL_TOL for r in short_rel),
          least_layer=f"{min(short_rel):.3e}")
    if not max(short_rel) > BF16_ROW_REL_TOL:
        raise RuntimeError(f"the per-layer check cannot see a window one "
                           f"key short: {max(short_rel):.3e} <= "
                           f"{BF16_ROW_REL_TOL}")
    via_plain = prefill_logits(plain, one[:, :LM_S])

    def against_plain(logits):
        return (rel_rows(torch, logits, via_plain),
                bool((logits.float().argmax(-1) ==
                      via_plain.float().argmax(-1)).all()))

    route, top1 = against_plain(via_kernel)
    phase("model", route="kernel vs plain flash in one prefill, B=1",
          logits_row_rel_err=f"{route:.3e}", tol=ROUTE_TOL, top1_agree=top1)
    # controls: a window one key short, and attention_core's bf16 numerics
    short, short_top1 = against_plain(prefill_logits(
        lambda q, k, v, scale, window: FAK.flash_attention_kernel(
            q, k, v, scale, window - 1), one[:, :LM_S]))
    bf16, bf16_top1 = against_plain(prefill_logits(core_by_kv_head(torch,
                                                                   AT),
                                                   one[:, :LM_S]))
    phase("model", route_control="kernel with window - 1 vs plain flash",
          logits_row_rel_err=f"{short:.3e}", top1_agree=short_top1,
          within_tol=short <= ROUTE_TOL)
    phase("model", route_control="attention_core (QK^T, P in bf16) vs "
          "plain flash", logits_row_rel_err=f"{bf16:.3e}",
          top1_agree=bf16_top1, within_tol=bf16 <= ROUTE_TOL)
    if not route <= ROUTE_TOL:
        raise RuntimeError(f"prefill through the kernel differs from the "
                           f"plain route: {route:.3e} > {ROUTE_TOL}")

    cache = TF.init_cache(cfg, 1, LM_S, device=dev)
    _, cache = TF.prefill(lm, cfg, one[:, :LM_S], cache)
    saved = [{n: x.clone() for n, x in layer.items()} for layer in cache]
    dec, _ = TF.decode_step(lm, cfg, one[:, LM_S],
                            torch.full((1,), LM_S, dtype=torch.int32,
                                       device=dev), cache)
    # control: the same token decoded one position too far, on the
    # prefill's own cache
    off, _ = TF.decode_step(lm, cfg, one[:, LM_S],
                            torch.full((1,), LM_S + 1, dtype=torch.int32,
                                       device=dev), saved)
    fresh, _ = TF.prefill(lm, cfg, one,
                          TF.init_cache(cfg, 1, LM_S, device=dev))
    dvp = rel_rows(torch, dec, fresh)
    ctrl = rel_rows(torch, off, fresh)
    phase("model", check=f"decode at {LM_S} vs a fresh {LM_S + 1}-token "
          f"prefill, B=1", logits_row_rel_err=f"{dvp:.3e}", tol=DECODE_TOL,
          top1_agree=bool((dec.float().argmax(-1) ==
                           fresh.float().argmax(-1)).all()))
    phase("model", decode_control=f"decode at {LM_S + 1} vs the fresh "
          f"prefill", logits_row_rel_err=f"{ctrl:.3e}",
          must_exceed=DECODE_TOL)
    if not dvp <= DECODE_TOL:
        raise RuntimeError(f"decode differs from prefill: {dvp:.3e} > "
                           f"{DECODE_TOL}")
    if not ctrl > DECODE_TOL:
        raise RuntimeError(f"the decode check cannot see a position off by "
                           f"one: {ctrl:.3e} <= {DECODE_TOL}")
    del lm, cache, saved

    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
            "launches": launches,
            "max_abs_err": max(test_err, kernel["max_abs_err"], layer_err),
            "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
            "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
            "library_ms": kernel["library_ms"]}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0])
    print(smi, flush=True)

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        infos = dict(zip(KERNEL_SOURCES,
                         pool.map(build.compile_source, KERNEL_SOURCES)))
    for name, info in infos.items():
        phase("build", kernel=name, seconds=f"{info['seconds']:.2f}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    phase("build", wall_s=f"{time.perf_counter() - t0:.2f}")

    walk = pagewalk_phase(torch, np, dev)
    hext_phase(torch, dev)
    walk_launches, attention = vmem_phase(torch, np, dev)
    # pagewalk's path is now its consumer's: the vmem decode path
    walk["launches"] = walk_launches
    torch.cuda.empty_cache()
    flash = model_phase(torch, np, dev)
    kernels = [walk, attention, flash]

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
