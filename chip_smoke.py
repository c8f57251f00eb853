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
                 version on the card at B in {1, 7, 512, 513, 262144}, on
                 4096 out-of-range coordinates and on bases 4 bytes (1 for
                 want_write) past an aligned one, and timed (CUDA events,
                 median) at the 262,144-query table sweep beside its byte
                 bound, with its decomposition (the fixed cost of a
                 one-element kernel, a copy_ of the same bytes, the walk
                 in table order and with L2 warm) and its grid;
4. hext        — (run last, after phase 6, so no trace follows a traced
                 CUDA graph) the simulator's run loop on the card: (a) sha,
                 crc32,
                 basicmath, stringsearch and fft x {native, guest} (10
                 harts, 256 KiB each) for 512 ticks on the eager engine
                 (host gates) and on the graph engine (device gates, one
                 CUDA graph) at 1, 8 and 32 ticks a replay: the whole
                 state of every hart, memory included, must be equal, and
                 each engine's ticks/s and the capture seconds are
                 printed; (b) all 9 workloads x {native, guest} as one
                 18-hart fleet on the default engine (it must be
                 ``graph``), snapshot after 12,288 ticks, restored onto the
                 card (equal to the saved state) and run to completion;
                 (c) the five short workloads' 1guest-preempt column.
                 Every ``HEXT_FIELDS`` field of every hart must equal
                 ``benchmarks/results/hext_runs.json`` (read, never
                 written); walls, lockstep and hart ticks/s, and the
                 device idle share of one profiled chunk are printed;
                 then the fleet operations on the graph engine: (d) the
                 fixed-seed torture corpus (seed 2026, 256 scenarios) as
                 two fleets, fuzz (224 harts x 16,384 words, 1,536 ticks)
                 and sched (32 harts x 65,536 words, 6,144 ticks), each
                 run on the graph engine and on ``OracleEngine`` from one
                 ``from_corpus`` boot and diffed hart by hart (0
                 mismatches, at least the 218 coverage buckets of
                 ``benchmarks/results/torture_coverage_baseline.json``),
                 a control (x7 of one hart changed after the graph's run
                 must be reported alone, and its repro line with that
                 fault injected must exit 1) and ``--case 7 -v``; (e) a
                 2-hart N=2 fleet (sha+crc32, stringsearch+fft,
                 timeslice 300): a migration mid run, a park to a file
                 and a resume into the freed slot, every guest at its
                 golden, then ``replace_hart`` of a lane with a fresh
                 boot run to its golden with no new graph captured; (f)
                 the service: fft, sha, crc32, stringsearch at N=2 and a
                 native sha and a guest fft on solo lanes, drained, every
                 counter field equal to a direct boot of the same groups;
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
                 the path's coordinates; the walk the path runs
                 (``translate_kernel`` on ``translate``'s own plan, fused
                 cache) and the walk on the same coordinates materialised
                 as vectors, each bit-exact and timed at its consumers'
                 shapes (B = 256 and 32,768) beside its bound; the whole
                 ``translate_block`` and ``ensure_mapped`` translate calls
                 timed and profiled, each required to be one walk with no
                 aten op that launches or copies and, where the profiler
                 sees the card, one CUDA kernel and no host-to-device
                 copy; the fused entry bit-equal to its plain version at
                 the decode path's coordinates; the batched decode (B=128)
                 on the
                 path's page map and on one where every request owns its
                 slots, held against its plain version in bf16 and on fp32
                 copies, and timed beside its byte bound, and the path's
                 own call shape (B = 1, the longest request) timed beside
                 its bound (one kernel call is two CUDA launches: the
                 split kernel and the combine); the fp32 shapes
                 of ``tests/test_kernels.py`` and an all-unmapped row; and
                 ``evict_tenant`` with the pool invariants checked;
6. model       — the dense LM serving path at H2O-Danube-3-4B's full
                 width and depth (24 layers, d 3840, H 32, KV 8, hd 120,
                 window 4096; seeded bf16 weights): the flash_attention
                 kernel against its plain version at the shapes of
                 ``tests/test_kernels.py`` (fp32 2e-5 on the SIMT kernel,
                 timed once; bf16 2e-2 on the tensor-core kernel), at a
                 ragged S with hd 120, hd 20, a window edge inside a key
                 tile and G = 1, hd 256 at G 16 (both kernels) and hd 250,
                 and one KV head at a time at the
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
7. kernels     — one JSON line listing each ported kernel (pagewalk's
                 times are those of the path's call, translate_block's
                 walk);
8. moe         — (run after phase 6, before phase 4) the MoE serving path:
                 the flash_attention kernel at Qwen3-30B-A3B's causal
                 prefill shape (B 1 and 4, S 8192, H 32, KV 4, hd 128)
                 and Granite-MoE-3B-A800M's (B 4, S 4096, H 24, KV 8, hd
                 64) against its plain version, timed beside its bound,
                 SDPA with ``is_causal=True`` and the plain version; then
                 each model at full width and depth from seeded bf16
                 weights built on the card (Qwen3: 48 layers, 128
                 experts, ~61 GB; Granite: 32 layers, 40 experts padded to
                 48): ``prefill`` of 4 prompts (8192 / 4096 tokens, the
                 last row one token repeated so capacity overflows) with
                 every kernel count set to 0 just before and read just
                 after (one flash launch a layer), then greedy
                 ``decode_step``s (16 / 8); the dropped assignments of
                 each row (the repeated row's > 0) and the tokens of the
                 padded experts (0) counted on the card; peak memory, the
                 weight init, prefill wall, decode ms a step beside its
                 byte bound and the device idle share of a decode step;
                 on Qwen3's layers 0 and 47 (1,024 tokens of the repeated
                 row and of a random row) the card's routing against the
                 CPU's on the card's logits (bit-equal), the card's output
                 against the CPU's on that routing, two card runs
                 bit-equal and a capacity C - 1 control; at B = 1 the
                 kernel against its plain version on every layer's q, k,
                 v (control: each query's own key dropped) and decode
                 against a fresh prefill (with its control), at a
                 capacity factor where nothing drops (ROADMAP R7);
9. recurrent   — (after phase 8, before phase 4) the recurrent,
                 state-space, encoder-decoder and frontend paths: the
                 flash_attention kernel at RecurrentGemma-9B's prefill
                 shape (B 1 and 4, S 8192, H 16, KV 1, hd 256, window 2048)
                 against its plain version one batch row at a time, timed
                 beside its bound, SDPA with the window as a mask and the
                 plain version, with the ptxas lines of its HDP 256
                 instantiations; then RecurrentGemma-9B (38 layers, 12
                 x (R, R, A) + R, R; 9.40 B parameters), Mamba2-130M (24 SSD
                 layers), Whisper-base (6 + 6 layers, 1,500 seeded
                 frames) and InternVL2-2B (24 layers, 256 seeded patch
                 embeddings before the text) at full width and depth from
                 seeded bf16 weights built on the card: ``prefill`` of 4
                 prompts (8192, 8192, 448 and 256 + 7936 positions) with
                 every kernel count set to 0 just before and read just
                 after (exactly 12 / 0 / 6 / 24 flash launches), 16 greedy
                 ``decode_step``s; peak memory, the weight init, prefill
                 wall beside its FLOP bound, decode ms a step beside its
                 byte bound and the device idle share of a decode step;
                 at B = 1: RecurrentGemma's kernel against its plain
                 version on every attention layer's q, k, v (control: the
                 window one key short) and the RG-LRU scan of layer 0 and
                 layer 37 (a remainder block) against the sequential fp32
                 recurrence on the card (control: one step late);
                 Mamba2's layer-0 ``ssd_chunked`` at a ragged S (8100)
                 against ``ssd_decode_step`` token by token (control: one
                 step late); for every model decode against a fresh
                 prefill (logits 2.5e-2), and at the first layer of each
                 kind its mixer output (1e-2 by row) beside a control
                 that must exceed it (an attention layer: one position
                 too far; a recurrent one: the state one token short).

10. train      — (after phase 9, before phase 4) the training path on
                 MiniCPM-2B (40 layers, d 2304, 36 heads, hd 64, d_ff 5760,
                 tied 122,880 x 2,304 embedding; muP scalings; WSD as
                 ``launch/train`` picks it).  Gates (a), (b), (d) at full
                 width with depth cut to 2 layers, from one seeded fp32
                 state: (a) 3 steps of ``build_train_step`` at 2 x 128 on
                 the card against the same steps on the CPU (losses 1e-4
                 relative, grad norms 1e-4, each parameter's update 5e-2 by
                 relative norm; control: the last label of each row
                 ignored on the card must move the loss beyond 1e-4); (b)
                 ``microbatches`` 2 against 1 (loss 1e-5, grad norm 1e-4;
                 control: the accumulated gradients not divided by M); (d)
                 under deterministic algorithms, 3 steps, a save through
                 ``CheckpointManager`` under ``chiprun_out/``, a restore
                 into a freshly built state (every tensor bit-equal) and
                 the next step from both states bit-equal (control: the
                 restored AdamW step one off must differ).  (e) the whole
                 model, seeded fp32 masters, 8 steps of 4 x 1024 tokens
                 through ``launch/train.main`` with every kernel count set
                 to 0 just before and read just after (0 launches: the
                 training path reaches no kernel, as the reference's
                 reaches no Pallas call); every loss and grad norm finite
                 and the loss of step 7 below step 0's; per-step loss,
                 grad norm and lr, step ms (median of steps 2-7), tokens/s,
                 the step's FLOP bound and the share of it reached, peak
                 memory, state bytes, the device idle share of one more,
                 profiled, step and the device ms of the step's parts
                 (the bf16 copy, one ``adamw_update``).  (c) layer 0's q, k, v of (e)'s
                 first step through ``attention_core`` (the training
                 attention) against the flash kernel, 1e-2 by row
                 (control: each query's own key dropped).

11. mesh       — (after phase 10, before phase 4) the mesh half on a
                 world-size-1 nccl group (a ``HashStore``) and
                 ``launch/mesh.make_host_mesh()``: (a) 3 steps of
                 MiniCPM-2B at full width, 2 layers, 2 x 128 through the
                 DTensor step (``grad_shardings``, the state placed by
                 ``tree_shardings``/``opt_state_specs``) and through
                 today's step from one seeded state, under deterministic
                 algorithms: loss, grad norm and every parameter
                 bit-equal (else the train phase's card-vs-CPU
                 tolerances, the parameters that differ named),
                 control: the DTensor step
                 at 2 x lr must differ; (b) the whole MiniCPM-2B, 3 steps
                 of 4 x 1024 through ``launch/train.main([..., "--mesh",
                 "host"])`` with the kernel counts read around it (0):
                 step ms, tokens/s, the peak memory of steps 1-2, the
                 idle share of a profiled step, beside phase 10's plain
                 path; (e) ``launch/analytic``'s FLOPs and bytes beside
                 this script's own bounds (not a gate); then, with the
                 group destroyed, the records of ``launch/dryrun.run_cell``
                 in one subprocess a cell (one default process group a
                 process, all started together at a lower priority, in the
                 default run before the train phase): (c) (b)'s cell
                 on a fake world of 1, whose live bytes a device must be
                 within 20 % of (b)'s measured peak, and (d) ``minicpm_2b train_4k`` and
                 ``qwen3_moe_30b_a3b decode_32k`` on (16, 16),
                 ``h2o_danube_3_4b prefill_32k`` on (2, 16, 16) (through
                 flash's fake binding), each ``ok``, with bytes a
                 device, the roofline terms, the dominant one, the
                 collectives by kind and the cell's wall.

``--train`` runs only the build of ``flash_attention`` and phase 10, and
prints no result line.

``--mesh`` runs only phase 11 and prints no result line.

``--serving`` runs only the build of ``flash_attention`` and the serving
phases (model, moe, recurrent), and prints no result line; with ``--src``
two checkouts' serving paths can be timed in turns in one call.

``--hext-matrix`` runs only the hext columns that phase 4 leaves out (the
long four's 1guest-preempt, and the 2guest- and 4guest-preempt columns of
all nine, up to 118,264 ticks), each held to the goldens, and prints no
result line.

``--recurrent`` runs only the build of ``flash_attention`` and phase 9,
and prints no result line.

``--serve`` runs only the 16-submission trace of the reference's serve
smoke (``benchmarks/run_serve.py --smoke``, carried here) through the
port's ``FleetService``: every checksum at its golden and at least one
migration, park and recovery, with the wall; it prints no result line.

``--walk-times [--src DIR]`` runs only the pagewalk timings of phases 3
and 5 for the ``repro_torch`` under ``DIR`` (default: this checkout's
``src``), so a parent commit unpacked beside this one can be timed in
turns with it inside one call; it prints no result line.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
HEXT_COMPARE_TICKS = 512           # (a) graph vs eager
HEXT_RATE_TICKS = 2048             # (a) each graph's rate
HEXT_IPS = (1, 8, 32)              # graph ticks per replay, each measured
HEXT_SNAPSHOT_AT = 12288           # (b) mid-run snapshot of the matrix
HEXT_MAX_TICKS = 30000             # susan guest needs 25,363
HEXT_PREEMPT_MAX_TICKS = 4096      # (c) the short column needs <= 3,069
HEXT_CHUNK = 1024                  # one all(done) read per 1024 ticks
HEXT_PROFILE_TICKS = 64
# (d) the torture corpus: the reference's fixed seed and count; the floor
# of coverage buckets is the reference's committed baseline
TORTURE_COUNT = 256
TORTURE_CONTROL_CASES = 7          # the mutation control: cases 0..6, fuzz
TORTURE_REPLAY_CASE = 7            # a sched-family case, replayed by --case
# (e) guest operations and (f) the service: the reference tests' shapes
GUEST_TIMESLICE = 300
SERVE_SLICE_TICKS = 2048
SERVE_CHUNK = 512

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
# and a ragged S at hd = 120; then, for the tensor-core kernel (bf16), hd =
# 20 (element loads), a window edge inside a key tile with a ragged last
# tile, and G = 1 at hd = 120; then RecurrentGemma's head layout at HDP 256
# (hd 256, KV 1, G 16) at a ragged S with a window edge inside a 32-key
# tile, hd 250 (element loads at HDP 256) and hd 256 on the SIMT kernel.
# fp32 shapes run the SIMT kernel.
FLASH_SHAPES = ((1, 64, 2, 1, 16, 0, "float32"),
                (2, 128, 4, 2, 32, 0, "float32"),
                (1, 128, 4, 4, 32, 32, "float32"),
                (2, 256, 8, 2, 64, 0, "bfloat16"),
                (1, 100, 8, 2, 120, 32, "float32"),
                (1, 100, 8, 2, 120, 32, "bfloat16"),
                (2, 150, 4, 2, 20, 40, "bfloat16"),
                (1, 257, 4, 1, 128, 64, "bfloat16"),
                (1, 200, 4, 4, 120, 0, "bfloat16"),
                (1, 203, 16, 1, 256, 50, "bfloat16"),
                (2, 77, 4, 2, 250, 0, "bfloat16"),
                (1, 100, 16, 1, 256, 40, "float32"))
# the fp32 (SIMT) route is timed once, at this test shape
FLASH_FP32_TIMED = (1, 100, 8, 2, 120, 32)
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

# moe: Qwen3-30B-A3B (src/repro/configs/qwen3_moe_30b_a3b.py) and
# Granite-MoE-3B-A800M (src/repro/configs/granite_moe_3b_a800m.py) at full
# width and depth, seeded bf16 weights: (arch, B, S, decode steps)
MOE_RUNS = (("qwen3_moe_30b_a3b", 4, 8192, 16),
            ("granite_moe_3b_a800m", 4, 4096, 8))
MOE_REPEATED_ROW = 3               # one token repeated: capacity overflows
MOE_ROUTE_TOKENS = 1024            # tokens of each routing check

# recurrent: RecurrentGemma-9B (src/repro/configs/recurrentgemma_9b.py),
# Mamba2-130M, Whisper-base and InternVL2-2B at full width and depth, seeded
# bf16 weights: (arch, B, text tokens, decode steps, frontend embeddings:
# whisper's encoder frames or InternVL2's prepended patches).  8192 is a
# multiple of RecurrentGemma's 2048 window (ROADMAP R6); InternVL2's 256
# patches + 7936 tokens make S = 8192; Whisper's decoder prompt is 448
# tokens over 1500 frames.  Each prefill launches the flash kernel once an
# attention layer: 12 (R, R, A x 12, then R, R), 0, 6 (the decoder's; the
# encoder and cross attention go through attention_core) and 24.
REC_RUNS = (("recurrentgemma_9b", 4, 8192, 16, 0),
            ("mamba2_130m", 4, 8192, 16, 0),
            ("whisper_base", 4, 448, 16, 1500),
            ("internvl2_2b", 4, 7936, 16, 256))
REC_FLASH_LAUNCHES = {"recurrentgemma_9b": 12, "mamba2_130m": 0,
                      "whisper_base": 6, "internvl2_2b": 24}
# the RG-LRU scan and the SSD (fp32) against their sequential recurrence on
# the card, by max |error| / max |value| (the CPU tests' fp32 tolerance)
SCAN_TOL = 1e-4
SSD_RAGGED_S = 8100                # 126 chunks of 64 + 36: zero-dt padding
FP32_PEAK_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores

# train: MiniCPM-2B (src/repro/configs/minicpm_2b.py), the config the
# reference's launch/train.py docstring trains.  Gates (a), (b), (d) at
# full width with depth cut to 2 layers (~405 M parameters), batch 2 x 128
# of SyntheticLMData, the schedule launch/train picks (WSD: scale_depth)
TRAIN_ARCH = "minicpm_2b"
TRAIN_CUT_LAYERS = 2
TRAIN_GATE_B, TRAIN_GATE_S, TRAIN_GATE_STEPS = 2, 128, 3
# (e) full width and depth: 8 steps of 4 x 1024 tokens through
# launch/train.main, lr 3e-4, WSD, remat "dots" (the config's default)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 1024, 8, 3e-4
# (a) card against the port's CPU path from one seeded fp32 state.  The
# loss tolerance must stay below what its control moves the loss by (the
# last label of each of the 2 rows ignored: 2.915e-4 relative on this
# batch), so it is 1e-4 (the card read 3.835e-5); grad norms 1e-4 (read
# 7.743e-6); each parameter's 3-step update by relative norm 5e-2 (read
# 3.932e-2: Adam's first steps are ~±lr by the sign of each gradient
# element, and bf16 GEMMs summed in another order flip the sign of a few
# near-zero ones).  Readings on an H100 80GB HBM3 at 700 W
TRAIN_LOSS_TOL = 1e-4
TRAIN_GN_TOL = 1e-4
TRAIN_UPDATE_TOL = 5e-2
# (b) microbatches 2 against 1 on the same batch (read 6.9e-8 / 5.2e-7;
# the control, gradients not divided by M, reads 1.0)
MICRO_LOSS_TOL = 1e-5
MICRO_GN_TOL = 1e-4
# the train phase's (e) numbers, for the mesh phase to print beside its own
TRAIN_PLAIN = {}

# mesh: the mesh half (runtime/sharding placements, the DTensor train
# step with grad_shardings, restore onto shardings, launch/dryrun) on a
# world-size-1 nccl group (a HashStore) and make_host_mesh(), and the dry
# run on the fake process group in subprocesses.  (a) at the train phase's
# gate size; (b) at (e)'s cell through launch/train --mesh host
MESH_STEPS = 3
# (c) the dry run's live bytes a device against (b)'s measured peak
MESH_DRY_TOL = 0.20
# (d) production-mesh cells: (arch, shape, multi_pod)
MESH_CELLS = (("minicpm_2b", "train_4k", False),
              ("qwen3_moe_30b_a3b", "decode_32k", False),
              ("h2o_danube_3_4b", "prefill_32k", True))
MESH_DRY_TIMEOUT_S = 600


def phase(name: str, **kv) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list:
    """One line per compiled kernel of nvcc's ``-Xptxas -v`` output: the
    kernel with its template arguments, then its register and spill
    lines."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            m = re.search(r"\d([a-z_]+_kernel)(I.*?E)?E", mangled)
            name = m.group(1) if m else mangled
            if m and m.group(2):
                args = re.findall(r"L[ib](\d+)E", m.group(2))
                dtype = ("bf16" if "bfloat16" in m.group(2) else
                         "float" if m.group(2).startswith("If") else None)
                name += f"<{', '.join(([dtype] if dtype else []) + args)}>"
            continue
        if name and ("registers" in line or "spill" in line):
            text = line.strip().removeprefix("ptxas info    : ")
            out.append(f"{name}: {text}")
    return out


def time_cuda(fn, torch, iters: int = 50, warmup: int = 5,
              flush=None, spin: int = 2_000_000) -> float:
    """Median milliseconds of ``fn`` by CUDA events, one event pair per
    call; ``flush`` (untimed) runs before each call.  A device spin of
    ``spin`` cycles (~1 ms by default) is queued ahead of each start
    event, so the pair times the device work and not the host's launch
    latency, as long as the host queues ``fn`` within the spin."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def walk_bytes(torch, tables, coords, fused=None, coord_bytes=None) -> int:
    """Bytes a two-stage walk of these queries (flat vectors tenant, req,
    page, want_write) must move: ``coord_bytes`` of coordinates in (13 B a
    query where each is a vector of its own), 9 B of results out a query,
    each stage-1 entry it touches in both tables (and in both fused
    tables), and each stage-2 entry touched by a query that passes stage
    1 and is not answered by the fused cache."""
    from repro_torch.indexing import gather_index
    from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref

    vs = tables[0]
    n_t, n_r, n_p = vs.shape
    n_g = tables[2].shape[1]
    t, r, p = (gather_index(x, n) for x, n in zip(coords[:3],
                                                   (n_t, n_r, n_p)))
    flat1 = (t * n_r + r) * n_p + p
    need2 = two_stage_translate_ref(*tables, *coords)[2] != 1
    if fused is not None:
        need2 &= ~fused[1].reshape(-1)[flat1]
    tp = gather_index(vs.reshape(-1)[flat1].long().clamp(min=0), n_g)
    n1 = int(torch.unique(flat1).numel())
    n2 = int(torch.unique((t * n_g + tp)[need2]).numel())
    b = flat1.numel()
    if coord_bytes is None:
        coord_bytes = b * (3 * 4 + 1)
    return (coord_bytes + b * (4 + 1 + 4) +
            n1 * (2 * 4 + (4 + 1 if fused is not None else 0)) + n2 * 4)


def plan_walk(torch, dev, tables, plan, fused):
    """``pagewalk.ops.translate``'s own walk for ``plan``: the kernel's
    arguments, the bytes it must move, and the flat coordinates (for the
    byte count and the plain version)."""
    from repro_torch.kernels.pagewalk.ref import read_coord

    args = (*tables, *plan.coords, plan.outer, plan.inner, *fused)
    flat = [read_coord(c, plan.outer, plan.inner, dev) for c in plan.coords]
    flat = [x.to(torch.int32) for x in flat[:3]] + [flat[3].to(torch.bool)]
    coord_bytes = sum(
        (plan.outer if c.s_outer else 1) * (plan.inner if c.s_inner else 1) *
        c.tensor.element_size() for c in plan.coords if c.tensor is not None)
    return args, walk_bytes(torch, tables, flat, fused, coord_bytes)


# aten ops that allocate or make a view and launch nothing on the card
# (``aten::to`` of a tensor already on the card with its dtype is one; a
# ``to`` that copies has ``_to_copy``/``copy_`` below it, which are not)
LAUNCH_FREE_OPS = frozenset({
    "aten::empty", "aten::empty_strided", "aten::view", "aten::reshape",
    "aten::_reshape_alias", "aten::expand", "aten::as_strided", "aten::to",
    "aten::alias", "aten::detach"})


def call_ops(torch, fns: dict) -> dict:
    """For each call in ``fns`` (label -> callable), what it issues, from
    one ``torch.profiler`` trace on the card:

    * ``launching_ops``: every aten op under the call's
      ``record_function`` span (nested ops included) that is not in
      ``LAUNCH_FREE_OPS`` — a kernel, a copy or a scalar made into a
      tensor.  These are CPU-side events, which need no CUPTI (the CUDA
      runtime calls under the span are CUPTI's, and are not read);
    * where the trace holds device events (``traced``), the CUDA kernels
      and host-to-device copies between the device spin
      (``torch.cuda._sleep``, a ``spin_kernel``) queued before the call
      and the next one (the span's own annotation on the device's
      timeline is not one).

    The trace is taken up to five times, until it holds device events
    with one spin before each call and one after the last: CUPTI now and
    then drops a device event from a trace (a spin went missing in one
    run on the H100), and a trace with a spin missing cannot be split
    into calls.  Each call's checks are made on a whole trace only.
    """
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            for k, fn in enumerate(fns.values()):
                torch.cuda._sleep(1000)
                with torch.profiler.record_function(f"smoke_call_{k}"):
                    fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not e.name.startswith("smoke_call_")),
                        key=lambda e: e.time_range.start)
        spins = sum("spin_kernel" in e.name for e in events)
        if events and spins == len(fns) + 1:
            break
        phase("vmem", call_ops_retrace=f"{len(events)} device events, "
              f"{spins} spins for {len(fns)} calls")
    spans = {e.name: e for e in prof.events()
             if e.name.startswith("smoke_call_") and
             e.device_type == torch.autograd.DeviceType.CPU}

    def launching(e):
        out = []
        for c in e.cpu_children:
            if c.name.startswith("aten::") and c.name not in LAUNCH_FREE_OPS:
                out.append(c.name)
            out += launching(c)
        return out

    calls, names = [], None
    for e in events:
        if "spin_kernel" in e.name:
            if names is not None:
                calls.append(names)
            names = []
        elif names is not None:
            names.append(e.name)
    if events and len(calls) != len(fns):
        raise RuntimeError(f"call_ops: {len(calls)} spans between spins "
                           f"for {len(fns)} calls")
    out = {}
    for k, label in enumerate(fns):
        if f"smoke_call_{k}" not in spans:
            raise RuntimeError(f"call_ops: no CPU span for {label}")
        names = calls[k] if events else []
        copies = [n for n in names if n.startswith(("Memcpy", "Memset"))]
        out[label] = {
            "launching_ops": sorted(set(launching(spans[f"smoke_call_{k}"]))),
            "traced": bool(events),
            "kernels": len(names) - len(copies),
            "h2d_copies": sum(n.startswith("Memcpy HtoD") for n in copies),
            "other_copies": sum(not n.startswith("Memcpy HtoD")
                                for n in copies),
            "names": sorted({n[:40] for n in names if n not in copies})}
    return out


def sweep_inputs(torch, np, dev):
    """The pagewalk phase's seeded tables, its queries at each of
    ``PAGEWALK_BATCHES`` (the last one every page of every request once,
    shuffled) and the generator, to draw more from."""
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

    return tables, {b: queries(b) for b in PAGEWALK_BATCHES}, rng


def sweep_times(torch, dev, tables, big):
    """The walk at the table sweep (``big``: every page of every request
    once, shuffled; B = 262,144), CUDA-event medians with L2 flushed
    before every call, beside its byte bound, then its decomposition with
    no new CUDA code: the fixed cost of a one-element kernel; a ``copy_``
    that moves the same coordinate and result bytes (half read, half
    written: a yardstick the port never calls); the walk on the same
    pages in table order; the walk with L2 warm.  Returns the shuffled
    walk's (kernel, plain version, bound) in ms."""
    from repro_torch.kernels.pagewalk import kernel as K
    from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref

    n_r, n_p = tables[0].shape[1:]
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    k_ms = time_cuda(lambda: K.two_stage_translate_kernel(*tables, *big),
                     torch, flush=flush)
    k_warm_ms = time_cuda(lambda: K.two_stage_translate_kernel(*tables, *big),
                          torch)
    plain_ms = time_cuda(lambda: two_stage_translate_ref(*tables, *big),
                         torch, flush=flush)
    nbytes = walk_bytes(torch, tables, big)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    b = big[0].numel()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    phase("pagewalk", B=b, kernel_us=f"{k_ms * 1e3:.2f}",
          kernel_warm_l2_us=f"{k_warm_ms * 1e3:.2f}",
          plain_us=f"{plain_ms * 1e3:.2f}", bytes=nbytes,
          bound_us=f"{bound_ms * 1e3:.3f}",
          grid=K.grid_size(b, n_sms) if hasattr(K, "grid_size") else None)

    one = torch.zeros(1, device=dev)
    fixed_ms = time_cuda(lambda: one.add_(1), torch, flush=flush)
    src = torch.empty(b * (3 * 4 + 1 + 4 + 1 + 4) // 2, dtype=torch.uint8,
                      device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_cuda(lambda: dst.copy_(src), torch, flush=flush)
    flat = torch.arange(b, device=dev)
    ordered = [x.to(torch.int32) for x in
               (flat // (n_r * n_p), (flat // n_p) % n_r, flat % n_p)] + [
        big[3]]
    for x, y in zip(K.two_stage_translate_kernel(*tables, *ordered),
                    two_stage_translate_ref(*tables, *ordered)):
        if not torch.equal(x, y):
            raise RuntimeError("pagewalk in table order differs from the "
                               "plain version")
    ordered_ms = time_cuda(
        lambda: K.two_stage_translate_kernel(*tables, *ordered), torch,
        flush=flush)
    phase("pagewalk", decomposition=f"B={b}",
          one_element_kernel_us=f"{fixed_ms * 1e3:.2f}",
          copy_same_bytes_us=f"{copy_ms * 1e3:.2f}",
          copy_bytes=2 * src.numel(),
          table_order_us=f"{ordered_ms * 1e3:.2f}",
          shuffled_us=f"{k_ms * 1e3:.2f}",
          warm_l2_shuffled_us=f"{k_warm_ms * 1e3:.2f}")
    return k_ms, plain_ms, bound_ms


def pagewalk_phase(torch, np, dev) -> dict:
    from repro_torch.kernels.pagewalk import kernel as K
    from repro_torch.kernels.pagewalk import ops
    from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref

    tables, qs, rng = sweep_inputs(torch, np, dev)
    big = qs[T * R * P]
    n = PAGEWALK_OUT_OF_RANGE
    wild = [rng.integers(-2 * d, 2 * d, n).astype(np.int32)
            for d in (T, R, P)]
    for c, v in zip(wild, (-1, 0, -1)):
        c[0] = v
    qs["out-of-range"] = [torch.as_tensor(x, device=dev) for x in wild] + [
        torch.as_tensor(rng.integers(0, 2, n).astype(bool), device=dev)]

    # bases 4 bytes (coordinates) and 1 byte (want_write) past an aligned
    # one, and a ragged tail: the kernel's scalar path
    qs["unaligned"] = [x[1:] for x in big]

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

    phase("pagewalk", own_path_launches=launches)
    k_ms, plain_ms, bound_ms = sweep_times(torch, dev, tables, big)
    return {"name": "pagewalk", "route": "cuda",
            "source": "src/repro_torch/csrc/pagewalk.cu",
            "replaces": "src/repro/kernels/pagewalk/kernel.py:53",
            "launches": launches, "max_abs_err": max_err, "ms": k_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


def hext_golden() -> dict:
    return json.loads((ROOT / "benchmarks/results/hext_runs.json")
                      .read_text())


def hext_check(report: dict, golden: dict) -> None:
    """Every ``HEXT_FIELDS`` field of every hart equals ``hext_runs.json``
    (a label ``w+w/Nguest-preempt`` reads workload w's column)."""
    for label, entry in report.items():
        name, column = label.split("/")
        want = golden["workloads"][name.split("+")[0]][column]
        bad = {f: (entry[f], want[f]) for f in HEXT_FIELDS
               if entry[f] != want[f]}
        if bad:
            raise RuntimeError(f"hext {label}: counters differ from "
                               f"hext_runs.json (got, want): {bad}")


def hext_rates(report: dict, wall: float) -> dict:
    lockstep = max(e["ticks"] for e in report.values())
    hart_ticks = sum(e["ticks"] for e in report.values())
    return {"harts": len(report), "wall_s": f"{wall:.3f}",
            "lockstep_ticks": lockstep,
            "lockstep_ticks_per_s": f"{lockstep / wall:.1f}",
            "hart_ticks_per_s": f"{hart_ticks / wall:.1f}"}


def hext_state_diff(a, b) -> dict:
    """{hart: diff} of two batched states, every hart, memory included."""
    from repro_torch.core.hext.engine import diff_arrays
    na, nb = a.to_numpy(), b.to_numpy()
    diffs = {i: diff_arrays(na, i, nb, i) for i in range(a.batch)}
    return {i: d for i, d in diffs.items() if d}


def hext_run(torch, fleet, ticks: int, chunk: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet.run(ticks, chunk=chunk)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def hext_profiled(torch, fleet, ticks: int) -> dict:
    """Kernels a tick and the device's idle share over one chunk of
    ``ticks`` under ``torch.profiler``: 1 - the union of the kernels'
    intervals over the span from the first kernel's start to the last
    one's end.  The tracer widens the gaps between a graph's kernels, so
    the idle share is also given against the wall of the same chunk run
    unprofiled just before (``idle_vs_unprofiled_wall``), after a first
    chunk that captures the fleet's graph."""
    hext_run(torch, fleet, ticks, ticks)
    wall = hext_run(torch, fleet, ticks, ticks)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        hext_run(torch, fleet, ticks, ticks)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"profiled_ticks": ticks,
           "unprofiled_ms_per_tick": f"{wall * 1e3 / ticks:.3f}"}
    if not kernels:
        return {**out, "device_idle_share": "not measured"}
    span = (max(k.time_range.end for k in kernels) -
            min(k.time_range.start for k in kernels))
    busy = busy_us(kernels)
    return {**out, "kernels_per_tick": f"{len(kernels) / ticks:.1f}",
            "device_busy_ms_per_tick": f"{busy / ticks / 1e3:.3f}",
            "device_idle_share_profiled": f"{1 - busy / span:.4f}",
            "idle_vs_unprofiled_wall": f"{1 - busy / 1e6 / wall:.4f}"}


def hext_phase(torch, dev) -> None:
    """(a) graph vs eager, (b) the 9 x {native, guest} matrix through a
    snapshot and restore, (c) the five short 1guest-preempt runs."""
    from repro_torch.core.hext import engine, programs
    from repro_torch.core.hext.sim import Fleet
    from repro_torch.kernels.pagewalk import kernel as K

    golden = hext_golden()
    by_name = {w.name: w for w in programs.WORKLOADS}
    short = [by_name[n] for n in HEXT_WORKLOADS]

    # (a) the eager engine (host gates) and the graph engine (device
    # gates, one CUDA graph) from one boot, whole state compared
    def boot_short(eng):
        return Fleet.boot(short * 2, guest=[False] * 5 + [True] * 5,
                          device=dev, engine=eng)

    eager = boot_short("eager")
    eager_s = hext_run(torch, eager, HEXT_COMPARE_TICKS, HEXT_COMPARE_TICKS)
    eager_rate = HEXT_COMPARE_TICKS / eager_s
    for ips in HEXT_IPS:
        eng = engine.GraphEngine(instrs_per_step=ips)
        graph = boot_short(eng)
        first_s = hext_run(torch, graph, HEXT_COMPARE_TICKS,
                           HEXT_COMPARE_TICKS)
        bad = hext_state_diff(graph.harts, eager.harts)
        if bad:
            raise RuntimeError(f"hext: graph (ips {ips}) and eager engines "
                               f"differ after {HEXT_COMPARE_TICKS} ticks: "
                               f"{bad}")
        # the rate, on the captured graph, over a longer window
        rate_s = hext_run(torch, boot_short(eng), HEXT_RATE_TICKS,
                          HEXT_RATE_TICKS)
        phase("hext", check=f"graph ips {ips} vs eager, "
              f"{HEXT_COMPARE_TICKS} ticks, 10 harts", equal=True,
              capture_s=f"{eng.last_capture_s:.3f}",
              first_run_s=f"{first_s:.3f}",
              graph_ticks_per_s=f"{HEXT_RATE_TICKS / rate_s:.1f}",
              eager_ticks_per_s=f"{eager_rate:.1f}")

    # (b) the paper's matrix on the default engine, snapshot mid-run
    wls = programs.WORKLOADS
    n = len(wls)

    def boot_matrix():
        return Fleet.boot(wls * 2, guest=[False] * n + [True] * n,
                          device=dev)

    fleet = boot_matrix()
    if fleet.engine.name != "graph":
        raise RuntimeError(f"hext: a CUDA fleet's default engine is "
                           f"{fleet.engine.name!r}, not 'graph'")
    # no kernel of the port lies on this path; the count is read around
    # it all the same
    K.two_stage_translate_kernel.launches = 0
    run1_s = hext_run(torch, fleet, HEXT_SNAPSHOT_AT, HEXT_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = fleet.snapshot(Path(tmp) / "matrix.npz")
        restored = Fleet.restore(path, device=dev)
        torch.cuda.synchronize()
        ckpt_s = time.perf_counter() - t0
        profiled = Fleet.restore(path, device=dev)
    bad = hext_state_diff(restored.harts, fleet.harts)
    if bad or restored.engine.name != "graph" or \
            restored.harts.device != dev:
        raise RuntimeError(f"hext: the restored matrix differs from the "
                           f"saved one: {bad} (engine "
                           f"{restored.engine.name})")
    phase("hext", snapshot_at=HEXT_SNAPSHOT_AT, harts=len(restored),
          restored_equal=True, engine=restored.engine.name,
          snapshot_and_restore_s=f"{ckpt_s:.3f}")
    del fleet
    run2_s = hext_run(torch, restored, HEXT_MAX_TICKS, HEXT_CHUNK)
    phase("hext", path_kernel_launches=K.two_stage_translate_kernel.launches)
    report = restored.report()
    hext_check(report, golden)
    phase("hext", matrix="9 x {native, guest}", all_counters_match=True,
          engine=restored.engine.name,
          capture_s=f"{restored.engine.last_capture_s:.3f}",
          run_before_snapshot_s=f"{run1_s:.3f}",
          run_after_restore_s=f"{run2_s:.3f}",
          **hext_rates(report, run1_s + run2_s))
    phase("hext", matrix="profiled chunk after the restore",
          **hext_profiled(torch, profiled, HEXT_PROFILE_TICKS))
    del restored, profiled

    # (c) the five short workloads' 1guest-preempt column
    pre = Fleet.boot(short, guests_per_hart=1,
                     timeslice=golden["timeslice"], device=dev)
    wall = hext_run(torch, pre, HEXT_PREEMPT_MAX_TICKS, HEXT_CHUNK)
    report = pre.report()
    hext_check(report, golden)
    phase("hext", column="1guest-preempt", workloads="+".join(HEXT_WORKLOADS),
          all_counters_match=True, engine=pre.engine.name,
          **hext_rates(report, wall))


def hext_matrix(torch, dev) -> None:
    """``--hext-matrix``: the columns the default run leaves out — the
    long four's 1guest-preempt column and the 2guest-preempt and
    4guest-preempt columns of all nine — each held to ``hext_runs.json``
    with its wall."""
    from repro_torch.core.hext import programs
    from repro_torch.core.hext.sim import Fleet

    golden = hext_golden()
    long4 = [w for w in programs.WORKLOADS if w.name not in HEXT_WORKLOADS]
    for n, wls in ((1, long4), (2, programs.WORKLOADS),
                   (4, programs.WORKLOADS)):
        fleet = Fleet.boot(wls, guests_per_hart=n,
                           timeslice=golden["timeslice"], device=dev)
        want = max(golden["workloads"][w.name][f"{n}guest-preempt"]["ticks"]
                   for w in wls)
        wall = hext_run(torch, fleet, want, HEXT_CHUNK)
        report = fleet.report()
        hext_check(report, golden)
        phase("hext-matrix", column=f"{n}guest-preempt",
              workloads="+".join(w.name for w in wls),
              all_counters_match=True, engine=fleet.engine.name,
              **hext_rates(report, wall))


def torture_phase(torch, dev) -> None:
    """(d) the fixed-seed 256-scenario corpus, per family one
    ``from_corpus`` boot on the graph engine and on ``OracleEngine``,
    every hart diffed; the coverage floor; a mutation control that must be
    reported with a repro line that re-runs it; ``--case 7 -v``."""
    from repro_torch.core.hext import engine, torture

    floor = json.loads((ROOT / "benchmarks/results/"
                        "torture_coverage_baseline.json").read_text())
    eng = engine.GraphEngine()
    rep = torture.run_corpus(SEED, TORTURE_COUNT, device=dev, engine=eng)
    for family, f in rep["families"].items():
        phase("torture", family=family, harts=f["harts"],
              mem_words=f["mem_words"], ticks=f["ticks"],
              engine=f["engine"], capture_s=f"{f['capture_s']:.3f}",
              machine_wall_s=f"{f['wall_machine']:.3f}",
              oracle_wall_s=f"{f['wall_oracle']:.3f}")
    buckets = rep["coverage"]["buckets"]
    phase("torture", scenarios=TORTURE_COUNT,
          mismatches=len(rep["failures"]), coverage_buckets=buckets,
          baseline_buckets=floor["buckets"],
          machine_wall_s=f"{rep['wall_machine']:.3f}",
          oracle_wall_s=f"{rep['wall_oracle']:.3f}",
          machine_scenarios_per_s=f"{rep['scenarios_per_sec_batched']:.2f}",
          capture_s=f"{rep['capture_s']:.3f}", graphs=eng.n_graphs)
    if rep["failures"]:
        for f in rep["failures"][:8]:
            print(f"  case {f['case']} ({f['mode']}): {f['diff'][:4]}\n"
                  f"    repro: {f['repro']}", flush=True)
        raise RuntimeError(f"torture: {len(rep['failures'])} mismatches "
                           f"between the graph engine and the oracle")
    if buckets < floor["buckets"]:
        raise RuntimeError(f"torture: {buckets} coverage buckets, below "
                           f"the baseline's {floor['buckets']}")
    if eng.n_graphs != 2:
        raise RuntimeError(f"torture: {eng.n_graphs} graphs captured for "
                           f"the two families")

    # the control: the same path with one leaf of one hart's machine state
    # changed must be reported, and its repro line must re-run the case
    class Mutated:
        name = "graph+x7"

        def run(self, state, max_ticks, chunk=4096):
            out = eng.run(state, max_ticks, chunk)
            regs = out.regs.clone()
            regs[-1, 7] ^= 0xDEAD
            return out.replace(regs=regs)

    ctl = torture.run_corpus(SEED, TORTURE_CONTROL_CASES, device=dev,
                             engine=Mutated())
    last = TORTURE_CONTROL_CASES - 1
    caught = [f["case"] for f in ctl["failures"]]
    if caught != [last] or not ctl["failures"][0]["diff"][0].startswith(
            "x7:"):
        raise RuntimeError(f"torture: the mutated x7 of case {last} was "
                           f"not reported alone: {ctl['failures']}")
    line = ctl["failures"][0]["repro"]
    args = line.split(" -m repro_torch.core.hext.torture ")[1].split()
    with contextlib.redirect_stdout(sys.stderr):
        rc_fault = torture.main(args + ["--inject-fault", "x7"])
        t0 = time.perf_counter()
        rc_case = torture.main(["--seed", str(SEED), "--case",
                                str(TORTURE_REPLAY_CASE), "-v"])
        case_s = time.perf_counter() - t0
    if rc_fault != 1 or rc_case != 0:
        raise RuntimeError(f"torture: the repro line {line!r} with an "
                           f"injected fault exited {rc_fault} (want 1); "
                           f"--case {TORTURE_REPLAY_CASE} exited {rc_case} "
                           f"(want 0)")
    phase("torture", control=f"x7 of case {last} mutated", caught=True,
          repro=repr(line), repro_with_fault_rc=rc_fault,
          case=TORTURE_REPLAY_CASE, case_rc=rc_case,
          case_wall_s=f"{case_s:.3f}")


def guest_phase(torch, dev) -> None:
    """(e) a 2-hart N=2 fleet of short workloads: a migration mid run, a
    park to a file and a resume into a free slot, every hart to its
    golden; then ``replace_hart`` of one lane with a fresh boot, run to
    its golden with no new graph captured."""
    from repro_torch.core.hext import programs
    from repro_torch.core.hext.sim import (Fleet, HartSpec, HartState,
                                           MigrationError)

    by = {w.name: w for w in programs.WORKLOADS}
    sha, crc, ss, fft = (by[n] for n in ("sha", "crc32", "stringsearch",
                                         "fft"))
    t_start = time.perf_counter()
    fleet = Fleet.boot([(sha, crc), (ss, fft)], guests_per_hart=2,
                       timeslice=GUEST_TIMESLICE, device=dev)
    eng = fleet.engine

    def retry(op):
        for attempt in range(12):
            try:
                return op(), attempt
            except MigrationError:
                fleet.run(GUEST_TIMESLICE, chunk=GUEST_TIMESLICE)
        raise RuntimeError("guest: the guest never became movable")

    fleet.run(1000, chunk=500)
    _, m_tries = retry(lambda: fleet.migrate_guest(0, 1, guest=1))
    with tempfile.TemporaryDirectory() as tmp:
        _, p_tries = retry(lambda: fleet.park_guest(1, 1,
                                                    Path(tmp) / "g.npz"))
        _, r_tries = retry(lambda: fleet.resume_guest(
            0, Path(tmp) / "g.npz"))
    fleet.run(30000, chunk=HEXT_CHUNK)
    rep = fleet.report()
    want = {"sha+crc32/2guest-preempt": [True, True],
            "stringsearch+parked/2guest-preempt": [True, None]}
    got = {k: v["ok_guests"] for k, v in rep.items()}
    if got != want or not all(v["ok"] and v["done"] for v in rep.values()):
        raise RuntimeError(f"guest: after migrate, park and resume the "
                           f"report is {rep}")
    graphs = eng.n_graphs
    ops_s = time.perf_counter() - t_start
    phase("guest", migrate_retries=m_tries, park_retries=p_tries,
          resume_retries=r_tries, all_goldens=True,
          lockstep_ticks=max(v["ticks"] for v in rep.values()),
          engine=eng.name, wall_s=f"{ops_s:.3f}")

    t0 = time.perf_counter()
    fleet.replace_hart(1, HartState.boot_preemptive(
        fft, sha, timeslice=GUEST_TIMESLICE, device=dev),
        HartSpec(fft, True, "fft+sha", guests=(fft, sha),
                 timeslice=GUEST_TIMESLICE))
    fleet.run(30000, chunk=HEXT_CHUNK)
    entry = fleet.report()["fft+sha/2guest-preempt"]
    if not entry["ok"] or entry["ok_guests"] != [True, True]:
        raise RuntimeError(f"guest: the replaced lane ended {entry}")
    if fleet.engine is not eng or eng.n_graphs != graphs:
        raise RuntimeError(f"guest: replace_hart captured a new graph "
                           f"({graphs} -> {eng.n_graphs})")
    phase("guest", replace_hart="lane 1 <- fft+sha", golden=True,
          graphs=eng.n_graphs, new_graphs=0,
          wall_s=f"{time.perf_counter() - t0:.3f}")


def service_phase(torch, dev) -> None:
    """(f) the reference's daemon-vs-direct cohort: fft, sha, crc32 and
    stringsearch at N=2 and a native sha and a guest fft on solo lanes;
    every counter field equal to a direct boot of the same groups."""
    from repro_torch.core.hext import programs
    from repro_torch.core.hext.policies import BinPackPolicy
    from repro_torch.core.hext.service import FleetService
    from repro_torch.core.hext.sim import Fleet, HartState

    by = {w.name: w for w in programs.WORKLOADS}
    with tempfile.TemporaryDirectory() as tmp:
        svc = FleetService(n_harts=2, guests_per_hart=2, n_solo=2,
                           timeslice=GUEST_TIMESLICE,
                           slice_ticks=SERVE_SLICE_TICKS, chunk=SERVE_CHUNK,
                           snapshot_dir=tmp, device=dev,
                           policy=BinPackPolicy(partial_after=0))
        vm = [svc.submit(by[n], tenant=t) for t, n in
              enumerate(("fft", "sha", "crc32", "stringsearch"))]
        nat = svc.submit(by["sha"], tenant=8, mode="native")
        gst = svc.submit(by["fft"], tenant=9, mode="guest")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.step()
        placed = {(svc.job(i).lane, svc.job(i).slot): svc.job(i).workload
                  for i in vm}
        groups = [tuple(placed[(lane, s)] for s in range(2))
                  for lane in (0, 1)]
        solo_order = [svc.job(nat).lane, svc.job(gst).lane]
        ok = svc.drain(200)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        if not ok or svc.stats["completed"] != 6:
            raise RuntimeError(f"service: drain ok={ok}, {svc.stats}")
        states = [HartState.boot_preemptive(*g, timeslice=GUEST_TIMESLICE,
                                            device=dev) for g in groups]
        states += [HartState.boot(by["sha"], device=dev),
                   HartState.boot(by["fft"], guest=True, device=dev)]
        direct = Fleet.from_states(states)
        t0 = time.perf_counter()
        while not direct.all_done:
            direct.run(SERVE_SLICE_TICKS, chunk=SERVE_CHUNK)
        direct_s = time.perf_counter() - t0
        want = direct.harts.counters
        pod, solo = svc._pod.harts.counters, svc._solo.harts.counters
        idx = torch.tensor(solo_order, device=dev)
        bad = [k for k in (f.name for f in dataclasses.fields(want))
               if not torch.equal(getattr(pod, k), getattr(want, k)[:2])
               or not torch.equal(getattr(solo, k)[idx],
                                  getattr(want, k)[2:])]
        if bad:
            raise RuntimeError(f"service: counters differ from a direct "
                               f"boot in {bad}")
        phase("service", jobs=6, all_counters_equal_direct=True,
              slices=svc.slices, drain_wall_s=f"{drain_s:.3f}",
              direct_wall_s=f"{direct_s:.3f}",
              engines=f"{svc._pod.engine.name}/{svc._solo.engine.name}",
              pod_graphs=svc._pod.engine.n_graphs,
              solo_graphs=svc._solo.engine.n_graphs)


# the 16-submission trace of the reference's serve smoke: a full N=3 cohort
# of long guests at slice 0, a long 4th tenant at slice 2 (a partial cohort:
# the shed window), a burst of short jobs at slice 6 (queue pressure: an
# eviction), one native solo job, and a hart failure at slice 10 (recovery)
SERVE_NAMES = (("susan", "dijkstra", "bitcount", "qsort", "sha", "crc32",
                "stringsearch", "fft", "sha", "crc32", "stringsearch", "fft",
                "sha", "crc32", "basicmath"))
SERVE_ARRIVALS = (0, 0, 0, 2) + (6,) * 11
SERVE_FAIL_AT = 10


def serve_smoke(torch, dev) -> None:
    """``--serve``: the 16-submission trace through the port's service;
    every checksum at its golden, at least one migration, park and
    recovery, and the wall."""
    from repro_torch.core.hext import programs
    from repro_torch.core.hext.policies import BinPackPolicy
    from repro_torch.core.hext.service import DONE, FleetService

    by = {w.name: w for w in programs.WORKLOADS}
    picks = [(by[n], t % 8, "vm") for t, n in enumerate(SERVE_NAMES)]
    picks.append((by["dijkstra"], 7, "native"))
    arrivals = SERVE_ARRIVALS + (6,)
    with tempfile.TemporaryDirectory() as tmp:
        svc = FleetService(
            n_harts=2, guests_per_hart=3, n_solo=1,
            timeslice=GUEST_TIMESLICE, slice_ticks=SERVE_SLICE_TICKS,
            chunk=SERVE_CHUNK, snapshot_every=3, fail_after=2,
            snapshot_dir=tmp, device=dev,
            policy=BinPackPolicy(max_queue=16, partial_after=1,
                                 shed_margin=2))
        k, failed = 0, False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while k < len(arrivals) or any(not j.terminal for j in svc.jobs()):
            while k < len(arrivals) and arrivals[k] <= svc.slices:
                wl, tenant, mode = picks[k]
                svc.submit(wl, tenant=tenant, mode=mode)
                k += 1
            if not failed and svc.slices >= SERVE_FAIL_AT:
                lanes = [i for i, l in enumerate(svc._pod_lanes) if l.active]
                if lanes:
                    svc.inject_hart_failure(lanes[-1], pool="pod")
                    failed = True
            svc.step()
            if svc.slices >= 2000:
                raise RuntimeError("serve: the trace did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    done = [j for j in svc.jobs() if j.state == DONE]
    checks = {
        "all_goldens_ok": len(done) == 16 and all(j.ok for j in done),
        "shed_happened": svc.stats["migrations"] >= 1,
        "park_happened": svc.stats["parks"] >= 1,
        "recovery_happened": svc.stats["recoveries"] >= 1,
    }
    m = svc.metrics()
    phase("serve", submissions=16, wall_s=f"{wall:.3f}", slices=m["slices"],
          ticks=m["ticks"], guests_per_s=f"{len(done) / wall:.3f}",
          **checks, **{k: m[k] for k in ("migrations", "parks", "resumes",
                                         "recoveries", "balloons")},
          pod_graphs=svc._pod.engine.n_graphs,
          solo_graphs=svc._solo.engine.n_graphs)
    if not all(checks.values()):
        raise RuntimeError(f"serve: checks failed: {checks}")


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


def mapped_cache(torch, np, dev):
    """The vmem phase's cache, its 8 x 16 requests mapped by
    ``ensure_mapped`` below each seeded length + 1 (the control plane,
    ``pagewalk`` under ``translate``): (kv, lengths, tenant_of, req_of,
    rng)."""
    from repro_torch.core.vmem import kvcache as KC
    from repro_torch.kernels.pagewalk import kernel as PWK

    B = VM_TENANTS * VM_REQS
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, VM_PAGES * VM_PAGE, B)        # [1, 4095]
    tenant_of = [b // VM_REQS for b in range(B)]
    req_of = [b % VM_REQS for b in range(B)]
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
    return kv, lengths, tenant_of, req_of, rng


def consumer_walks(torch, dev, kv, lengths, tenant_of, req_of):
    """The walk at its consumers' shapes on the vmem tables, L2 flushed,
    each beside its byte bound and held bit-exact against its plain
    version: one request's 256 pages (the longest request:
    ``translate_block``'s call) and the batched decode's [B, 1] x [1,
    pages] coordinates.  Each shape is walked by
    ``two_stage_translate_kernel`` on the coordinates materialised as
    vectors (what a tree before ``translate_kernel`` launched, its
    ``translate`` selecting the fused cache in torch), and, where the tree
    has it, by ``translate_kernel`` on ``translate``'s own plan with the
    fused cache (what its ``translate`` launches; also held against the
    whole call's answer).  Then the whole ``translate_block`` call and
    the whole ``translate`` of ``ensure_mapped`` (Python ints, no fused
    cache): device time from one event pair (a ~10 ms spin ahead of it,
    so the host has queued the call), host time a call (the mean of 200
    calls ended by one synchronise), the walks it launches and what it
    issues (``call_ops``).  Returns (kernel, plain version, bound) in ms
    of the walk the tree's ``translate`` launches at ``translate_block``'s
    shape, and each whole call's counts."""
    from repro_torch.core.vmem import page_table as PT
    from repro_torch.kernels.pagewalk import kernel as PWK
    from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref

    scratch = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    tb = kv.tables
    tabs = (tb.vs_table, tb.vs_perm, tb.g_table)
    lb = int(lengths.argmax())
    t_b, r_b = tenant_of[lb], req_of[lb]
    cols = torch.arange(VM_PAGES, dtype=torch.int32, device=dev)
    tt = torch.as_tensor(tenant_of, dtype=torch.int32, device=dev)[:, None]
    rr = torch.as_tensor(req_of, dtype=torch.int32, device=dev)[:, None]
    shapes = {"translate_block": ((t_b, r_b, range(VM_PAGES)),
                                  PT.translate_block(tb, t_b, r_b, VM_PAGES)),
              "batched decode": ((tt, rr, cols[None, :]),
                                 PT.translate(tb, tt, rr, cols[None, :]))}
    times = {}
    for label, (coords, whole) in shapes.items():
        flat = [torch.as_tensor(x, dtype=torch.int32, device=dev)
                .expand(whole.slot.shape).reshape(-1).contiguous()
                if not isinstance(x, range) else cols for x in coords]
        flat.append(torch.zeros_like(flat[0], dtype=torch.bool))
        walks = {"two_stage_translate_kernel on materialised vectors": (
            lambda f=flat: PWK.two_stage_translate_kernel(*tabs, *f),
            lambda f=flat: two_stage_translate_ref(*tabs, *f),
            walk_bytes(torch, tabs, flat))}
        if hasattr(PWK, "translate_kernel"):
            from repro_torch.kernels.pagewalk import ops as PWO
            from repro_torch.kernels.pagewalk.ref import translate_ref

            plan = PWO.plan_coords(*coords, False, dev)
            args, nbytes = plan_walk(torch, dev, tabs, plan,
                                     (tb.fused, tb.fused_ok))
            walks[f"translate_kernel {plan.outer}x{plan.inner} fused"] = (
                lambda: PWK.translate_kernel(*args),
                lambda: translate_ref(*args), nbytes)
            for x, y, z in zip(PWK.translate_kernel(*args),
                               translate_ref(*args), whole):
                if not (torch.equal(x, y) and torch.equal(x, z.reshape(-1))):
                    raise RuntimeError(f"pagewalk at {label}'s plan differs "
                                       f"from its plain version or from "
                                       f"the whole call")
        for walk, (fn, plain, nbytes) in walks.items():
            if not all(torch.equal(x, y) for x, y in zip(fn(), plain())):
                raise RuntimeError(f"{walk} at {label} differs from its "
                                   f"plain version")
            k_ms = time_cuda(fn, torch, flush=flush)
            plain_ms = time_cuda(plain, torch, flush=flush)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            phase("vmem", pagewalk_shape=label, B=whole.slot.numel(),
                  walk=walk, kernel_us=f"{k_ms * 1e3:.2f}",
                  plain_us=f"{plain_ms * 1e3:.2f}", bytes=nbytes,
                  bound_us=f"{bound_ms * 1e3:.3f}")
        # the last one is the walk this tree's translate launches
        times[label] = (k_ms, plain_ms, bound_ms)

    calls = {"translate_block": lambda: PT.translate_block(
                 tb, t_b, r_b, VM_PAGES),
             "ensure_mapped translate": lambda: PT.translate(
                 tb, t_b, r_b, 3, use_fused=False)}
    ops_by_call = call_ops(torch, calls)
    for label, fn in calls.items():
        before = PWK.two_stage_translate_kernel.launches
        fn()
        torch.cuda.synchronize()
        ops = ops_by_call[label]
        ops["walks"] = PWK.two_stage_translate_kernel.launches - before
        c_ms = time_cuda(fn, torch, flush=flush, spin=20_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        phase("vmem", call=label, device_us=f"{c_ms * 1e3:.2f}",
              host_us=f"{host_us:.1f}", walks=ops["walks"],
              launching_ops="|".join(ops["launching_ops"]) or None,
              traced=ops["traced"], cuda_kernels=ops["kernels"],
              h2d_copies=ops["h2d_copies"], other_copies=ops["other_copies"],
              kernel_names="|".join(ops["names"]))
    return times["translate_block"], ops_by_call


def vmem_phase(torch, np, dev) -> list:
    from repro_torch.core.vmem import allocator as AL
    from repro_torch.core.vmem import kvcache as KC
    from repro_torch.core.vmem import page_table as PT
    from repro_torch.kernels.paged_attention import kernel as PAK
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.pagewalk import kernel as PWK
    from repro_torch.kernels.pagewalk import ops as PWO
    from repro_torch.kernels.pagewalk.ref import (translate_ref,
                                                  two_stage_translate_ref)

    B = VM_TENANTS * VM_REQS
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kv, lengths, tenant_of, req_of, rng = mapped_cache(torch, np, dev)

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

    path_times, ops_by_call = consumer_walks(torch, dev, kv, lengths,
                                             tenant_of, req_of)
    # each translate call is one walk, issues no aten op that launches a
    # kernel or copies (CPU-side events), and, where the profiler sees the
    # card, one CUDA kernel and no host-to-device copy
    for label, ops in ops_by_call.items():
        if ops["walks"] != 1 or ops["launching_ops"] or (ops["traced"] and (
                ops["kernels"] != 1 or ops["h2d_copies"] != 0)):
            raise RuntimeError(f"{label} on the card is not one launch: "
                               f"{ops}")

    # the fused entry (translate's whole function) against its plain
    # version on the same arguments at the decode path's coordinates
    # ([B, 1] x [1, pages]: stride-0 coordinates), on the path's fused
    # cache (filled by ensure_mapped below each length) and on a seeded
    # one over a random half of the entries
    plan = PWO.plan_coords(tt, rr, cols[None, :], False, dev)
    tabs = (kv.tables.vs_table, kv.tables.vs_perm, kv.tables.g_table)
    fused_seeded = (
        torch.randint(-1, VM_SLOTS, kv.tables.fused.shape, generator=gen,
                      device=dev, dtype=torch.int32),
        torch.rand(kv.tables.fused.shape, generator=gen, device=dev) < 0.5)
    for label, fz in (("path", (kv.tables.fused, kv.tables.fused_ok)),
                      ("seeded half", fused_seeded)):
        args = (*tabs, *plan.coords, plan.outer, plan.inner, *fz)
        before = PWK.two_stage_translate_kernel.launches
        got = PWK.translate_kernel(*args)
        want = translate_ref(*args)
        if PWK.two_stage_translate_kernel.launches != before + 1 or not all(
                torch.equal(x, y) for x, y in zip(got, want)):
            raise RuntimeError(f"the fused entry ({label} cache) differs "
                               f"from its plain version")
        phase("vmem", fused_entry=label, outer=plan.outer, inner=plan.inner,
              strides=[c[2:] for c in plan.coords],
              hits=int(fz[1].sum()), bit_exact=True)
    lens = torch.as_tensor(lengths + 1, dtype=torch.int32, device=dev)
    got = pa_ops.paged_attention(q, kv.k_pool, kv.v_pool, page_map, lens,
                                 scale, device=dev)
    # the split count follows B (choose_splits), so the batched call and
    # the per-request calls add the same terms in another order
    path_outs = torch.stack(outs)
    vs_path = close(got, path_outs, BF16_TOL,
                    "batched decode vs the per-request path")
    vs_path_rel = row_rel_err(got, path_outs, BF16_ROW_REL_TOL,
                              "batched decode vs the per-request path")

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
    phase("vmem", batched_B=B, slots="shared",
          vs_path_max_abs_err=f"{vs_path:.3e}",
          vs_path_max_row_rel_err=f"{vs_path_rel:.3e}",
          n_splits=PAK.choose_splits(B, VM_KV, VM_PAGE, VM_PAGES, n_sms),
          kernel_us=f"{k_ms * 1e3:.2f}",
          kernel_warm_l2_us=f"{k_warm_ms * 1e3:.2f}",
          plain_us=f"{plain_ms * 1e3:.2f}", bytes=nbytes,
          bound_us=f"{bound_ms * 1e3:.3f}", distinct_kv_rows=distinct_rows,
          request_kv_rows=request_rows)
    phase("vmem", batched_B=B, slots="own",
          kernel_us=f"{own_k_ms * 1e3:.2f}",
          plain_us=f"{own_plain_ms * 1e3:.2f}", bytes=own_bytes,
          bound_us=f"{own_bound_ms * 1e3:.3f}", kv_rows=request_rows)

    # the path's own call shape: B = 1, the longest request, held against
    # the path's output for it before it is timed
    lb = int(torch.argmax(lens))
    one = (q[lb:lb + 1], kv.k_pool, kv.v_pool, page_map[lb:lb + 1],
           lens[lb:lb + 1], scale)
    got1 = PAK.paged_attention_kernel(*one, unmapped_reads_zero=1)
    if not torch.equal(got1[0], outs[lb]):
        raise RuntimeError("the B = 1 call differs from the path's call")
    one_ms = time_cuda(lambda: PAK.paged_attention_kernel(
        *one, unmapped_reads_zero=1), torch, flush=flush)
    one_bytes = (2 * int(lens[lb]) * row_bytes + 2 * VM_H * VM_HD * 2 +
                 int(n_read[lb]) * 4 + 4)
    one_bound_ms = one_bytes / HBM_BYTES_PER_S * 1e3
    phase("vmem", path_call_shape="B=1, the longest request",
          length=int(lens[lb]),
          n_splits=PAK.choose_splits(1, VM_KV, VM_PAGE, VM_PAGES, n_sms),
          kernel_us=f"{one_ms * 1e3:.2f}", bytes=one_bytes,
          bound_us=f"{one_bound_ms * 1e3:.3f}")

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

    return [pw_launches, path_times, {
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
        route = ("tensor cores" if dtype == torch.bfloat16 else "SIMT")
        phase("model", flash_shape=shape, route=route,
              max_abs_err=f"{err:.3e}", tol=tol)
        if (B, S, H, KV, hd, window) == FLASH_FP32_TIMED:
            # each dtype's kernel once at this shape, after its check
            ms = time_cuda(lambda: FAK.flash_attention_kernel(
                q, k, v, hd ** -0.5, window), torch)
            phase("model", flash_shape=shape, route=route,
                  kernel_us=f"{ms * 1e3:.2f}")
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
def patched(module, name, fn):
    """Inside the block, ``module.name`` is ``fn``."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def prefill_attention(fn):
    """Inside the block, ``attn_prefill`` attends through ``fn(q, k, v,
    scale, window)`` in place of ``ops.flash_attention``."""
    from repro_torch.models import attention as AT

    return patched(AT, "flash_attention", fn)


def teed_flash(torch, FAK, ref):
    """An attention for ``attn_prefill`` that launches the kernel, holds
    its output against the plain version (one KV head at a time) on the
    same q, k, v, and passes the kernel's output on; ``.errs`` keeps each
    call's (max abs, max row relative, [control's max row relative])
    error.  The control is the kernel one key short, which the row
    tolerance must see: with a window, the window one key short; without
    one, each query's own key dropped (``own_key_dropped``)."""
    def attend(q, k, v, scale, window):
        got = FAK.flash_attention_kernel(q, k, v, scale, window)
        short = (FAK.flash_attention_kernel(q, k, v, scale, window - 1)
                 if window else own_key_dropped(FAK, got, q, k, v, scale))
        attend.errs.append(check_by_kv_head(
            torch, ref, got, q, k, v, scale, window,
            f"flash_attention, layer {len(attend.errs)}", controls=(short,)))
        return got
    attend.errs = []
    return attend


def own_key_dropped(FAK, got, q, k, v, scale):
    """Causal attention with each query's own key dropped: query s > 0
    sees keys 0..s-1 (the kernel on q[:, 1:] against k, v[:, :-1]; RoPE
    is already in q and k), query 0 keeps ``got``'s row."""
    short = got.clone()
    short[:, 1:] = FAK.flash_attention_kernel(
        q[:, 1:].contiguous(), k[:, :-1].contiguous(),
        v[:, :-1].contiguous(), scale, 0)
    return short


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


def device_busy(torch, step, top_n=6):
    """(device busy ms, profiled step ms, top kernels) of one ``step()``
    under ``torch.profiler``: the union of its kernels' device intervals,
    the step's host wall (launch to synchronise) under the profiler, and
    the ``top_n`` kernels with the most device time as (name, launches,
    µs).
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
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    return (busy_us(kernels) / 1e3, wall_us / 1e3,
            [(name[:60], n, round(us, 1)) for name, (n, us) in top])


def rel_rows(torch, got, want) -> float:
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def serve(torch, dev, cfg, lm, TF, prompts, counts, steps=LM_STEPS,
          extra=None):
    """The path: one prefill of the prompts, then ``steps`` greedy decode
    steps; every kernel count is set to 0 just before the prefill and the
    launches of the prefill and of the decode steps are read after each.
    ``extra`` are the frontend's embeddings (``prefill``'s
    ``extra_embeds``): a VLM's F patches come before the text, so decode
    starts at position F + S.  The cache holds F + S + steps positions (a
    window slab: the window)."""
    B, S = prompts.shape
    F = extra_positions(cfg, extra)
    cache = TF.init_cache(cfg, B, F + S + steps, device=dev)
    torch.cuda.synchronize()
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    logits, cache = TF.prefill(lm, cfg, prompts, cache, extra)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    at_prefill = [c.launches for c in counts]
    tokens, step_ms = [], []
    pos = torch.full((B,), F + S, dtype=torch.int32, device=dev)
    for _ in range(steps):
        nxt = logits.float().argmax(dim=-1)
        tokens.append(nxt)
        t0 = time.perf_counter()
        logits, cache = TF.decode_step(lm, cfg, nxt, pos, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        pos = pos + 1
        if logits.shape != (B, cfg.padded_vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise RuntimeError("decode_step: bad logits")
    return (prefill_s, at_prefill, [c.launches for c in counts],
            torch.stack(tokens, dim=1), step_ms, cache, pos, logits)


def extra_positions(cfg, extra) -> int:
    """Positions a frontend's embeddings take before the text: a VLM's
    patches do, an encoder's frames do not."""
    return 0 if extra is None or cfg.is_enc_dec else extra.shape[1]


def decode_check(torch, dev, cfg, lm, TF, one, name, attend=None,
                 held=None) -> float:
    """Decode at position S (``one`` is [1, S+1] tokens) on the cache of a
    prefill of the first S, against a fresh (S+1)-token prefill, by logit
    row norm within DECODE_TOL; its control, the same token decoded one
    position too far on the prefill's own cache, must exceed it.  The
    caches hold S + 2 positions (a window slab: the window).  ``attend``,
    if given, attends the first prefill (``prefill_attention``).

    An MoE model passes ``held``, a ``HeldDecode``: the fresh prefill
    records its last token's attention outputs and routing (the check
    stands only if it dropped none of its assignments, since decode never
    drops), both decodes take the prefill's routing of each layer, and
    decode on its own routing is printed beside them.  Its gate's control
    is the attention output of layer 0, where both sides have the same
    input: decode's within BF16_ROW_REL_TOL of the prefill's last row by
    row norm, the control's above it (the logits' control is printed:
    q/k-normed attention over 8192 keys is diffuse, and one position
    moves the logits by about the rounding).  Returns the error."""
    S = one.shape[1] - 1
    with held.record() if held else contextlib.nullcontext():
        fresh, _ = TF.prefill(lm, cfg, one,
                              TF.init_cache(cfg, 1, S + 2, device=dev))
    cache = TF.init_cache(cfg, 1, S + 2, device=dev)
    with prefill_attention(attend) if attend else contextlib.nullcontext():
        _, cache = TF.prefill(lm, cfg, one[:, :S], cache)
    saved = [{n: x.clone() for n, x in layer.items()} for layer in cache]
    at = torch.full((1,), S, dtype=torch.int32, device=dev)
    with held.replay() if held else contextlib.nullcontext():
        dec, _ = TF.decode_step(lm, cfg, one[:, S], at, cache)
    if held:
        held_line, attn = held.summary(), held.attn_errs()
    # control: the same token decoded one position too far, on the
    # prefill's own cache
    with held.replay() if held else contextlib.nullcontext():
        off, _ = TF.decode_step(lm, cfg, one[:, S], at + 1, saved)
    # the vocabulary's padding columns (-1e30) are left out
    V = cfg.vocab_size
    if held:
        attn_ctrl = held.attn_errs()
        # decode on its own routing (it rewrites the row at S first)
        own, _ = TF.decode_step(lm, cfg, one[:, S], at, cache)
        own_err = rel_rows(torch, own[..., :V], fresh[..., :V])
        phase(name, **held_line,
              own_routing_logits_row_rel_err=f"{own_err:.3e}")
    del cache, saved
    dec, off, fresh = (x[..., :V] for x in (dec, off, fresh))
    dvp = rel_rows(torch, dec, fresh)
    ctrl = rel_rows(torch, off, fresh)
    phase(name, check=f"decode at {S} vs a fresh {S + 1}-token "
          f"prefill, B=1", logits_row_rel_err=f"{dvp:.3e}", tol=DECODE_TOL,
          top1_agree=bool((dec.float().argmax(-1) ==
                           fresh.float().argmax(-1)).all()))
    phase(name, decode_control=f"decode at {S + 1} vs the fresh "
          f"prefill", logits_row_rel_err=f"{ctrl:.3e}",
          must_exceed=DECODE_TOL if not held else "no (printed)")
    if not dvp <= DECODE_TOL:
        raise RuntimeError(f"decode differs from prefill: {dvp:.3e} > "
                           f"{DECODE_TOL}")
    if held:
        phase(name, check="decode's attention output vs the prefill's last "
              "row, layer 0", row_rel_err=f"{attn[0]:.3e}",
              tol=BF16_ROW_REL_TOL, control_row_rel_err=f"{attn_ctrl[0]:.3e}",
              must_exceed=BF16_ROW_REL_TOL,
              deeper_layers_max=f"{max(attn[1:], default=0.0):.3e}",
              deeper_layers_control_min=f"{min(attn_ctrl[1:], default=0):.3e}")
        if not attn[0] <= BF16_ROW_REL_TOL:
            raise RuntimeError(f"decode's attention differs from the "
                               f"prefill's at layer 0: {attn[0]:.3e}")
        if not attn_ctrl[0] > BF16_ROW_REL_TOL:
            raise RuntimeError(f"the attention check cannot see a position "
                               f"off by one: {attn_ctrl[0]:.3e}")
    elif not ctrl > DECODE_TOL:
        raise RuntimeError(f"the decode check cannot see a position off by "
                           f"one: {ctrl:.3e} <= {DECODE_TOL}")
    return dvp


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
    busy_ms, prof_ms, top = device_busy(
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

    decode_check(torch, dev, cfg, lm, TF, one, "model")
    del lm

    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
            "launches": launches,
            "max_abs_err": max(test_err, kernel["max_abs_err"], layer_err),
            "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
            "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
            "library_ms": kernel["library_ms"]}


# ---------------------------------------------------------------------------
# moe: the MoE serving path (Qwen3-30B-A3B, Granite-MoE-3B-A800M)
# ---------------------------------------------------------------------------

class DispatchCounts:
    """Inside ``with``, a tee of ``moe.dispatch`` (the capacity ranks of
    every MoE call) that counts on the card: dropped assignments of each
    group (a batch row) summed over the calls, the dropped assignments of
    each group's last token, and the kept assignments of each expert."""

    def __init__(self, torch, MOE, E, dev):
        self.MOE, self.saved = MOE, MOE.dispatch
        self.per_expert = torch.zeros(E, dtype=torch.long, device=dev)
        self.drops = self.last_drops = 0

    def __call__(self, experts, E, C):
        rank, keep = self.saved(experts, E, C)
        drop = (~keep).long()
        self.drops = self.drops + drop.sum(-1)
        self.last_drops = self.last_drops + drop[:, -experts.shape[-1]:] \
            .sum(-1)
        self.per_expert.scatter_add_(0, experts.reshape(-1),
                                     keep.reshape(-1).long())
        return rank, keep

    def __enter__(self):
        self.MOE.dispatch = self
        return self

    def __exit__(self, *exc):
        self.MOE.dispatch = self.saved


class HeldDecode:
    """Decode against prefill on an MoE model.  Top-k routing is a step
    function of the block's normed input h2, and decode's h2 differs from
    the prefill's by rounding (its attention keeps P in bf16, the flash
    kernel in fp32), so a near-tied pick can flip and the difference
    cascades through the later layers.  ``record()`` wraps the fresh
    prefill: each layer keeps its last token's attention output, h2 and
    routing, and the dropped assignments of that token are counted (they
    must be 0: decode never drops).  ``replay()`` wraps a decode step:
    its MoE call of layer i takes the prefill's routing of layer i in
    place of its own (counting the layers where its own h2 picks another
    expert set, and the largest difference of its h2 from the
    prefill's), and its attention outputs are kept.  (Routing on
    identical inputs is held bit for bit by ``moe_route_checks``.)"""

    def __init__(self, torch, MOE, E, dev):
        from repro_torch.models import attention as AT

        self.torch, self.MOE, self.AT = torch, MOE, AT
        self.counter = DispatchCounts(torch, MOE, E, dev)
        self.last, self.attn = [], []

    @contextlib.contextmanager
    def record(self):
        route, attend = self.MOE._route, self.AT.attn_prefill

        def keep(p, cfg, x):
            gates, experts, aux = route(p, cfg, x)
            self.last.append((x[:, -1:].clone(), gates[:, -1:].clone(),
                              experts[:, -1:].clone()))
            return gates, experts, aux

        def keep_attn(p, cfg, x, positions):
            y, kv = attend(p, cfg, x, positions)
            self.attn.append(y[:, -1:].clone())
            return y, kv

        with self.counter, patched(self.MOE, "_route", keep), \
                patched(self.AT, "attn_prefill", keep_attn):
            yield
        last = int(self.counter.last_drops.sum())
        if last:
            raise RuntimeError(f"the decode check cannot stand: the fresh "
                               f"prefill dropped {last} assignments of its "
                               f"last token, which decode never drops")

    @contextlib.contextmanager
    def replay(self):
        torch, route, calls = self.torch, self.MOE._route, iter(self.last)
        attend = self.AT.attn_decode
        self.flips, self.h2_rel, self.attn_out = [], 0.0, []

        def as_prefill(p, cfg, x):
            xp, gp, ep = next(calls)
            _, own, aux = route(p, cfg, x)
            self.flips.append(not torch.equal(own.sort(-1).values,
                                              ep.sort(-1).values))
            self.h2_rel = max(self.h2_rel, float(
                (x.float() - xp.float()).norm() / xp.float().norm()))
            return gp, ep, aux

        def keep_attn(*args):
            y, ck, cv = attend(*args)
            self.attn_out.append(y)
            return y, ck, cv

        with patched(self.MOE, "_route", as_prefill), \
                patched(self.AT, "attn_decode", keep_attn):
            yield

    def attn_errs(self) -> list:
        """Row relative error of the last replay's attention output of
        each layer against the prefill's last row."""
        return [rel_rows(self.torch, got, want)
                for got, want in zip(self.attn_out, self.attn, strict=True)]

    def summary(self) -> dict:
        return dict(fresh_prefill_last_token_dropped_assignments=0,
                    decode_takes_prefill_routing_layers=len(self.flips),
                    own_h2_other_expert_set_layers=sum(self.flips),
                    max_h2_row_rel_diff=f"{self.h2_rel:.3e}")


def kept_inputs(MOE, layers, n):
    """A tee of ``moe.apply_moe`` for ``patched``: the first ``n`` tokens of
    every row of the input (the block's normed h2) of the calls whose
    index is in ``layers`` (the layers of one forward), in ``.kept``."""
    def tee(p, cfg, x, n_groups=0):
        if tee.calls in layers:
            tee.kept[tee.calls] = x[:, :n].clone()
        tee.calls += 1
        return tee.apply(p, cfg, x, n_groups)
    tee.apply, tee.calls, tee.kept = MOE.apply_moe, 0, {}
    return tee


def moe_row_err(torch, got, want) -> float:
    """Max over token rows of ||got - want|| / ||want||; a row that is zero
    in ``want`` (every assignment of its token dropped) counts 0 if it is
    zero in ``got`` too, else inf."""
    g, w = got.float(), want.float()
    num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
    inf = torch.full_like(num, float("inf"))
    return float(torch.where(den > 0, num / den.clamp_min(1e-30),
                             torch.where(num > 0, inf, 0 * num)).max())


def moe_route_checks(torch, MOE, cfg, lm, kept) -> float:
    """On each kept layer's h2 (B = 1: the repeated row and a random row,
    MOE_ROUTE_TOKENS tokens each): the card's routing against the CPU's
    routing of the card's fp32 logits (experts, gates, ranks, keep set:
    bit-equal), the card's output against the same function on the CPU on
    that routing (2e-2 by element, 1e-2 by row), two card runs bit-equal,
    and, on the repeated row, the control: the card with capacity C - 1,
    which the row tolerance must see.  Returns the max abs error."""
    E, k = MOE._padded_experts(cfg), cfg.moe.top_k
    C = MOE.capacity(cfg, MOE_ROUTE_TOKENS)
    worst = 0.0
    for layer, h2 in sorted(kept.items()):
        p = lm.layers[layer].moe
        p_cpu = MOE.MoE(cfg, device="cpu")
        p_cpu.load_state_dict(p.state_dict())
        for row, name in ((MOE_REPEATED_ROW, "repeated"), (0, "random")):
            x = h2[row:row + 1]
            logits = MOE.router_logits(p, cfg, x)
            gates, experts, _ = MOE.route_logits(cfg, logits, x.dtype)
            rank, keep = MOE.dispatch(experts, E, C)
            g0, e0, _ = MOE.route_logits(cfg, logits.cpu(), x.dtype)
            r0, k0 = MOE.dispatch(e0, E, C)
            same = [torch.equal(a.cpu(), b) for a, b in
                    ((experts, e0), (gates, g0), (rank, r0), (keep, k0))]
            y1, _ = MOE.apply_moe(p, cfg, x)
            y2, _ = MOE.apply_moe(p, cfg, x)
            want = MOE._gather_moe(p_cpu, cfg, x.cpu(), g0, e0)
            what = f"moe layer {layer}, {name} row"
            if not all(same):
                raise RuntimeError(f"{what}: the card's routing differs from "
                                   f"the CPU's on the same logits (experts, "
                                   f"gates, ranks, keep: {same})")
            if not torch.equal(y1, y2):
                raise RuntimeError(f"{what}: two runs on the card differ")
            err = close(y1.cpu(), want, BF16_TOL, what)
            rel = moe_row_err(torch, y1.cpu(), want)
            if not rel <= BF16_ROW_REL_TOL:
                raise RuntimeError(f"{what}: row relative error {rel:.3e} "
                                   f"above {BF16_ROW_REL_TOL}")
            worst = max(worst, err)
            line = dict(layer=layer, row=name, tokens=MOE_ROUTE_TOKENS,
                        capacity=C, dropped=int((~k0).sum()),
                        routing_bit_equal=True, two_runs_bit_equal=True,
                        max_abs_err=f"{err:.3e}", tol=BF16_TOL,
                        max_row_rel_err=f"{rel:.3e}",
                        row_rel_tol=BF16_ROW_REL_TOL)
            if name == "repeated":
                if not int((~k0).sum()):
                    raise RuntimeError(f"{what}: no assignment overflowed")
                with patched(MOE, "capacity", lambda cfg, T: C - 1):
                    short, _ = MOE.apply_moe(p, cfg, x)
                ctrl = moe_row_err(torch, short.cpu(), want)
                line.update(control="capacity C - 1",
                            control_row_rel_err=f"{ctrl:.3e}")
                if not ctrl > BF16_ROW_REL_TOL:
                    raise RuntimeError(f"{what}: the check cannot see "
                                       f"capacity C - 1: {ctrl:.3e}")
            phase("moe", **line)
        del p_cpu
    return worst


def flash_prefill_times(torch, dev, gen, FAK, ref, flush, shape,
                        name: str) -> dict:
    """The kernel at a prefill shape (B, S, H, KV, hd, window): held
    against its plain version one batch row and KV head at a time, then
    timed beside its bound, SDPA (K/V heads repeated outside the timed
    call; causal: ``is_causal=True``, its fused path; windowed: the window
    as a boolean mask, off its fused path) and, at B = 1, the plain
    version; printed under phase ``name``."""
    B, S, H, KV, hd, window = shape
    G, scale = H // KV, hd ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = flash_inputs(torch, gen, dev, B, S, H, KV, hd, torch.bfloat16)
    got = FAK.flash_attention_kernel(q, k, v, scale, window)
    err = rel = 0.0
    for b in range(B):
        e, r, _ = check_by_kv_head(torch, ref, got[b:b + 1], q[b:b + 1],
                                   k[b:b + 1], v[b:b + 1], scale, window,
                                   f"flash_attention {shape}, row {b}")
        err, rel = max(err, e), max(rel, r)
    iters = 20 if B == 1 else 5
    k_ms = time_cuda(lambda: FAK.flash_attention_kernel(q, k, v, scale,
                                                        window),
                     torch, iters=iters, warmup=2, flush=flush)
    bound_ms, bound_by, flops, nbytes = flash_bound(B, S, H, KV, hd, window,
                                                    2)
    if window:
        pos = torch.arange(S, device=dev)
        kw = dict(attn_mask=(pos[None, :] <= pos[:, None]) &
                  (pos[None, :] > pos[:, None] - window), scale=scale)
    else:
        kw = dict(is_causal=True, scale=scale)
    qh, kh, vh = (x.transpose(1, 2) for x in
                  (q, k.repeat_interleave(G, dim=2),
                   v.repeat_interleave(G, dim=2)))
    lib_err = float((sdpa(qh, kh, vh, **kw).transpose(1, 2).float()
                     - got.float()).abs().max())
    lib_ms = time_cuda(lambda: sdpa(qh, kh, vh, **kw), torch, iters=iters,
                       warmup=2, flush=flush)
    del qh, kh, vh, got, kw
    out = dict(max_abs_err=err, ms=k_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=lib_ms)
    sdpa_key = "sdpa_masked_ms" if window else "sdpa_causal_ms"
    line = dict(flash_shape=shape, vs_plain_max_abs_err=f"{err:.3e}",
                max_row_rel_err=f"{rel:.3e}", kernel_ms=f"{k_ms:.4f}",
                bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, flops=flops,
                bytes=nbytes, kernel_over_bound=f"{k_ms / bound_ms:.2f}",
                **{sdpa_key: f"{lib_ms:.4f}"},
                sdpa_over_kernel=f"{lib_ms / k_ms:.3f}",
                sdpa_vs_kernel_max_abs=f"{lib_err:.3e}")
    if B == 1:
        plain = plain_by_kv_head(torch, ref)
        out["plain_ms"] = time_cuda(lambda: plain(q, k, v, scale, window),
                                    torch, iters=3, warmup=1, flush=flush)
        line["plain_by_kv_head_ms"] = f"{out['plain_ms']:.4f}"
    phase(name, **line)
    return out


def decode_bytes(torch, cfg, lm, cache) -> int:
    """Bytes a decode step must move: every weight the decoder reads once
    (of an untied embedding table, the B rows it gathers; no encoder
    weight), every cache entry read once, and the recurrent states and
    conv windows written once."""
    B = cache[0][next(iter(cache[0]))].shape[0]
    n = sum(p.numel() * p.element_size() for p in lm.parameters())
    if cfg.is_enc_dec:
        n -= sum(p.numel() * p.element_size()
                 for p in lm.encoder.parameters())
    if not cfg.tie_embeddings:
        n -= (lm.embed.shape[0] - B) * lm.embed.shape[1] * \
            lm.embed.element_size()
    for layer in cache:
        for name, x in layer.items():
            n += x.numel() * x.element_size() * (
                2 if name in ("h", "conv") else 1)
    return n


def moe_serve(torch, np, dev, arch, B, S, steps) -> float:
    """One MoE model at full width and depth: seeded bf16 weights built on
    the card, ``prefill`` of B x S prompts (row MOE_REPEATED_ROW one token
    repeated) then ``steps`` greedy decode steps, with every kernel count
    set to 0 just before the prefill and read after (one flash launch a
    layer); the dropped assignments of each row and the tokens of each
    expert (padded experts: none) counted on the card; a second serve for
    the walls, a profiled decode step for the idle share and a profiled
    prefill for its kernels; routing and
    output checks (Qwen3), the kernel against its plain version on every
    layer's q, k, v and decode against prefill at B = 1.  Returns the
    max abs error of the kernel and MoE checks."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FAK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import kernel as PAK
    from repro_torch.kernels.pagewalk import kernel as PWK
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF

    cfg = get_config(arch)
    E = MOE._padded_experts(cfg)
    t0 = time.perf_counter()
    lm = TF.init_lm(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    phase("moe", arch=cfg.name, layers=cfg.n_layers, d=cfg.d_model,
          experts=f"{cfg.moe.n_experts} (padded {E}) top-{cfg.moe.top_k}",
          params=n_params, weight_bytes=sum(p.numel() * p.element_size()
                                            for p in lm.parameters()),
          init_s=f"{init_s:.2f}",
          allocated_gb=f"{torch.cuda.memory_allocated(dev) / 1e9:.2f}")
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)),
                              device=dev)
    prompts[MOE_REPEATED_ROW] = prompts[MOE_REPEATED_ROW, 0]
    counts = (FAK.flash_attention_kernel, PAK.paged_attention_kernel,
              PWK.two_stage_translate_kernel)
    last = cfg.n_layers - 1
    tee = kept_inputs(MOE, {0, last}, MOE_ROUTE_TOKENS)
    torch.cuda.reset_peak_memory_stats(dev)
    with DispatchCounts(torch, MOE, E, dev) as dc, \
            patched(MOE, "apply_moe", tee):
        (prefill_s, at_prefill, at_end, tokens, _, cache, _, _) = serve(
            torch, dev, cfg, lm, TF, prompts[:, :S], counts, steps)
    peak = torch.cuda.max_memory_allocated(dev)
    drops = dc.drops.tolist()
    padded = int(dc.per_expert[cfg.moe.n_experts:].sum())
    phase("moe", path=f"prefill {B} x {S} + {steps} decode steps",
          flash_launches_prefill=at_prefill[0],
          flash_launches_total=at_end[0],
          paged_attention_launches=at_end[1], pagewalk_launches=at_end[2],
          capacity=MOE.capacity(cfg, S),
          dropped_assignments_per_row=drops,
          last_token_dropped_per_row=dc.last_drops.tolist(),
          tokens_to_padded_experts=padded,
          first_prefill_wall_s=f"{prefill_s:.3f}",
          peak_allocated_gb=f"{peak / 1e9:.2f}")
    if at_prefill[0] != cfg.n_layers or at_end[0] != cfg.n_layers:
        raise RuntimeError(f"{arch}: the prefill launched the flash kernel "
                           f"{at_prefill[0]} times (decode: "
                           f"{at_end[0] - at_prefill[0]}), not once per "
                           f"layer")
    if not drops[MOE_REPEATED_ROW] > 0:
        raise RuntimeError(f"{arch}: the repeated row dropped nothing")
    if padded:
        raise RuntimeError(f"{arch}: {padded} assignments reached a padded "
                           f"expert")
    tok = tokens.cpu().numpy()
    phase("moe", greedy_tokens=tok.tolist())
    del cache
    kept = tee.kept

    # steady state: a second serve, then one profiled decode step
    (prefill2_s, _, _, tokens2, step_ms, cache, pos, _) = serve(
        torch, dev, cfg, lm, TF, prompts[:, :S], counts, steps)
    decode_ms = sum(step_ms) / len(step_ms)
    bound_ms = decode_bytes(torch, cfg, lm, cache) / \
        HBM_BYTES_PER_S * 1e3
    nxt = tokens2[:, -1]
    busy_ms, prof_ms, top = device_busy(
        torch, lambda: TF.decode_step(lm, cfg, nxt, pos, cache))
    phase("moe", prefill_wall_s=f"{prefill2_s:.3f}",
          prefill_tok_per_s=f"{B * S / prefill2_s:.0f}",
          decode_steps=len(step_ms), decode_ms_per_step=f"{decode_ms:.3f}",
          decode_ms_median=f"{statistics.median(step_ms):.3f}",
          decode_ms_min_max=f"{min(step_ms):.3f}/{max(step_ms):.3f}",
          decode_bound_ms=f"{bound_ms:.3f}", decode_bound_by="bytes",
          decode_over_bound=f"{decode_ms / bound_ms:.2f}",
          same_tokens_as_first_serve=bool(torch.equal(tokens2, tokens)))
    if busy_ms is None:
        phase("moe", decode_device_idle_share="not measured",
              decode_step_profiled_ms=f"{prof_ms:.3f}")
    else:
        phase("moe", decode_device_busy_ms=f"{busy_ms:.3f}",
              decode_device_idle_share=f"{1.0 - busy_ms / decode_ms:.4f}",
              decode_step_profiled_ms=f"{prof_ms:.3f}",
              idle_share_of_profiled_step=f"{1.0 - busy_ms / prof_ms:.4f}")
    phase("moe", decode_step_top_kernels=top)
    del cache, tokens2
    gc.collect()
    # where the prefill's device time goes: one profiled prefill
    cache = TF.init_cache(cfg, B, S, device=dev)
    busy_ms, prof_ms, top = device_busy(
        torch, lambda: TF.prefill(lm, cfg, prompts[:, :S], cache), top_n=10)
    phase("moe", prefill_device_busy_ms=None if busy_ms is None
          else f"{busy_ms:.1f}", prefill_profiled_s=f"{prof_ms / 1e3:.3f}",
          prefill_top_kernels=top)
    del cache

    # checks at B = 1
    worst = 0.0
    if arch == MOE_RUNS[0][0]:
        worst = moe_route_checks(torch, MOE, cfg, lm, kept)
    del kept
    # decode against prefill (ROADMAP R7): a prefill drops the assignments
    # past capacity, decode (C = 1 for its one token) none, and the seeded
    # models' deep layers route most tokens of a row alike (the path line's
    # drops), so at the configured capacity factor every row's last token
    # drops.  The check runs at capacity factor E_real / k, where C = T and
    # nothing can drop (decode's C stays 1); its first prefill holds the
    # kernel against its plain version on every layer
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    teed = teed_flash(torch, FAK, flash_attention_ref)
    decode_check(torch, dev, nodrop, lm, TF, prompts[:1], "moe", attend=teed,
                 held=HeldDecode(torch, MOE, E, dev))
    if len(teed.errs) != cfg.n_layers:
        raise RuntimeError("the teed prefill did not attend once per layer")
    layer_err = max(e for e, _, _ in teed.errs)
    short_rel = [c[0] for _, _, c in teed.errs]
    phase("moe", route="kernel vs plain flash on each layer's q, k, v",
          layers=len(teed.errs), max_abs_err=f"{layer_err:.3e}",
          tol=BF16_TOL,
          max_row_rel_err=f"{max(r for _, r, _ in teed.errs):.3e}",
          row_rel_tol=BF16_ROW_REL_TOL)
    phase("moe", layer_control="kernel with each query's own key dropped "
          "vs plain flash on each layer's q, k, v",
          max_row_rel_err=f"{max(short_rel):.3e}",
          must_exceed=BF16_ROW_REL_TOL,
          layers_above_tol=sum(r > BF16_ROW_REL_TOL for r in short_rel))
    if not max(short_rel) > BF16_ROW_REL_TOL:
        raise RuntimeError(f"the per-layer check cannot see one key short: "
                           f"{max(short_rel):.3e} <= {BF16_ROW_REL_TOL}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return max(worst, layer_err)


def moe_phase(torch, np, dev) -> dict:
    """The kernel at both models' causal prefill shapes, then each model
    served (``moe_serve``).  Returns the kernel's max abs error."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FAK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase("moe", allocated_at_start_gb=
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    worst = 0.0
    for arch, B, S, _ in MOE_RUNS:
        cfg = get_config(arch)
        shape = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        for b in ((1, B) if arch == MOE_RUNS[0][0] else (B,)):
            out = flash_prefill_times(torch, dev, gen, FAK,
                                      flash_attention_ref, scratch.zero_,
                                      (b, S) + shape + (0,), "moe")
            worst = max(worst, out["max_abs_err"])
    del scratch
    torch.cuda.empty_cache()
    for arch, B, S, steps in MOE_RUNS:
        t1 = time.perf_counter()
        worst = max(worst, moe_serve(torch, np, dev, arch, B, S, steps))
        phase("moe", arch=arch, wall_s=f"{time.perf_counter() - t1:.1f}")
    phase("moe", phase_wall_s=f"{time.perf_counter() - t0:.1f}")
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# recurrent: RG-LRU and SSM blocks, the encoder-decoder and the frontend path
# ---------------------------------------------------------------------------

def prefill_bound(torch, cfg, lm, TF, B, S, F_enc) -> dict:
    """The least time a prefill of B x S positions (an encoder's F_enc
    frames besides) can take at the card's peaks: every weight matrix once
    per row it projects (bf16 on the tensor cores, fp32 ones, the RG-LRU
    gates, on the fp32 units), 4 * hd flops per visible (query, key) pair
    and head, the SSD's chunk products in fp32; the last position
    unembedded."""
    from repro_torch.models import ssm as SSM

    def mats(module, rows):
        n = [0, 0]
        for p in module.parameters():
            if p.ndim >= 2:
                n[p.dtype == torch.float32] += 2 * p.numel() * rows
        return n

    def pairs(S, T, window, causal=True):
        if not causal:
            return S * T
        w = window or S
        return sum(min(q + 1, w) for q in range(S))

    bf16 = fp32 = 0
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    for kind, blk in zip(TF.layer_kinds(cfg), lm.layers):
        b, f = mats(blk, B * S)
        bf16, fp32 = bf16 + b, fp32 + f
        if kind == "attn":
            bf16 += 4 * hd * H * B * pairs(S, S, cfg.window)
        elif kind == "ssm":
            d_inner, Hs, N = SSM.ssm_dims(cfg)
            L, P = cfg.ssm.chunk, cfg.ssm.head_dim
            nc = -(-S // L)
            fp32 += 2 * B * nc * (L * L * N + Hs * L * L * P
                                  + 2 * Hs * P * N * L)
    if cfg.is_enc_dec:
        for blk in lm.encoder.blocks:
            bf16 += mats(blk, B * F_enc)[0] + \
                4 * hd * H * B * pairs(F_enc, F_enc, 0, causal=False)
        for cp in lm.cross:
            bf16 += 2 * cp.attn.wq.numel() * 2 * B * S + \
                2 * cp.attn.wk.numel() * 2 * B * F_enc + \
                4 * hd * H * B * pairs(S, F_enc, 0, causal=False)
    bf16 += 2 * lm.embed.numel() * B
    t_bf16, t_fp32 = bf16 / BF16_PEAK_FLOPS, fp32 / FP32_PEAK_FLOPS
    return dict(bound_s=t_bf16 + t_fp32, bf16_flops=bf16, fp32_flops=fp32)


def mixer_tee(out: list):
    """Inside the block, every layer's mixer (``attn_prefill``,
    ``attn_decode``, ``apply_rglru``, ``apply_ssm``) appends the last row
    of its output to ``out``, in layer order."""
    from repro_torch.models import attention as AT
    from repro_torch.models import rglru as RG
    from repro_torch.models import ssm as SSM

    stack = contextlib.ExitStack()
    for mod, name in ((AT, "attn_prefill"), (AT, "attn_decode"),
                      (RG, "apply_rglru"), (SSM, "apply_ssm")):
        def tee(*args, fn=getattr(mod, name), **kw):
            res = fn(*args, **kw)
            out.append(res[0][:, -1:].clone())
            return res
        stack.enter_context(patched(mod, name, tee))
    return stack


def mixer_decode_check(torch, dev, cfg, lm, TF, one, extra) -> float:
    """Decode at position F + S (``one`` is [1, S+1] tokens, ``extra`` the
    frontend's [1, F, d] or None) on the cache of a prefill of the first
    S, against a fresh prefill of all S + 1: the logits by row norm within
    DECODE_TOL, and each layer's mixer output (attention, RG-LRU or SSM)
    against the fresh prefill's last row.  Gates: at the first layer of
    each kind, where both sides see the same input, decode within
    BF16_ROW_REL_TOL; its control, the decode one position too far (an
    attention layer) or on the state of the first S - 1 tokens (a
    recurrent layer, token S at position S - 1), above it.  The logits'
    controls are printed.  Returns the logits' error."""
    S = one.shape[1] - 1
    T = extra_positions(cfg, extra) + S + 2
    at = torch.full((1,), T - 2, dtype=torch.int32, device=dev)
    fresh_rows, dec_rows, off_rows, short_rows = [], [], [], []
    with mixer_tee(fresh_rows):
        fresh, _ = TF.prefill(lm, cfg, one,
                              TF.init_cache(cfg, 1, T, device=dev), extra)
    cache = TF.init_cache(cfg, 1, T, device=dev)
    _, cache = TF.prefill(lm, cfg, one[:, :S], cache, extra)
    saved = [{n: x.clone() for n, x in layer.items()} for layer in cache]
    with mixer_tee(dec_rows):
        dec, _ = TF.decode_step(lm, cfg, one[:, S], at, cache)
    with mixer_tee(off_rows):
        off, _ = TF.decode_step(lm, cfg, one[:, S], at + 1, saved)
    del cache, saved
    short_cache = TF.init_cache(cfg, 1, T, device=dev)
    _, short_cache = TF.prefill(lm, cfg, one[:, :S - 1], short_cache, extra)
    with mixer_tee(short_rows):
        short, _ = TF.decode_step(lm, cfg, one[:, S], at - 1, short_cache)
    del short_cache
    V = cfg.vocab_size
    dvp, off_err, short_err = (rel_rows(torch, x[..., :V], fresh[..., :V])
                               for x in (dec, off, short))
    phase("recurrent", arch=cfg.name,
          check=f"decode at {T - 2} vs a fresh prefill, B=1",
          logits_row_rel_err=f"{dvp:.3e}", tol=DECODE_TOL,
          top1_agree=bool((dec.float().argmax(-1) ==
                           fresh.float().argmax(-1)).all()),
          control_position_plus_1=f"{off_err:.3e}",
          control_one_token_short=f"{short_err:.3e}")
    if not dvp <= DECODE_TOL:
        raise RuntimeError(f"{cfg.name}: decode differs from prefill: "
                           f"{dvp:.3e} > {DECODE_TOL}")
    kinds = TF.layer_kinds(cfg)
    errs = [rel_rows(torch, d, f) for d, f in zip(dec_rows, fresh_rows,
                                                 strict=True)]
    for kind in sorted(set(kinds)):
        i = kinds.index(kind)
        ctrl_rows, what = ((off_rows, "one position too far")
                           if kind == "attn" else
                           (short_rows, "on the state one token short"))
        ctrl = rel_rows(torch, ctrl_rows[i], fresh_rows[i])
        deeper = [e for e, k in zip(errs, kinds) if k == kind][1:]
        phase("recurrent", arch=cfg.name,
              check=f"decode's {kind} output vs the prefill's last row, "
              f"layer {i}", row_rel_err=f"{errs[i]:.3e}",
              tol=BF16_ROW_REL_TOL, control=what,
              control_row_rel_err=f"{ctrl:.3e}",
              must_exceed=BF16_ROW_REL_TOL,
              deeper_layers_max=f"{max(deeper, default=0.0):.3e}")
        if not errs[i] <= BF16_ROW_REL_TOL:
            raise RuntimeError(f"{cfg.name}: decode's {kind} output differs "
                               f"from the prefill's at layer {i}: "
                               f"{errs[i]:.3e}")
        if not ctrl > BF16_ROW_REL_TOL:
            raise RuntimeError(f"{cfg.name}: the {kind} check cannot see "
                               f"a decode {what}: {ctrl:.3e}")
    return dvp


def sequential_check(torch, got, want, what) -> float:
    """max |got - want| / max |want| within SCAN_TOL, and the control, got
    against ``want`` one step late (got[t] vs want[t - 1]), above it."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    late = float((got[:, 1:] - want[:, :-1]).abs().max()) / scale
    phase("recurrent", check=what, rel_max_err=f"{err:.3e}", tol=SCAN_TOL,
          control="the recurrence one step late",
          control_rel_max_err=f"{late:.3e}", must_exceed=SCAN_TOL)
    if not err <= SCAN_TOL:
        raise RuntimeError(f"{what}: {err:.3e} > {SCAN_TOL}")
    if not late > SCAN_TOL:
        raise RuntimeError(f"{what}: the check cannot see a recurrence one "
                           f"step late: {late:.3e}")
    return err


def first_and_last_call(module, name):
    """A tee of ``module.name`` for ``patched`` that keeps the (args,
    result) of its first call in ``.first`` and of its last in ``.last``."""
    def tee(*args, **kw):
        res = tee.fn(*args, **kw)
        tee.last = (args, res)
        if tee.first is None:
            tee.first = tee.last
        return res
    tee.fn, tee.first, tee.last = getattr(module, name), None, None
    return tee


def rglru_scan_gate(torch, dev, cfg, lm, TF, one):
    """The kernel against its plain version on every attention layer's q,
    k, v (control: the window one key short) and the RG-LRU scan of layer
    0 and of the last layer (a remainder block) against the sequential
    fp32 recurrence over the same a, b on the card (control: the
    recurrence one step late), all in one B = 1 prefill.  Returns the
    kernel's max abs error."""
    from repro_torch.kernels.flash_attention import kernel as FAK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import rglru as RG

    teed = teed_flash(torch, FAK, flash_attention_ref)
    scans = first_and_last_call(RG, "linear_scan")
    with prefill_attention(teed), patched(RG, "linear_scan", scans):
        TF.prefill(lm, cfg, one, TF.init_cache(cfg, 1, one.shape[1],
                                                device=dev))
    n_attn = TF.layer_kinds(cfg).count("attn")
    if len(teed.errs) != n_attn:
        raise RuntimeError("the teed prefill did not attend once an "
                           "attention layer")
    layer_err = max(e for e, _, _ in teed.errs)
    short_rel = [c[0] for _, _, c in teed.errs]
    phase("recurrent", arch=cfg.name,
          route="kernel vs plain flash on each attention layer's q, k, v",
          layers=len(teed.errs), max_abs_err=f"{layer_err:.3e}",
          tol=BF16_TOL,
          max_row_rel_err=f"{max(r for _, r, _ in teed.errs):.3e}",
          row_rel_tol=BF16_ROW_REL_TOL,
          control="window - 1",
          control_max_row_rel_err=f"{max(short_rel):.3e}",
          control_least_layer=f"{min(short_rel):.3e}",
          must_exceed=BF16_ROW_REL_TOL)
    if not min(short_rel) > BF16_ROW_REL_TOL:
        raise RuntimeError(f"the per-layer check cannot see a window one "
                           f"key short: {min(short_rel):.3e}")
    kinds = TF.layer_kinds(cfg)
    rglru_layers = [i for i, k in enumerate(kinds) if k == "rglru"]
    for layer, ((a, b), hs) in zip((rglru_layers[0], rglru_layers[-1]),
                                   (scans.first, scans.last)):
        h, seq = torch.zeros_like(b[:, 0]), torch.empty_like(b)
        for t in range(b.shape[1]):
            h = torch.addcmul(b[:, t], a[:, t], h)
            seq[:, t] = h
        sequential_check(torch, hs, seq, f"{cfg.name} layer {layer} RG-LRU "
                         f"scan vs the sequential recurrence, "
                         f"S={b.shape[1]}")
    return layer_err


def ssd_gate(torch, dev, cfg, lm, TF, one):
    """Layer 0's ``ssd_chunked`` at the ragged S of ``one`` (a prefill at
    B = 1) against ``ssd_decode_step`` run token by token on the card over
    the same inputs: y and the final state (control: y one step late)."""
    from repro_torch.models import ssm as SSM

    calls = first_and_last_call(SSM, "ssd_chunked")
    with patched(SSM, "ssd_chunked", calls):
        TF.prefill(lm, cfg, one, TF.init_cache(cfg, 1, one.shape[1],
                                                device=dev))
    (x, dt, A, Bm, Cm, D, chunk), (y, h_last) = calls.first
    del calls
    h = torch.zeros_like(h_last)
    seq = torch.empty_like(y)
    for t in range(x.shape[1]):
        seq[:, t], h = SSM.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t],
                                           Cm[:, t], D, h)
    S = x.shape[1]
    sequential_check(torch, y, seq, f"{cfg.name} layer 0 ssd_chunked vs "
                     f"ssd_decode_step, S={S} (chunk {chunk}, "
                     f"{-(-S // chunk)} chunks, {(-S) % chunk} padded)")
    err = float((h_last - h).abs().max() / h.abs().max())
    phase("recurrent", check="final state", rel_max_err=f"{err:.3e}",
          tol=SCAN_TOL)
    if not err <= SCAN_TOL:
        raise RuntimeError(f"ssd_chunked's final state: {err:.3e}")


def recurrent_serve(torch, np, dev, arch, B, S, steps, n_extra) -> dict:
    """One model at full width and depth from seeded bf16 weights built on
    the card: ``prefill`` of B x S prompts (with ``n_extra`` seeded
    frontend embeddings: whisper's frames or InternVL2's patches) then
    ``steps`` greedy decode steps, with every kernel count set to 0 just
    before the prefill and read after (REC_FLASH_LAUNCHES); a second serve
    for the walls, a profiled decode step for the idle share; then at
    B = 1 the model's gates and decode against a fresh prefill."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FAK
    from repro_torch.kernels.paged_attention import kernel as PAK
    from repro_torch.kernels.pagewalk import kernel as PWK
    from repro_torch.models import transformer as TF

    cfg = get_config(arch)
    t0 = time.perf_counter()
    lm = TF.init_lm(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kinds = TF.layer_kinds(cfg)
    phase("recurrent", arch=cfg.name, layers=cfg.n_layers,
          kinds="/".join(f"{k}:{kinds.count(k)}" for k in sorted(set(kinds))),
          enc_layers=cfg.n_enc_layers, d=cfg.d_model,
          params=sum(p.numel() for p in lm.parameters()),
          weight_bytes=sum(p.numel() * p.element_size()
                           for p in lm.parameters()),
          init_s=f"{init_s:.2f}",
          allocated_gb=f"{torch.cuda.memory_allocated(dev) / 1e9:.2f}")
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)),
                              device=dev)
    extra = None
    if n_extra:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        extra = torch.randn((B, n_extra, cfg.d_model), generator=gen,
                            device=dev).to(torch.bfloat16)
    counts = (FAK.flash_attention_kernel, PAK.paged_attention_kernel,
              PWK.two_stage_translate_kernel)
    torch.cuda.reset_peak_memory_stats(dev)
    (prefill_s, at_prefill, at_end, tokens, _, cache, _, _) = serve(
        torch, dev, cfg, lm, TF, prompts[:, :S], counts, steps, extra)
    peak = torch.cuda.max_memory_allocated(dev)
    want = REC_FLASH_LAUNCHES[arch]
    F = extra_positions(cfg, extra)
    phase("recurrent", arch=cfg.name,
          path=f"prefill {B} x {F + S}" + (f" ({F} patches + {S} tokens)"
                                           if F else "")
          + (f" over {n_extra} encoder frames" if cfg.is_enc_dec else "")
          + f" + {steps} decode steps",
          flash_launches_prefill=at_prefill[0],
          flash_launches_total=at_end[0], flash_launches_expected=want,
          paged_attention_launches=at_end[1], pagewalk_launches=at_end[2],
          first_prefill_wall_s=f"{prefill_s:.3f}",
          peak_allocated_gb=f"{peak / 1e9:.2f}")
    if not at_prefill[0] == at_end[0] == want == kinds.count("attn"):
        raise RuntimeError(f"{arch}: the prefill launched the flash kernel "
                           f"{at_prefill[0]} times (decode: "
                           f"{at_end[0] - at_prefill[0]}), not {want}")
    phase("recurrent", arch=cfg.name, greedy_tokens=tokens.cpu().tolist())
    del cache

    # steady state: a second serve, then one profiled decode step
    (prefill2_s, _, _, tokens2, step_ms, cache, pos, _) = serve(
        torch, dev, cfg, lm, TF, prompts[:, :S], counts, steps, extra)
    decode_ms = sum(step_ms) / len(step_ms)
    nbytes = decode_bytes(torch, cfg, lm, cache)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pre = prefill_bound(torch, cfg, lm, TF, B, F + S, n_extra)
    nxt = tokens2[:, -1]
    busy_ms, prof_ms, top = device_busy(
        torch, lambda: TF.decode_step(lm, cfg, nxt, pos, cache))
    phase("recurrent", arch=cfg.name, prefill_wall_s=f"{prefill2_s:.3f}",
          prefill_bound_s=f"{pre['bound_s']:.4f}",
          prefill_bf16_flops=pre["bf16_flops"],
          prefill_fp32_flops=pre["fp32_flops"],
          prefill_tok_per_s=f"{B * (F + S) / prefill2_s:.0f}",
          decode_steps=len(step_ms), decode_ms_per_step=f"{decode_ms:.3f}",
          decode_ms_median=f"{statistics.median(step_ms):.3f}",
          decode_ms_min_max=f"{min(step_ms):.3f}/{max(step_ms):.3f}",
          decode_bound_ms=f"{bound_ms:.3f}", decode_bound_bytes=nbytes,
          decode_over_bound=f"{decode_ms / bound_ms:.2f}",
          same_tokens_as_first_serve=bool(torch.equal(tokens2, tokens)))
    if busy_ms is None:
        phase("recurrent", arch=cfg.name,
              decode_device_idle_share="not measured",
              decode_step_profiled_ms=f"{prof_ms:.3f}")
    else:
        phase("recurrent", arch=cfg.name,
              decode_device_busy_ms=f"{busy_ms:.3f}",
              decode_device_idle_share=f"{1.0 - busy_ms / decode_ms:.4f}",
              decode_step_profiled_ms=f"{prof_ms:.3f}",
              idle_share_of_profiled_step=f"{1.0 - busy_ms / prof_ms:.4f}")
    phase("recurrent", arch=cfg.name, decode_step_top_kernels=top)
    del cache, tokens2
    gc.collect()
    # where the prefill's device time goes: one profiled prefill
    cache = TF.init_cache(cfg, B, F + S, device=dev)
    busy_ms, prof_ms, top = device_busy(
        torch, lambda: TF.prefill(lm, cfg, prompts[:, :S], cache, extra),
        top_n=10)
    phase("recurrent", arch=cfg.name, prefill_device_busy_ms=None
          if busy_ms is None else f"{busy_ms:.1f}",
          prefill_profiled_s=f"{prof_ms / 1e3:.3f}",
          prefill_top_kernels=top)
    del cache

    # checks at B = 1
    one = prompts[:1]
    one_extra = None if extra is None else extra[:1]
    worst = 0.0
    if "rglru" in kinds:
        worst = rglru_scan_gate(torch, dev, cfg, lm, TF, one[:, :S])
    if "ssm" in kinds:
        ssd_gate(torch, dev, cfg, lm, TF, one[:, :SSD_RAGGED_S])
    mixer_decode_check(torch, dev, cfg, lm, TF, one, one_extra)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "decode_ms": decode_ms,
            "prefill_s": prefill2_s}


def recurrent_phase(torch, np, dev, flash_log: str) -> dict:
    """The flash kernel at RecurrentGemma-9B's prefill shape (hd 256, MQA:
    KV 1, G 16, window 2048; B 1 and 4, S 8192) against its plain version,
    timed beside its bound, SDPA with the window as a mask and the plain
    version, with the ptxas lines of its HDP 256 instantiations; then each
    model of REC_RUNS served (``recurrent_serve``).  Returns the kernel's
    max abs error and its times at RecurrentGemma's shape (B 1)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FAK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase("recurrent", allocated_at_start_gb=
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f}")
    for line in ptxas_lines(flash_log):
        if "<256" in line or "float, 256" in line:
            phase("recurrent", ptxas=line)
    cfg = get_config(REC_RUNS[0][0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    shape = (REC_RUNS[0][2], cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, cfg.window)
    times = {}
    worst = 0.0
    for b in (1, REC_RUNS[0][1]):
        times[b] = flash_prefill_times(torch, dev, gen, FAK,
                                       flash_attention_ref, scratch.zero_,
                                       (b,) + shape, "recurrent")
        worst = max(worst, times[b]["max_abs_err"])
    del scratch
    torch.cuda.empty_cache()
    for arch, B, S, steps, n_extra in REC_RUNS:
        t1 = time.perf_counter()
        out = recurrent_serve(torch, np, dev, arch, B, S, steps, n_extra)
        worst = max(worst, out["max_abs_err"])
        phase("recurrent", arch=arch,
              wall_s=f"{time.perf_counter() - t1:.1f}")
    phase("recurrent", phase_wall_s=f"{time.perf_counter() - t0:.1f}")
    return {"max_abs_err": worst, "rg": times[1],
            "rg_path_ms": times[REC_RUNS[0][1]]["ms"]}


# ---------------------------------------------------------------------------
# train: the training path (MiniCPM-2B)
# ---------------------------------------------------------------------------

def train_state_copy(torch, cfg, p0, dev, moments_from=None):
    """A training state on ``dev`` holding the fp32 masters ``p0`` (a dict
    of CPU tensors) and a zero AdamW state (or a copy of
    ``moments_from``'s)."""
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import AdamWState, adamw_init

    lm = TF.LM(cfg, device=dev, dtype=torch.float32)
    with torch.no_grad():
        for n, p in lm.named_parameters():
            p.copy_(p0[n])
    opt = adamw_init(dict(lm.named_parameters()))
    if moments_from is not None:
        opt = AdamWState(step=moments_from.step.clone(),
                         m={k: x.clone() for k, x in moments_from.m.items()},
                         v={k: x.clone() for k, x in moments_from.v.items()})
    return lm, opt


def rel_norm(torch, got, want) -> float:
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm())


def max_update_err(torch, lm, want_lm, p0) -> float:
    """Max over parameters of ||(p - p0) - (q - p0)|| / ||q - p0|| (the
    CPU's ``want_lm`` gives q)."""
    want = dict(want_lm.named_parameters())
    worst = 0.0
    for n, p in lm.named_parameters():
        du = p.detach().cpu() - p0[n]
        dw = want[n].detach() - p0[n]
        worst = max(worst, rel_norm(torch, du, dw))
    return worst


def loss_only(torch, cfg, lm, batch) -> float:
    """The loss of ``batch`` on ``lm``'s compute copy (the train step's
    forward), no update."""
    from repro_torch.models import transformer as TF
    from repro_torch.models.weights import jax_ranks
    from repro_torch.runtime.train_loop import _cast_params, to_device

    dev = next(lm.parameters()).device
    pb = _cast_params(dict(lm.named_parameters()), torch.bfloat16,
                      jax_ranks(cfg, lm))
    with torch.no_grad():
        loss, _ = torch.func.functional_call(
            lm, pb, (lambda m, b: TF.loss_fn(m, cfg, b),
                     to_device(batch, dev)))
    return float(loss)


def train_gates_abd(torch, dev) -> dict:
    """Gates (a), (b) and (d) on MiniCPM-2B at full width, 2 layers."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.train import schedule
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.sharding import single_device_policy
    from repro_torch.runtime.train_loop import (build_train_step,
                                                init_train_state)

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CUT_LAYERS)
    t0 = time.perf_counter()
    lm, opt = init_train_state(cfg, SEED, device=dev)
    p0 = {n: p.detach().cpu() for n, p in lm.named_parameters()}
    phase("train", gate="setup", arch=cfg.name, layers=cfg.n_layers,
          params=sum(x.numel() for x in p0.values()),
          init_s=f"{time.perf_counter() - t0:.2f}")
    sched = schedule(cfg, TRAIN_LR, TRAIN_GATE_STEPS)
    step_fn = build_train_step(cfg, single_device_policy(), sched)
    data = SyntheticLMData(cfg, TRAIN_GATE_B, TRAIN_GATE_S)
    out = {}

    # ---- (a) the card against the port's CPU path -------------------------
    t0 = time.perf_counter()
    cpu_lm, cpu_opt = train_state_copy(torch, cfg, p0, "cpu")
    ctrl_batch = data.batch_at(0)
    ctrl_batch["labels"] = ctrl_batch["labels"].copy()
    ctrl_batch["labels"][:, -1] = -1
    ctrl_loss = loss_only(torch, cfg, lm, ctrl_batch)
    card, cpu = [], []
    for step in range(TRAIN_GATE_STEPS):
        lm, opt, m = step_fn(lm, opt, data.batch_at(step), step)
        cpu_lm, cpu_opt, cm = step_fn(cpu_lm, cpu_opt, data.batch_at(step),
                                      step)
        card.append({k: float(v) for k, v in m.items()})
        cpu.append({k: float(v) for k, v in cm.items()})
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(card, cpu))
    gn_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                 for a, b in zip(card, cpu))
    upd_err = max_update_err(torch, lm, cpu_lm, p0)
    ctrl_err = abs(ctrl_loss - cpu[0]["loss"]) / abs(cpu[0]["loss"])
    phase("train", gate="(a) card vs CPU, 3 steps",
          card_losses=[f"{c['loss']:.6f}" for c in card],
          cpu_losses=[f"{c['loss']:.6f}" for c in cpu],
          grad_norms=[f"{c['grad_norm']:.5f}" for c in card],
          lr=[f"{c['lr']:.3e}" for c in card])
    phase("train", gate="(a)", loss_rel_err=f"{loss_err:.3e}",
          tol=TRAIN_LOSS_TOL, grad_norm_rel_err=f"{gn_err:.3e}",
          gn_tol=TRAIN_GN_TOL, max_update_rel_err=f"{upd_err:.3e}",
          update_tol=TRAIN_UPDATE_TOL,
          wall_s=f"{time.perf_counter() - t0:.1f}")
    phase("train", gate="(a) control: last label of each row ignored on "
          "the card", loss_rel_err=f"{ctrl_err:.3e}",
          must_exceed=TRAIN_LOSS_TOL)
    if not (loss_err <= TRAIN_LOSS_TOL and gn_err <= TRAIN_GN_TOL and
            upd_err <= TRAIN_UPDATE_TOL):
        raise RuntimeError("train (a): the card's steps differ from the "
                           "CPU's beyond tolerance")
    if not ctrl_err > TRAIN_LOSS_TOL:
        raise RuntimeError(f"train (a): the loss tolerance cannot see two "
                           f"ignored labels ({ctrl_err:.3e})")
    out["card_vs_cpu"] = dict(loss=loss_err, grad_norm=gn_err,
                              update=upd_err, control=ctrl_err)
    del cpu_lm, cpu_opt, lm, opt

    # ---- (b) microbatches 2 against 1 --------------------------------------
    def one_step(M, average=None):
        lm, opt = train_state_copy(torch, cfg, p0, dev)
        fn = build_train_step(cfg, single_device_policy(microbatches=M),
                              sched)
        with (patched(train_loop, "_average", average) if average
              else contextlib.nullcontext()):
            _, _, m = fn(lm, opt, data.batch_at(0), 0)
        return {k: float(v) for k, v in m.items()}

    m1, m2 = one_step(1), one_step(2)
    ctrl = one_step(2, lambda grads, loss, M: (grads, loss / M))
    micro = (abs(m2["loss"] - m1["loss"]) / m1["loss"],
             abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"])
    micro_ctrl = abs(ctrl["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
    phase("train", gate="(b) microbatches 2 vs 1",
          loss=f"{m2['loss']:.6f}/{m1['loss']:.6f}",
          loss_rel_err=f"{micro[0]:.3e}", tol=MICRO_LOSS_TOL,
          grad_norm=f"{m2['grad_norm']:.5f}/{m1['grad_norm']:.5f}",
          grad_norm_rel_err=f"{micro[1]:.3e}", gn_tol=MICRO_GN_TOL)
    phase("train", gate="(b) control: gradients not divided by M",
          grad_norm_rel_err=f"{micro_ctrl:.3e}", must_exceed=MICRO_GN_TOL)
    if not (micro[0] <= MICRO_LOSS_TOL and micro[1] <= MICRO_GN_TOL):
        raise RuntimeError("train (b): microbatches 2 differ from 1")
    if not micro_ctrl > MICRO_GN_TOL:
        raise RuntimeError("train (b): the control was not seen")
    out["microbatch"] = dict(loss=micro[0], grad_norm=micro[1],
                             control=micro_ctrl)

    # ---- (d) checkpoint and determinism --------------------------------------
    t0 = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    ckdir = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=out_dir))
    torch.use_deterministic_algorithms(True)
    try:
        lm, opt = train_state_copy(torch, cfg, p0, dev)
        for step in range(TRAIN_GATE_STEPS):
            lm, opt, _ = step_fn(lm, opt, data.batch_at(step), step)
        live = {"params": dict(lm.named_parameters()), "opt": opt}
        mgr = CheckpointManager(str(ckdir), every=0)
        mgr.maybe_save(TRAIN_GATE_STEPS - 1, live, force=True)
        mgr.finalize()
        fresh_lm, fresh_opt = init_train_state(cfg, SEED + 1, device=dev)
        fresh = {"params": dict(fresh_lm.named_parameters()),
                 "opt": fresh_opt}
        fresh, start = mgr.restore_or_init(lambda: fresh)
        restored_equal = all(torch.equal(a, b) for a, b in zip(
            tensors(live), tensors(fresh)))
        nxt = data.batch_at(TRAIN_GATE_STEPS)
        _, _, lm_m = step_fn(lm, opt, nxt, TRAIN_GATE_STEPS)
        _, _, re_m = step_fn(fresh_lm, fresh["opt"], nxt, TRAIN_GATE_STEPS)
        next_equal = (all(torch.equal(a, b) for a, b in zip(
            tensors(live), tensors(fresh)))
            and all(torch.equal(lm_m[k], re_m[k]) for k in lm_m))
        # control: restore again, the AdamW step one off
        fresh = mgr.restore_or_init(lambda: fresh)[0]
        off = fresh["opt"]._replace(step=fresh["opt"].step - 1)
        step_fn(fresh_lm, off, nxt, TRAIN_GATE_STEPS)
        ctrl_equal = all(torch.equal(a, b) for a, b in zip(
            lm.parameters(), fresh_lm.parameters()))
        del fresh, fresh_lm, fresh_opt, live
    finally:
        torch.use_deterministic_algorithms(False)
        import shutil
        shutil.rmtree(ckdir, ignore_errors=True)
    phase("train", gate="(d) checkpoint after step 2, restore, step 3",
          start_step=start, restored_bit_equal=restored_equal,
          next_step_bit_equal=next_equal,
          control_step_one_off_bit_equal=ctrl_equal,
          wall_s=f"{time.perf_counter() - t0:.1f}")
    if not (restored_equal and next_equal and start == TRAIN_GATE_STEPS - 1):
        raise RuntimeError("train (d): the restored state or its next step "
                           "is not bit-equal to the live one")
    if ctrl_equal:
        raise RuntimeError("train (d): the control (AdamW step one off) "
                           "was not seen")
    return out


def time_once(torch, fn) -> float:
    """Device milliseconds of one call of ``fn`` by a CUDA event pair
    (after one untimed call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def tensors(state):
    """The tensors of a training state {"params": ..., "opt": AdamWState},
    in a fixed order."""
    opt = state["opt"]
    return ([state["params"][k] for k in sorted(state["params"])]
            + [opt.step] + [opt.m[k] for k in sorted(opt.m)]
            + [opt.v[k] for k in sorted(opt.v)])


def train_flop_bound(torch, cfg, n_params, B, S) -> dict:
    """The least time of a train step of B x S tokens: 6 flops a
    parameter and token (forward and backward; the tied table as the
    unembedding's product) plus 3 x the causal attention's forward, 4 * hd
    flops per visible (query, key) pair and head, at the bf16 peak."""
    pairs = S * (S + 1) // 2
    attn = 3 * 4 * cfg.resolved_head_dim * cfg.n_heads * B * pairs \
        * cfg.n_layers
    flops = 6 * n_params * B * S + attn
    return dict(flops=flops, bound_s=flops / BF16_PEAK_FLOPS)


def train_phase(torch, np, dev) -> dict:
    """The training path: gates (a), (b), (d) at 2 layers, then (e) the
    whole MiniCPM-2B through ``launch/train.main`` with every kernel count
    read around it, then (c) on (e)'s layer-0 q, k, v.  Returns the
    launch counts of (e)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FAK
    from repro_torch.kernels.paged_attention import kernel as PAK
    from repro_torch.kernels.pagewalk import kernel as PWK
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.train import schedule
    from repro_torch.models import attention as AT
    from repro_torch.models.weights import jax_ranks
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.runtime.sharding import single_device_policy
    from repro_torch.runtime.train_loop import _cast_params, build_train_step

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase("train", allocated_at_start_gb=
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f}")
    gates = train_gates_abd(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) full width and depth through launch/train --------------------
    cfg = get_config(TRAIN_ARCH)
    rec = {"t": [], "metrics": [], "state": None, "qkv": None}

    def on_step(step, lm, opt, metrics):
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["metrics"].append({k: float(v) for k, v in metrics.items()})
        rec["state"] = (lm, opt)

    core = AT.attention_core

    def capture_first(q, k, v, mask, scale, attn_softcap=0.0):
        if rec["qkv"] is None:
            rec["qkv"] = tuple(x.detach().clone() for x in (q, k, v))
        return core(q, k, v, mask, scale, attn_softcap)

    counts = (FAK.flash_attention_kernel, PAK.paged_attention_kernel,
              PWK.two_stage_translate_kernel)
    args = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--lr", str(TRAIN_LR),
            "--log-every", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counts:
        c.launches = 0
    t0 = time.perf_counter()
    with patched(AT, "attention_core", capture_first):
        losses = launch_train.main(args, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": counts[0].launches,
                "paged_attention": counts[1].launches,
                "pagewalk": counts[2].launches}
    peak = torch.cuda.max_memory_allocated(dev)
    lm, opt = rec["state"]
    n_params = sum(p.numel() for p in lm.parameters())
    state_bytes = sum(x.numel() * x.element_size() for x in
                      list(lm.parameters()) + list(opt.m.values())
                      + list(opt.v.values()))
    step_bytes = state_bytes + 2 * 2 * n_params   # + bf16 copy and grads
    met = rec["metrics"]
    for i, m in enumerate(met):
        phase("train", gate="(e)", step=i, loss=f"{m['loss']:.4f}",
              grad_norm=f"{m['grad_norm']:.4f}", lr=f"{m['lr']:.3e}")
    step_ms = [(b - a) * 1e3 for a, b in zip(rec["t"], rec["t"][1:])]
    steady = statistics.median(step_ms[1:])     # steps 2..7
    bound = train_flop_bound(torch, cfg, n_params, TRAIN_B, TRAIN_S)
    phase("train", gate="(e) MiniCPM-2B full width and depth",
          layers=cfg.n_layers, params=n_params, remat=cfg.remat,
          tokens_per_step=TRAIN_B * TRAIN_S, wall_s=f"{wall:.2f}",
          first_step_ms=f"{(rec['t'][0] - t0) * 1e3:.1f}",
          step_ms_median_2_7=f"{steady:.2f}",
          step_ms_min_max=f"{min(step_ms[1:]):.2f}/{max(step_ms[1:]):.2f}",
          tokens_per_s=f"{TRAIN_B * TRAIN_S / steady * 1e3:.0f}",
          flops_per_step=f"{bound['flops']:.4e}",
          bound_ms=f"{bound['bound_s'] * 1e3:.2f}",
          share_of_bound=f"{bound['bound_s'] * 1e3 / steady:.4f}",
          peak_mem_gb=f"{peak / 1e9:.2f}",
          masters_and_moments_gb=f"{state_bytes / 1e9:.2f}",
          with_bf16_copy_and_grads_gb=f"{step_bytes / 1e9:.2f}")
    phase("train", gate="(e) kernel launches on the training path",
          **launches)
    TRAIN_PLAIN.update(step_ms=steady, peak_gb=peak / 1e9,
                       tokens_per_s=TRAIN_B * TRAIN_S / steady * 1e3)
    finite = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                 for m in met)
    if not finite or not met[-1]["loss"] < met[0]["loss"] or \
            losses != [m["loss"] for m in met]:
        raise RuntimeError(f"train (e): losses {losses} (finite: {finite})")
    if any(launches.values()):
        raise RuntimeError(f"train (e): the training path launched "
                           f"{launches}; it reaches no kernel")

    # one more step, profiled: the device idle share
    step_fn = build_train_step(cfg, single_device_policy(),
                               schedule(cfg, TRAIN_LR, TRAIN_STEPS))
    from repro_torch.data.pipeline import SyntheticLMData
    batch = SyntheticLMData(cfg, TRAIN_B, TRAIN_S).batch_at(TRAIN_STEPS)
    busy_ms, prof_ms, top = device_busy(
        torch, lambda: step_fn(lm, opt, batch, TRAIN_STEPS), top_n=8)
    if busy_ms is None:
        phase("train", gate="(e) profiled step",
              device_idle_share="not measured",
              profiled_step_ms=f"{prof_ms:.1f}")
    else:
        # idle against the unprofiled step (the median) and, for
        # reference, against the profiled step's own wall
        phase("train", gate="(e) profiled step",
              device_busy_ms=f"{busy_ms:.1f}",
              device_idle_share=f"{1.0 - busy_ms / steady:.4f}",
              profiled_step_ms=f"{prof_ms:.1f}",
              idle_share_of_profiled_step=f"{1.0 - busy_ms / prof_ms:.4f}")
    phase("train", top_kernels=top)
    # the step's parts by CUDA events: the bf16 copy, one AdamW update (on
    # bf16 gradients of zero; the state is not used again)
    params = dict(lm.named_parameters())
    ranks = jax_ranks(cfg, lm)
    cast_ms = time_once(torch, lambda: _cast_params(params, torch.bfloat16,
                                                    ranks))
    grads = {k: torch.zeros_like(p, dtype=torch.bfloat16)
             for k, p in params.items()}
    adamw_ms = time_once(torch, lambda: adamw_update(
        params, grads, opt, TRAIN_LR, ranks=ranks))
    del grads, params
    phase("train", gate="(e) parts of the step", cast_ms=f"{cast_ms:.2f}",
          adamw_update_ms=f"{adamw_ms:.2f}",
          adamw_byte_bound_ms=f"{26 * n_params / HBM_BYTES_PER_S * 1e3:.2f}",
          rest_of_step_ms=f"{steady - cast_ms - adamw_ms:.2f}")
    rec["state"] = None
    del lm, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the training attention against the kernel --------------------
    q, k, v = rec["qkv"]
    scale = cfg.resolved_head_dim ** -0.5
    pos = torch.arange(q.shape[1], device=dev)
    mask = AT._causal_mask(pos, pos, cfg.window)[None, None]
    want = AT.attention_core(q, k, v, mask, scale)
    got = FAK.flash_attention_kernel(q.contiguous(), k.contiguous(),
                                     v.contiguous(), scale, 0)
    short = own_key_dropped(FAK, got, q, k, v, scale)
    rel = rel_rows(torch, got, want)
    ctrl = rel_rows(torch, short, want)
    phase("train", gate="(c) layer 0 attention_core vs flash kernel",
          shape=list(q.shape), kv_heads=k.shape[2],
          max_abs_err=f"{float((got.float() - want.float()).abs().max()):.3e}",
          max_row_rel_err=f"{rel:.3e}", row_rel_tol=BF16_ROW_REL_TOL)
    phase("train", gate="(c) control: each query's own key dropped",
          max_row_rel_err=f"{ctrl:.3e}", must_exceed=BF16_ROW_REL_TOL)
    if not rel <= BF16_ROW_REL_TOL:
        raise RuntimeError(f"train (c): attention_core and the kernel "
                           f"differ by {rel:.3e} by row")
    if not ctrl > BF16_ROW_REL_TOL:
        raise RuntimeError("train (c): the control was not seen")
    phase("train", phase_wall_s=f"{time.perf_counter() - t_phase:.1f}")
    return launches


# ---------------------------------------------------------------------------
# mesh: the mesh half on the card (world size 1) and on the fake world
# ---------------------------------------------------------------------------

def mesh_gate_a(torch, dev, mesh) -> dict:
    """(a) the DTensor step on ``mesh`` against today's step, 3 steps of
    MiniCPM-2B at full width, 2 layers, 2 x 128, from one seeded state,
    under deterministic algorithms: loss, grad norm and every parameter
    bit-equal; control: the DTensor step at twice the lr must differ."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.sharding import single_device_policy
    from repro_torch.runtime.train_loop import (build_train_step,
                                                init_train_state)

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CUT_LAYERS)
    data = SyntheticLMData(cfg, TRAIN_GATE_B, TRAIN_GATE_S)

    def on_mesh(lr):
        lm, opt = init_train_state(cfg, SEED, device=dev)
        pol, psh, opt, place = launch_train.on_mesh(cfg, mesh, 1, lm, opt)
        fn = build_train_step(cfg, pol, launch_train.schedule(
            cfg, lr, MESH_STEPS), grad_shardings=psh)
        return lm, opt, fn, place

    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        plain, popt = init_train_state(cfg, SEED, device=dev)
        pfn = build_train_step(cfg, single_device_policy(),
                               launch_train.schedule(cfg, TRAIN_LR,
                                                     MESH_STEPS))
        lm, opt, fn, place = on_mesh(TRAIN_LR)
        placed = {n: [str(p) for p in x.placements]
                  for n, x in list(lm.named_parameters())[:2]}
        rows = []
        for step in range(MESH_STEPS):
            batch = data.batch_at(step)
            plain, popt, pm = pfn(plain, popt, batch, step)
            lm, opt, mm = fn(lm, opt, place(batch), step)
            rows.append((float(pm["loss"]), float(mm["loss"]),
                         float(pm["grad_norm"]), float(mm["grad_norm"])))
        want = dict(plain.named_parameters())
        diff = {}
        for n, p in lm.named_parameters():
            got = p.to_local()
            if not torch.equal(got, want[n]):
                diff[n] = float((got.double() - want[n].double()).norm()
                                / want[n].double().norm().clamp_min(1e-30))
        metrics_equal = all(a == b and c == d for a, b, c, d in rows)
        steps_equal = all(torch.equal(opt.m[n].to_local(), popt.m[n])
                          for n in popt.m)
        del lm, opt, fn
        clm, copt, cfn, cplace = on_mesh(2 * TRAIN_LR)
        for step in range(MESH_STEPS):
            clm, copt, _ = cfn(clm, copt, cplace(data.batch_at(step)), step)
        ctrl_equal = all(torch.equal(p.to_local(), want[n])
                         for n, p in clm.named_parameters())
        del clm, copt, cfn, plain, popt, want
    finally:
        torch.use_deterministic_algorithms(False)
    bit_equal = metrics_equal and steps_equal and not diff
    phase("mesh", gate="(a) DTensor step on make_host_mesh() vs today's "
          "step", arch=cfg.name, layers=cfg.n_layers,
          batch=f"{TRAIN_GATE_B}x{TRAIN_GATE_S}", steps=MESH_STEPS,
          placements_of_first_two=placed,
          losses=[f"{a:.6f}/{b:.6f}" for a, b, _, _ in rows],
          grad_norms=[f"{c:.6f}/{d:.6f}" for _, _, c, d in rows],
          wall_s=f"{time.perf_counter() - t0:.1f}")
    phase("mesh", gate="(a)", loss_and_grad_norm_bit_equal=metrics_equal,
          every_parameter_bit_equal=not diff, moments_bit_equal=steps_equal,
          params_differing=len(diff),
          worst=(max(diff.items(), key=lambda kv: kv[1]) if diff else None))
    phase("mesh", gate="(a) control: the DTensor step at 2 x lr",
          bit_equal=ctrl_equal, must_be=False)
    if ctrl_equal:
        raise RuntimeError("mesh (a): the control (2 x lr) was not seen")
    if not bit_equal:
        loss_err = max(abs(b - a) / abs(a) for a, b, _, _ in rows)
        gn_err = max(abs(d - c) / c for _, _, c, d in rows)
        upd = max(diff.values(), default=0.0)
        phase("mesh", gate="(a) not bit-equal: the train phase's tolerances",
              loss_rel_err=f"{loss_err:.3e}", tol=TRAIN_LOSS_TOL,
              grad_norm_rel_err=f"{gn_err:.3e}", gn_tol=TRAIN_GN_TOL,
              max_param_rel_err=f"{upd:.3e}", update_tol=TRAIN_UPDATE_TOL)
        if not (loss_err <= TRAIN_LOSS_TOL and gn_err <= TRAIN_GN_TOL and
                upd <= TRAIN_UPDATE_TOL):
            raise RuntimeError("mesh (a): the DTensor step differs from "
                               "today's beyond the train phase's tolerances")
    return {"bit_equal": bit_equal}


def mesh_full(torch, np, dev) -> dict:
    """(b) MiniCPM-2B at full width and depth, (e)'s cell (4 x 1024,
    remat "dots"), 3 steps through ``launch/train.main(["--mesh",
    "host"])``: step ms, tokens/s, peak memory of steps 1-2 (after the
    state is placed), the idle share of one more, profiled, step; the
    kernel counts read around it."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels.flash_attention import kernel as FAK
    from repro_torch.kernels.paged_attention import kernel as PAK
    from repro_torch.kernels.pagewalk import kernel as PWK
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.sharding import default_policy
    from repro_torch.runtime.train_loop import build_train_step

    cfg = get_config(TRAIN_ARCH)
    rec = {"t": [], "metrics": [], "state": None}

    def on_step(step, lm, opt, metrics):
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["metrics"].append({k: float(v) for k, v in metrics.items()})
        rec["state"] = (lm, opt)
        if step == 0:       # the steps' peak, not the placing's
            torch.cuda.reset_peak_memory_stats(dev)

    counts = (FAK.flash_attention_kernel, PAK.paged_attention_kernel,
              PWK.two_stage_translate_kernel)
    for c in counts:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launch_train.main(["--arch", TRAIN_ARCH, "--steps", str(MESH_STEPS),
                       "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                       "--lr", str(TRAIN_LR), "--log-every", "1",
                       "--mesh", "host"], on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": counts[0].launches,
                "paged_attention": counts[1].launches,
                "pagewalk": counts[2].launches}
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = [(b - a) * 1e3 for a, b in zip(rec["t"], rec["t"][1:])]
    met = rec["metrics"]
    lm, opt = rec["state"]
    mesh = next(lm.parameters()).device_mesh
    psh = {n: list(p.placements) for n, p in lm.named_parameters()}
    pol = default_policy(mesh)
    fn = build_train_step(cfg, pol, launch_train.schedule(
        cfg, TRAIN_LR, MESH_STEPS), grad_shardings=psh)
    from torch.distributed.tensor import distribute_tensor
    batch = {k: distribute_tensor(torch.as_tensor(x.astype(np.int64),
                                                  device=dev), mesh,
                                  pol.shard(mesh, ("dp", None), x.shape))
             for k, x in SyntheticLMData(cfg, TRAIN_B, TRAIN_S).batch_at(
                 MESH_STEPS).items()}
    busy_ms, prof_ms, top = device_busy(
        torch, lambda: fn(lm, opt, batch, MESH_STEPS), top_n=8)
    steady = statistics.median(step_ms)
    out = dict(step_ms=steady, peak=peak,
               tokens_per_s=TRAIN_B * TRAIN_S / steady * 1e3)
    phase("mesh", gate="(b) MiniCPM-2B full width and depth, launch/train "
          "--mesh host", layers=cfg.n_layers, remat=cfg.remat,
          tokens_per_step=TRAIN_B * TRAIN_S, wall_s=f"{wall:.2f}",
          losses=[f"{m['loss']:.4f}" for m in met],
          first_step_ms=f"{(rec['t'][0] - t0) * 1e3:.1f}",
          step_ms_steps_1_2=[f"{x:.2f}" for x in step_ms],
          tokens_per_s=f"{out['tokens_per_s']:.0f}",
          peak_mem_gb_steps_1_2=f"{peak / 1e9:.2f}",
          device_busy_ms=("not measured" if busy_ms is None
                          else f"{busy_ms:.1f}"),
          device_idle_share=("not measured" if busy_ms is None
                             else f"{1.0 - busy_ms / steady:.4f}"),
          profiled_step_ms=f"{prof_ms:.1f}")
    phase("mesh", gate="(b) beside the plain path, this run (train (e))",
          plain_step_ms=(f"{TRAIN_PLAIN['step_ms']:.2f}" if TRAIN_PLAIN
                         else "not run"),
          plain_peak_gb=(f"{TRAIN_PLAIN['peak_gb']:.2f}" if TRAIN_PLAIN
                         else "not run"),
          recorded_plain="884.98-937.36 ms, 56.33 GB")
    phase("mesh", top_kernels=top)
    phase("mesh", gate="(b) kernel launches on the mesh path", **launches)
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in met):
        raise RuntimeError(f"mesh (b): losses {met}")
    if any(launches.values()):
        raise RuntimeError(f"mesh (b): the mesh path launched {launches}")
    rec["state"] = None
    del lm, opt, fn, batch
    out["launches"] = launches
    return out


MESH_DRY_SCRIPT = r"""
import json, sys
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
arch, shape, multi_pod, cut, out = sys.argv[1:6]
kw = {}
if cut == "card":   # (c): the card's (b) cell on a fake world of 1
    kw = dict(mesh_shape=(1, 1), microbatches=1,
              shape=ShapeConfig(shape, "train", int(sys.argv[7]),
                                int(sys.argv[6])))
rec = dryrun.run_cell(arch, shape, multi_pod == "1", device="cuda", **kw)
json.dump(rec, open(out, "w"))
"""


def start_dry_runs(src: str) -> dict:
    """(c) and (d): ``launch/dryrun.run_cell`` of (b)'s cell on a fake
    world of 1 and of the ``MESH_CELLS`` on the production meshes, each in
    a subprocess of its own (one default process group a process), all
    started together, at a lower priority: they trace on the host only,
    so the default run starts them before the train phase and the card's
    phases go on meanwhile.  ``join_dry_runs`` collects them."""
    out_dir = ROOT / "chiprun_out" / "mesh_dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    jobs = [(TRAIN_ARCH, "train_4k", False, "card")] + \
        [(a, s, mp, "") for a, s, mp in MESH_CELLS]
    procs = []
    for i, (arch, shape, mp, cut) in enumerate(jobs):
        path = out_dir / f"{i}_{arch}__{shape}.json"
        with open(path.with_suffix(".log"), "w") as log:
            p = subprocess.Popen(
                [sys.executable, "-c", MESH_DRY_SCRIPT, arch, shape,
                 str(int(mp)), cut or "-", str(path), str(TRAIN_B),
                 str(TRAIN_S)], env=env, stdout=log,
                stderr=subprocess.STDOUT)
        os.setpriority(os.PRIO_PROCESS, p.pid, 10)
        procs.append((path, p))
    return {"procs": procs, "t0": time.perf_counter()}


def stop_dry_runs(runs: dict) -> None:
    """Kill whatever of ``runs`` still runs."""
    for _, p in runs["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()


def join_dry_runs(runs: dict) -> list:
    """The records of ``start_dry_runs``' cells, (c)'s first; each cell
    must end within ``MESH_DRY_TIMEOUT_S`` of the start."""
    recs = []
    for path, p in runs["procs"]:
        left = MESH_DRY_TIMEOUT_S - (time.perf_counter() - runs["t0"])
        try:
            p.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            stop_dry_runs(runs)
            raise RuntimeError(f"mesh: a dry-run cell ran past "
                               f"{MESH_DRY_TIMEOUT_S} s")
        if p.returncode != 0:
            stop_dry_runs(runs)
            err = path.with_suffix(".log").read_text()
            raise RuntimeError(f"mesh: dry-run subprocess failed: "
                               f"{err[-2000:]}")
        recs.append(json.loads(path.read_text()))
    return recs


def mesh_bounds(torch) -> None:
    """(e) the dry run's analytic model beside this script's own bounds
    at (b)'s cell (4 x 1024 MiniCPM-2B; decode at B 4 against a 1024-token
    cache), with the ratios.  Not a gate."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import analytic
    from repro_torch.models import transformer as TF

    cfg = get_config(TRAIN_ARCH)
    lm = TF.LM(cfg, device="meta")
    n_params = sum(p.numel() for p in lm.parameters())
    train = ShapeConfig("train_4k", "train", TRAIN_S, TRAIN_B)
    ex = analytic.exec_flops(cfg, train, "train", cfg.remat)
    us = analytic.useful_flops(cfg, train, "train")
    hbm = analytic.hbm_bytes(cfg, train, "train", 4)
    own = train_flop_bound(torch, cfg, n_params, TRAIN_B, TRAIN_S)["flops"]
    cache = [{n: torch.empty(s, dtype=dt, device="meta")
              for n, (s, dt, _) in layer.items()}
             for layer in TF.cache_shapes(cfg, TRAIN_B, TRAIN_S)]
    dec_own = decode_bytes(torch, cfg, lm, cache)
    dec = analytic.hbm_bytes(cfg, ShapeConfig("decode", "decode", TRAIN_S,
                                              TRAIN_B), "decode", 2)
    phase("mesh", gate="(e) bounds side by side (not a gate)",
          analytic_exec_flops=f"{ex:.4e}", analytic_useful_flops=f"{us:.4e}",
          train_flop_bound=f"{own:.4e}",
          exec_over_bound=f"{ex / own:.4f}", useful_over_bound=f"{us / own:.4f}",
          analytic_train_hbm_bytes=f"{hbm:.4e}",
          analytic_decode_hbm_bytes=f"{dec:.4e}", decode_bytes=f"{dec_own:.4e}",
          analytic_over_decode_bytes=f"{dec / dec_own:.4f}",
          n_params=n_params, cfg_n_params=cfg.n_params())


def mesh_phase(torch, np, dev, src: str, runs: dict = None) -> dict:
    """The mesh phase: (a), (b) and (e) on a world-size-1 nccl group and
    ``make_host_mesh()`` (destroyed after), then (c) and (d) on the fake
    process group in the subprocesses of ``runs`` (``start_dry_runs``;
    started here where not given).  Returns (b)'s kernel counts."""
    t_phase = time.perf_counter()
    if runs is not None:
        return _mesh_phase(torch, np, dev, runs, t_phase)
    runs = start_dry_runs(src)
    try:
        return _mesh_phase(torch, np, dev, runs, t_phase)
    finally:
        stop_dry_runs(runs)


def _mesh_phase(torch, np, dev, runs: dict, t_phase: float) -> dict:
    import gc

    import torch.distributed as dist

    from repro_torch.launch.train import host_mesh

    gc.collect()
    torch.cuda.empty_cache()
    mesh = host_mesh(dev)
    phase("mesh", backend=dist.get_backend(), world_size=dist.get_world_size(),
          mesh=str(mesh))
    try:
        mesh_gate_a(torch, dev, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        full = mesh_full(torch, np, dev)
        mesh_bounds(torch)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = join_dry_runs(runs)
    bad = [r for r in recs if r["status"] != "ok"]
    for r in recs:
        if r["status"] != "ok":
            phase("mesh", cell=f"{r['arch']} {r['shape']}",
                  status=r["status"], error=r.get("error"),
                  traceback=r.get("traceback", "")[-1500:])
            continue
        t = r["roofline"]
        phase("mesh", cell=f"{r['arch']} {r['shape']}", mesh=r["mesh"],
              microbatches=r["microbatches"],
              bytes_per_device_gb=f"{r['memory']['per_device_live_bytes'] / 1e9:.3f}",
              fits_h100_80g=r["memory"]["fits_h100_80g"],
              t_compute_s=f"{t['t_compute_s']:.4e}",
              t_compute_traced_s=f"{t['t_compute_traced_s']:.4e}",
              t_memory_s=f"{t['t_memory_s']:.4e}",
              t_collective_s=f"{t['t_collective_s']:.4e}",
              dominant=t["dominant"],
              collective_by_kind=t["collective_by_kind"],
              traced_flops_per_dev=f"{t['traced_flops_per_dev']:.4e}",
              exec_flops_per_dev=f"{t['exec_flops'] / r['chips']:.4e}",
              wall_s=r["wall_s"])
    phase("mesh", dry_runs_wall_s=f"{time.perf_counter() - runs['t0']:.1f}",
          dry_runs_waited_s=f"{time.perf_counter() - t0:.1f}")
    if bad:
        raise RuntimeError(f"mesh: {len(bad)} dry-run cells not ok")
    est = recs[0]["memory"]["per_device_live_bytes"]
    err = abs(est - full["peak"]) / full["peak"]
    phase("mesh", gate="(c) the dry run's bytes a device vs (b)'s peak",
          dry_run_gb=f"{est / 1e9:.3f}", measured_gb=f"{full['peak'] / 1e9:.3f}",
          rel_err=f"{err:.4f}", tol=MESH_DRY_TOL)
    if not err <= MESH_DRY_TOL:
        raise RuntimeError(f"mesh (c): the dry run's {est / 1e9:.2f} GB is "
                           f"{err:.1%} from the measured peak")
    phase("mesh", phase_wall_s=f"{time.perf_counter() - t_phase:.1f}")
    return full["launches"]


def walk_times(torch, np, dev, smi: str) -> int:
    """``--walk-times``: only the pagewalk timings of phases 3 and 5 (the
    table sweep and its decomposition; the consumers' shapes and the
    whole translate calls), for the package ``--src`` names."""
    from repro_torch.kernels import build

    info = build.compile_source("pagewalk")
    phase("build", kernel="pagewalk", seconds=f"{info['seconds']:.2f}")
    for line in ptxas_lines(info["log"]):
        print(f"  ptxas: {line}", flush=True)
    tables, qs, _ = sweep_inputs(torch, np, dev)
    sweep_times(torch, dev, tables, qs[T * R * P])
    consumer_walks(torch, dev, *mapped_cache(torch, np, dev)[:4])
    print(smi, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walk-times", action="store_true",
                    help="only the pagewalk timings (no checks of the "
                    "other phases, no result line)")
    ap.add_argument("--hext-matrix", action="store_true",
                    help="only the hext columns the default run leaves "
                    "out (the long four's 1guest-preempt, all nine's "
                    "2guest- and 4guest-preempt), each held to the goldens "
                    "(no other phase, no result line)")
    ap.add_argument("--serving", action="store_true",
                    help="only the build and the serving phases (model, "
                    "moe, recurrent; no other phase, no result line)")
    ap.add_argument("--recurrent", action="store_true",
                    help="only the build and the recurrent phase (no "
                    "other phase, no result line)")
    ap.add_argument("--train", action="store_true",
                    help="only the build and the train phase (no other "
                    "phase, no result line)")
    ap.add_argument("--mesh", action="store_true",
                    help="only the mesh phase (no other phase, no result "
                    "line)")
    ap.add_argument("--serve", action="store_true",
                    help="only the 16-submission serve trace through the "
                    "port's service (no other phase, no result line)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is run (so "
                    "two checkouts can be timed in turns in one call)")
    args = ap.parse_args(argv)
    # the train phase's deterministic gate needs cuBLAS's fixed workspace,
    # which is read when CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    if args.walk_times:
        phase("walk-times", src=Path(args.src).resolve(),
              torch=torch.__version__)
        print(smi, flush=True)
        return walk_times(torch, np, dev, smi)
    if args.hext_matrix:
        phase("hext-matrix", torch=torch.__version__)
        print(smi, flush=True)
        hext_matrix(torch, dev)
        print(smi, flush=True)
        return 0
    if args.serving:
        phase("serving", src=Path(args.src).resolve(),
              torch=torch.__version__)
        print(smi, flush=True)
        info = build.compile_source("flash_attention")
        phase("build", kernel="flash_attention",
              seconds=f"{info['seconds']:.2f}")
        for serving_phase in (model_phase, moe_phase):
            torch.cuda.empty_cache()
            serving_phase(torch, np, dev)
        torch.cuda.empty_cache()
        recurrent_phase(torch, np, dev, info["log"])
        print(smi, flush=True)
        return 0
    if args.recurrent:
        phase("recurrent", torch=torch.__version__)
        print(smi, flush=True)
        info = build.compile_source("flash_attention")
        phase("build", kernel="flash_attention",
              seconds=f"{info['seconds']:.2f}")
        recurrent_phase(torch, np, dev, info["log"])
        print(smi, flush=True)
        return 0
    if args.train:
        phase("train", torch=torch.__version__)
        print(smi, flush=True)
        info = build.compile_source("flash_attention")
        phase("build", kernel="flash_attention",
              seconds=f"{info['seconds']:.2f}")
        train_phase(torch, np, dev)
        print(smi, flush=True)
        return 0
    if args.mesh:
        phase("mesh", torch=torch.__version__)
        print(smi, flush=True)
        mesh_phase(torch, np, dev, str(Path(args.src).resolve()))
        print(smi, flush=True)
        return 0
    if args.serve:
        phase("serve", torch=torch.__version__)
        print(smi, flush=True)
        serve_smoke(torch, dev)
        print(smi, flush=True)
        return 0
    t_start = time.perf_counter()
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
        for line in ptxas_lines(info["log"]):
            print(f"  ptxas: {line}", flush=True)
    phase("build", wall_s=f"{time.perf_counter() - t0:.2f}")

    walk = pagewalk_phase(torch, np, dev)
    walk_launches, path_times, attention = vmem_phase(torch, np, dev)
    # pagewalk's path is its consumer's, the vmem decode path: its launches
    # there, and its times at the path's call (translate_block's walk)
    walk["launches"] = walk_launches
    walk["ms"], walk["plain_ms"], walk["bound_ms"] = path_times
    torch.cuda.empty_cache()
    flash = model_phase(torch, np, dev)
    torch.cuda.empty_cache()
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               moe_phase(torch, np, dev)["max_abs_err"])
    torch.cuda.empty_cache()
    rec = recurrent_phase(torch, np, dev, infos["flash_attention"]["log"])
    flash["max_abs_err"] = max(flash["max_abs_err"], rec["max_abs_err"])
    # the kernel at RecurrentGemma-9B's prefill shape (B 1; the path's B 4)
    flash.update(recurrentgemma_ms=rec["rg"]["ms"],
                 recurrentgemma_path_ms=rec["rg_path_ms"],
                 recurrentgemma_bound_ms=rec["rg"]["bound_ms"],
                 recurrentgemma_plain_ms=rec["rg"]["plain_ms"],
                 recurrentgemma_library_ms=rec["rg"]["library_ms"])
    kernels = [walk, attention, flash]
    torch.cuda.empty_cache()
    # the mesh phase's dry runs trace on the host while the train phase
    # and the mesh phase's own steps run on the card
    src = str(Path(args.src).resolve())
    runs = start_dry_runs(src)
    try:
        # the training path's launches of each kernel (0: it reaches none)
        train_launches = train_phase(torch, np, dev)
        for entry, name in zip(kernels, ("pagewalk", "paged_attention",
                                         "flash_attention")):
            entry["train_launches"] = train_launches[name]
        torch.cuda.empty_cache()
        # the mesh half: the DTensor train step at world size 1, the dry run
        mesh_launches = mesh_phase(torch, np, dev, src, runs)
    finally:
        stop_dry_runs(runs)
    for entry, name in zip(kernels, ("pagewalk", "paged_attention",
                                     "flash_attention")):
        entry["mesh_launches"] = mesh_launches[name]
    torch.cuda.empty_cache()
    # last: after CUDA graphs were captured and traced in a process, a
    # later trace of the pagewalk calls there held no spin kernels
    # (PERF.md §7)
    hext_phase(torch, dev)
    # the fleet operations on the graph engine: torture, guest operations,
    # the service
    for fleet_phase in (torture_phase, guest_phase, service_phase):
        t0 = time.perf_counter()
        fleet_phase(torch, dev)
        torch.cuda.empty_cache()
        phase(fleet_phase.__name__[:-len("_phase")],
              phase_wall_s=f"{time.perf_counter() - t0:.1f}")
    phase("smoke", wall_s=f"{time.perf_counter() - t_start:.1f}")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
