"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # R19 (rmat-19-32), the paper's graph size
    python3 chip_smoke.py --scale 12 # a quick run on a small RMAT graph
    python3 chip_smoke.py --phases train  # development: the build, then 4i only

``--phases`` (a comma-separated subset of ``PHASES``) runs only those phases
after the device and the build; the ``kernels`` line then names only the
kernels they ran. With no argument every phase runs.

Phases (any failure raises and exits nonzero; no phase's error is caught):

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles every CUDA source of ``src/repro_torch/csrc`` at once
   (one ``nvcc`` each) and prints the build time and ``ptxas`` resources.
3. Kernels: holds each hand-written kernel against its plain PyTorch
   version on the card, at the reference test shapes and at the main
   path's own shape (the R19 graph's dst-sorted edge stream), checks that
   a float ``+`` gives the same bits on two runs, and times kernel, plain
   version and (where one exists) a single PyTorch library call with CUDA
   events (an attention row names the backend SDPA's dispatcher takes,
   ``library_backend``). ``edge_stream`` runs with the work list the bind built (its
   longest bin, chunks, work items and build time are printed), gets its
   device time (both of its kernels) from profiler events, and is also
   held to its plain version on a skewed stream (one bin of 2^20 edges,
   bins around the chunk length, empty bins) under every dtype, apply and
   op. ``shuffle_reduce`` runs at the main shape with the bind's work list
   (as the engine's full-stream commits do) and with the list built per
   launch on the device (both lists' facts are printed), and is held to
   its plain version on the skewed stream (through both lists) and on the
   one-bin counter stream (a broadcast index, its list sized on the host)
   under every dtype and op; the per-launch and stride-0 routes then run
   once under ``torch.cuda.set_sync_debug_mode("error")``, so a read back
   to the host fails the run.
   The LM kernels (flash attention, MoE gather) are held to theirs at the
   reference test shapes and at the LM path's shapes: Kimi-K2's decode
   attention over the KV cache and a prefill-size causal attention, its
   decode dispatch and a 4096-token prefill dispatch. Attention runs every
   route the wrapper takes by dtype and shape: bfloat16 through the
   tensor-core (sm90) kernel, float32 through the CUDA-core kernel's decode
   route (few query rows per kv head) or its tile route; each call's route
   is read from the three launch counters. Each bf16 row gives the
   instantiation it ran at and its row form (``sm90``: 64 rows a block, one
   consumer warpgroup, or 128, two), ``kernel_over_library`` and its share
   of the bound; the build phase prints the tensor-core forward's
   registers, spills and dynamic shared memory per instantiation and form
   (a spill fails the run) and ptxas's notes where it serialises wgmma.
   The float32 decode route also runs at qwen3-0.6b's decode shape (its
   [4, 32, 8, 128] cache read in place) and over a 4,096-key cache, each
   with its splits, the same bits on two calls and the ``ptxas``
   resources of its two kernels; at the long
   cache a fault control (the splits folded without their exp(m_s - m)
   weights, in plain PyTorch) must fail the float32 check. A route sweep
   times both float32 routes at 2-32 query rows a kv head (the threshold's
   measurement). The float32 tile route (every instantiation's ``ptxas``
   registers, spills and shared memory in the build phase; a spill at Dh <=
   128 fails the run) also runs at qwen3-0.6b's 16-token forward shape,
   and at the 2048-token prefill row gives its device time, its tile plan,
   the same bits on two calls and a fault control (its schedule in plain
   PyTorch without the per-tile rescale) that must fail the float32 check.
   The batched launches
   (16 rows over the bind's edges, offsets and list) of ``shuffle_reduce``
   (f32 ``+``, i32 min, i32 ``|``, a row stride of 0) and ``edge_stream``
   (i32 add/min with shared weights, f32 src/``+``, i32 src/``|``) are
   held to their plain versions and bit for bit to 16 one-row launches.
   The decode-shaped rows
   also get their device time, read from profiler kernel events, beside
   the host-paced loop's time; so do both MoE gather rows.
4. Graph path: ``repro_torch.compile(src).bind(g).run(**params)`` on the
   card for BFS_ECP, PAGERANK and SSSP (one cold run, then five warm
   runs whose median is the warm time), each checked
   against an independent numpy/scipy oracle, with both graph kernels'
   launch counters set to 0 before and read after. One more warm run of
   each program under ``torch.profiler`` then shows where its time goes:
   the device's busy and idle share and the kernels that took the most
   time, and one more the device time of each ``shuffle_reduce`` call by
   its shape (bins, updates): every kernel of ``csrc/shuffle_reduce.cu``
   the call ran (the list, the main kernel, the fold), summed.
   Then the batched path, ``bind_batch(g).run_many(sets)``: BFS_ECP at K =
   64 roots by the bit-packed multi-source path, BFS_ECP (``msbfs=False``)
   and SSSP at K = 16 roots, PAGERANK at K = 16 with ``iters`` drawn from
   16-20 (root 0 and the rest drawn from the seed); each sized first, one
   cold and three warm batches with both graph kernels' counters set to 0
   just before and read just after, every lane bit-identical to a
   sequential ``Session.run``, the root-0 lane equal to the oracle,
   MS-BFS's launches at most a quarter of the sequential ones; queries/s
   beside K x the sequential warm median, launches, edges, one profiled
   batch's busy and idle share, peak memory.
   Then (4c, ``{"phase": "artifacts", ...}`` lines) the accelerator
   artifacts: BFS_ECP, PAGERANK and SSSP through ``compile(src).lower(graph=
   g)`` -> ``report()`` -> ``save`` -> ``load_accelerator`` (every kernel
   ``aot-loaded``: the build phase built the libraries) -> ``bind(g)``, one
   cold and five warm runs, each bit-identical to the main phase's warm run
   (properties, host scalars, launch counts); lower, save, load and bind
   seconds, the bind's allocated bytes beside the report's state and graph
   plan. BFS_ECP's loaded accelerator is rebound to a twin graph of the
   bucket (seed + 1): its first run equals the oracle and pays compile time
   exactly when it touches a frontier pad that no earlier bind touched.
   The script then runs itself with ``--load-artifact DIR`` as a fresh
   process (load, bind, one BFS_ECP run; no ``nvcc``, the same levels'
   hash). Last, under ``repro_torch.telemetry``, one traced run of each
   program: span counts, host seconds per ``launch:<kernel>`` and of the
   ``run`` span (every launch span descends from it, one per launch), a
   Chrome trace that parses, traced against untraced warm runs
   interleaved (the tracer's cost), and one traced run under the profiler
   (its launch spans' host seconds beside its device busy time). Both
   graph kernels' counters are set to 0 before the phase and read after.
   Then (4d, ``{"phase": "streaming", ...}`` lines) streaming updates: a
   graph padded to its geometric bucket (R19's is 661,395 x 19,719,866: the
   padding edges are self-loops on one vertex) behind a
   ``StreamingSession`` bound from ``program.lower(graph=g, bucket=True)``,
   for BFS_ECP and SSSP under ``Target(cache=False)`` on R19, and SSSP,
   WCC and PAGERANK on rmat(16, 32) (their R19 binds cut for time). One
   additions-only delta of 4,096 edges drawn from the seed
   (SSSP's weights 1-63); the next query must be a host repair (PAGERANK:
   a full run), bit-identical to a full run on the card at that version
   (``ss.session.run``), equal to the oracle on the updated graph's real
   edges (WCC's: scipy's weak components, each labelled by its smallest
   lane id, the degree rank under the hub relabel), and a full run must
   lower nothing (a new warm key only for a frontier pad touched first;
   an unseen root as well). BFS_ECP then takes a removal delta of 64
   real edges (a full run, equal to the oracle); BFS_ECP's and uncached
   SSSP's refreshed bindings, the work list included, must equal those
   of the accelerator bound to the updated graph afresh, tensor for
   tensor, and its run theirs. Each line gives the bind, the update's
   seconds (``apply_updates``, ``refresh_graph``, the rest), the query's
   and the full runs' seconds (a first and five warm), a profiled full
   run's device busy time before and after the update, the work list's
   chunks, launches (both counters set to 0 before each program) and
   peak memory.
   Then (4e, ``{"phase": "serving", ...}`` lines) the served graph query:
   ``repro_torch.analyze`` over the eight sources and the two embedded
   twins (no error), a racy program refused by ``service.submit`` with
   ``ProgramRejected`` before the registry sees it; a cold
   ``repro_torch.serve(dir)`` (2 workers, ``max_batch=8``, tenants a:2,
   b:1) answers 64 BFS_ECP, 16 SSSP and 4 PAGERANK requests submitted at
   once, then the same requests again on the resident entries, every
   answer bit for bit the main phase's session run of the same
   parameters and four of them the oracles' (p50/p99 per program and
   tenant, queries/s, each entry's bind seconds, the stats snapshot,
   peak memory); ``BFS_ECP_EMBEDDED`` lands on the BFS entry; a second
   service on the same store answers from the warm artifact (no
   lowering, no ``nvcc``). ``AutoTuner`` (its defaults) searches BFS_ECP
   and SSSP on rmat(16, 16) (a trial is a bind: not R19): trials, prune
   notes, the winner, its speedup, its objective beside a profiled traced
   run's device busy time; a fresh tuner makes no trial, ``lower(tuned=
   True)`` stamps the manifest, and a service with the lookup on counts
   ``tuned_hits`` and answers as the base target does. Last, ``python -m
   repro_torch.launch.serve --graph bfs --queries 16 --pool 2`` runs as a
   child. Both counters are set to 0 after the reference answers.
   Then (4f, ``{"phase": "distributed", ...}`` lines) the distributed
   engine: ``Target(kind="distributed", n_devices=4)``, its four shards
   on the one card (every shuffle copy stays on it; no link between cards
   is measured). BFS_ECP, SSSP and PAGERANK (iters 20) on the R19 graph:
   one bind, one cold run (it partitions the graph), five warm runs;
   BFS_ECP and SSSP bit for bit the main phase's single-device runs,
   PAGERANK within ``rtol=1e-5, atol=1e-6`` of it, within the oracle's
   tolerance and the same bits on two runs; equal launches, one superstep
   per launch of a distributable edge stage. Each line gives the
   partition seconds, the edges per shard, the reference's padded slots
   and bytes beside the stored ones, the warm median beside the main
   phase's, ``shuffle_reduce`` launches beside supersteps x 4, a profiled
   warm run, the device time of one superstep's stages (apply, the
   shuffle's copies, the reduce) beside a single-device full launch of
   the same kernel on the same state (its update equal to the
   superstep's, and four ``shuffle_reduce`` launches a superstep), and
   peak memory; one PAGERANK iteration runs under
   ``torch.cuda.set_sync_debug_mode("error")``. BFS_ECP on one shard (bit
   for bit), PAGERANK batched at K = 16 on the same engine (every lane a
   sequential distributed run's bits, one superstep a round; queries/s
   beside the batch phase's). On rmat(16, 16): a distributed
   ``StreamingSession`` repair after a 4,096-edge addition equals a full
   distributed run, ``repro_torch.serve(dir, backend="distributed")``
   answers 16 BFS_ECP roots as a single-device session does, and the
   serving CLI runs with ``--backend distributed`` as a child. Both
   counters are set to 0 at its start.
   The graph sessions are freed after it.
5. LM path: ``launch.serve.generate`` on Kimi-K2 at full width with its
   depth cut to 2 layers (1 dense + 1 MoE, random weights from the seed,
   bf16), batch 4, prompt 16, generate 16 (the CLI defaults), twice,
   with the LM kernels' launch counters set to 0 before and read after:
   the two runs must give the same tokens and the logits must be finite.
   Then qwen3-0.6b at its full config in float32: decode logits at every
   prompt position must agree with the whole-sequence forward; every
   one-query attention of its decode steps (2,240) must take the decode
   route and the 16-token forward's 28 the tile route.
   Then qwen3-0.6b at its full config in bf16: one ``Model.forward`` over
   batch 4 x 2048 prompt tokens (wall time, device busy time and the
   tensor-core attention's share of it, launches, peak memory), after the
   kernel is held to its plain version at exactly that attention shape.
   Then the same forward in float32 (``lm_prefill_f32``): 28 tile-route
   launches asserted, none of the decode route or the sm90 kernel, the
   tile route held to its plain version at that attention shape, the same
   bits on two calls, its share of the forward's device time beside the
   attention's bound.
   Then (4g, ``{"phase": "lm_families", ...}`` lines) the attention
   families beyond the dense and GQA-MoE ones, every model with random
   weights from the seed and the LM counters set to 0 just before it and
   read just after. First the tensor-core kernel at their widths, each row
   held to its plain version and timed beside its bound and SDPA (same
   scale): h2o-danube's windowed prefill (Dh 120), hubert's bidirectional
   frames (Dh 80), deepseek-v2's MLA prefill ((Dqk, Dv) = (192, 128)) and
   its absorbed decode over 32 and 4,096 latent slots ((576, 512), the
   values a view of the keys). Then deepseek-v2 at full width, depth cut
   to 2 (1 dense + 1 MoE layer), bf16: ``generate`` twice (the same
   tokens), a forward over 1 x 2048 tokens, sm90 and MoE gather launches;
   one MLA layer at full width in float32, its forward against 64
   absorbed decode steps. h2o-danube-3 at its full config: ``generate``
   twice in bf16; in float32, its depth cut to 4 layers, a teacher-forced
   decode of 4,160 tokens into an 8,192-token cache (a 4,096-slot ring
   that wraps) against one windowed forward, every step within ``2e-3 *
   max(1, |logits|)``.
   qwen2-vl at its full config on seeded patch embeddings: a bf16 forward
   over [4, 2048, 1536]; in float32, 16 decode steps on embeddings against
   the forward. hubert-xlarge at its full config: a bidirectional bf16
   forward over [4, 1000, 1280] frame embeddings, twice, the same bits.
   Then (4h, ``{"phase": "ssm_families", ...}`` lines) the recurrent
   families, random weights from the seed, the LM counters set to 0 just
   before each model and read just after. First the tensor-core kernel at
   zamba2's shared attention, bf16 [4, 32, 2048, 80] causal under its
   4,096-token window, held to its plain version (with the row-relative
   check and its controls) and timed beside its bound and SDPA, and the
   float32 tile and decode routes at the shapes zamba2's f32 check gives
   them. Then zamba2-2.7b at its full config (54 Mamba2 blocks in 9
   groups, each followed by the one shared attention block), bf16:
   ``generate`` twice (the same tokens, 9 sm90 launches a step), a forward
   over [4, 2048] tokens (timed, finite, 9 sm90 launches), one decode step
   and one forward profiled; in float32 at full depth, 64 teacher-forced
   decode steps against one forward, each within ``2e-3 * max(1,
   |logits|)`` (9 tile-route and 64 x 9 decode-route launches).
   xlstm-125m at its full config: ``generate`` twice in bf16 (the same
   tokens, no attention launch); in float32 a forward over [4, 2048]
   (timed: the sLSTM steps through every position) against 64 decode
   steps within the same tolerance. For zamba2, the forward's two forms
   of the SSD's products, in place (serving) and out of place (grad mode,
   no graph), each timed with its transient peak memory.
   Then (4i, ``{"phase": "train", ...}`` lines) training. First the
   backward kernels (bf16: ``csrc/flash_attention_bwd_sm90.cu`` on the
   tensor cores, with the log-sum-exp the tensor-core forward saves; f32:
   ``csrc/flash_attention_bwd.cu`` on the CUDA cores, with the one the
   tile route saves; the build phase prints each f32 kernel's registers,
   spills and the block's shared memory, and a spill fails the run) at
   qwen3-0.6b's layer (bf16 and f32 [4, 16, 2048, 128], kv 8, causal),
   deepseek-v2's MLA (bf16 and f32 [2, 128, 1024, (192, 128)]), zamba2's
   width under a window
   that hides keys (bf16 [2, 32, 2048, 80], window 512) and hubert's
   bidirectional frames (bf16 [2, 16, 1024, 80]): dq, dk and dv held to
   the plain twin on the card (bf16 by a row-relative rule, float32 by
   max |err| / max |g|), the same bits twice, fault controls that must
   fail (a key tile dropped from P; for float32 also the twin on
   bf16-rounded inputs), the time beside the bound of the least work (2 *
   (3 Dqk + 2 Dv) FLOPs a visible pair, or q, k, v, out, dout read and
   dq, dk, dv written once) and SDPA's backward alone on a retained graph
   (queued CUDA events, backend named); each row also gives its time on
   the first CUDA-core backward (where it was timed), its
   factor against SDPA's backward and the ``ptxas`` registers and spills
   of the instantiation it ran, and holds the forward's output with its
   log-sum-exp to the same bits as without; the f32 rows give their tiles
   and the bytes of their dQ parts; the gather's transpose at deepseek-v2's dispatch, bit
   for bit its twin, beside its byte bound and ``index_add_``. Then
   qwen3-0.6b at its full config in bf16 through
   ``repro_torch.launch.train.main``: 10 steps of [4, 2048] tokens in two
   microbatches, remat on; every loss and grad norm finite, step 0's loss
   within 1.0 of ln(vocab), the last below the first, 28 x 2 backward and
   twice as many forward attention launches a step (remat); step time,
   tokens/s, peak memory and a profiled step with the backward kernels'
   share of its device busy time. The f32 gradient of qwen3 at
   full width cut to 2 layers ([1, 128] tokens) on the card against the
   CPU's, each parameter within 1e-3 of its max. deepseek-v2 at full width
   cut to 2 layers, one bf16 step with 8-bit moments on [2, 1024] tokens:
   finite, the gather's backward launched, every attention backward at
   (192, 128). Last, checkpoints through the CLI (``--smoke`` on the
   card): a 6-step run resumed to 8 steps at step 6, an 8-step run
   restarted from its step-6 checkpoint equal to it uninterrupted (lines
   and final checkpoint, bit for bit), and the manager's round trip of
   bf16 weights and 8-bit moments on the card.
6. The last line is ``{"ok": true, "device": {...}}``.

"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
SSSP_INF = 1073741823  # the SSSP program's INF
EDGE_FACTOR = 32  # edges per vertex of the paper's RMAT graphs (rmat-19-32)
WARM_RUNS = 5  # warm runs per program; warm_s is their median (host clocks vary)
PAGERANK_RTOL = 1e-4  # float32 engine vs float64 oracle after 20 iterations
PAGERANK_ATOL = 1e-10
FA_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}  # tests/test_kernels.py's tolerances
# bf16 attention at the path's shapes, beside FA_TOL: max over rows of
# max |kernel - plain| / rms(plain row), the plain version in float32 on the
# same bf16 inputs. It sits between the sound kernel's reading and those of
# the controls (P rounded to fp8, a key tile dropped or doubled), which every
# run computes and requires to fail it (PERF.md has the readings).
ROW_REL_TOL = 5e-2
CONTROL_KEYS = (1024, 1088)  # the key tile a control drops or doubles
KIMI, KIMI_LAYERS = "kimi-k2-1t-a32b", 2  # full width, depth cut to 1 dense + 1 MoE layer
QWEN = "qwen3-0.6b"  # the serving CLI's default arch, full config
LM_BATCH, LM_PROMPT, LM_GEN = 4, 16, 16  # the serving CLI's defaults
PREFILL_LEN = 2048  # qwen3-0.6b bf16 forward: batch LM_BATCH x PREFILL_LEN prompt tokens
PREFILL_RUNS = 3  # timed forwards after one warm-up; the median is kept
SKEW_HUB = 2**20  # edges (updates) of the one long bin in the skewed cases
COUNTER_UPDATES = 2**19  # the one-bin counter: R19's |V| updates into |V| bins
DECODE_RTOL = 2e-3  # decode vs forward, tests/test_models.py's own tolerance
LONG_CACHE = 4096  # keys of the float32 decode route's long-cache row (qwen3-0.6b heads)
BATCH_K = 16  # queries a batch (generic path) and rows of the batched kernel checks
ROWS_PARTIAL = 13  # rows of the batched edge_stream check whose last group is partial
BATCH_WARM_RUNS = 3  # warm batches per run; the median is kept
BATCH_MSBFS = "__msbfs__"  # kernel_launches key of the multi-source BFS path
STREAM_DELTA = 4096  # edges of each additions-only delta of the streaming phase
STREAM_ADD_DELTAS = 1  # additions-only deltas a program (BFS_ECP's cut from 2 for time)
STREAM_REMOVE = 64  # real edges of BFS_ECP's removal delta
STREAM_SMALL_SCALE = 16  # cached SSSP's, WCC's and PAGERANK's streaming graph: rmat(16, 32)
DIST_DEVICES = 4  # shards of phase 4f's distributed target (on one card they share it)
DIST_SMALL_SCALE = 16  # phase 4f's streaming, serving and CLI graph: rmat(16, 16)
# a distributed float sum against the single-device one: PAGERANK's values
# are about 1/V (1.9e-6 at R19), so atol stays three decades below them
DIST_RTOL, DIST_ATOL = 1e-5, 1e-9
PADDED_SLOT_BYTES = 13  # the reference's [D, D, Emax] buckets: src, dst, weight, valid
# phase 4g: the attention families beyond the dense and GQA-MoE ones
DEEPSEEK, DEEPSEEK_LAYERS = "deepseek-v2-236b", 2  # full width, 1 dense + 1 MoE layer
H2O, QWEN2VL, HUBERT = "h2o-danube-3-4b", "qwen2-vl-2b", "hubert-xlarge"
FAMILY_PREFILL = 2048  # tokens of deepseek-v2's forward, patches of qwen2-vl's
HUBERT_FRAMES = 1000  # frames of hubert's forward (20 s of audio at 50 frames a second)
MLA_CHECK_POSITIONS = 64  # positions of the f32 MLA layer's decode-vs-forward check
WRAP_TOKENS, WRAP_CACHE = 4160, 8192  # h2o-danube's f32 ring run: 64 steps past the wrap
# its depth, cut from 24: at 31 ms a step (the host's launches, ~1.2 ms a
# layer) the full depth took 129 s of the phase's 150 on the H100
WRAP_LAYERS = 4
# phase 4h: the recurrent families (zamba2: Mamba2 + one shared attention block; xLSTM)
ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-125m"
SSM_PREFILL = 2048  # tokens a row of the bf16 zamba2 forward and the f32 xLSTM forward
SSM_CHECK_POSITIONS = 64  # teacher-forced decode steps held to a forward, f32
SSM_FORWARD_RUNS = 2  # timed bf16 zamba2 forwards after one warm-up; the median is kept


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches (CUDA events,
    after a warm-up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: the ptxas entries of csrc/flash_attention.cu, as the build phase read them
FA_PTXAS: list = []
PROFILE_TRIES = 3  # profiled windows a measurement may take before it times with events
#: every profiled window of the run and those that missed kernels (window
#: index, kernel events seen), printed in the ``done`` line; ``stale``: the
#: last measurement's windows all missed, so the next takes one window
PROFILE_WINDOWS = {"windows": 0, "missed": [], "stale": False}


def profiled(run, seen_all=bool, tries: int = PROFILE_TRIES):
    """``run()`` (which launches kernels) under ``torch.profiler``, ended by
    a synchronise: returns the profile, its CUDA kernel events and the
    window's host time.

    The profiler now and then reports no device event for a window that
    launched kernels, and on the card's machine, late in a long process,
    it stopped reporting the kernels of short windows altogether (the
    Kineto log counted them "out of range"; a pause of up to 1 s around
    the window did not bring them back), while long windows kept nearly
    all. So a window whose events fail ``seen_all`` (by default: none at
    all) is recorded and run again, up to ``tries`` windows (one after a
    measurement whose windows all missed); then it returns ``(None, None,
    wall_s)`` and the callers measure without it. No check of the run
    reads a profile."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(1 if PROFILE_WINDOWS["stale"] else tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        PROFILE_WINDOWS["windows"] += 1
        if seen_all(kernels):
            PROFILE_WINDOWS["stale"] = False
            return prof, kernels, wall_s
        PROFILE_WINDOWS["missed"].append([PROFILE_WINDOWS["windows"], len(kernels)])
        print(f"chip_smoke: profiler window {PROFILE_WINDOWS['windows']} saw {len(kernels)} "
              "kernel events", file=sys.stderr)
    PROFILE_WINDOWS["stale"] = True
    return None, None, wall_s


QUEUE_HOLD_CYCLES = 100_000_000  # ~50 ms of the card's clock: the host queues the calls meanwhile


def queued_event_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` without the profiler: the stream
    is held by a sleep kernel while the host queues ``iters`` calls, each
    between two CUDA events, so the card runs them back to back and each
    pair of events brackets one call's kernels, not the host's launch
    gaps; less the same pairs' time with nothing between them (the events'
    own cost). ``fn`` must not synchronise."""
    def bracketed(call) -> float:
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_HOLD_CYCLES)
        for start, end in pairs:
            start.record()
            call()
            end.record()
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in pairs) / iters

    return bracketed(fn) - bracketed(lambda: None)


def device_ms(fn, iters: int = 20, warmup: int = 3, focus: str = None) -> dict:
    """Mean device time of one ``fn()`` over ``iters`` calls: the summed
    durations of the kernels it launched, from ``torch.profiler`` kernel
    events, so the host's time between launches is left out; ``focus_ms``
    sums only the kernels whose name holds ``focus``. Where the profiler
    missed the calls' kernels, :func:`queued_event_ms` measures them
    (``"timing": "events"``, no kernel names, no ``focus_ms``)."""
    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(iters):
            fn()

    _, kernels, _ = profiled(calls, seen_all=lambda k: len(k) >= iters)
    if kernels is None:  # no kernel events: the calls' device time by queued CUDA events
        return {"ms": queued_event_ms(fn, iters), "kernels_per_call": None,
                "kernels": [], "focus_ms": None, "timing": "events"}
    names = sorted({e.name[:80] for e in kernels})
    out = {"ms": sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3,
           "kernels_per_call": len(kernels) / iters, "kernels": names}
    if focus is not None:
        out["focus_ms"] = sum(e.time_range.elapsed_us() for e in kernels
                              if focus in e.name) / iters / 1e3
    return out


def profile_run(run, top: int = 6, focus: str = None) -> dict:
    """One more warm ``run()`` under ``torch.profiler``: its wall time, the
    time the device was busy (kernel intervals merged), and the kernels
    that took the most device time. The profiler slows the host, so the
    idle share it gives is an upper bound of the unprofiled run's."""
    prof, kernels, wall_s = profiled(run)
    if kernels is None:
        return {"wall_s": wall_s, "device_kernels": None, "device_busy_s": None,
                "device_idle_share": None, "top_kernels_ms": {}, "focus_ms": None,
                "profiler": "no kernel events"}
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # host side: time inside PyTorch ops (the rest of the wall time is the
    # Python interpreter and the profiler itself)
    ops = [(e.key, e.self_cpu_time_total) for e in prof.key_averages()]
    top_ops = sorted(ops, key=lambda kv: -kv[1])[:top]
    out = {
        "wall_s": wall_s, "device_kernels": len(kernels), "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top_k},
        "host_ops_s": sum(us for _, us in ops) / 1e6,
        "top_host_ops_ms": {name[:80]: us / 1e3 for name, us in top_ops},
    }
    if focus is not None:
        us = sum(t for name, t in by_name.items() if focus in name)
        out.update({"focus": focus, "focus_ms": us / 1e3,
                    "focus_share_of_busy": us / busy_us if busy_us else None})
    return out


def shuffle_reduce_launches(sr, run) -> list:
    """One more warm ``run()`` with the shape and route of each
    ``shuffle_reduce`` call recorded (the module's function wrapped for this
    run only) and matched, in call order, with its device time from
    profiler kernel events: every kernel of ``csrc/shuffle_reduce.cu`` the
    call ran, summed (a per-launch list's kernel comes before the main
    kernel, the fold after it; the routing step's PyTorch ops are not in
    it). Returns one entry per shape (bins, updates, dtype, op, route): its
    calls, their mean and total device time, largest total first, and the
    bound of one call."""
    shapes = []
    inner = sr.shuffle_reduce_sorted

    def recording(vals, offsets, n_out, op, split=None):
        if n_out > 0:  # the wrapper launches nothing for no bins
            route = ("given list" if split is not None else
                     "per-launch list" if sr.split_windows(vals.shape[0]) else "no list")
            shapes.append((n_out, vals.shape[0], str(vals.dtype).split(".")[-1], op, route))
        return inner(vals, offsets, n_out, op, split)

    def recorded_run():
        shapes.clear()  # a window the profiler saw nothing of runs again
        run()

    def mains(kernels):
        return [e for e in kernels if "shuffle_reduce_kernel" in e.name]

    sr.shuffle_reduce_sorted = recording
    try:
        _, kernels, _ = profiled(recorded_run, seen_all=lambda k: len(mains(k)) == len(shapes))
    finally:
        sr.shuffle_reduce_sorted = inner
    if kernels is None:
        return []
    calls, pending = [], 0.0
    for e in sorted((e for e in kernels if "shuffle_reduce_" in e.name),
                    key=lambda e: e.time_range.start):
        us = e.time_range.elapsed_us()
        if "shuffle_reduce_list_kernel" in e.name:
            pending += us
        elif "shuffle_reduce_kernel" in e.name:
            calls.append(pending + us)
            pending = 0.0
        else:  # the fold, after its call's main kernel
            calls[-1] += us
    groups: dict = {}
    for shape, us in zip(shapes, calls):
        groups.setdefault(shape, []).append(us / 1e3)
    # bound: each update read once, each offset read once, each bin written once
    out = [{"bins": k[0], "updates": k[1], "dtype": k[2], "op": k[3], "route": k[4],
            "launches": len(v), "device_ms_mean": sum(v) / len(v), "device_ms_total": sum(v),
            "bound_ms": bound(4 * k[1] + 4 * (k[0] + 1) + 4 * k[0], k[1])[0]}
           for k, v in groups.items()]
    return sorted(out, key=lambda r: -r["device_ms_total"])


def bound(n_bytes: int, n_ops: int, ops_per_s: float = F32_OPS_PER_S):
    """Least time the card could take: bytes over HBM rate vs operations
    over the peak rate of their type (float32 by default); returns (ms,
    which one bounds)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_kernels(log_text: str) -> list:
    """Each entry function of a ``ptxas -v`` log: its mangled name, head
    dim (the first integer template argument), registers and spill bytes."""
    rows: list = []
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            dh = re.search(r"ILi(\d+)E", m.group(1))
            rows.append({"entry": m.group(1), "dh": int(dh.group(1)) if dh else None})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and rows:
            rows[-1]["spill_store_bytes"] = int(m.group(1))
            rows[-1]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def register_occupancy(registers: int, threads: int = 256) -> float:
    """Theoretical occupancy (resident warps over the SM's 64) that a
    kernel's register count allows at ``threads`` a block on sm_90: 65,536
    registers an SM, allocated 256 at a time per warp, whole blocks only."""
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(32, (65536 // per_warp) // (threads // 32))
    return min(64, blocks * threads // 32) / 64


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def f32_sum_tolerance(vals: torch.Tensor, ids: torch.Tensor, n_out: int) -> torch.Tensor:
    """Per-bin bound on |kernel - plain| for a float32 sum of n_b terms
    taken in two orders: each order errs by at most (n_b + 5) * 2^-24 *
    sum|v| (sequential or 32-lane strided plus a 5-level tree), so the two
    differ by at most twice that."""
    ids = ids.long()
    cnt = torch.zeros(n_out, dtype=torch.float64, device=vals.device)
    cnt.index_add_(0, ids, torch.ones_like(vals, dtype=torch.float64))
    abs_sum = torch.zeros(n_out, dtype=torch.float64, device=vals.device)
    abs_sum.index_add_(0, ids, vals.abs().double())
    return 2.0 * (cnt + 5.0) * 2.0**-24 * abs_sum


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor, op: str,
                tol: torch.Tensor = None) -> float:
    """Exact for min/max and int32; float32 + within ``tol`` per bin."""
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape)
    if got.dtype == torch.float32:
        finite = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), finite), f"{name}: non-finite bins differ"
        assert torch.equal(got[~finite], want[~finite]), f"{name}: infinite bins differ"
        err = (got.double() - want.double()).abs()
        err = torch.where(finite, err, torch.zeros_like(err))
        if op == "+":
            assert tol is not None
            bad = int((err > tol).sum())
            assert bad == 0, f"{name}: {bad} bins outside the float-sum bound"
        else:
            assert float(err.max()) == 0.0, f"{name}: not exact"
        return float(err.max()) if err.numel() else 0.0
    assert torch.equal(got, want), f"{name}: not exact"
    return 0.0


def kernel_tests(sr, es, ref, dev: str) -> dict:
    """The reference test shapes (tests/test_kernels.py), kernel vs plain."""
    rng = np.random.default_rng(0)
    n_cases = 0
    max_err = {"shuffle_reduce": 0.0, "edge_stream": 0.0}
    for n, v in [(64, 16), (1000, 300), (4096, 512), (513, 1024), (7, 5)]:
        for op in ("+", "min", "max"):
            for dtype in (np.float32, np.int32):
                # indices up to v + 10: the out-of-range ones are dropped
                idx = torch.from_numpy(rng.integers(0, v + 10, n).astype(np.int32)).to(dev)
                vals = torch.from_numpy(rng.integers(-50, 50, n).astype(dtype)).to(dev)
                got = sr.shuffle_reduce(vals, idx, v, op)
                want = ref.shuffle_reduce_ref(vals, idx, v, op)
                tol = torch.zeros(v, dtype=torch.float64, device=dev)  # integer-valued: exact
                err = check_equal(f"shuffle_reduce n={n} v={v} {op} {dtype.__name__}",
                                  got, want, op, tol)
                max_err["shuffle_reduce"] = max(max_err["shuffle_reduce"], err)
                n_cases += 1
    # empty bins hold the identity
    out = sr.shuffle_reduce(torch.tensor([1.0, 2.0, 3.0], device=dev),
                            torch.tensor([2, 2, 2], dtype=torch.int32, device=dev), 5, "min")
    assert out[2].item() == 1.0 and torch.isinf(out[0]) and torch.isinf(out[4])
    n_cases += 1
    for e, v in [(128, 32), (3000, 400), (5000, 123)]:
        for apply_op in ("add", "mul", "src"):
            for op in ("+", "min", "max"):
                sv = torch.from_numpy(rng.normal(size=e).astype(np.float32)).to(dev)
                w = torch.from_numpy(rng.normal(size=e).astype(np.float32)).to(dev)
                dst = torch.from_numpy(rng.integers(0, v, e).astype(np.int32)).to(dev)
                act = torch.from_numpy(rng.random(e) < 0.4).to(dev)
                got = es.edge_stream(sv, w, dst, act, v, apply_op, op)
                want = ref.edge_stream_ref(sv, w, dst, act, v, apply_op, op)
                upd = ref._apply(apply_op, sv, w)
                tol = f32_sum_tolerance(torch.where(act, upd, 0.0), dst, v)
                err = check_equal(f"edge_stream e={e} v={v} {apply_op} {op}", got, want, op, tol)
                max_err["edge_stream"] = max(max_err["edge_stream"], err)
                n_cases += 1
    return {"cases": n_cases, "max_abs_err": max_err}


def split_facts(sr, split, offsets: torch.Tensor, n_e: int) -> dict:
    """What the bind's work list for edge_stream holds, and what building
    it costs: the median host time (ending in a synchronise) of three more
    builds from the same offsets, which must give the same list. The
    kernel's work items are the chunks, then the bins in quads of four
    (csrc/edge_stream.cu)."""
    build_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = sr.split_bins(offsets, n_e)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        assert all(torch.equal(a, b) for a, b in zip(again, split)), "work list differs"
    n_chunks, n_out = split.chunks.shape[0], offsets.shape[0] - 1
    n_b = offsets.clamp(0, n_e).diff().clamp(min=0)
    quad_max = torch.cat([n_b, n_b.new_zeros(-n_out % 4)]).view(-1, 4).amax(dim=1)
    return {"split_len": sr.SPLIT_LEN, "longest_bin": int(n_b.max()),
            "split_bins": split.bins.shape[0], "chunks": n_chunks,
            "work_items": n_chunks + quad_max.shape[0],
            "short_quads": int((quad_max <= 32).sum()),  # walked 8 lanes a bin
            "build_ms": statistics.median(build_s) * 1e3}


def list_facts(sr, bind_split, launch_split) -> dict:
    """What the two work lists of one stream hold: the bind's (split bins,
    chunks) and the per-launch one's capacity (chunk and bin slots, fixed by
    the stream's length) against the slots it uses, which must be the
    bind's list in slot order."""
    used = launch_split.chunks[:, 0] >= 0
    assert torch.equal(launch_split.chunks[used], bind_split.chunks), "per-launch list differs"
    assert torch.equal(launch_split.bins[launch_split.bins >= 0], bind_split.bins)
    return {"split_len": sr.SPLIT_LEN, "split_bins": bind_split.bins.shape[0],
            "chunks": bind_split.chunks.shape[0],
            "per_launch_chunk_slots": launch_split.chunks.shape[0],
            "per_launch_chunk_slots_used": int(used.sum()),
            "per_launch_bin_slots": launch_split.bins.shape[0]}


def skewed_shuffle_reduce(sr, ref, dev: str) -> dict:
    """shuffle_reduce on streams built to cross its work list, kernel vs
    plain under every dtype and op: exact for int32, min and max, float32 +
    within f32_sum_tolerance and the same bits on two calls.

    * The skewed stream: one bin of SKEW_HUB updates, bins of L-1, L, L+1,
      2L and 2L+1 updates (L = SPLIT_LEN), bins around the one-lane length
      (64, 65), empty bins and a uniform rest of 0-90 updates a bin, through
      the bind's list (``split_bins``) and the per-launch one.
    * The one-bin counter: COUNTER_UPDATES updates into as many bins through
      a broadcast index (``activeVertex[0] = activeVertex[0] + 1``), whose
      list is sized on the host.

    Then the routes that build or size their list per call (per-launch,
    stride-0, and the unsorted wrapper with its sort) run once under
    ``torch.cuda.set_sync_debug_mode("error")``: a read back to the host
    raises, and the run fails."""
    big = sr.SPLIT_LEN
    rng = np.random.default_rng(3)
    counts = np.concatenate([[0, SKEW_HUB, 0, big - 1, big, big + 1, 0, 2 * big, 2 * big + 1,
                              64, 65, 0], rng.integers(0, 91, 60_000)])
    n_out, n = counts.shape[0], int(counts.sum())
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)).to(dev)
    ids = ref.bin_ids(offsets)
    bind_split = sr.split_bins(offsets, n)
    n_c = COUNTER_UPDATES
    one = torch.tensor(5, dtype=torch.int32, device=dev).expand(n_c)
    c_offsets = sr.route(one, n_c)[1]
    c_ids = ref.bin_ids(c_offsets)
    n_cases, max_err = 0, 0.0
    for dtype in (torch.int32, torch.float32):
        if dtype == torch.int32:  # small enough that no sum wraps
            vals, cvals = (torch.from_numpy(rng.integers(-30, 30, m).astype(np.int32)).to(dev)
                           for m in (n, n_c))
        else:
            vals, cvals = (torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)
                           for m in (n, n_c))
        for op in ("+", "min", "max"):
            calls = {  # route: (wrapper, its arguments, the sorted stream it reduces)
                "bind list": (sr.shuffle_reduce_sorted, (vals, offsets, n_out, op, bind_split),
                              vals, offsets, ids),
                "per-launch list": (sr.shuffle_reduce_sorted, (vals, offsets, n_out, op),
                                    vals, offsets, ids),
                "counter": (sr.shuffle_reduce, (cvals, one, n_c, op), cvals, c_offsets, c_ids),
            }
            for route, (fn, call_args, v, off, bid) in calls.items():
                name = f"shuffle_reduce skewed {str(dtype).split('.')[-1]} {op} ({route})"
                got = fn(*call_args)
                tol = None
                if dtype == torch.float32 and op == "+":
                    assert torch.equal(got.view(torch.int32), fn(*call_args).view(torch.int32)), \
                        f"{name}: float + differs between two calls"
                    tol = f32_sum_tolerance(v, bid, off.shape[0] - 1)
                err = check_equal(name, got, ref.segment_reduce_ref(v, off, op), op, tol)
                max_err = max(max_err, err)
                n_cases += 1
    # the routes whose list is built or sized per call read nothing back
    idx = torch.from_numpy(rng.integers(0, n_out, n).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sr.shuffle_reduce_sorted(vals, offsets, n_out, "min")
        sr.shuffle_reduce(cvals, one, n_c, "+")
        sr.shuffle_reduce(vals, idx, n_out, "max")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counter_split = sr.one_bin_split(one, n_c)
    dev_c = device_ms(lambda: sr.shuffle_reduce(cvals, one, n_c, "+"), focus="shuffle_reduce_")
    dev_s = device_ms(lambda: sr.shuffle_reduce_sorted(vals, offsets, n_out, "+", bind_split))
    return {"cases": n_cases, "max_abs_err": max_err, "updates": n, "bins": n_out,
            "longest_bin": int(counts.max()), "sync_free_routes": 3,
            "work_list": list_facts(sr, bind_split, sr.launch_split(offsets, n)),
            "skewed_f32_sum_device_ms": dev_s["ms"],
            "counter": {"updates": n_c, "bins": n_c, "chunks": counter_split.chunks.shape[0],
                        "device_ms": dev_c["focus_ms"], "kernels": [k for k in dev_c["kernels"]
                                                                    if "shuffle_reduce_" in k],
                        "routing_ops_device_ms": (None if dev_c["focus_ms"] is None
                                                  else dev_c["ms"] - dev_c["focus_ms"])}}


def skewed_edge_stream(sr, es, ref, dev: str) -> dict:
    """edge_stream on a stream built to cross the work list's edges: one bin
    of SKEW_HUB edges, bins of L-1, L, L+1, 2L and 2L+1 edges (L =
    SPLIT_LEN), empty bins and a uniform rest of 0-16 edges a bin, in int32
    and float32 under every apply and op, kernel vs plain: exact for int32,
    min and max; float32 + within f32_sum_tolerance and the same bits on
    two calls."""
    big = sr.SPLIT_LEN
    rng = np.random.default_rng(2)
    n_v = 4096
    counts = np.concatenate([[0, SKEW_HUB, 0, big - 1, big, big + 1, 0, 2 * big, 2 * big + 1, 0],
                             rng.integers(0, 17, 60_000)])
    n_out, n_e = counts.shape[0], int(counts.sum())
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)).to(dev)
    src_s = torch.from_numpy(rng.integers(0, n_v, n_e).astype(np.int32)).to(dev)
    eid_s = torch.from_numpy(rng.permutation(n_e).astype(np.int32)).to(dev)
    vact = torch.from_numpy(rng.random(n_v) < 0.6).to(dev)
    split = sr.split_bins(offsets, n_e)
    ids = ref.bin_ids(offsets)
    n_cases, max_err = 0, 0.0
    for dtype in (torch.int32, torch.float32):
        if dtype == torch.int32:  # small enough that no sum wraps
            vval, w = (torch.from_numpy(rng.integers(-30, 30, n).astype(np.int32)).to(dev)
                       for n in (n_v, n_e))
        else:
            vval, w = (torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
                       for n in (n_v, n_e))
        for apply_op in ("add", "mul", "src"):
            eid, ww = (None, None) if apply_op == "src" else (eid_s, w)
            for op in ("+", "min", "max"):
                name = f"edge_stream skewed {str(dtype).split('.')[-1]} {apply_op} {op}"
                got = es.edge_stream_gather(vval, vact, src_s, eid, ww, offsets, apply_op, op,
                                            split)
                want = ref.edge_stream_gather_ref(vval, vact, src_s, eid, ww, offsets, apply_op,
                                                  op)
                tol = None
                if dtype == torch.float32 and op == "+":
                    again = es.edge_stream_gather(vval, vact, src_s, eid, ww, offsets, apply_op,
                                                  op, split)
                    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
                        f"{name}: float + differs between two calls"
                    upd = ref._apply(apply_op, vval[src_s], None if ww is None else ww[eid])
                    tol = f32_sum_tolerance(torch.where(vact[src_s], upd, 0.0), ids, n_out)
                max_err = max(max_err, check_equal(name, got, want, op, tol))
                n_cases += 1
    return {"cases": n_cases, "max_abs_err": max_err, "edges": n_e, "bins": n_out,
            "longest_bin": int(counts.max()), "split_bins": split.bins.shape[0],
            "chunks": split.chunks.shape[0], "split_len": sr.SPLIT_LEN}


def main_shape_kernels(sr, es, ref, gb, weights, dev: str) -> dict:
    """Each kernel at the main path's shape: the bound graph's dst-sorted
    edge stream (|E| updates into |V| bins)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    offsets = gb["dst_offsets"]
    n_out = offsets.shape[0] - 1
    n_e = gb["es_src"].shape[0]
    ids = ref.bin_ids(offsets)
    rows = {}

    # -- shuffle_reduce: float32 + (the PageRank-style commit), with the
    #    bind's work list as the engine's full-stream commits pass it, and
    #    with the list built per launch on the device ---------------------
    bind_split = gb["es_split"]
    vals = torch.randn(n_e, generator=gen, device=dev)
    got = sr.shuffle_reduce_sorted(vals, offsets, n_out, "+", bind_split)
    again = sr.shuffle_reduce_sorted(vals, offsets, n_out, "+", bind_split)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
        "shuffle_reduce: float + differs between two runs"
    per_launch = sr.shuffle_reduce_sorted(vals, offsets, n_out, "+")
    assert torch.equal(got.view(torch.int32), per_launch.view(torch.int32)), \
        "shuffle_reduce: the per-launch list gives other bits than the bind's"
    want = ref.segment_reduce_ref(vals, offsets, "+")
    err = check_equal("shuffle_reduce main-shape f32 +", got, want, "+",
                      f32_sum_tolerance(vals, ids, n_out))
    ivals = torch.randint(-2**20, 2**20, (n_e,), generator=gen, device=dev, dtype=torch.int32)
    for v, op in [(ivals, "+"), (ivals, "min"), (ivals, "max"), (vals, "min"), (vals, "max")]:
        for name, split in (("bind", bind_split), ("per-launch", None)):
            check_equal(f"shuffle_reduce main-shape {str(v.dtype)[6:]} {op} ({name} list)",
                        sr.shuffle_reduce_sorted(v, offsets, n_out, op, split),
                        ref.segment_reduce_ref(v, offsets, op), op)
    # the library calls that compute the same sum (the port calls neither)
    lib_out = torch.zeros(n_out, device=dev)
    ids_l = ids.long()
    b_ms, b_by = bound(4 * n_e + 4 * (n_out + 1) + 4 * n_out, n_e)
    dev_bind = device_ms(lambda: sr.shuffle_reduce_sorted(vals, offsets, n_out, "+", bind_split))
    dev_launch = device_ms(lambda: sr.shuffle_reduce_sorted(vals, offsets, n_out, "+"))
    rows["shuffle_reduce"] = {
        "kernel_ms": time_ms(lambda: sr.shuffle_reduce_sorted(vals, offsets, n_out, "+",
                                                              bind_split)),
        "kernel_device_ms": dev_bind["ms"], "kernel_device_kernels": dev_bind["kernels"],
        "per_launch_list_device_ms": dev_launch["ms"],
        "per_launch_list_kernels": dev_launch["kernels"],
        "work_list": list_facts(sr, bind_split, sr.launch_split(offsets, n_e)),
        "plain_ms": time_ms(lambda: ref.segment_reduce_ref(vals, offsets, "+"), iters=5),
        "library_ms": time_ms(lambda: lib_out.scatter_reduce_(0, ids_l, vals, "sum")),
        "library_call": "torch.Tensor.scatter_reduce_",
        "index_add_ms": time_ms(lambda: lib_out.index_add_(0, ids, vals)),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
        "shape": {"updates": n_e, "bins": n_out, "dtype": "float32", "op": "+"},
    }

    # -- edge_stream: the SSSP relax (int32, add weight, min) and the
    #    PageRank contribution (float32, src, +) on the bound graph -------
    n_v = gb["n_vertices"]
    split = gb["es_split"]  # the work list the bind built, as the engine's launches use it
    vact = torch.rand(n_v, generator=gen, device=dev) < 0.5
    sp = torch.randint(0, 2**20, (n_v,), generator=gen, device=dev, dtype=torch.int32)
    w = weights
    got = es.edge_stream_gather(sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min",
                                split)
    want = ref.edge_stream_gather_ref(sp, vact, gb["es_src"], gb["es_eid"], w, offsets,
                                      "add", "min")
    err_i = check_equal("edge_stream main-shape i32 add min", got, want, "min")
    n_active = int(vact[gb["es_src"]].sum())
    b_ms, b_by = bound(4 * n_e + 8 * n_active + 5 * n_v + 8 * n_out + 4, 2 * n_active)
    dev_i = device_ms(lambda: es.edge_stream_gather(
        sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min", split))
    # the same stream with apply 'src': what the weight gather by edge id costs
    dev_s = device_ms(lambda: es.edge_stream_gather(
        sp, vact, gb["es_src"], None, None, offsets, "src", "min", split))
    rows["edge_stream"] = {
        "kernel_ms": time_ms(lambda: es.edge_stream_gather(
            sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min", split)),
        "kernel_device_ms": dev_i["ms"], "kernel_device_kernels": dev_i["kernels"],
        "src_apply_device_ms": dev_s["ms"],
        "plain_ms": time_ms(lambda: ref.edge_stream_gather_ref(
            sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min"), iters=5),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_i,
        "shape": {"edges": n_e, "bins": n_out, "dtype": "int32", "apply": "add",
                  "op": "min", "active_edges": n_active},
        "work_list": split_facts(sr, split, offsets, n_e),
    }
    rank = torch.rand(n_v, generator=gen, device=dev)
    got = es.edge_stream_gather(rank, vact, gb["es_src"], None, None, offsets, "src", "+",
                                split)
    again = es.edge_stream_gather(rank, vact, gb["es_src"], None, None, offsets, "src", "+",
                                  split)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
        "edge_stream: float + differs between two runs"
    want = ref.edge_stream_gather_ref(rank, vact, gb["es_src"], None, None, offsets, "src", "+")
    upd = torch.where(vact, rank, 0.0)[gb["es_src"]]
    err_f = check_equal("edge_stream main-shape f32 src +", got, want, "+",
                        f32_sum_tolerance(upd, ids, n_out))
    b_ms, b_by = bound(4 * n_e + 5 * n_v + 8 * n_out + 4, n_e)
    dev_f = device_ms(lambda: es.edge_stream_gather(
        rank, vact, gb["es_src"], None, None, offsets, "src", "+", split))
    rows["edge_stream_f32"] = {
        "kernel_ms": time_ms(lambda: es.edge_stream_gather(
            rank, vact, gb["es_src"], None, None, offsets, "src", "+", split)),
        "kernel_device_ms": dev_f["ms"], "kernel_device_kernels": dev_f["kernels"],
        "plain_ms": time_ms(lambda: ref.edge_stream_gather_ref(
            rank, vact, gb["es_src"], None, None, offsets, "src", "+"), iters=5),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_f,
        "shape": {"edges": n_e, "bins": n_out, "dtype": "float32", "apply": "src", "op": "+"},
    }
    return rows


def es_resources(ptxas: list, dtype, apply_op: str, op: str, group: int) -> dict:
    """``ptxas`` registers and theoretical occupancy of the batched
    ``edge_stream`` kernels one call of ``group``-row groups runs (the walk
    and the pack; csrc/edge_stream.cu's template arguments) and of the
    one-row walk of the same case."""
    t = "f" if dtype == torch.float32 else "i"
    apply_c = {"add": 0, "mul": 1, "src": 2}[apply_op]
    op_c = {"+": 0, "min": 1, "max": 2, "|": 3}[op]
    src = apply_op == "src"
    names = {
        "rows_kernel": f"edge_stream_rows_kernelI{t}Li{apply_c}ELi{op_c}ELi{group}EE",
        "pack_kernel": f"pack_kernelI{t}Li{op_c if src else 0}ELi{group}ELb{int(src)}EE",
        "one_row_kernel": f"edge_stream_kernelI{t}Li{apply_c}ELi{op_c}EE",
    }
    out = {"group_rows": group}
    if not ptxas:  # a cached build prints no ptxas log
        return {**out, "registers": "not measured: the build was cached"}
    for key, pat in names.items():
        hits = [row for row in ptxas if pat in row["entry"] and "registers" in row]
        assert len(hits) == 1, f"ptxas: {len(hits)} entries match {pat}"
        out[key] = {"registers": hits[0]["registers"],
                    "occupancy": register_occupancy(hits[0]["registers"])}
    return out


def batched_kernels(sr, es, ref, gb, weights, dev: str, es_ptxas: list) -> dict:
    """The batched launches at the main shape: BATCH_K rows (queries) over
    the bound graph's dst-sorted edges, offsets and work list. Each is held
    to its plain version (exact, or float ``+`` within f32_sum_tolerance
    per bin) and bit for bit to BATCH_K one-row launches of the same kernel
    (float ``+`` too: each row folds its bins in the one-row order), and
    timed (CUDA events and profiler device time) beside the one-row
    launches it replaces and its bound. ``edge_stream`` also runs MS-BFS's
    launch (2 int32 rows, ``src``/``|``, a shared flag row), timed the same
    way, and each 16-row case at ROWS_PARTIAL rows (a partial group of
    rows), held to its one-row launches bit for bit and not timed; each
    row gives the ``ptxas`` registers and occupancy of the kernels it runs
    (``es_ptxas``: the build's entries). Bounds: each input read once (a
    shared operand once, not once a row), each output written once."""
    gen = torch.Generator(device=dev).manual_seed(2)
    k = BATCH_K
    offsets, split = gb["dst_offsets"], gb["es_split"]
    n_out, n_e, n_v = offsets.shape[0] - 1, gb["es_src"].shape[0], gb["n_vertices"]
    src_s, eid_s = gb["es_src"], gb["es_eid"]
    ids = ref.row_bins(ref.bin_ids(offsets), k, n_out)  # row k's bins at k * n_out ..
    rows = {}

    def bits(t):
        return t.view(torch.int32)

    def one_row_launches(fn):
        return torch.stack([fn(q) for q in range(k)])

    # -- shuffle_reduce: float32 +, int32 min, int32 |, a row stride of 0 --
    vals = torch.randn(k, n_e, generator=gen, device=dev)
    ivals = torch.randint(-2**31, 2**31 - 1, (k, n_e), generator=gen, device=dev,
                          dtype=torch.int32)
    checks = {}
    for name, v, op in (("f32 +", vals, "+"), ("i32 min", ivals, "min"), ("i32 |", ivals, "|"),
                        ("f32 + row stride 0", vals[0].expand(k, -1), "+")):
        got = sr.shuffle_reduce_sorted_batched(v, offsets, n_out, op, split)
        one = one_row_launches(lambda q, v=v, op=op: sr.shuffle_reduce_sorted(
            v[q], offsets, n_out, op, split))
        assert torch.equal(bits(got), bits(one)), \
            f"shuffle_reduce_batched {name}: differs from {k} one-row launches"
        want = ref.segment_reduce_batched_ref(v, offsets, op)
        tol = f32_sum_tolerance(v.reshape(-1), ids, k * n_out).view(k, n_out) if op == "+" \
            and v.dtype == torch.float32 else None
        checks[name] = check_equal(f"shuffle_reduce_batched main-shape {name}", got, want, op,
                                   tol)
        del got, one, want
    b_ms, b_by = bound(4 * k * n_e + 4 * (n_out + 1) + 4 * k * n_out, k * n_e)
    call = lambda: sr.shuffle_reduce_sorted_batched(vals, offsets, n_out, "+", split)  # noqa: E731
    dev_b = device_ms(call, iters=10)
    dev_one = device_ms(lambda: [sr.shuffle_reduce_sorted(vals[q], offsets, n_out, "+", split)
                                 for q in range(k)], iters=3)
    # the library call that computes the same sums (the port never calls it)
    lib_out = torch.zeros(k * n_out, device=dev)
    ids_l = ids.long()
    flat = vals.reshape(-1)
    lib = lambda: lib_out.scatter_reduce_(0, ids_l, flat, "sum")  # noqa: E731
    dev_lib = device_ms(lib, iters=10)
    rows["shuffle_reduce_batched"] = {
        "kernel_ms": time_ms(call, iters=10), "kernel_device_ms": dev_b["ms"],
        "kernel_device_kernels": dev_b["kernels"],
        "one_row_launches_device_ms": dev_one["ms"],
        "plain_ms": time_ms(lambda: ref.segment_reduce_batched_ref(vals, offsets, "+"),
                            iters=2, warmup=1),
        "library_ms": time_ms(lib, iters=10), "library_device_ms": dev_lib["ms"],
        "library_call": "torch.Tensor.scatter_reduce_",
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": max(checks.values()), "max_abs_err_by_case": checks,
        "bit_identical_to_one_row_launches": list(checks),
        "shape": {"rows": k, "updates": n_e, "bins": n_out, "dtype": "float32", "op": "+",
                  "work_list": "the bind's"},
    }
    del vals, ivals

    # -- edge_stream: SSSP's relax (i32 add/min, shared weights), PageRank's
    #    contribution (f32 src/+), MS-BFS's level step (i32 src/|) ---------
    vact = torch.rand(k, n_v, generator=gen, device=dev) < 0.5
    sp = torch.randint(0, 2**20, (k, n_v), generator=gen, device=dev, dtype=torch.int32)
    rank = torch.rand(k, n_v, generator=gen, device=dev)
    words = torch.randint(-2**31, 2**31 - 1, (k, n_v), generator=gen, device=dev,
                          dtype=torch.int32)
    every = torch.ones(n_v, dtype=torch.bool, device=dev)
    cases = {
        "edge_stream_batched": ("i32 add min, shared weights", sp, vact, eid_s, weights, "add",
                                "min"),
        "edge_stream_batched_f32": ("f32 src +", rank, vact, None, None, "src", "+"),
        "edge_stream_batched_or": ("i32 src |, shared mask", words, every, None, None, "src",
                                   "|"),
        "edge_stream_batched_msbfs": ("i32 src |, 2 rows, shared mask (MS-BFS)", words[:2],
                                      every, None, None, "src", "|"),
    }
    def es_rows(vv, act, eid, w, apply_op, op, lo=0, hi=None):
        """Rows lo .. hi as one batched call, and as one-row launches."""
        act = act if act.dim() == 1 else act[lo:hi]
        batched = lambda: es.edge_stream_gather_batched(  # noqa: E731
            vv[lo:hi], act, src_s, eid, w, offsets, apply_op, op, split)
        one_rows = lambda: [es.edge_stream_gather(  # noqa: E731
            row, act if act.dim() == 1 else act[q], src_s, eid, w, offsets, apply_op, op, split)
            for q, row in enumerate(vv[lo:hi])]
        return batched, one_rows

    for row_name, (name, vv, act, eid, w, apply_op, op) in cases.items():
        k = vv.shape[0]
        call, one_rows = es_rows(vv, act, eid, w, apply_op, op)
        got = call()
        one = torch.stack(one_rows())
        assert torch.equal(bits(got), bits(one)), \
            f"edge_stream_batched {name}: differs from {k} one-row launches"
        want = ref.edge_stream_gather_batched_ref(vv, act, src_s, eid, w, offsets, apply_op, op)
        tol = None
        if op == "+":
            upd = torch.where(act, vv, 0.0).index_select(1, src_s)
            tol = f32_sum_tolerance(upd.reshape(-1), ids[:k * n_e], k * n_out).view(k, n_out)
            del upd
        err = check_equal(f"{row_name} main-shape {name}", got, want, op, tol)
        del got, one, want
        act_rows = act if act.dim() == 2 else act.expand(k, -1)
        n_active = int(act_rows.index_select(1, src_s).sum())  # (row, edge) pairs applied
        weighted = apply_op != "src"
        n_bytes = (4 * n_e * (3 if weighted else 1) + k * n_v * (4 + (1 if act.dim() == 2 else 0))
                   + (0 if act.dim() == 2 else n_v) + 4 * (n_out + 1) + 4 * k * n_out)
        b_ms, b_by = bound(n_bytes, (2 if weighted else 1) * n_active)
        dev_b = device_ms(call, iters=10)
        dev_one = device_ms(one_rows, iters=3)
        rows[row_name] = {
            "kernel_ms": time_ms(call, iters=10), "kernel_device_ms": dev_b["ms"],
            "kernel_device_kernels": dev_b["kernels"],
            "one_row_launches_device_ms": dev_one["ms"],
            "plain_ms": time_ms(lambda vv=vv, act=act, eid=eid, w=w, apply_op=apply_op, op=op:
                                ref.edge_stream_gather_batched_ref(vv, act, src_s, eid, w,
                                                                   offsets, apply_op, op),
                                iters=2, warmup=1),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "bit_identical_to_one_row_launches": True,
            **es_resources(es_ptxas, vv.dtype, apply_op, op, es.row_group(k)),
            "shape": {"rows": k, "edges": n_e, "bins": n_out, "case": name,
                      "active_row_edges": n_active},
        }
        if k == BATCH_K:
            # a partial group: ROWS_PARTIAL rows, bits only, not timed
            part, part_one = es_rows(vv, act, eid, w, apply_op, op, hi=ROWS_PARTIAL)
            assert torch.equal(bits(part()), bits(torch.stack(part_one()))), \
                f"edge_stream_batched {name} at {ROWS_PARTIAL} rows: differs from one-row launches"
            rows[row_name]["partial_group"] = {
                "rows": ROWS_PARTIAL, "group_rows": es.row_group(ROWS_PARTIAL),
                "bit_identical_to_one_row_launches": True}
            # the same rows as two calls of k / 2 (groups of 8 rows, not 16)
            halves = [es_rows(vv, act, eid, w, apply_op, op, h, h + k // 2)[0]
                      for h in (0, k // 2)]
            rows[row_name]["two_calls_of_half_the_rows_device_ms"] = device_ms(
                lambda halves=halves: [f() for f in halves], iters=10)["ms"]
    return rows


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Attention kernel vs plain version within the reference tests'
    tolerance of the dtype; returns the max abs error."""
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape)
    assert torch.isfinite(got).all(), f"{name}: non-finite output"
    err = float((got.float() - want.float()).abs().max())
    tol = FA_TOL[got.dtype]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    assert ok, f"{name}: max abs error {err} outside {tol}"
    return err


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max over rows of max |got - want| / rms(want row): an error that
    scales with each row's output, so a fault confined to long rows (whose
    outputs are small) is not hidden by an absolute tolerance."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1).sqrt().clamp_min(1e-30)
    return float(((g - w).abs().amax(dim=-1) / rms).max())


def visible_keys(lq: int, lk: int, causal: bool, window: int, device) -> torch.Tensor:
    """``[Lq, Lk]`` bool, True where query ``i`` (at position ``Lk - Lq +
    i``) sees key ``j``: the kernels' and the plain version's mask."""
    q_pos = torch.arange(lq, device=device)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=device)[None, :]
    seen = torch.ones(lq, lk, dtype=torch.bool, device=device)
    if causal:
        seen &= k_pos <= q_pos
    if window > 0:
        seen &= k_pos > q_pos - window
    return seen


def control_keys(lk: int) -> tuple:
    """The keys ``[lo, hi)`` a control drops or doubles: CONTROL_KEYS where
    the keys reach past them, else ``min(64, Lk // 2)`` keys from the
    middle on, ``lo`` a multiple of their count (1,000 frames: 448 to 512;
    32 slots: 16 to 32)."""
    if lk > CONTROL_KEYS[1]:
        return CONTROL_KEYS
    width = min(64, lk // 2)
    lo = lk // 2 // width * width
    return lo, lo + width


def attention_control(q, k, v, causal: bool, window: int, scale: float, keys: tuple,
                      p_dtype=torch.bfloat16, tile_weight: float = 1.0) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch, with a fault
    to show what the row-relative check catches: float32 scores times
    ``scale`` under the causal and window masks, max and sum, P rounded to
    ``p_dtype`` before P.V (the kernel rounds it to bf16), and the keys
    ``[lo, hi) = keys`` counted ``tile_weight`` times (0: a key tile
    skipped, 2: one taken twice); output in q's dtype. A kv head's query
    heads are folded into its rows, so K and V are read once, not
    repeated."""
    b, h, lq, dqk = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, lq, dqk)
    logits = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) * scale
    del qg
    logits.masked_fill_(~visible_keys(lq, lk, causal, window, q.device), float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    del logits
    lo, hi = keys
    p[..., lo:hi] *= tile_weight
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bngqk,bnkd->bngqd", p.to(p_dtype).float(), v.float()) / denom
    return out.reshape(b, h, lq, v.shape[3]).to(q.dtype)


def check_row_rel(name: str, got: torch.Tensor, q, k, v, causal: bool, ref, window: int = 0,
                  scale: float = None) -> dict:
    """The bf16 kernel's output against the plain version in float32 on
    the same inputs (same mask and scale), by :func:`row_rel_err`, within
    ROW_REL_TOL; and three controls over the keys of :func:`control_keys`,
    each of which must fall outside it, so that the check is shown able to
    fail at this shape in this run."""
    lq, lk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else scale
    keys = control_keys(lk)
    assert bool(visible_keys(lq, lk, causal, window, q.device)[:, keys[0]:keys[1]].any()), \
        f"{name}: no query sees the control keys {keys}"
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal, window, scale)
    err = row_rel_err(got, want)
    args = (q, k, v, causal, window, scale, keys)
    controls = {
        "p_fp8_e4m3": row_rel_err(attention_control(*args, torch.float8_e4m3fn), want),
        "key_tile_dropped": row_rel_err(attention_control(*args, tile_weight=0.0), want),
        "key_tile_doubled": row_rel_err(attention_control(*args, tile_weight=2.0), want),
    }
    del want
    caught = {c: r > ROW_REL_TOL for c, r in controls.items()}
    assert all(caught.values()), f"{name}: a control passes the row-relative check: {controls}"
    assert err <= ROW_REL_TOL, f"{name}: row-relative error {err} outside {ROW_REL_TOL}"
    return {"row_rel_err": err, "row_rel_tol": ROW_REL_TOL, "controls": controls,
            "control_keys": list(keys)}


def took_route(fa, before) -> str:
    """The route of the one attention call made since ``before`` (the
    counters LAUNCHES, SM90_LAUNCHES, DECODE_LAUNCHES), read from them."""
    moved = (fa.LAUNCHES - before[0], fa.SM90_LAUNCHES - before[1],
             fa.DECODE_LAUNCHES - before[2])
    routes = {(1, 1, 0): "sm90", (1, 0, 1): "decode", (1, 0, 0): "cuda_core"}
    assert moved in routes, f"attention counters moved by {moved} in one call"
    return routes[moved]


def fa_counters(fa) -> tuple:
    return fa.LAUNCHES, fa.SM90_LAUNCHES, fa.DECODE_LAUNCHES


def lm_kernel_tests(fa, md, ref, dev: str) -> dict:
    """The LM kernels at the reference test shapes (tests/test_kernels.py),
    kernel vs plain: attention in float32 (the CUDA-core kernel's tile and
    decode routes) and bf16 (the tensor-core kernel), the gather exactly.
    Each attention case reads the route its launch took from the three
    launch counters."""
    rng = np.random.default_rng(1)
    n_cases = 0
    max_err = {"flash_attention_float32": 0.0, "flash_attention_bfloat16": 0.0,
               "moe_gather": 0.0}
    routes = {"cuda_core": 0, "decode": 0, "sm90": 0}
    for b, h, hkv, lq, lk, dh in [(1, 2, 2, 64, 64, 32), (2, 4, 2, 128, 128, 64),
                                  (1, 4, 1, 1, 256, 64), (1, 2, 2, 100, 100, 32)]:
        for causal, window in [(True, 0), (False, 0), (True, 48)]:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                           .to(dev, dtype) for shape in
                           [(b, h, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh)])
                name = (f"flash_attention {b, h, hkv, lq, lk, dh} causal={causal} "
                        f"window={window} {dtype}")
                before = fa_counters(fa)
                got = fa.flash_attention(q, k, v, causal, window)
                took = took_route(fa, before)
                want_route = ("sm90" if dtype == torch.bfloat16 else
                              "decode" if lq == 1 or h // hkv * lq <= fa.DECODE_MAX_ROWS
                              else "cuda_core")
                assert took == fa._route(q, h // hkv) == want_route, f"{name}: took {took}"
                routes[took] += 1
                err = check_close(name, got, ref.flash_attention_ref(q, k, v, causal, window))
                key = f"flash_attention_{str(dtype).split('.')[-1]}"
                max_err[key] = max(max_err[key], err)
                n_cases += 1
    for e, c, d, bc in [(8, 256, 64, 128), (4, 128, 32, 128), (16, 512, 128, 128)]:
        sizes = np.minimum(rng.multinomial(e * c // 2, np.ones(e) / e), c).astype(np.int32)
        aligned = ((sizes + bc - 1) // bc) * bc
        offs = np.zeros(e, np.int32)
        offs[1:] = np.cumsum(aligned)[:-1]
        tok = torch.from_numpy(rng.normal(size=(int(offs[-1] + aligned[-1]), d))
                               .astype(np.float32)).to(dev)
        offs_t, sizes_t = torch.from_numpy(offs).to(dev), torch.from_numpy(sizes).to(dev)
        got = md.moe_gather(tok, offs_t, sizes_t, c)
        want = ref.moe_gather_ref(tok[None], None, offs_t[None], sizes_t[None], c)[0]
        assert torch.equal(got, want), f"moe_gather e={e} c={c} d={d}: not exact"
        n_cases += 1
    return {"cases": n_cases, "max_abs_err": max_err, "attention_routes": routes}


def _attention_row(fa, ref, q, k, v, causal: bool, pairs: int, plain_iters: int,
                   device_side: bool = False, window: int = 0, scale: float = None) -> dict:
    """Kernel vs plain at one shape, timed beside the library call that
    computes the same function: SDPA with GQA and the same scale, with no
    mask where every key is visible (Lq = 1 over the whole cache), its
    causal mask where that is ours (Lq = Lk and no window hides a key), else
    our mask as a boolean ``attn_mask`` built outside the timed call (a
    sliding window that hides keys). Every bf16 row also takes
    :func:`check_row_rel` with its fault controls. ``pairs`` is the
    unmasked (query, key) pairs of each head: 2 * (Dqk + Dv) FLOPs each
    (two products), bounded at the peak rate of the dtype (bf16 tensor
    cores, float32 CUDA cores); the bytes read each input once (values that
    are a view of the keys, MLA's latent, are the keys' bytes) and write
    the output once. ``device_side`` adds the device time of kernel and
    library call from profiler events (the host-paced loop times the
    wrapper's Python at decode size), and on the float32 decode route that
    of the tile route on the same inputs."""
    b, h, lq, dh = q.shape
    lk, dv = k.shape[2], v.shape[3]
    route = fa._route(q, h // k.shape[1])

    def kernel():
        return fa.flash_attention(q, k, v, causal, window, scale)

    before = fa_counters(fa)
    got = kernel()
    assert took_route(fa, before) == route, route
    err = check_close(f"flash_attention {tuple(q.shape)} over {tuple(k.shape)}, "
                      f"{tuple(v.shape)} {q.dtype}",
                      got, ref.flash_attention_ref(q, k, v, causal, window, scale))
    rel = None
    if q.dtype == torch.bfloat16:
        rel = check_row_rel(f"flash_attention_sm90 {tuple(q.shape)}", got, q, k, v, causal, ref,
                            window, scale)
    seen = visible_keys(lq, lk, causal, window, q.device)
    if bool(seen.all()):
        lib_mask = {}
    elif lq == lk and torch.equal(seen, torch.ones_like(seen).tril()):
        lib_mask = {"is_causal": True}
    else:
        lib_mask = {"attn_mask": seen}

    def library():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, scale=scale, **lib_mask)

    lib = library()
    lib_diff = float((lib.float() - got.float()).abs().max())
    if q.dtype == torch.bfloat16:
        check_close("scaled_dot_product_attention", lib, got)
    del lib
    # the backend SDPA's dispatcher takes for these inputs (flash,
    # memory-efficient, cuDNN or the math fallback's products)
    lib_backend = SDPBackend(torch._fused_sdp_choice(
        q, k, v, scale=scale, enable_gqa=True, **lib_mask)).name
    shared = v.untyped_storage().data_ptr() == k.untyped_storage().data_ptr()
    n_bytes = ((q.numel() + got.numel()) * q.element_size()
               + (k.numel() + (0 if shared else v.numel())) * k.element_size())
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    b_ms, b_by = bound(n_bytes, 2 * b * h * pairs * (dh + dv), rate)
    row = {
        "route": route,
        "kernel_ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, causal, window, scale),
                            iters=plain_iters, warmup=1),
        "library_ms": time_ms(library),
        "library_call": "torch.nn.functional.scaled_dot_product_attention(enable_gqa=True"
                        + "".join(f", {key}=" + ("True" if key == "is_causal" else "window mask")
                                  for key in lib_mask) + ")",
        "library_max_abs_diff": lib_diff, "library_backend": lib_backend,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
        "shape": {"q": list(q.shape), "k": list(k.shape), "v": list(v.shape),
                  "q_strides": list(q.stride()), "k_strides": list(k.stride()),
                  "v_strides": list(v.stride()), "values_view_keys": shared,
                  "dtype": str(q.dtype), "causal": causal, "window": window,
                  "scale": scale if scale is not None else 1.0 / math.sqrt(dh)},
    }
    if rel is not None:
        row["row_rel_check"] = rel
    if route == "sm90":  # the instantiation and the rows a block holds (64: one consumer, 128: two)
        row["sm90"] = {"instantiation": list(fa.kernel_widths(route, dh, dv)),
                       "form_rows": fa.sm90_form(dh, dv, h // k.shape[1] * lq)}
    if route == "decode":
        r, tiles, n, chunk = fa.decode_plan(b, k.shape[1], h // k.shape[1] * lq, k.shape[2],
                                            fa.kernel_widths(route, dh, dv)[0], fa._sm_count(0))
        row["decode"] = {"row_tile": r, "row_tiles": tiles, "splits": n, "chunk": chunk,
                         "blocks": b * k.shape[1] * tiles * n}
    row["bound_share"] = b_ms / row["kernel_ms"]
    row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
    if device_side:
        kd = device_ms(kernel)
        ld = device_ms(library)
        row.update({"kernel_device_ms": kd["ms"], "kernel_device_kernels": kd["kernels"],
                    "library_device_ms": ld["ms"], "library_device_kernels": ld["kernels"],
                    "device_timing": "events" if "events" in (kd.get("timing"),
                                                              ld.get("timing")) else "profiler",
                    "device_bound_share": b_ms / kd["ms"],
                    "kernel_over_library_device": kd["ms"] / ld["ms"]})
        if route == "decode":  # the tile route on the same inputs, at the tile tile_plan picks
            tile = fa._launch("cuda_core", q, k, v, causal, 0)
            check_close("flash_attention tile route", tile, ref.flash_attention_ref(q, k, v,
                                                                                    causal))
            row["tile_route_device_ms"] = device_ms(
                lambda: fa._launch("cuda_core", q, k, v, causal, 0))["ms"]
    return row


def _dispatch_row(md, ref, moe_mod, cfg, n_tokens: int, gen, plain_iters: int,
                  device_side: bool = False) -> dict:
    """The MoE layer's dispatch of ``n_tokens`` tokens (its own groups,
    capacity and routing plan for random top-k experts), kernel vs plain
    (exact), beside ``index_select`` over a zero-padded token table with a
    precomputed slot -> row map (the library call for the same gather).
    ``device_side`` adds both calls' device times from profiler events."""
    dev = gen.device
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    g = moe_mod._dispatch_groups(n_tokens)
    tg = n_tokens // g
    cap = int(max(1, math.ceil(cfg.moe_capacity_factor * tg * k / e)))
    x = torch.randn(g, tg, d, generator=gen, device=dev).bfloat16()
    top_e = torch.rand(g, tg, e, generator=gen, device=dev).topk(k, dim=-1).indices
    _, order, offsets, sizes = moe_mod.route(top_e, e, cap)
    rows = (order // k).to(torch.int32)
    offsets, sizes = offsets.to(torch.int32), sizes.to(torch.int32)
    got = md.moe_gather(x, offsets, sizes, cap, rows)
    assert torch.equal(got, ref.moe_gather_ref(x, rows, offsets, sizes, cap)), \
        f"moe_gather {n_tokens} tokens: not exact"
    # the library form: one index_select over [x; 0] with a slot -> row map
    c = torch.arange(cap, device=dev)
    slot = (offsets.long()[..., None] + c).clamp(max=tg * k - 1)
    row = rows.long().gather(1, slot.reshape(g, -1)).reshape(slot.shape)
    live = c < sizes.long()[..., None]
    flat = torch.where(live, row + tg * torch.arange(g, device=dev)[:, None, None], g * tg)
    flat = flat.reshape(-1)
    table = torch.cat([x.reshape(g * tg, d), torch.zeros(1, d, dtype=x.dtype, device=dev)])
    assert torch.equal(torch.index_select(table, 0, flat).reshape(got.shape), got)
    live_rows = int(sizes.sum())
    read_rows = int(torch.unique(flat[flat < g * tg]).numel())  # token rows the run needs
    n_bytes = got.numel() * 2 + read_rows * d * 2 + 4 * (2 * g * e + live_rows)
    b_ms, b_by = bound(n_bytes, 0)
    row = {
        "kernel_ms": time_ms(lambda: md.moe_gather(x, offsets, sizes, cap, rows)),
        "plain_ms": time_ms(lambda: ref.moe_gather_ref(x, rows, offsets, sizes, cap),
                            iters=plain_iters, warmup=1),
        "library_ms": time_ms(lambda: torch.index_select(table, 0, flat)),
        "library_call": "torch.index_select (slot -> row map precomputed)",
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
        "shape": {"tokens": n_tokens, "groups": g, "experts": e, "capacity": cap, "d": d,
                  "out": list(got.shape), "live_rows": live_rows, "token_rows_read": read_rows,
                  "dtype": "bfloat16"},
    }
    if device_side:
        kd = device_ms(lambda: md.moe_gather(x, offsets, sizes, cap, rows))
        ld = device_ms(lambda: torch.index_select(table, 0, flat))
        row.update({"kernel_device_ms": kd["ms"], "kernel_device_kernels": kd["kernels"],
                    "library_device_ms": ld["ms"], "library_device_kernels": ld["kernels"]})
    return row


def lm_main_shape_kernels(fa, md, ref, moe_mod, cfg, dev: str) -> dict:
    """Each LM kernel at the Kimi-K2 path's shapes: the last decode step's
    attention (one query per head over the 32-slot cache, read in its
    [B, buf, Hkv, Dh] layout) and a prefill-size causal attention, each in
    bf16 (the tensor-core kernel) and in float32 (the CUDA-core kernel);
    the decode step's dispatch and a 4096-token prefill dispatch. The
    float32 prefill row (the tile route) also gives its device time, the
    same bits on two calls, its tile plan and the tile rescale fault
    control."""
    gen = torch.Generator(device=dev).manual_seed(1)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    buf = LM_PROMPT + LM_GEN
    rows = {}
    for dtype, name in ((torch.bfloat16, "flash_attention_sm90"),
                        (torch.float32, "flash_attention")):
        q = torch.randn(LM_BATCH, 1, h, dh, generator=gen, device=dev).to(dtype)
        ck, cv = (torch.randn(LM_BATCH, buf, hkv, dh, generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        rows[f"{name}_decode"] = _attention_row(
            fa, ref, q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2), True, buf, 20,
            device_side=True)
        s = 2048
        q, k, v = (torch.randn(1, n, s, dh, generator=gen, device=dev).to(dtype)
                   for n in (h, hkv, hkv))
        rows[name] = _attention_row(fa, ref, q, k, v, True, s * (s + 1) // 2, 3,
                                    device_side=dtype == torch.float32)
        if dtype == torch.float32:
            rows[name]["same_bits_twice"] = torch.equal(fa.flash_attention(q, k, v),
                                                        fa.flash_attention(q, k, v))
            assert rows[name]["same_bits_twice"], f"{name}: two calls gave different bits"
            rows[name]["tile"] = tile_facts(fa, q, k)
            rows[name]["tile_rescale_control"] = tile_rescale_control(fa, ref, q, k, v)
        del q, k, v, ck, cv
    rows["moe_gather"] = _dispatch_row(md, ref, moe_mod, cfg, LM_BATCH, gen, 20,
                                       device_side=True)
    rows["moe_gather_prefill"] = _dispatch_row(md, ref, moe_mod, cfg, 4096, gen, 3,
                                               device_side=True)
    return rows


def decode_resources(ptxas: list, dh: int, rows: int) -> dict:
    """``ptxas`` registers and spills of the float32 decode route's kernel
    at the instantiation of widths ``dh`` (keys and values) and row tile
    ``rows`` (its template arguments); the last block of a row tile folds
    the splits, so there is no second kernel."""
    if not ptxas:  # a cached build prints no ptxas log
        return {"registers": "not measured: the build was cached"}
    hits = [r for r in ptxas if "flash_decode_kernel" in r["entry"]
            and f"ILi{dh}ELi{dh}ELi{rows}EE" in r["entry"]]
    assert len(hits) == 1, f"ptxas: {len(hits)} entries match"
    r = hits[0]
    return {"decode_kernel": {
        "entry": r["entry"], "registers": r.get("registers"),
        "spill_store_bytes": r.get("spill_store_bytes"),
        "spill_load_bytes": r.get("spill_load_bytes"),
        "theoretical_occupancy": register_occupancy(r["registers"])
        if "registers" in r else None}}


def decode_control(fa, ref, q, k, v, fault: str, scale: float = None) -> dict:
    """A fault control for the float32 check at a decode-route shape: the
    decode route's schedule in plain PyTorch (``ref.flash_attention_split_ref``,
    with the splits and layout the wrapper takes), once as the kernel folds
    and once with ``fault``: ``"no_split_rescale"`` folds the splits
    without their exp(m_s - m) weights, ``"lost_split"`` leaves the last
    split out of the fold (a last block that folds before every split has
    written), ``"no_unit_rescale"`` leaves out a team's rescale where a
    unit raises its max. The sound one must pass ``check_close``'s
    tolerance and the faulty one must fail it, so that the check is shown
    able to fail at this shape in this run."""
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    dk = fa.kernel_widths("decode", dh, v.shape[3])[0]
    _, _, n, chunk = fa.decode_plan(b, hkv, h // hkv * lq, lk, dk, fa._sm_count(0))
    _, teams, unit = fa.decode_layout(dk)
    assert n > 1 or fault == "no_unit_rescale", "the control needs a shape cut into splits"
    want = ref.flash_attention_ref(q, k, v, True, scale=scale)
    tol = FA_TOL[torch.float32]
    out = {"splits": n, "chunk": chunk, "teams": teams, "unit": unit, "tol": tol}
    bad = {"no_split_rescale": {"rescale": False}}.get(fault, {"broken": fault})
    for name, kwargs in (("model", {}), (fault, bad)):
        got = ref.flash_attention_split_ref(q, k, v, True, n_splits=n, chunk=chunk, teams=teams,
                                            unit=unit, scale=scale, **kwargs)
        out[f"{name}_max_abs_err"] = float((got - want).abs().max())
        out[f"{name}_passes"] = bool(torch.allclose(got, want, rtol=tol, atol=tol))
    assert out["model_passes"], f"the decode schedule's model fails the check: {out}"
    assert not out[f"{fault}_passes"], f"the {fault} control passes the check: {out}"
    return out


def tile_resources(ptxas: list, fa) -> list:
    """``ptxas`` registers and spills of every instantiation of the float32
    tile route (widths DK and DV, large, mid or small form), with its
    threads, the dynamic shared memory its launch asks for (the wrapper's
    count, which a CPU test holds to the source's ``Tile`` constants) and
    the blocks an SM holds at once (the CUDA runtime's occupancy for its
    registers, threads and shared memory). A spill where both widths are
    at most 128 fails the run."""
    rows = [r for r in ptxas if "flash_attention_kernel" in r["entry"]]
    if not rows:  # a cached build prints no ptxas log
        return [{"registers": "not measured: the build was cached"}]
    out = []
    for r in rows:
        dqk, dv, form = (int(x) for x in re.search(r"ILi(\d+)ELi(\d+)ELi([012])EE",
                                                   r["entry"]).groups())
        form = fa.TILE_FORMS[form]
        bm, bn = fa.tile_shape(dqk, form)
        spills = r.get("spill_store_bytes", 0) + r.get("spill_load_bytes", 0)
        assert max(dqk, dv) > 128 or spills == 0, f"tile route spills at {dqk, dv}: {r}"
        out.append({"dh": dqk, "dv": dv, "form": form, "threads": fa.tile_threads(form),
                    "row_tile": bm, "key_tile": bn, "registers": r.get("registers"),
                    "spill_store_bytes": r.get("spill_store_bytes"),
                    "spill_load_bytes": r.get("spill_load_bytes"),
                    "dynamic_smem_bytes": fa.tile_smem_bytes(dqk, form, dv),
                    "blocks_per_sm": fa.tile_occupancy(dqk, dv, bm)})
    return sorted(out, key=lambda x: (x["dh"], x["dv"], -x["row_tile"]))


def decode_kernels(ptxas: list) -> list:
    """``ptxas`` registers and spills of every instantiation of the float32
    decode route (widths, row tile)."""
    out = []
    for r in ptxas:
        if "flash_decode_kernel" not in r["entry"]:
            continue
        dqk, dv, rows = (int(x) for x in re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)EE",
                                                   r["entry"]).groups())
        out.append({"dh": dqk, "dv": dv, "row_tile": rows, "registers": r.get("registers"),
                    "spill_store_bytes": r.get("spill_store_bytes"),
                    "spill_load_bytes": r.get("spill_load_bytes")})
    return sorted(out, key=lambda x: (x["dh"], x["row_tile"]))


def tile_facts(fa, q, k, v=None) -> dict:
    """The tile route's plan for q over k and v (``None``: values as wide
    as the keys): its form, threads, rows a block holds, keys a tile,
    tiles a kv head, blocks, the block's shared memory and the blocks an
    SM holds at once."""
    b, h, lq, dh = q.shape
    hkv = k.shape[1]
    dk, dv = fa.kernel_widths("cuda_core", dh, dh if v is None else v.shape[3])
    bm, bn, tiles = fa.tile_plan(b, hkv, h // hkv * lq, dk, fa._sm_count(0))
    form = fa.plan_form(dk, bm)
    return {"form": form, "threads": fa.tile_threads(form), "row_tile": bm, "key_tile": bn,
            "tiles": tiles, "blocks": b * hkv * tiles,
            "smem_bytes": fa.tile_smem_bytes(dk, form, dv),
            "blocks_per_sm": fa.tile_occupancy(dk, dv, bm)}


def tile_rescale_control(fa, ref, q, k, v, window: int = 0, scale: float = None) -> dict:
    """A fault control for the float32 check at a tile-route shape: the
    tile route's schedule in plain PyTorch (``ref.flash_attention_tile_ref``,
    with the tiles the wrapper takes), once as the kernel folds its key
    tiles and once without the per-tile rescale of ``l`` and ``acc``. The
    sound one must pass ``check_close``'s tolerance and the faulty one must
    fail it, so that the check is shown able to fail at this shape in this
    run."""
    plan = tile_facts(fa, q, k, v)
    want = ref.flash_attention_ref(q, k, v, True, window, scale)
    tol = FA_TOL[torch.float32]
    out = {"row_tile": plan["row_tile"], "key_tile": plan["key_tile"], "tol": tol}
    for name, rescale in (("model", True), ("no_tile_rescale", False)):
        got = ref.flash_attention_tile_ref(q, k, v, True, window, bm=plan["row_tile"],
                                           bn=plan["key_tile"], rescale=rescale, scale=scale)
        out[f"{name}_max_abs_err"] = float((got - want).abs().max())
        out[f"{name}_passes"] = bool(torch.allclose(got, want, rtol=tol, atol=tol))
        del got
    assert out["model_passes"], f"the tile schedule's model fails the check: {out}"
    assert not out["no_tile_rescale_passes"], f"the rescale control passes the check: {out}"
    return out


def same_bits(fa, q, k, v, window: int = 0, scale: float = None) -> dict:
    """The same bits on two calls, and (on the tile route) the same output
    bits with the log-sum-exp the backward takes as without it."""
    first = fa.flash_attention(q, k, v, True, window, scale)
    out = {"same_bits_twice": torch.equal(first, fa.flash_attention(q, k, v, True, window,
                                                                    scale))}
    assert out["same_bits_twice"], "two calls gave different bits"
    if fa._route(q, q.shape[1] // k.shape[1]) == "cuda_core":
        with_lse = fa._launch("cuda_core", q, k, v, True, window, scale, with_lse=True)[0]
        out["same_bits_with_lse"] = torch.equal(first, with_lse)
        assert out["same_bits_with_lse"], "the output changed with the log-sum-exp"
    return out


def qwen_forward_row(fa, ref, cfg, dev: str) -> dict:
    """The float32 tile route at qwen3-0.6b's 16-token forward (the shape
    of its 28 tile-route launches in the f32 phase): q [2, 16, 16, 128]
    out of its [B, L, H, Dh] activation over k, v [2, 8, 16, 128] out of
    theirs, causal; kernel vs plain, device times of kernel and SDPA from
    profiler events (the host paces a loop at this size)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = (torch.randn(2, LM_PROMPT, n, dh, generator=gen, device=dev).transpose(1, 2)
               for n in (h, hkv, hkv))
    row = _attention_row(fa, ref, q, k, v, True, LM_PROMPT * (LM_PROMPT + 1) // 2, 20,
                         device_side=True)
    assert row["route"] == "cuda_core", row["route"]
    row["same_bits_twice"] = torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v))
    assert row["same_bits_twice"], "qwen3 forward row: two calls gave different bits"
    row["tile"] = tile_facts(fa, q, k)
    return row


def f32_decode_rows(fa, ref, cfg, dev: str, ptxas: list) -> dict:
    """The float32 decode route at qwen3-0.6b's decode shape: q [4, 16, 1,
    128] out of its [B, 1, H, Dh] activation over the [4, 32, 8, 128] cache
    read in place (the shape of its 2,240 launches on the path), and the
    same heads over a 4,096-key cache (134 MB of K/V, cut into splits).
    Each row: kernel vs plain, the splits, device times of the kernel and
    of SDPA, the bound, the same bits on two calls, and the ``ptxas``
    resources of the decode kernel; the long one also the
    split-rescale fault control."""
    gen = torch.Generator(device=dev).manual_seed(3)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rows = {}
    for name, lk in (("flash_attention_decode_qwen3", LM_PROMPT + LM_GEN),
                     ("flash_attention_decode_long", LONG_CACHE)):
        x = torch.randn(LM_BATCH, 1, h, dh, generator=gen, device=dev)
        ck, cv = (torch.randn(LM_BATCH, lk, hkv, dh, generator=gen, device=dev)
                  for _ in range(2))
        q, k, v = x.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)
        row = _attention_row(fa, ref, q, k, v, True, lk, 20, device_side=True)
        assert row["route"] == "decode", row["route"]
        row["ptxas"] = decode_resources(ptxas, dh, row["decode"]["row_tile"])
        row["same_bits_twice"] = torch.equal(fa.flash_attention(q, k, v),
                                             fa.flash_attention(q, k, v))
        assert row["same_bits_twice"], f"{name}: two calls gave different bits"
        if lk == LONG_CACHE:
            row["split_rescale_control"] = decode_control(fa, ref, q, k, v, "no_split_rescale")
        rows[name] = row
        del x, ck, cv, q, k, v
    return rows


def route_sweep(fa, ref, dev: str) -> list:
    """Both float32 routes at the same shapes around DECODE_MAX_ROWS (qwen3
    heads, group 2, at Lq 1-16; Kimi-K2 heads, group 8, at Lq 1-4; over 32
    and 4,096 keys, causal), each held to the plain version and timed on
    the device from profiler events: the measurement the threshold is set
    from. Calls ``fa._launch`` with each route; none of it is counted."""
    gen = torch.Generator(device=dev).manual_seed(4)
    out = []
    for lk in (LM_PROMPT + LM_GEN, LONG_CACHE):
        k, v = (torch.randn(LM_BATCH, 8, lk, 128, generator=gen, device=dev) for _ in range(2))
        for group, lqs in ((2, (1, 2, 4, 8, 16)), (8, (1, 2, 4))):
            for lq in lqs:
                q = torch.randn(LM_BATCH, 8 * group, lq, 128, generator=gen, device=dev)
                want = ref.flash_attention_ref(q, k, v, True)
                row = {"group": group, "lq": lq, "rows": group * lq, "lk": lk,
                       "route": fa._route(q, group)}
                for route in ("decode", "cuda_core"):
                    got = fa._launch(route, q, k, v, True, 0)
                    row[f"{route}_max_abs_err"] = check_close(
                        f"{route} {tuple(q.shape)} over {tuple(k.shape)}", got, want)
                    row[f"{route}_device_ms"] = device_ms(
                        lambda r=route: fa._launch(r, q, k, v, True, 0))["ms"]
                row["decode_over_tile"] = row["decode_device_ms"] / row["cuda_core_device_ms"]
                out.append(row)
        del k, v
    return out


def _reset_lm_counters(fa, md) -> None:
    """Set the LM kernels' launch counters to 0."""
    fa.LAUNCHES = 0
    fa.SM90_LAUNCHES = 0
    fa.DECODE_LAUNCHES = 0
    md.LAUNCHES = 0


def _lm_counters(fa, md) -> dict:
    """The LM kernels' launches since :func:`_reset_lm_counters`, by route."""
    return {"flash_attention_sm90": fa.SM90_LAUNCHES,
            "flash_attention_tile": fa.LAUNCHES - fa.SM90_LAUNCHES - fa.DECODE_LAUNCHES,
            "flash_attention_decode": fa.DECODE_LAUNCHES, "moe_gather": md.LAUNCHES}


def lm_phase(repro_torch_mods, dev: str, seed: int) -> dict:
    """Kimi-K2 at full width, depth cut to 2 layers, bf16: ``generate``
    twice (batch 4, prompt 16, generate 16) plus one ``forward`` over the
    prompts and one ``decode_step``, with the LM kernels' counters set to 0
    just before and read just after."""
    fa, md, get_config, Model, serve = repro_torch_mods
    cfg = get_config(KIMI).scaled(n_layers=KIMI_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)

    _reset_lm_counters(fa, md)
    step_s: list = []
    t0 = time.perf_counter()
    first = serve.generate(model, prompts, LM_GEN, step_s=step_s).cpu()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = serve.generate(model, prompts, LM_GEN).cpu()
    second_s = time.perf_counter() - t0
    logits, aux = model.forward(prompts)
    step_logits, _ = model.decode_step(model.init_cache(LM_BATCH, 1), prompts[:, :1])
    decode_aux = dict(model.last_aux)
    torch.cuda.synchronize()
    launches = _lm_counters(fa, md)

    assert torch.equal(first, second), "Kimi-K2: two generate runs gave different tokens"
    assert first.shape == (LM_BATCH, LM_GEN)
    assert bool(((first >= 0) & (first < cfg.vocab_size)).all())
    assert logits.shape == (LM_BATCH, LM_PROMPT, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(step_logits).all(), \
        "Kimi-K2: non-finite logits"
    assert launches["flash_attention_sm90"] > 0, \
        "the tensor-core flash kernel never launched on the bf16 LM path"
    assert launches["flash_attention_tile"] == launches["flash_attention_decode"] == 0, \
        "a bf16 attention took the CUDA-core kernel"
    assert launches["moe_gather"] > 0, "moe_gather never launched on the LM path"
    embed_bytes = model.embed.numel() * model.embed.element_size()
    # bytes one decode step must read: every weight but the embedding table
    # (of which it gathers LM_BATCH rows); the dense MoE einsum reads every expert
    step_bytes = model.param_bytes() - embed_bytes + LM_BATCH * cfg.d_model * 2
    median_ms = statistics.median(step_s) * 1e3
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    row = {
        "phase": "lm", "model": KIMI, "dtype": "bfloat16",
        "config": {key: getattr(cfg, key) for key in (
            "d_model", "n_layers", "first_dense_layers", "n_heads", "n_kv_heads", "head_dim",
            "d_ff", "n_experts", "n_shared_experts", "top_k", "moe_d_ff", "vocab_size")},
        "reduced": {"n_layers": [get_config(KIMI).n_layers, KIMI_LAYERS]},
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen_len": LM_GEN,
        "param_bytes": model.param_bytes(), "init_s": init_s,
        "decode_steps": len(step_s), "median_step_ms": median_ms,
        "step_ms_min_max": [min(step_s) * 1e3, max(step_s) * 1e3],
        "first_run_s": first_s, "second_run_s": second_s,
        "tokens_per_s": LM_BATCH * (LM_PROMPT + LM_GEN) / second_s,
        "step_weight_bytes": step_bytes, "step_bound_ms": bound_ms,
        "step_bound_share": bound_ms / median_ms,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "forward_drop_fraction": float(aux["drop_fraction"]),
        "forward_load_balance_loss": float(aux["load_balance_loss"]),
        "decode_drop_fraction": float(decode_aux["drop_fraction"]),
        "tokens_identical": True, "tokens": first[:2].tolist(), "launches": launches,
        "profile_decode_step": _profile_step(model, prompts),
    }
    del model, logits, step_logits
    return row


def _profile_step(model, prompts) -> dict:
    """One warm decode step (at the last position of a full cache) under
    the profiler: where a step's time goes, on the device and the host."""
    cache = model.init_cache(prompts.shape[0], LM_PROMPT)
    for t in range(LM_PROMPT - 1):
        _, cache = model.decode_step(cache, prompts[:, t:t + 1])
    return profile_run(lambda: model.decode_step(cache, prompts[:, -1:]), top=8)


def qwen_phase(repro_torch_mods, dev: str, seed: int) -> dict:
    """qwen3-0.6b at its full config in float32: ``generate`` timed as on
    Kimi-K2, then decode logits at every position against the
    whole-sequence forward (the kernel at Lq = 1 and at Lq = S), within
    ``2e-3 * max(1, |logits|)``."""
    fa, md, get_config, Model, serve = repro_torch_mods
    cfg = get_config(QWEN)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    _reset_lm_counters(fa, md)
    step_s: list = []
    serve.generate(model, prompts, LM_GEN, step_s=step_s)
    t0 = time.perf_counter()
    serve.generate(model, prompts, LM_GEN).cpu()
    run_s = time.perf_counter() - t0
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, LM_PROMPT))).to(dev)
    full, _ = model.forward(toks)
    cache = model.init_cache(2, LM_PROMPT)
    worst = 0.0
    for t in range(LM_PROMPT):
        step, cache = model.decode_step(cache, toks[:, t:t + 1])
        err = float((step[:, 0] - full[:, t]).abs().max())
        scale = max(1.0, float(full[:, t].abs().max()))
        assert err < DECODE_RTOL * scale, f"{QWEN} t={t}: decode vs forward {err} (scale {scale})"
        worst = max(worst, err / scale)
    assert torch.isfinite(full).all()
    launches = _lm_counters(fa, md)
    # one query a step: two generate runs (prompt + generated steps) and the
    # decode_step loop take the decode route; the one 16-token forward the tile route
    steps = 2 * (LM_PROMPT + LM_GEN) + LM_PROMPT
    assert launches["flash_attention_decode"] == steps * cfg.n_layers, launches
    assert launches["flash_attention_tile"] == cfg.n_layers, launches
    assert launches["flash_attention_sm90"] == 0, "a float32 attention took the sm90 kernel"
    median_ms = statistics.median(step_s) * 1e3
    bound_ms = model.param_bytes() / HBM_BYTES_PER_S * 1e3  # tied head: the table is read
    row = {
        "phase": "lm", "model": QWEN, "dtype": "float32", "reduced": {},
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen_len": LM_GEN,
        "param_bytes": model.param_bytes(), "decode_steps": len(step_s),
        "median_step_ms": median_ms, "step_ms_min_max": [min(step_s) * 1e3, max(step_s) * 1e3],
        "tokens_per_s": LM_BATCH * (LM_PROMPT + LM_GEN) / run_s,
        "step_bound_ms": bound_ms, "step_bound_share": bound_ms / median_ms,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "decode_vs_forward": {"positions": LM_PROMPT, "max_err_over_scale": worst,
                              "rtol": DECODE_RTOL},
        "launches": launches,
    }
    row["profile_decode_step"] = _profile_step(model, prompts)
    del model, full
    return row


def qwen_prefill_phase(repro_torch_mods, ref, dev: str, seed: int) -> dict:
    """qwen3-0.6b at its full config in bf16 (as ``launch/serve.py`` runs
    it): ``Model.forward`` over LM_BATCH x PREFILL_LEN prompt tokens from
    the seed. First the tensor-core kernel is held to its plain version at
    exactly that forward's attention shape and layout; then one warm-up
    forward with the counters set to 0 just before and read just after
    (one sm90 launch per layer), PREFILL_RUNS timed forwards (host clock
    ending in a synchronise; the median is kept) and one profiled forward
    (device busy time and the flash kernel's share of it)."""
    fa, md, get_config, Model, serve = repro_torch_mods
    cfg = get_config(QWEN)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    # the forward's layout: [B, L, H, Dh] activations viewed as [B, H, L, Dh]
    q, k, v = (torch.randn(LM_BATCH, PREFILL_LEN, n, dh, generator=gen, device=dev)
               .bfloat16().transpose(1, 2) for n in (h, hkv, hkv))
    before = fa.SM90_LAUNCHES
    got = fa.flash_attention(q, k, v, True)
    assert fa.SM90_LAUNCHES == before + 1
    name = f"flash_attention_sm90 {tuple(q.shape)} over {tuple(k.shape)}"
    shape_err = check_close(name, got, ref.flash_attention_ref(q, k, v, True))
    rel = check_row_rel(name, got, q, k, v, True, ref)
    shape = {"q": list(q.shape), "kv": list(k.shape), "causal": True, "dtype": "bfloat16"}
    del q, k, v, got
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    tokens = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_size, (LM_BATCH, PREFILL_LEN))).to(dev)
    _reset_lm_counters(fa, md)
    logits, _ = model.forward(tokens)
    torch.cuda.synchronize()
    launches = _lm_counters(fa, md)
    assert launches == {"flash_attention_sm90": cfg.n_layers, "flash_attention_tile": 0,
                        "flash_attention_decode": 0, "moe_gather": 0}, launches
    assert logits.shape == (LM_BATCH, PREFILL_LEN, cfg.vocab_size)
    assert torch.isfinite(logits).all(), f"{QWEN} bf16 forward: non-finite logits"
    del logits
    runs_s = []
    for _ in range(PREFILL_RUNS):
        t0 = time.perf_counter()
        model.forward(tokens)
        torch.cuda.synchronize()
        runs_s.append(time.perf_counter() - t0)
    prof = profile_run(lambda: model.forward(tokens), top=8, focus="flash_attention_sm90")
    pairs = PREFILL_LEN * (PREFILL_LEN + 1) // 2
    attn_flop = cfg.n_layers * 4 * LM_BATCH * h * pairs * dh
    row = {
        "phase": "lm_prefill", "model": QWEN, "dtype": "bfloat16", "reduced": {},
        "batch": LM_BATCH, "prompt_len": PREFILL_LEN,
        "kernel_check": {"shape": shape, "max_abs_err": shape_err,
                         "tol": FA_TOL[torch.bfloat16], **rel},
        "forward_ms_median": statistics.median(runs_s) * 1e3,
        "forward_ms_runs": [t * 1e3 for t in runs_s],
        "attention_flop": attn_flop,
        "attention_bound_ms": attn_flop / BF16_OPS_PER_S * 1e3,
        "launches_per_forward": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "profile_forward": prof,
    }
    del model
    return row


def qwen_prefill_f32_phase(repro_torch_mods, ref, dev: str, seed: int) -> dict:
    """qwen3-0.6b at its full config in float32: ``Model.forward`` over
    LM_BATCH x PREFILL_LEN prompt tokens from the seed, the float32 tile
    route's path at full width. First the tile route is held to its plain
    version at exactly that forward's attention shape and layout ([4, 16,
    2048, 128] over [4, 8, 2048, 128], viewed from [B, L, H, Dh]) within
    FA_TOL[float32], gives the same bits on two calls, and is timed beside
    the plain version and SDPA; then one warm-up forward with the counters
    set to 0 just before and read just after (one tile-route launch per
    layer, none of the decode route or the sm90 kernel), PREFILL_RUNS timed
    forwards (host clock ending in a synchronise; the median is kept) and
    one profiled forward (device busy time and the tile route's share of
    it)."""
    fa, md, get_config, Model, serve = repro_torch_mods
    cfg = get_config(QWEN)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    q, k, v = (torch.randn(LM_BATCH, PREFILL_LEN, n, dh, generator=gen, device=dev)
               .transpose(1, 2) for n in (h, hkv, hkv))
    pairs = PREFILL_LEN * (PREFILL_LEN + 1) // 2
    check = _attention_row(fa, ref, q, k, v, True, pairs, 3, device_side=True)
    assert check["route"] == "cuda_core", check["route"]
    check["same_bits_twice"] = torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v))
    assert check["same_bits_twice"], "lm_prefill_f32: two calls gave different bits"
    check["tile"] = tile_facts(fa, q, k)
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    tokens = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, (LM_BATCH, PREFILL_LEN))).to(dev)
    _reset_lm_counters(fa, md)
    logits, _ = model.forward(tokens)
    torch.cuda.synchronize()
    launches = _lm_counters(fa, md)
    assert launches == {"flash_attention_tile": cfg.n_layers, "flash_attention_decode": 0,
                        "flash_attention_sm90": 0, "moe_gather": 0}, launches
    assert logits.shape == (LM_BATCH, PREFILL_LEN, cfg.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all(), \
        f"{QWEN} f32 forward: non-finite logits"
    del logits
    runs_s = []
    for _ in range(PREFILL_RUNS):
        t0 = time.perf_counter()
        model.forward(tokens)
        torch.cuda.synchronize()
        runs_s.append(time.perf_counter() - t0)
    prof = profile_run(lambda: model.forward(tokens), top=8, focus="flash_attention_kernel")
    attn_flop = cfg.n_layers * 4 * LM_BATCH * h * pairs * dh
    row = {
        "phase": "lm_prefill_f32", "model": QWEN, "dtype": "float32", "reduced": {},
        "batch": LM_BATCH, "prompt_len": PREFILL_LEN,
        "kernel_check": {"tol": FA_TOL[torch.float32], **check},
        "forward_ms_median": statistics.median(runs_s) * 1e3,
        "forward_ms_runs": [t * 1e3 for t in runs_s],
        "attention_flop": attn_flop,
        "attention_bound_ms": attn_flop / F32_OPS_PER_S * 1e3,
        "attention_bound_share": (attn_flop / F32_OPS_PER_S * 1e3 / prof["focus_ms"]
                                  if prof["focus_ms"] else None),
        "launches_per_forward": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "profile_forward": prof,
    }
    del model
    return row


# -- phase 4g: the attention families beyond the dense and GQA-MoE ones -----


def tile_row(fa, ref, q, k, v, pairs: int, window: int = 0, scale: float = None) -> dict:
    """A float32 tile-route row (:func:`_attention_row`, device times) with
    its plan, the same bits twice and with the log-sum-exp, and the tile
    rescale fault control."""
    row = _attention_row(fa, ref, q, k, v, True, pairs, 20, device_side=True, window=window,
                         scale=scale)
    assert row["route"] == "cuda_core", row["route"]
    row["tile"] = tile_facts(fa, q, k, v)
    row.update(same_bits(fa, q, k, v, window, scale))
    row["tile_rescale_control"] = tile_rescale_control(fa, ref, q, k, v, window, scale)
    return row


def decode_row(fa, ref, q, k, v, pairs: int, faults: tuple) -> dict:
    """A float32 decode-route row (:func:`_attention_row`, device times)
    over a cache read in place (no copy of k or v), with its plan, the
    ``ptxas`` resources of its instantiation, the same bits twice and the
    fault controls ``faults`` (:func:`decode_control`)."""
    assert fa._aligned(k) is k and fa._aligned(v) is v, "the cache is not read in place"
    row = _attention_row(fa, ref, q, k, v, True, pairs, 20, device_side=True)
    assert row["route"] == "decode", row["route"]
    row["cache_read_in_place"] = True
    dk = fa.kernel_widths("decode", q.shape[3], v.shape[3])[0]
    row["ptxas"] = decode_resources(FA_PTXAS, dk, row["decode"]["row_tile"])
    row.update(same_bits(fa, q, k, v))
    for fault in faults:
        row[f"{fault}_control"] = decode_control(fa, ref, q, k, v, fault)
    return row


def family_kernel_rows(fa, ref, dev: str, seed: int) -> dict:
    """The tensor-core kernel at the new families' widths, bf16, each held
    to its plain version and timed beside it, its bound and SDPA (same
    scale): h2o-danube's prefill ([1, 32, 4096, 120] over 8 kv heads,
    window 4096, which hides no key at 4,096 tokens, so SDPA's causal mask
    is the same function), hubert's bidirectional frames ([4, 16, 1000,
    80]), deepseek-v2's MLA prefill ([1, 128, 2048] at (Dqk, Dv) = (192,
    128), scale 1/sqrt(192)) and its absorbed decode (128 heads, one query,
    over one latent kv head of 32 and 4,096 slots at (576, 512), the values
    a view of the keys' first 512 columns; device times from profiler
    events). Then the float32 routes at the shapes phase 4g runs them:
    h2o-danube's ring forward on the tile route ([1, 32, 4160, 120], its
    window of 4,096 hiding keys: SDPA takes it as a mask) and its decode step
    over the full ring ([1, 32, 1, 120] over 4,096 slots), MLA's layer
    forward ([1, 128, 64] at (192, 128)) and its absorbed decode step over
    64 latent slots, each with its route read from the counters."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    mla_scale = 1.0 / math.sqrt(192)
    rows = {}
    s = 4096
    rows["flash_attention_sm90_h2o_prefill"] = _attention_row(
        fa, ref, rnd(1, 32, s, 120), rnd(1, 8, s, 120), rnd(1, 8, s, 120), True,
        s * (s + 1) // 2, 3, window=4096)
    s = HUBERT_FRAMES
    rows["flash_attention_sm90_hubert"] = _attention_row(
        fa, ref, rnd(4, 16, s, 80), rnd(4, 16, s, 80), rnd(4, 16, s, 80), False, s * s, 3)
    s = FAMILY_PREFILL
    rows["flash_attention_sm90_mla_prefill"] = _attention_row(
        fa, ref, rnd(1, 128, s, 192), rnd(1, 128, s, 192), rnd(1, 128, s, 128), True,
        s * (s + 1) // 2, 3, scale=mla_scale)
    for n in (LM_PROMPT + LM_GEN, LONG_CACHE):
        keys = rnd(LM_BATCH, n, 576)[:, None]  # the latent [B, 1, n, 576]
        row = _attention_row(fa, ref, rnd(LM_BATCH, 128, 1, 576), keys, keys[..., :512], True,
                             n, 20, device_side=True, scale=mla_scale)
        assert row["shape"]["values_view_keys"]
        rows[f"flash_attention_sm90_mla_decode_{n}"] = row
        del keys

    def rnd32(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    s = WRAP_TOKENS
    row = _attention_row(fa, ref, rnd32(1, 32, s, 120), rnd32(1, 8, s, 120), rnd32(1, 8, s, 120),
                         True, sum(min(p + 1, 4096) for p in range(s)), 2, device_side=True,
                         window=4096)
    assert row["route"] == "cuda_core", row["route"]
    rows["flash_attention_tile_h2o_ring_forward"] = row
    # the ring's K and V, [B, buf, Hkv, Dh] each, read in place
    ck, cv = (rnd32(1, 4096, 8, 120).transpose(1, 2) for _ in range(2))
    q = rnd32(1, 1, 32, 120).transpose(1, 2)
    rows["flash_attention_decode_h2o_ring"] = decode_row(fa, ref, q, ck, cv, 4096,
                                                         ("no_split_rescale", "lost_split"))
    del ck, cv
    n = MLA_CHECK_POSITIONS
    q, k, v = rnd32(1, 128, n, 192), rnd32(1, 128, n, 192), rnd32(1, 128, n, 128)
    rows["flash_attention_tile_mla_forward"] = tile_row(fa, ref, q, k, v, n * (n + 1) // 2,
                                                        scale=mla_scale)
    keys = rnd32(1, n, 576)[:, None]
    row = _attention_row(fa, ref, rnd32(1, 128, 1, 576), keys, keys[..., :512], True, n, 20,
                         device_side=True, scale=mla_scale)
    assert row["route"] == "decode", row["route"]
    rows["flash_attention_decode_mla"] = row
    return rows


def _init_params(params, gen) -> None:
    """Draw a parameter dict as ``Model.init`` draws its weights."""
    from repro_torch.models.layers import init_normal_

    for p in params.values():
        if p.init_scale is not None:
            init_normal_(p, p.init_scale, gen)


def _relative_errors(got, want) -> torch.Tensor:
    """max |got - want| / max(1, max |want|) over the last dim, for each
    row, on the device (no synchronise)."""
    return (got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1).clamp_min(1.0)


def deepseek_phase(mods, dev: str, seed: int, smi: str) -> dict:
    """deepseek-v2-236b at full width, depth cut to 2 (1 dense + 1 MoE
    layer, as the Kimi phase cuts), bf16: ``generate`` twice (batch 4,
    prompt 16, generate 16), the same tokens and finite logits, one
    forward over 1 x 2048 tokens; the sm90 kernel and the MoE gather both
    launched. Then one MLA layer at full width in float32: ``mla_forward``
    (the tile route at (192, 128)) against 64 absorbed ``mla_decode`` steps
    (the decode route at (576, 512), 128 heads over one latent kv head)
    within DECODE_RTOL x max(1, |out|)."""
    from repro_torch.models import attention as attn_mod

    fa, md, get_config, Model, serve = mods
    full = get_config(DEEPSEEK)
    cfg = full.scaled(n_layers=DEEPSEEK_LAYERS)
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed + 5)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, FAMILY_PREFILL))).to(dev)
    _reset_lm_counters(fa, md)
    step_s: list = []
    first = serve.generate(model, prompts, LM_GEN, step_s=step_s).cpu()
    second = serve.generate(model, prompts, LM_GEN).cpu()
    logits, aux = model.forward(tokens)
    finite = bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    launches = _lm_counters(fa, md)
    assert torch.equal(first, second), f"{DEEPSEEK}: two generate runs gave different tokens"
    assert first.shape == (LM_BATCH, LM_GEN) and finite, f"{DEEPSEEK}: tokens or logits"
    assert launches["flash_attention_sm90"] > 0 and launches["moe_gather"] > 0, launches
    assert launches["flash_attention_tile"] == launches["flash_attention_decode"] == 0, launches
    row = {"phase": "lm_families", "model": DEEPSEEK, "dtype": "bfloat16", "card": smi,
           "config": {key: getattr(cfg, key) for key in (
               "d_model", "n_layers", "first_dense_layers", "n_heads", "kv_lora_rank",
               "q_lora_rank", "rope_head_dim", "v_head_dim", "n_experts", "top_k",
               "vocab_size")},
           "reduced": {"n_layers": [full.n_layers, DEEPSEEK_LAYERS]},
           "param_bytes": model.param_bytes(), "tokens_identical": True,
           "tokens": first[:2].tolist(), "median_step_ms": statistics.median(step_s) * 1e3,
           "forward_tokens": FAMILY_PREFILL, "forward_drop_fraction": float(aux["drop_fraction"]),
           "launches": launches, "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    p = attn_mod.mla_init(full, torch.float32, dev)
    _init_params(p, gen)
    n = MLA_CHECK_POSITIONS
    x = torch.randn(1, n, full.d_model, generator=gen, device=dev)
    _reset_lm_counters(fa, md)
    out = attn_mod.mla_forward(p, full, x, torch.arange(n, device=dev)[None])
    cache = attn_mod.mla_init_cache(full, 1, n, torch.float32, dev)
    steps = torch.cat([attn_mod.mla_decode(p, full, cache, x[:, t:t + 1], t)[0]
                       for t in range(n)], dim=1)
    worst = float(_relative_errors(steps, out).max())
    mla = _lm_counters(fa, md)
    assert worst <= DECODE_RTOL, f"{DEEPSEEK} MLA layer: decode vs forward {worst}"
    assert mla["flash_attention_tile"] == 1 and mla["flash_attention_decode"] == n, mla
    row["mla_layer_f32"] = {"positions": n, "max_err_over_scale": worst, "rtol": DECODE_RTOL,
                            "launches": mla, "out_scale": float(out.abs().max())}
    row["seconds"] = time.perf_counter() - t_model
    del p, cache, out, steps
    return row


def h2o_phase(mods, dev: str, seed: int, smi: str) -> dict:
    """h2o-danube-3-4b at its full config: ``generate`` twice in bf16 (the
    same tokens, finite logits, sm90 launches); then the ring wrap in
    float32, batch 1, at WRAP_LAYERS layers: a teacher-forced decode of
    WRAP_TOKENS tokens into
    ``init_cache(1, WRAP_CACHE)`` (a ring of 4,096 slots that wraps at step
    4,096; the decode route at Dh 120) against one forward over the same
    tokens (the tile route, whose window of 4,096 hides keys past it):
    every step's logits within DECODE_RTOL x max(1, |logits|), the last 64
    past the wrap among them."""
    fa, md, get_config, Model, serve = mods
    cfg = get_config(H2O)
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed + 8)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    _reset_lm_counters(fa, md)
    step_s: list = []
    first = serve.generate(model, prompts, LM_GEN, step_s=step_s).cpu()
    second = serve.generate(model, prompts, LM_GEN).cpu()
    torch.cuda.synchronize()
    launches = _lm_counters(fa, md)
    assert torch.equal(first, second), f"{H2O}: two generate runs gave different tokens"
    assert launches["flash_attention_sm90"] == 2 * (LM_PROMPT + LM_GEN) * cfg.n_layers, launches
    row = {"phase": "lm_families", "model": H2O, "dtype": "bfloat16", "card": smi,
           "config": {key: getattr(cfg, key) for key in (
               "d_model", "n_layers", "n_heads", "n_kv_heads", "head_dim", "sliding_window",
               "d_ff", "vocab_size")},
           "reduced": {}, "param_bytes": model.param_bytes(), "tokens_identical": True,
           "tokens": first[:2].tolist(), "median_step_ms": statistics.median(step_s) * 1e3,
           "launches": launches}
    del model
    gc.collect()
    torch.cuda.empty_cache()

    wrap_cfg = cfg.scaled(n_layers=WRAP_LAYERS)
    model = Model(wrap_cfg, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, WRAP_TOKENS))).to(dev)
    _reset_lm_counters(fa, md)
    t0 = time.perf_counter()
    full, _ = model.forward(toks)
    cache = model.init_cache(1, WRAP_CACHE)
    ring = cache["kv"][0]["k"].shape[1]
    errs = torch.empty(WRAP_TOKENS, device=dev)
    for t in range(WRAP_TOKENS):
        step, cache = model.decode_step(cache, toks[:, t:t + 1])
        errs[t] = _relative_errors(step[0], full[0, t:t + 1]).max()
    errs = errs.cpu()
    wrap_s = time.perf_counter() - t0
    wrap = _lm_counters(fa, md)
    assert ring == cfg.sliding_window < WRAP_TOKENS, ring
    worst_tail, worst = float(errs[-64:].max()), float(errs.max())
    assert worst <= DECODE_RTOL, f"{H2O} ring: decode vs forward {worst} at step " \
                                 f"{int(errs.argmax())}"
    assert wrap["flash_attention_tile"] == wrap_cfg.n_layers, wrap
    assert wrap["flash_attention_decode"] == WRAP_TOKENS * wrap_cfg.n_layers, wrap
    row["ring_wrap_f32"] = {
        "tokens": WRAP_TOKENS, "cache_len": WRAP_CACHE, "ring_slots": ring,
        "steps_past_wrap": WRAP_TOKENS - ring, "max_err_over_scale_last_64": worst_tail,
        "max_err_over_scale": worst, "rtol": DECODE_RTOL, "seconds": wrap_s,
        "reduced": ({"n_layers": [cfg.n_layers, WRAP_LAYERS]} if WRAP_LAYERS != cfg.n_layers
                    else {}),
        "launches": wrap, "max_memory_allocated": torch.cuda.max_memory_allocated()}
    row["seconds"] = time.perf_counter() - t_model
    del model, full, cache
    return row


def qwen2vl_phase(mods, dev: str, seed: int, smi: str) -> dict:
    """qwen2-vl-2b at its full config, from seeded patch embeddings: a bf16
    forward over [4, 2048, 1536] (finite, one sm90 launch a layer); then in
    float32, 16 teacher-forced ``decode_step``s on embeddings against an f32
    forward's first 16 positions, within DECODE_RTOL x max(1, |logits|)."""
    fa, md, get_config, Model, serve = mods
    cfg = get_config(QWEN2VL)
    t_model = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    embeds = torch.randn(LM_BATCH, FAMILY_PREFILL, cfg.d_model, generator=gen,
                         device=dev).bfloat16()
    _reset_lm_counters(fa, md)
    logits, _ = model.forward(embeds=embeds)
    finite = bool(torch.isfinite(logits).all())
    launches = _lm_counters(fa, md)
    assert finite and logits.shape == (LM_BATCH, FAMILY_PREFILL, cfg.vocab_size)
    assert launches["flash_attention_sm90"] == cfg.n_layers, launches
    row = {"phase": "lm_families", "model": QWEN2VL, "dtype": "bfloat16", "card": smi,
           "config": {key: getattr(cfg, key) for key in (
               "d_model", "n_layers", "n_heads", "n_kv_heads", "head_dim", "mrope", "frontend",
               "vocab_size")},
           "reduced": {}, "param_bytes": model.param_bytes(),
           "forward_embeds": [LM_BATCH, FAMILY_PREFILL, cfg.d_model], "launches": launches}
    del model, logits, embeds
    gc.collect()
    torch.cuda.empty_cache()

    model = Model(cfg, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    embeds = torch.randn(2, LM_PROMPT, cfg.d_model, generator=gen, device=dev)
    _reset_lm_counters(fa, md)
    full, _ = model.forward(embeds=embeds)
    cache = model.init_cache(2, LM_PROMPT)
    steps = []
    for t in range(LM_PROMPT):
        step, cache = model.decode_step(cache, embeds[:, t:t + 1])
        steps.append(step)
    worst = float(_relative_errors(torch.cat(steps, dim=1), full).max())
    f32 = _lm_counters(fa, md)
    assert worst <= DECODE_RTOL, f"{QWEN2VL}: decode vs forward {worst}"
    assert f32["flash_attention_decode"] == LM_PROMPT * cfg.n_layers, f32
    row["decode_vs_forward_f32"] = {"positions": LM_PROMPT, "max_err_over_scale": worst,
                                    "rtol": DECODE_RTOL, "launches": f32}
    row["seconds"] = time.perf_counter() - t_model
    del model, full, cache
    return row


def hubert_phase(mods, dev: str, seed: int, smi: str) -> dict:
    """hubert-xlarge at its full config, bf16: a bidirectional forward over
    seeded frame embeddings [4, 1000, 1280], twice, with equal bits and
    finite logits (one sm90 launch a layer a forward)."""
    fa, md, get_config, Model, serve = mods
    cfg = get_config(HUBERT)
    t_model = time.perf_counter()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    frames = torch.randn(LM_BATCH, HUBERT_FRAMES, cfg.d_model,
                         generator=torch.Generator(device=dev).manual_seed(seed + 10),
                         device=dev).bfloat16()
    _reset_lm_counters(fa, md)
    a, _ = model.forward(embeds=frames)
    b, _ = model.forward(embeds=frames)
    launches = _lm_counters(fa, md)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all()), f"{HUBERT}: forward"
    assert launches["flash_attention_sm90"] == 2 * cfg.n_layers, launches
    row = {"phase": "lm_families", "model": HUBERT, "dtype": "bfloat16", "card": smi,
           "config": {key: getattr(cfg, key) for key in (
               "d_model", "n_layers", "n_heads", "head_dim", "causal", "has_decoder",
               "frontend", "vocab_size")},
           "reduced": {}, "param_bytes": model.param_bytes(),
           "forward_embeds": [LM_BATCH, HUBERT_FRAMES, cfg.d_model], "same_bits_twice": True,
           "launches": launches, "seconds": time.perf_counter() - t_model}
    del model, a, b
    return row


def lm_families_phase(mods, ref, dev: str, seed: int, smi: str) -> tuple:
    """Phase 4g: the kernel rows at the new widths, then deepseek-v2,
    h2o-danube-3, qwen2-vl and hubert, each with the LM counters set to 0
    just before it and read just after. Returns (rows, kernel rows,
    launches summed over the models)."""
    fa, md = mods[0], mods[1]
    t_phase = time.perf_counter()
    kernel_rows = family_kernel_rows(fa, ref, dev, seed)
    for name, row in kernel_rows.items():
        log({"phase": "lm_families", "kernel": name, "card": smi, **row})
    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    for run in (deepseek_phase, h2o_phase, qwen2vl_phase, hubert_phase):
        rows.append(run(mods, dev, seed, smi))
        log(rows[-1])
        gc.collect()
        torch.cuda.empty_cache()
    total = {key: 0 for key in _lm_counters(fa, md)}
    for row in rows:
        for part in (row, row.get("mla_layer_f32"), row.get("ring_wrap_f32"),
                     row.get("decode_vs_forward_f32")):
            if part:
                for key, n in part["launches"].items():
                    total[key] += n
    log({"phase": "lm_families", "launches": total, "phase_s": time.perf_counter() - t_phase})
    return rows, kernel_rows, total


# -- phase 4h: the recurrent families (Mamba2 with zamba2's shared attention; xLSTM) --


def ssm_kernel_rows(fa, ref, dev: str, seed: int) -> dict:
    """The kernels at zamba2's shared attention (32 heads, as many kv heads,
    Dh 80, window 4,096): the bf16 prefill [4, 32, 2048, 80] (the window
    hides no key at 2,048 tokens, so SDPA's causal mask is the same
    function) at ``<128, 128, 64>``, held to its plain version with the
    row-relative check and its controls; then the float32 routes at the
    shapes the f32 check runs them: the tile route over a 64-token forward
    ([2, 32, 64, 80]) and the decode route over the last step's 64 slots of
    the ring ([2, 32, 1, 80], the cache read in place)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 11)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    rows = {}
    s, b = SSM_PREFILL, LM_BATCH
    bf = torch.bfloat16
    rows["flash_attention_sm90_zamba2_prefill"] = _attention_row(
        fa, ref, rnd(b, 32, s, 80, dtype=bf), rnd(b, 32, s, 80, dtype=bf),
        rnd(b, 32, s, 80, dtype=bf), True, s * (s + 1) // 2, 3, window=4096)
    n = SSM_CHECK_POSITIONS
    rows["flash_attention_tile_zamba2_forward"] = tile_row(
        fa, ref, rnd(2, 32, n, 80), rnd(2, 32, n, 80), rnd(2, 32, n, 80), n * (n + 1) // 2,
        window=4096)
    ck, cv = (rnd(2, n, 32, 80).transpose(1, 2) for _ in range(2))
    rows["flash_attention_decode_zamba2"] = decode_row(
        fa, ref, rnd(2, 1, 32, 80).transpose(1, 2), ck, cv, n, ("no_unit_rescale",))
    return rows


def _bf16_serving(fa, md, serve, model, prompts, name: str) -> dict:
    """``generate`` twice (batch 4, prompt 16, generate 16) with the LM
    counters set to 0 just before: the same tokens, in range; the decode
    steps' times and the launches."""
    _reset_lm_counters(fa, md)
    step_s: list = []
    t0 = time.perf_counter()
    first = serve.generate(model, prompts, LM_GEN, step_s=step_s).cpu()
    first_s = time.perf_counter() - t0
    second = serve.generate(model, prompts, LM_GEN).cpu()
    torch.cuda.synchronize()
    launches = _lm_counters(fa, md)
    assert torch.equal(first, second), f"{name}: two generate runs gave different tokens"
    assert first.shape == (LM_BATCH, LM_GEN)
    assert bool(((first >= 0) & (first < model.cfg.vocab_size)).all()), name
    return {"tokens_identical": True, "tokens": first[:2].tolist(), "decode_steps": len(step_s),
            "median_step_ms": statistics.median(step_s) * 1e3,
            "step_ms_min_max": [min(step_s) * 1e3, max(step_s) * 1e3],
            "first_run_s": first_s, "launches": launches}


def _decode_vs_forward(model, toks, full) -> tuple:
    """Teacher-forced ``decode_step`` over ``toks [B, n]`` against ``full``,
    the forward's logits at the same positions: (worst error over scale,
    the step at it), read after the last step."""
    n = toks.shape[1]
    cache = model.init_cache(toks.shape[0], n)
    errs = torch.empty(n, device=toks.device)
    for t in range(n):
        step, cache = model.decode_step(cache, toks[:, t:t + 1])
        errs[t] = _relative_errors(step[:, 0], full[:, t]).max()
    errs = errs.cpu()
    return float(errs.max()), int(errs.argmax())


def forward_forms(model, tokens) -> dict:
    """The two forms of the SSD's products (zamba2) in one forward of
    ``tokens``: in place (no grad mode, as ``forward``
    serves) and out of place (grad mode on with no parameter taking a
    gradient: the form a train step runs, without its graph), run in the
    order in place, out of place, out of place, in place. Each form's wall
    ms a run and its transient peak, ``max_memory_allocated`` less what
    was allocated before the run."""
    forms = {"in_place": torch.no_grad, "out_of_place": torch.enable_grad}
    runs = {name: {"ms": [], "peak_bytes": []} for name in forms}
    for name in ("in_place", "out_of_place", "out_of_place", "in_place"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with forms[name]():
            logits, _ = model._forward(tokens, None)
        torch.cuda.synchronize()
        runs[name]["ms"].append((time.perf_counter() - t0) * 1e3)
        runs[name]["peak_bytes"].append(torch.cuda.max_memory_allocated() - base)
        assert logits.grad_fn is None
        del logits
    return runs


def zamba2_phase(mods, dev: str, seed: int, smi: str) -> dict:
    """zamba2-2.7b at its full config. bf16: ``generate`` twice (one sm90
    launch a group a step, none of the f32 routes), a forward over [4,
    2048] tokens (a warm-up, then SSM_FORWARD_RUNS timed; finite logits; one
    sm90 launch a group), one warm decode step and one forward profiled.
    float32 at full depth: SSM_CHECK_POSITIONS teacher-forced decode steps
    against one forward (the tile route once a group, the decode route once
    a group a step), within DECODE_RTOL x max(1, |logits|)."""
    fa, md, get_config, Model, serve = mods
    cfg = get_config(ZAMBA)
    groups = cfg.n_layers // cfg.attn_every
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed + 12)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    served = _bf16_serving(fa, md, serve, model, prompts, ZAMBA)
    launches = served["launches"]
    assert launches["flash_attention_sm90"] == 2 * (LM_PROMPT + LM_GEN) * groups, launches
    assert launches["flash_attention_tile"] == launches["flash_attention_decode"] == 0, launches

    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, SSM_PREFILL))).to(dev)
    _reset_lm_counters(fa, md)
    logits, _ = model.forward(tokens)
    torch.cuda.synchronize()
    fwd_launches = _lm_counters(fa, md)
    assert fwd_launches["flash_attention_sm90"] == groups, fwd_launches
    assert logits.shape == (LM_BATCH, SSM_PREFILL, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), f"{ZAMBA}: non-finite forward logits"
    del logits
    forward_s = []
    for _ in range(SSM_FORWARD_RUNS):
        t0 = time.perf_counter()
        model.forward(tokens)
        torch.cuda.synchronize()
        forward_s.append(time.perf_counter() - t0)
    row = {"phase": "ssm_families", "model": ZAMBA, "dtype": "bfloat16", "card": smi,
           "config": {key: getattr(cfg, key) for key in (
               "d_model", "n_layers", "attn_every", "n_heads", "n_kv_heads", "head_dim",
               "sliding_window", "ssm_state", "ssm_heads", "ssm_expand", "ssm_conv", "d_ff",
               "vocab_size")},
           "groups": groups, "reduced": {}, "param_bytes": model.param_bytes(), **served,
           "forward_tokens": [LM_BATCH, SSM_PREFILL], "forward_ms": statistics.median(
               forward_s) * 1e3, "forward_runs_ms": [t * 1e3 for t in forward_s],
           "forward_tokens_per_s": LM_BATCH * SSM_PREFILL / statistics.median(forward_s),
           "forward_launches": fwd_launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    row["profile_decode_step"] = _profile_step(model, prompts)
    row["profile_forward"] = profile_run(lambda: model.forward(tokens), top=8)
    row["forward_forms"] = forward_forms(model, tokens)
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()

    model = Model(cfg, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    n = SSM_CHECK_POSITIONS
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, n))).to(dev)
    _reset_lm_counters(fa, md)
    t0 = time.perf_counter()
    full, _ = model.forward(toks)
    worst, at = _decode_vs_forward(model, toks, full)
    f32 = _lm_counters(fa, md)
    assert worst <= DECODE_RTOL, f"{ZAMBA} f32: decode vs forward {worst} at step {at}"
    assert bool(torch.isfinite(full).all())
    assert f32["flash_attention_tile"] == groups and f32["flash_attention_sm90"] == 0, f32
    assert f32["flash_attention_decode"] == n * groups, f32
    row["decode_vs_forward_f32"] = {
        "positions": n, "batch": 2, "max_err_over_scale": worst, "at_step": at,
        "rtol": DECODE_RTOL, "seconds": time.perf_counter() - t0, "reduced": {},
        "param_bytes": model.param_bytes(), "launches": f32,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    row["seconds"] = time.perf_counter() - t_model
    del model, full
    return row


def xlstm_phase(mods, dev: str, seed: int, smi: str) -> dict:
    """xlstm-125m at its full config: ``generate`` twice in bf16 (the same
    tokens, no attention launch); in float32 one forward over [4, 2048]
    tokens (timed: each sLSTM layer steps through the 2,048 positions)
    against SSM_CHECK_POSITIONS teacher-forced decode steps, within
    DECODE_RTOL x max(1, |logits|)."""
    fa, md, get_config, Model, serve = mods
    cfg = get_config(XLSTM)
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed + 13)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    served = _bf16_serving(fa, md, serve, model, prompts, XLSTM)
    assert not any(served["launches"].values()), served["launches"]
    row = {"phase": "ssm_families", "model": XLSTM, "dtype": "bfloat16", "card": smi,
           "config": {key: getattr(cfg, key) for key in (
               "d_model", "n_layers", "slstm_every", "n_heads", "ssm_expand", "vocab_size")},
           "reduced": {}, "param_bytes": model.param_bytes(), **served,
           "profile_decode_step": _profile_step(model, prompts)}
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = Model(cfg, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, SSM_PREFILL))).to(dev)
    _reset_lm_counters(fa, md)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, _ = model.forward(tokens)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    n = SSM_CHECK_POSITIONS
    worst, at = _decode_vs_forward(model, tokens[:, :n], full[:, :n])
    f32 = _lm_counters(fa, md)
    assert worst <= DECODE_RTOL, f"{XLSTM} f32: decode vs forward {worst} at step {at}"
    assert bool(torch.isfinite(full).all()) and not any(f32.values()), f32
    row["decode_vs_forward_f32"] = {
        "forward_tokens": [LM_BATCH, SSM_PREFILL], "forward_ms": forward_s * 1e3,
        "positions": n, "batch": LM_BATCH, "max_err_over_scale": worst, "at_step": at,
        "rtol": DECODE_RTOL, "launches": f32,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    row["seconds"] = time.perf_counter() - t_model
    del model, full
    return row


def ssm_families_phase(mods, ref, dev: str, seed: int, smi: str) -> tuple:
    """Phase 4h: the kernel rows at zamba2's shared attention, then zamba2
    and xlstm, each with the LM counters set to 0 just before a run and
    read just after. Returns (rows, kernel rows, launches summed over the
    models)."""
    fa, md = mods[0], mods[1]
    t_phase = time.perf_counter()
    kernel_rows = ssm_kernel_rows(fa, ref, dev, seed)
    for name, row in kernel_rows.items():
        log({"phase": "ssm_families", "kernel": name, "card": smi, **row})
    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    for run in (zamba2_phase, xlstm_phase):
        rows.append(run(mods, dev, seed, smi))
        log(rows[-1])
        gc.collect()
        torch.cuda.empty_cache()
    total = {key: 0 for key in _lm_counters(fa, md)}
    for row in rows:
        for part in (row, row.get("decode_vs_forward_f32")):
            for key, n in part["launches"].items():
                total[key] += n
        total["flash_attention_sm90"] += row.get("forward_launches", {}).get(
            "flash_attention_sm90", 0)
    log({"phase": "ssm_families", "launches": total, "phase_s": time.perf_counter() - t_phase})
    return rows, kernel_rows, total


# ---------------------------------------------------------------------------
# 4i. training: the backward kernels, qwen3-0.6b's train loop, deepseek-v2's
# MoE/MLA step, the gradient against the plain path, checkpoint resume
# ---------------------------------------------------------------------------

TRAIN_STEPS = 10  # qwen3-0.6b train steps through launch.train.main
TRAIN_ARGS = ["--seq-len", "2048", "--global-batch", "4", "--microbatches", "2"]
GRAD_LAYERS, GRAD_TOKENS = 2, 128  # the f32 gradient against the CPU's: qwen3 cut to 2 layers
GRAD_TOL = 1e-3  # each parameter's gradient within GRAD_TOL * max|g| of the CPU's
#: a bf16 gradient against the float32 plain twin: max over rows of
#: max |err| / max(rms(row), GRAD_ROW_FLOOR * rms(tensor)) within
#: ROW_REL_TOL (the forward rows' rule); the floor keeps a row whose
#: gradient cancels to rounding noise (a query that sees one key) from
#: dividing by that noise
GRAD_ROW_FLOOR = 1e-2
#: a float32 gradient against the twin: max |err| / max |g| per tensor
#: (grad_vs_plain's rule). The two sum orders' rounding reads ~1e-6 to
#: 1e-5; the twin on bf16-rounded inputs reads ~2e-3 to 4e-3, and each
#: float32 row asserts that this control fails
GRAD_F32_TOL = 1e-4
#: the rows' times on the first CUDA-core (SIMT) backward: for bf16 the
#: one csrc/flash_attention_bwd_sm90.cu replaced, for float32 the design
#: csrc/flash_attention_bwd.cu had before its register-blocked one (None:
#: never timed), ms (PERF.md section 6; H100 80GB HBM3, 700 W, queued CUDA
#: events)
SIMT_BWD_MS = {"qwen3": 15.03, "deepseek_v2_mla": 21.34, "zamba2_window": 5.951,
               "hubert": 2.958, "qwen3_f32": 15.45, "deepseek_v2_mla_f32": None}
#: the backward rows: (name, dtype, q [B, H, L, Dqk], kv heads, Dv, causal, window)
BWD_ROWS = [("qwen3", torch.bfloat16, (4, 16, 2048, 128), 8, 128, True, 0),
            ("qwen3_f32", torch.float32, (4, 16, 2048, 128), 8, 128, True, 0),
            ("deepseek_v2_mla", torch.bfloat16, (2, 128, 1024, 192), 128, 128, True, 0),
            ("deepseek_v2_mla_f32", torch.float32, (2, 128, 1024, 192), 128, 128, True, 0),
            ("zamba2_window", torch.bfloat16, (2, 32, 2048, 80), 32, 80, True, 512),
            ("hubert", torch.bfloat16, (2, 16, 1024, 80), 16, 80, False, 0)]


#: the kernels of each backward source (by dtype) a call runs; those
#: templated on the widths are read at the call's instantiation
BWD_KERNELS = {torch.bfloat16: ("dkdv_kernel", "dq_kernel"),
               torch.float32: ("delta_kernel", "dkdv_kernel", "dq_reduce_kernel")}


def bwd_resources(ptxas: list, widths, kernels=BWD_KERNELS[torch.bfloat16]) -> dict:
    """``ptxas`` registers and spills of a backward source's ``kernels`` at
    the instantiation ``widths`` (DQK, DV), from that source's build
    entries; None for a cached build (no log)."""
    if not ptxas:
        return None
    pat = f"ILi{widths[0]}ELi{widths[1]}E"
    out = {}
    for kernel in kernels:
        hits = [r for r in ptxas if kernel in r["entry"] and (pat in r["entry"] or
                                                              "ILi" not in r["entry"])]
        assert len(hits) == 1, f"ptxas: {len(hits)} entries match {kernel} {pat}"
        out[kernel] = {k: hits[0].get(k) for k in ("registers", "spill_store_bytes",
                                                    "spill_load_bytes")}
    return out


def grad_row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1).sqrt()
    floor = GRAD_ROW_FLOOR * w.pow(2).mean().sqrt()
    return float(((g - w).abs().amax(dim=-1) / torch.maximum(rms, floor).clamp_min(1e-30)).max())


def grad_max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    w = want.float()
    return float((got.float() - w).abs().max() / w.abs().max().clamp_min(1e-30))


def attention_bwd_control(ref, q, k, v, out, dout, causal: bool, window: int, keys: tuple):
    """The plain twin's formula with the keys ``[lo, hi)`` dropped from P
    (a key tile skipped): the fault the row-relative check must catch."""
    b, h, lq, dqk = q.shape
    group = h // k.shape[1]
    scale = 1.0 / math.sqrt(dqk)
    kr, vr = (t.float().repeat_interleave(group, dim=1) for t in (k, v))
    p, denom = ref._softmax_parts(q.float(), kr, causal, window, scale)
    p = p / denom
    p[..., keys[0]:keys[1]] = 0.0
    g = dout.float()
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", g, vr) - (g * out.float()).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = (torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale).unflatten(1, (-1, group)).sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g).unflatten(1, (-1, group)).sum(2)
    return dq, dk, dv


def _bwd_row(fa, ref, name, dtype, qshape, hkv, dv, causal, window, gen, ptxas) -> dict:
    """One backward row: the kernels against the plain twin on the card
    (dq, dk and dv; bf16 by the row-relative rule, float32 by max |err| /
    max |g|), the same bits twice, a fault control that must fail (a key
    tile dropped; for float32 also the twin on bf16-rounded inputs), the
    kernel's time (queued CUDA events) beside the plain twin's, SDPA's
    backward alone on one retained graph (the library, queued alike) and
    the bound of the least work: 2 * (3 Dqk + 2 Dv) FLOPs a visible
    (query, key) pair, and q, k, v, out and dout read once, dq, dk and dv
    written once. The forward also gives its log-sum-exp (its output the
    same bits as without; bf16 the tensor-core route's, float32 the tile
    route's), which the timed backward takes, as training does; the first
    of the two calls takes none and so runs the forward for it. ``ptxas``:
    the build entries of the row's backward source."""
    b, h, lq, dqk = qshape
    dev = gen.device
    q = torch.randn(b, h, lq, dqk, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, hkv, lq, dqk, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, hkv, lq, dv, generator=gen, device=dev).to(dtype)
    dout = torch.randn(b, h, lq, dv, generator=gen, device=dev).to(dtype)
    out = fa.flash_attention(q, k, v, causal, window)
    bf16 = dtype == torch.bfloat16
    with_lse, lse = fa._launch("sm90" if bf16 else "cuda_core", q, k, v, causal, window,
                               1.0 / math.sqrt(dqk), with_lse=True)
    assert torch.equal(with_lse, out), f"{name}: the forward's bits differ with lse"
    del with_lse

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, dout, causal, window, lse=lse)

    before = fa.BWD_LAUNCHES
    got, again = fa.flash_attention_bwd(q, k, v, out, dout, causal, window), kernel()
    assert fa.BWD_LAUNCHES - before == 2
    assert all(torch.equal(x, y) for x, y in zip(got, again)), f"{name}: bits differ"
    inputs = (q, k, v, out, dout)
    want = ref.flash_attention_bwd_ref(*(t.float() for t in inputs), causal, window)
    rule, tol = (grad_row_rel, ROW_REL_TOL) if bf16 else (grad_max_rel, GRAD_F32_TOL)
    errs = {f"d{x}": rule(a, w) for x, a, w in zip("qkv", got, want)}
    max_abs = max(float((a.float() - w).abs().max()) for a, w in zip(got, want))
    for x, a in zip("qkv", got):
        assert torch.isfinite(a).all(), f"{name}: d{x} not finite"
    assert all(e <= tol for e in errs.values()), f"{name}: gradient errors {errs} > {tol}"
    keys = control_keys(lq)
    faults = {"keys_dropped": attention_bwd_control(ref, *inputs, causal, window, keys)}
    if not bf16:  # a kernel that rounded to bf16 inside
        faults["bf16_inputs"] = ref.flash_attention_bwd_ref(
            *(t.bfloat16().float() for t in inputs), causal, window)
    caught = {}
    for fault, grads in faults.items():
        caught[fault] = {f"d{x}": rule(c, w) for x, c, w in zip("qkv", grads, want)}
        assert all(e > tol for e in caught[fault].values()), \
            f"{name}: the control {fault} passes: {caught[fault]}"
    del got, again, want, faults
    seen = visible_keys(lq, lq, causal, window, dev)
    pairs = int(seen.sum()) * b * h
    n_bytes = (2 * (q.numel() + k.numel() + v.numel()) + out.numel() + dout.numel()) \
        * q.element_size()
    rate = BF16_OPS_PER_S if bf16 else F32_OPS_PER_S
    b_ms, b_by = bound(n_bytes, 2 * (3 * dqk + 2 * dv) * pairs, rate)
    kernel_ms = queued_event_ms(kernel, 3)
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, dout, causal, window),
                       iters=1, warmup=1)
    mask = ({} if bool(seen.all()) else {"is_causal": True}
            if window == 0 else {"attn_mask": seen})
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, enable_gqa=True, **mask)
    lib_dout = torch.empty_like(lib_out.detach()).copy_(dout)  # laid out as its output

    def lib_bwd():
        return torch.autograd.grad(lib_out, leaves, lib_dout, retain_graph=True)

    backend = SDPBackend(torch._fused_sdp_choice(*leaves, enable_gqa=True, **mask)).name
    for _ in range(2):  # the backend's first calls pick and build its plan
        lib_bwd()
    library_ms = queued_event_ms(lib_bwd, 10)
    del lib_out, leaves
    widths = fa.bwd_widths(dqk, dv, dtype)
    simt = SIMT_BWD_MS[name]
    extra = {"source": "src/repro_torch/csrc/" + fa.BWD_SOURCES[dtype] + ".cu",
             "simt_ms": simt, "speedup_vs_simt": simt / kernel_ms if simt else None,
             "ptxas": bwd_resources(ptxas, widths, BWD_KERNELS[dtype]),
             "forward_lse_same_bits": True}
    if not bf16:
        extra["tiles"] = dict(zip(("keys", "rows"), fa.bwd_tiles(widths[0])))
        extra["dq_part_bytes"] = 4 * fa._bwd_entry("part")(b, h, lq, lq, dqk, dv)
    return {"route": "cuda", "dtype": str(dtype).split(".")[-1], "kernel_ms": kernel_ms,
            **extra, "library_factor": kernel_ms / library_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "torch.autograd.grad of scaled_dot_product_attention("
                            "enable_gqa=True" + "".join(f", {key}" for key in mask)
                            + "), the graph retained: its backward alone",
            "library_backend": backend,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / kernel_ms,
            "visible_pairs": pairs, "max_abs_err": max_abs,
            "grad_rule": "row_rel" if bf16 else "max_rel", "grad_err": errs, "grad_tol": tol,
            "control": {"keys_dropped": list(keys), "grad_err": caught},
            "same_bits_twice": True, "widths": list(widths),
            "shape": {"q": list(q.shape), "k": list(k.shape), "v": list(v.shape),
                      "causal": causal, "window": window}}


def _gather_bwd_row(md, ref, moe_mod, cfg, n_tokens: int, gen) -> dict:
    """The gather's transpose at deepseek-v2's dispatch of ``n_tokens``
    tokens (its groups, top-6 of 160 experts, capacity factor 1.25, D =
    5120, bf16): bit for bit its plain twin, twice; timed beside its byte
    bound (live slot rows read once, token rows written once, the inverse
    map's indices) and ``index_add_`` over the same slots."""
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    dev = gen.device
    g = moe_mod._dispatch_groups(n_tokens)
    tg = n_tokens // g
    cap = int(max(1, math.ceil(cfg.moe_capacity_factor * tg * k / e)))
    top_e = torch.rand(g, tg, e, generator=gen, device=dev).topk(k, dim=-1).indices
    _, order, offsets, sizes = moe_mod.route(top_e, e, cap)
    rows = (order // k).to(torch.int32)
    offsets, sizes = offsets.to(torch.int32), sizes.to(torch.int32)
    dout = torch.randn(g, e, cap, d, generator=gen, device=dev).bfloat16()

    def kernel():
        return md.moe_gather_bwd(dout, offsets, sizes, cap, tg, rows)

    before = md.BWD_LAUNCHES
    got, again = kernel(), kernel()
    assert md.BWD_LAUNCHES - before == 2
    want = ref.moe_gather_bwd_ref(dout, rows, offsets, sizes, cap, tg)
    assert torch.equal(got, want) and torch.equal(got, again), "moe_gather_bwd: not exact"
    # the library form: one index_add_ of every slot's row into its token
    # row, the dead slots into a spare row
    c = torch.arange(cap, device=dev)
    slot = (offsets.long()[..., None] + c).clamp(max=tg * k - 1)
    tok = rows.long().gather(1, slot.reshape(g, -1)).reshape(slot.shape)
    live = c < sizes.long()[..., None]
    index = torch.where(live, tok + tg * torch.arange(g, device=dev)[:, None, None],
                        g * tg).reshape(-1)
    flat = dout.reshape(-1, d)

    def library():
        return torch.zeros(g * tg + 1, d, dtype=dout.dtype, device=dev).index_add_(
            0, index, flat)

    lib_diff = float((library()[:-1].float() - got.reshape(-1, d).float()).abs().max())
    live_rows = int(sizes.sum())
    n_bytes = live_rows * d * 2 + got.numel() * 2 + 4 * (g * e * cap + g * (tg + 1))
    b_ms, b_by = bound(n_bytes, live_rows * d)
    dev_ms = device_ms(kernel, iters=10, focus="moe_gather_bwd_kernel")
    return {"route": "cuda", "kernel_ms": queued_event_ms(kernel, 10),
            "kernel_device_ms": dev_ms["ms"], "kernel_only_device_ms": dev_ms.get("focus_ms"),
            "plain_ms": time_ms(lambda: ref.moe_gather_bwd_ref(dout, rows, offsets, sizes, cap,
                                                               tg), iters=3, warmup=1),
            "library_ms": queued_event_ms(library, 10),
            "library_call": "torch.Tensor.index_add_ (slot -> token row map precomputed)",
            "library_max_abs_diff": lib_diff, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": 0.0, "same_bits_twice": True,
            "shape": {"tokens": n_tokens, "groups": g, "experts": e, "top_k": k,
                      "capacity": cap, "d": d, "live_slots": live_rows, "dtype": "bfloat16"}}


def _train_cli(train, argv) -> tuple:
    """``launch.train.main(argv)`` with its standard output captured:
    (the CSV rows as dicts, the other lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(argv) == 0
    lines = buf.getvalue().splitlines()
    head = lines.index("step,loss,grad_norm,lr,step_time_s")
    rows = [dict(zip(("step", "loss", "grad_norm", "lr", "step_time_s"), map(float,
                                                                              line.split(","))))
            for line in lines[head + 1:] if not line.startswith("#")]
    return rows, lines[:head] + [line for line in lines[head + 1:] if line.startswith("#")]


def qwen_train(mods, train, dev: str, seed: int) -> dict:
    """qwen3-0.6b at its full config in bf16 through ``launch.train.main``:
    10 steps of [4, 2048] tokens in two microbatches, remat on. The LM
    counters are set to 0 just before and read just after: 28 x 2 backward
    launches a step and twice as many forward ones (remat). Then one more
    step, built the same way outside the CLI, profiled."""
    fa, md, get_config, Model = mods[0], mods[1], mods[2], mods[3]
    from repro_torch.data import SyntheticLM
    from repro_torch.train import OptConfig, init_state, make_train_step

    cfg = get_config(QWEN)
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_counters(fa, md)
    fa.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    rows, _ = _train_cli(train, ["--arch", QWEN, "--steps", str(TRAIN_STEPS), *TRAIN_ARGS,
                                 "--seed", str(seed), "--log-every", "1", "--device", dev])
    wall_s = time.perf_counter() - t0
    launches = {**_lm_counters(fa, md), "flash_attention_bwd": fa.BWD_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    assert [int(r["step"]) for r in rows] == list(range(TRAIN_STEPS))
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows), rows
    assert abs(rows[0]["loss"] - math.log(cfg.vocab_size)) < 1.0, rows[0]
    assert rows[-1]["loss"] < rows[0]["loss"], (rows[0], rows[-1])
    per_step = cfg.n_layers * 2  # layers x microbatches
    assert launches["flash_attention_bwd"] == per_step * TRAIN_STEPS, launches
    assert launches["flash_attention_sm90"] == 2 * per_step * TRAIN_STEPS, launches
    step_s = statistics.median(r["step_time_s"] for r in rows[2:])
    t0 = time.perf_counter()  # the host's share of a step: drawing its batch
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticLM(cfg, 2048, 4, seed=seed).batch(0).items()}
    data_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # one more step, outside the CLI, profiled
    model = Model(cfg, torch.bfloat16, dev).init(torch.Generator(dev).manual_seed(seed))
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=3, total_steps=TRAIN_STEPS)
    state = init_state(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(model, opt_cfg, n_microbatches=2)
    state, _ = step(state, batch)
    box = {}

    def one_step():
        box["state"], box["metrics"] = step(state, batch)

    prof = profile_run(one_step, top=8, focus="repro_fa_bwd")  # both backward sources
    del model, state, step, box
    tokens = 4 * 2048
    return {"phase": "train", "model": QWEN, "config": "full", "dtype": "bfloat16",
            "steps": TRAIN_STEPS, "argv": TRAIN_ARGS, "remat": True,
            "losses": [r["loss"] for r in rows], "grad_norms": [r["grad_norm"] for r in rows],
            "lr": [r["lr"] for r in rows], "step_times_s": [r["step_time_s"] for r in rows],
            "step_s_median_2_9": step_s, "tokens_per_s": tokens / step_s,
            "data_batch_s": data_s,
            "first_loss_vs_ln_vocab": rows[0]["loss"] - math.log(cfg.vocab_size),
            "wall_s": wall_s, "max_memory_allocated": peak, "launches": launches,
            "launches_per_step": {"flash_attention_bwd": per_step,
                                  "flash_attention_sm90": 2 * per_step},
            "bwd_share_of_busy": prof.get("focus_share_of_busy"),
            "bwd_ms": prof.get("focus_ms"), "profile_one_step": prof}


def grad_vs_plain(mods, dev: str, seed: int) -> dict:
    """qwen3-0.6b at full width cut to 2 layers, float32, one loss on [1,
    128] tokens: the card's gradient (the hand-written kernels forward and
    backward) against the same weights' gradient on the CPU (the plain
    versions and twins), every parameter within GRAD_TOL * max|g|."""
    fa, get_config, Model = mods[0], mods[2], mods[3]
    cfg = dataclasses.replace(get_config(QWEN), n_layers=GRAD_LAYERS)
    gen = torch.Generator().manual_seed(seed + 3)
    toks = torch.randint(0, cfg.vocab_size, (2, 1, GRAD_TOKENS), generator=gen)
    batch = {"tokens": toks[0], "labels": toks[1]}
    grads, losses = {}, {}
    for where in ("cpu", dev):
        before = fa.BWD_LAUNCHES
        model = Model(cfg, torch.float32, where)
        if where == "cpu":
            model.init(torch.Generator("cpu").manual_seed(seed))
            weights = model.state_dict()
        else:
            model.load_state_dict(weights)
        model.requires_grad_(True)
        loss, _ = model.loss({k: t.to(where) for k, t in batch.items()})
        loss.backward()
        losses[where] = float(loss.detach())
        grads[where] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        card_bwd = fa.BWD_LAUNCHES - before  # the last run's: the card's
        del model
    worst, worst_name = 0.0, None
    for name, want in grads["cpu"].items():
        err = float((grads[dev][name] - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    assert worst <= GRAD_TOL, f"gradient {worst_name}: {worst} of max|g| > {GRAD_TOL}"
    assert card_bwd == GRAD_LAYERS, card_bwd
    return {"phase": "train", "check": "grad_vs_cpu", "model": QWEN, "layers": GRAD_LAYERS,
            "tokens": [1, GRAD_TOKENS], "dtype": "float32", "loss_card": losses[dev],
            "loss_cpu": losses["cpu"], "worst_grad_err_over_max": worst,
            "worst_param": worst_name, "tol": GRAD_TOL, "params": len(grads["cpu"]),
            "card_bwd_launches": card_bwd}


def deepseek_train_step(mods, dev: str, seed: int) -> dict:
    """deepseek-v2 at full width cut to 2 layers (1 dense-first, 1 MoE),
    bf16, one train step on [2, 1024] tokens with 8-bit moments: the loss
    and grad norm finite, the gather's backward launched, the attention
    backward at (192, 128); peak memory."""
    fa, md, get_config, Model = mods[0], mods[1], mods[2], mods[3]
    from repro_torch.data import SyntheticLM
    from repro_torch.train import OptConfig, init_state, make_train_step

    cfg = dataclasses.replace(get_config(DEEPSEEK), n_layers=2)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, torch.bfloat16, dev).init(torch.Generator(dev).manual_seed(seed))
    opt_cfg = OptConfig(quantized=True)
    state = init_state(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(model, opt_cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticLM(cfg, 1024, 2, seed=seed).batch(0).items()}
    widths = []
    inner = fa.flash_attention_bwd

    def recording(q, k, v, *args, **kwargs):
        widths.append((q.shape[-1], v.shape[-1], str(q.dtype).split(".")[-1]))
        return inner(q, k, v, *args, **kwargs)

    _reset_lm_counters(fa, md)
    fa.BWD_LAUNCHES, md.BWD_LAUNCHES = 0, 0
    fa.flash_attention_bwd = recording
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        step_s = time.perf_counter() - t0
    finally:
        fa.flash_attention_bwd = inner
    launches = {**_lm_counters(fa, md), "flash_attention_bwd": fa.BWD_LAUNCHES,
                "moe_gather_bwd": md.BWD_LAUNCHES}
    assert math.isfinite(loss) and math.isfinite(gn), (loss, gn)
    assert launches["moe_gather_bwd"] >= 1, launches
    mla = (cfg.resolved_head_dim + cfg.rope_head_dim, cfg.resolved_v_head_dim)  # (192, 128)
    assert len(widths) == cfg.n_layers and all(w[:2] == mla for w in widths), widths
    out = {"phase": "train", "model": DEEPSEEK, "layers": 2, "dtype": "bfloat16",
           "optimizer": "adamw8bit", "tokens": [2, 1024], "loss": loss, "grad_norm": gn,
           "step_s": step_s, "param_bytes": model.param_bytes(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches,
           "attention_bwd_widths": sorted(set(widths))}
    del model, state, step
    return out


def checkpoint_resume(mods, train, dev: str) -> dict:
    """``launch.train.main`` with ``--smoke`` on the card: a 6-step run
    saving at 3 and 6, then a call to 8 steps resumes at step 6; the same
    run uninterrupted to 8 against it restarted from its step-6
    checkpoint: steps 6 and 7 print the same lines and the final
    checkpoints hold the same bits. And the manager's round trip of a
    bf16 model's weights and 8-bit state on the card, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import OptConfig, init_state, make_train_step

    fa, get_config, Model = mods[0], mods[2], mods[3]
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    smoke = ["--smoke", "--device", dev, "--seq-len", "64", "--global-batch", "4",
             "--log-every", "1", "--ckpt-every", "3"]
    try:
        first, _ = _train_cli(train, smoke + ["--steps", "6", "--ckpt-dir", f"{root}/a"])
        resumed, notes = _train_cli(train, smoke + ["--steps", "8", "--ckpt-dir", f"{root}/a"])
        assert [int(r["step"]) for r in first] == list(range(6))
        assert notes[0] == "# resumed from step 6" and \
            [int(r["step"]) for r in resumed] == [6, 7], (notes, resumed)
        whole, _ = _train_cli(train, smoke + ["--steps", "8", "--ckpt-dir", f"{root}/b"])
        shutil.copytree(f"{root}/b/step_00000008", f"{root}/whole_8")
        shutil.rmtree(f"{root}/b/step_00000008")
        again, notes = _train_cli(train, smoke + ["--steps", "8", "--ckpt-dir", f"{root}/b"])
        assert notes[0] == "# resumed from step 6", notes
        same_lines = [(r["loss"], r["grad_norm"]) for r in again] == \
            [(r["loss"], r["grad_norm"]) for r in whole[6:]]
        with np.load(f"{root}/whole_8/shard_0.npz") as z:
            want = {k: z[k] for k in z.files}
        with np.load(f"{root}/b/step_00000008/shard_0.npz") as z:
            differ = [k for k in z.files if not np.array_equal(z[k], want[k])]
        assert same_lines and not differ, (same_lines, differ[:5])
        # the manager's round trip on the card: bf16 weights, int8 moments
        cfg = dataclasses.replace(get_config(QWEN), n_layers=1)
        model = Model(cfg, torch.bfloat16, dev).init(torch.Generator(dev).manual_seed(1))
        opt_cfg = OptConfig(quantized=True)
        state = init_state(dict(model.named_parameters()), opt_cfg)
        toks = torch.randint(0, cfg.vocab_size, (2, 2, 64), device=dev)
        state, _ = make_train_step(model, opt_cfg)(state, {"tokens": toks[0],
                                                           "labels": toks[1]})
        tree = {"params": dict(model.named_parameters()), "opt": state}
        mgr = CheckpointManager(f"{root}/c")
        mgr.save_async(1, tree)
        mgr.wait()
        like = {"params": {n: torch.zeros_like(p) for n, p in tree["params"].items()},
                "opt": {"m": {n: {key: torch.zeros_like(t) for key, t in s.items()}
                              for n, s in state["m"].items()},
                        "v": {n: {key: torch.zeros_like(t) for key, t in s.items()}
                              for n, s in state["v"].items()},
                        "step": torch.zeros_like(state["step"])}}
        back = mgr.restore(1, like)
        flat = [(n, back["params"][n], p) for n, p in tree["params"].items()]
        for key in ("m", "v"):
            flat += [(f"{key}.{n}.{q}", back["opt"][key][n][q], t)
                     for n, s in state[key].items() for q, t in s.items()]
        bad = [n for n, a, b in flat if a.device != b.device or not torch.equal(a, b)]
        assert not bad and int(back["opt"]["step"]) == int(state["step"]), bad[:5]
        del model, state, tree, back
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "train", "check": "checkpoint_resume", "resumed_at": 6,
            "steps_6_7_equal_uninterrupted": same_lines, "final_checkpoint_bits_equal": True,
            "losses_uninterrupted": [r["loss"] for r in whole],
            "losses_restarted_6_7": [r["loss"] for r in again],
            "roundtrip_leaves_bit_identical": len(flat),
            "roundtrip_dtypes": sorted({str(b.dtype).split(".")[-1] for _, _, b in flat})}


def train_phase(mods, ref, moe_mod, dev: str, seed: int, smi: str, bwd_ptxas: dict) -> tuple:
    """Phase 4i. Returns (the backward kernels' rows, launches on the main
    path: the bf16 attention backward's in qwen3-0.6b's training, the f32
    one's in the gradient against the CPU, the gather's in deepseek-v2's
    step, and their forward kernels'). ``bwd_ptxas``: the build entries of
    each backward source by dtype."""
    from repro_torch.launch import train

    fa, md, get_config = mods[0], mods[1], mods[2]
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    rows = {}
    for name, dtype, qshape, hkv, dv, causal, window in BWD_ROWS:
        rows[f"flash_attention_bwd_{name}"] = _bwd_row(fa, ref, name, dtype, qshape, hkv, dv,
                                                       causal, window, gen,
                                                       bwd_ptxas.get(dtype, []))
        log({"phase": "train", "kernel": f"flash_attention_bwd_{name}", "card": smi,
             **rows[f"flash_attention_bwd_{name}"]})
        gc.collect()
        torch.cuda.empty_cache()
    rows["moe_gather_bwd"] = _gather_bwd_row(md, ref, moe_mod, get_config(DEEPSEEK), 2048, gen)
    log({"phase": "train", "kernel": "moe_gather_bwd", "card": smi, **rows["moe_gather_bwd"]})
    gc.collect()
    torch.cuda.empty_cache()
    qwen = qwen_train(mods, train, dev, seed)
    log({**qwen, "card": smi})
    gc.collect()
    torch.cuda.empty_cache()
    grad = grad_vs_plain(mods, dev, seed)
    log({**grad, "card": smi})
    gc.collect()
    torch.cuda.empty_cache()
    deepseek = deepseek_train_step(mods, dev, seed)
    log({**deepseek, "card": smi})
    gc.collect()
    torch.cuda.empty_cache()
    log({**checkpoint_resume(mods, train, dev), "card": smi})
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"flash_attention_bwd": qwen["launches"]["flash_attention_bwd"],
                "flash_attention_bwd_f32": grad["card_bwd_launches"],
                "moe_gather_bwd": deepseek["launches"]["moe_gather_bwd"],
                "flash_attention_sm90": (qwen["launches"]["flash_attention_sm90"]
                                         + deepseek["launches"]["flash_attention_sm90"]),
                "moe_gather": deepseek["launches"]["moe_gather"]}
    log({"phase": "train", "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return rows, launches



def state_bytes(prog, g, k: int) -> int:
    """Bytes of a batch's state on the card: every property ``[K, n]`` in
    its dtype, the degree rows ``[K, V]``; the weights stay one shared row
    unless a kernel writes them."""
    n = 0
    for p in prog.module.properties.values():
        n += k * (g.n_edges if p.is_edge else g.n_vertices) * (1 if p.scalar == "bool" else 4)
    return n


def batch_phase(repro_torch, sources, sessions, g, oracle_of, sr, es, seed: int,
                smi: str) -> tuple:
    """The batched path on R19: ``bind_batch(g).run_many(sets)`` for
    BFS_ECP at K = 64 (MS-BFS), BFS_ECP with ``msbfs=False`` and SSSP at K
    = 16 (roots: 0 and others drawn from the seed), PAGERANK at K = 16
    (``iters`` drawn from 16-20, so lanes converge apart and the masks
    merge). Each run is sized first, then one cold and BATCH_WARM_RUNS warm
    batches (the median is kept), with both graph kernels' counters set to
    0 just before and read just after; every lane must equal a sequential
    ``Session.run`` of the port bit for bit, and the root-0 lane the
    oracle; one more batch is profiled."""
    rng = np.random.default_rng(seed)
    roots = [0] + [int(r) for r in rng.choice(np.arange(1, g.n_vertices), 63, replace=False)]
    runs = [
        ("BFS_ECP", "msbfs", [{"root": r} for r in roots], True),
        ("BFS_ECP", "generic", [{"root": r} for r in roots[:BATCH_K]], False),
        ("SSSP", "generic", [{"root": r} for r in roots[:BATCH_K]], True),
        ("PAGERANK", "generic", [{"iters": int(i)} for i in rng.integers(16, 21, BATCH_K)], True),
    ]
    launches = {"shuffle_reduce": 0, "edge_stream": 0}
    rows, sequential_s = [], {}
    for name, path, sets, msbfs in runs:
        k = len(sets)
        prog = repro_torch.compile(getattr(sources, name))
        planned = state_bytes(prog, g, k)
        free, _ = torch.cuda.mem_get_info()
        assert planned < free, f"{name} K={k}: {planned} B of state, {free} B free"
        t0 = time.perf_counter()
        bs = prog.bind_batch(g, msbfs=msbfs)
        bind_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        sr.LAUNCHES = 0
        es.LAUNCHES = 0
        t0 = time.perf_counter()
        cold = bs.run_many(sets)
        cold_s = time.perf_counter() - t0
        warm_s = []
        for _ in range(BATCH_WARM_RUNS):
            t0 = time.perf_counter()
            warm = bs.run_many(sets)
            warm_s.append(time.perf_counter() - t0)
        run_launches = {"shuffle_reduce": sr.LAUNCHES, "edge_stream": es.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        assert run_launches["edge_stream"] > 0, f"{name} ({path}): edge_stream never launched"
        for kname, n in run_launches.items():
            launches[kname] += n
        st = warm[0].stats
        assert st.batch_size == k and all(r.stats is st for r in warm)
        assert (BATCH_MSBFS in st.kernel_launches) == (path == "msbfs"), (name, path)
        # every lane against a sequential run of the port, bit for bit
        sess, seq_s, seq_launches = sessions[name], [], 0
        for p, a, c in zip(sets, warm, cold):
            t0 = time.perf_counter()
            want = sess.run(**p)
            seq_s.append(time.perf_counter() - t0)
            seq_launches += want.stats.total_launches
            for prop, x in want.properties.items():
                for got in (a, c):
                    y = got.properties[prop]
                    assert y.dtype == x.dtype and np.array_equal(x.view(np.uint8),
                                                                 y.view(np.uint8)), \
                        f"batched {name} ({path}) {p}: {prop} differs from the sequential run"
            assert a.host_env == want.host_env and c.host_env == want.host_env, (name, p)
        sequential_s[(name, k)] = statistics.median(seq_s)
        prop, oracle = oracle_of(name, sets[0])
        lane0 = warm[0].properties[prop]
        if name == "PAGERANK":
            assert np.allclose(lane0, oracle, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL), name
        else:
            assert np.array_equal(lane0.astype(np.int64), oracle), f"{name}: lane 0 vs oracle"
        if path == "msbfs":
            assert st.total_launches <= 0.25 * seq_launches, \
                f"MS-BFS: {st.total_launches} launches a batch vs {seq_launches} sequential"
        warm_med = statistics.median(warm_s)
        prof = profile_run(lambda bs=bs, sets=sets: bs.run_many(sets))
        rows.append({
            "phase": "batch", "program": name, "path": path, "k": k, "card": smi,
            "params": sets[0] if name != "PAGERANK" else {"iters": [p["iters"] for p in sets]},
            "planned_state_bytes": planned, "bind_s": bind_s,
            "cold_s": cold_s, "warm_s": warm_med, "warm_runs_s": warm_s,
            "queries_per_s": k / warm_med,
            "sequential_warm_median_s": sequential_s[(name, k)],
            "sequential_k_s": k * sequential_s[(name, k)],
            "sequential_queries_per_s": 1.0 / sequential_s[(name, k)],
            "speedup": k * sequential_s[(name, k)] / warm_med,
            "launches_per_batch": st.total_launches, "kernel_launches": st.kernel_launches,
            "sequential_launches_for_k": seq_launches,
            "edges_traversed": st.edges_traversed, "host_iterations": st.host_iterations,
            "device_busy_s": prof["device_busy_s"], "device_idle_share": prof["device_idle_share"],
            "profiled_wall_s": prof["wall_s"], "top_kernels_ms": prof["top_kernels_ms"],
            "max_memory_allocated": peak, "lanes_bit_identical": k, "lane0_oracle": True,
            "kernel_calls": run_launches,
        })
        del bs, cold, warm
        gc.collect()
        torch.cuda.empty_cache()
    assert launches["shuffle_reduce"] > 0, "shuffle_reduce never launched in the batch phase"
    return rows, launches


# ---------------------------------------------------------------------------
# 4c. accelerator artifacts and tracing
# ---------------------------------------------------------------------------


def _identical(want, got) -> bool:
    """Properties bit for bit, host scalars and launch counts equal."""
    if set(want.properties) != set(got.properties) or want.host_env != got.host_env:
        return False
    for prop, x in want.properties.items():
        y = got.properties[prop]
        if x.dtype != y.dtype or not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
            return False
    a, b = want.stats, got.stats
    return (a.kernel_launches, a.full_launches, a.compacted_launches, a.fused_launches) == \
        (b.kernel_launches, b.full_launches, b.compacted_launches, b.fused_launches)


def _identical_props(want, got) -> bool:
    """Properties bit for bit and host scalars equal (a repair has no
    launches to compare)."""
    if set(want.properties) != set(got.properties) or want.host_env != got.host_env:
        return False
    return all(x.dtype == got.properties[p].dtype
               and np.array_equal(x.view(np.uint8), got.properties[p].view(np.uint8))
               for p, x in want.properties.items())


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def level_digest(levels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(levels, dtype=np.int32).tobytes()).hexdigest()


def artifact_child(path: str, scale: int, seed: int) -> int:
    """``--load-artifact DIR``: a fresh process's warm start. Rebuilds the
    graph from the seed (not timed), then ``load_accelerator`` -> ``bind``
    -> one BFS_ECP run from root 0; prints one JSON line."""
    t_start = time.perf_counter()
    import repro_torch
    from repro_torch.graph import generators

    import_s = time.perf_counter() - t_start
    g = generators.rmat(scale, EDGE_FACTOR, seed=seed, weighted=True)
    t0 = time.perf_counter()
    acc = repro_torch.load_accelerator(path)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess = acc.bind(g)
    bind_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = sess.run(root=0)
    run_s = time.perf_counter() - t0
    log({"import_s": import_s, "load_s": load_s, "bind_s": bind_s, "first_run_s": run_s,
         "first_answer_s": load_s + bind_s + run_s,
         "compile_time_s": r.stats.compile_time_s,
         "nvcc_cached": {n: info["cached"] for n, info in acc.library.builds.items()},
         "modes": sorted({k.mode for k in acc.report().kernels}),
         "old_level_sha256": level_digest(r.properties["old_level"])})
    return 0


def _launch_tree(spans, stats) -> dict:
    """Span counts, and per ``launch:<kernel>`` host seconds, of one traced
    run; asserts the launch spans number the run's launches and all
    descend from its ``run`` span."""
    counts: dict = {}
    for sp in spans:
        counts[sp.name] = counts.get(sp.name, 0) + 1
    runs = [sp for sp in spans if sp.name == "run"]
    assert len(runs) == 1, counts
    launch = [sp for sp in spans if sp.name.startswith("launch:")]
    assert len(launch) == stats.total_launches, (len(launch), stats.total_launches)
    by_parent: dict = {}
    for sp in spans:
        by_parent.setdefault(sp.parent_id, []).append(sp)
    below, stack = set(), [runs[0].span_id]
    while stack:
        for child in by_parent.get(stack.pop(), []):
            below.add(child.span_id)
            stack.append(child.span_id)
    assert all(sp.span_id in below for sp in launch), "a launch span outside the run"
    host_s, by_mode = {}, {}
    for sp in launch:
        host_s[sp.name] = host_s.get(sp.name, 0.0) + sp.duration_s
        key = f"{sp.name} {sp.attrs.get('mode')}"
        n, t = by_mode.get(key, (0, 0.0))
        by_mode[key] = (n + 1, t + sp.duration_s)
    return {"span_counts": counts, "launch_host_s": host_s,
            "launch_host_s_by_mode": {k: {"launches": n, "host_s": t}
                                      for k, (n, t) in by_mode.items()},
            "launch_host_total_s": sum(host_s.values()), "run_span_s": runs[0].duration_s,
            "frontier_masks": stats.frontier_masks, "frontier_mask_s": stats.frontier_mask_s}


def artifact_phase(repro_torch, sources, generators, g, main_results, main_bind_s, params,
                   sr, es, scale: int, seed: int, smi: str) -> tuple:
    """Phase 4c: ``lower`` -> ``report`` -> ``save`` -> ``load_accelerator``
    -> ``bind`` -> ``run`` for BFS_ECP, PAGERANK and SSSP on the resident
    R19 graph, each run bit-identical to the main phase's warm run; a
    rebind of BFS_ECP's loaded accelerator to a twin graph of the bucket;
    a fresh process's warm start from the saved artifact (no ``nvcc``);
    then one traced run of each program. Returns (rows, launches)."""
    from repro_torch import telemetry

    t_phase = time.perf_counter()
    rows, accs = [], {}
    sr.LAUNCHES = 0
    es.LAUNCHES = 0
    store = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")
    for name in ("BFS_ECP", "PAGERANK", "SSSP"):
        prog = repro_torch.compile(getattr(sources, name))
        t0 = time.perf_counter()
        acc = prog.lower(graph=g)
        lower_s = time.perf_counter() - t0
        rep = acc.report()
        t0 = time.perf_counter()
        path = acc.save(os.path.join(store, name))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        acc2 = repro_torch.load_accelerator(path)
        load_s = time.perf_counter() - t0
        modes = sorted({k.mode for k in acc2.report().kernels})
        assert modes == ["aot-loaded"], f"{name}: kernel modes {modes} after the build phase"
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sess = acc2.bind(g)
        torch.cuda.synchronize()
        bind_s = time.perf_counter() - t0
        bind_bytes = torch.cuda.memory_allocated() - mem0
        t0 = time.perf_counter()
        cold = sess.run(**params[name])
        cold_s = time.perf_counter() - t0
        warm_runs_s = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            warm = sess.run(**params[name])
            warm_runs_s.append(time.perf_counter() - t0)
        main_warm, main_warm_runs_s = main_results[name][1], main_results[name][3]
        for got in (cold, warm):
            assert _identical(main_warm, got), f"{name}: the artifact's run differs from bind(g)'s"
        accs[name] = (acc2, sess, path)
        rows.append({
            "phase": "artifacts", "program": name, "params": params[name], "card": smi,
            "lower_s": lower_s, "save_s": save_s, "artifact_bytes": _dir_bytes(path),
            "load_s": load_s, "modes": modes, "bind_s": bind_s,
            "main_bind_s": main_bind_s[name], "bind_allocated_bytes": bind_bytes,
            "state_bytes": rep.state_bytes, "gb_bytes": rep.gb_bytes,
            "state_plus_gb_bytes": rep.state_bytes + rep.gb_bytes,
            "cold_s": cold_s, "cold_compile_time_s": cold.stats.compile_time_s,
            "warm_s": statistics.median(warm_runs_s), "warm_runs_s": warm_runs_s,
            "main_warm_s": statistics.median(main_warm_runs_s),
            "identical_to_main": True, "determinism": rep.determinism,
            "report": {"kernels": [{"name": k.name, "kind": k.kind, "stages": list(k.stages),
                                    "direction": k.direction, "mode": k.mode}
                                   for k in rep.kernels],
                       "live_peak_bytes": rep.live_buffer_peak_bytes},
        })

    # -- rebind: BFS_ECP's loaded accelerator on a twin graph of the bucket
    twin = generators.rmat(scale, EDGE_FACTOR, seed=seed + 1, weighted=True)
    acc2 = accs["BFS_ECP"][0]
    assert repro_torch.GraphShape.of(twin) == acc2.shape, "the twin left the bucket"
    t0 = time.perf_counter()
    twin_sess = acc2.bind(twin)
    twin_bind_s = time.perf_counter() - t0
    warmed = set(acc2.library.warm_keys)
    t0 = time.perf_counter()
    r = twin_sess.run(root=0)
    twin_run_s = time.perf_counter() - t0
    # the engines of one library share its warm keys: the twin pays compile
    # time exactly for the frontier pads no earlier bind touched
    new_keys = sorted(set(acc2.library.warm_keys) - warmed)
    assert not any(k[0] == "full" for k in new_keys), new_keys
    assert (r.stats.compile_time_s == 0.0) == (not new_keys), \
        f"rebind compiled for {r.stats.compile_time_s} s, new keys {new_keys}"
    want = bfs_levels(twin.n_vertices, twin.src, twin.dst, 0)
    assert np.array_equal(r.properties["old_level"], want), "twin BFS differs from the oracle"
    rows.append({"phase": "artifacts", "rebind": "BFS_ECP", "twin_seed": seed + 1,
                 "bind_s": twin_bind_s, "first_run_s": twin_run_s,
                 "compile_time_s": r.stats.compile_time_s, "new_keys": new_keys,
                 "binds": acc2.binds,
                 "oracle": {"exact": True, "reached": int((want != -1).sum())}})
    del twin_sess, twin, r
    gc.collect()

    # -- warm start in a fresh process (graph generation left out of its times)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--load-artifact",
                          accs["BFS_ECP"][2], "--scale", str(scale), "--seed", str(seed)],
                         capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    assert out.returncode == 0, f"the fresh process failed:\n{out.stderr[-3000:]}"
    child = json.loads(out.stdout.strip().splitlines()[-1])
    assert child["nvcc_cached"] and all(child["nvcc_cached"].values()), child
    assert child["modes"] == ["aot-loaded"], child
    parent_digest = level_digest(main_results["BFS_ECP"][1].properties["old_level"])
    assert child["old_level_sha256"] == parent_digest, "the fresh process's BFS differs"
    rows.append({"phase": "artifacts", "fresh_process": "BFS_ECP", "process_s": child_s,
                 **child, "matches_parent": True})

    # -- tracing: one traced run of each program through its artifact session
    tr = telemetry.enable()
    try:
        for name, (acc2, sess, _) in accs.items():
            tr.reset()
            t0 = time.perf_counter()
            r = sess.run(**params[name])
            traced_s = time.perf_counter() - t0
            tree = _launch_tree(tr.spans(), r.stats)
            assert r.trace is not None and acc2.report().profile["runs"] == 1, name
            chrome = os.path.join(store, f"{name}.trace.json")
            n_events = tr.export_chrome(chrome)
            with open(chrome) as f:
                doc = json.load(f)
            assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == n_events > 0
            # the tracer's cost: untraced and traced warm runs, interleaved
            plain_s, with_s = [], []
            for _ in range(WARM_RUNS):
                telemetry.disable()
                t0 = time.perf_counter()
                sess.run(**params[name])
                plain_s.append(time.perf_counter() - t0)
                tr = telemetry.enable()
                t0 = time.perf_counter()
                sess.run(**params[name])
                with_s.append(time.perf_counter() - t0)
            # host seconds per launch beside the device time of the same
            # (profiled, traced) run
            held = []

            def traced_once(s=sess, n=name):
                telemetry.get().reset()  # a window the profiler retries starts clean
                held.append(s.run(**params[n]))

            prof = profile_run(traced_once)
            prof_tree = _launch_tree(telemetry.get().spans(), held[-1].stats)
            rows.append({
                "phase": "artifacts", "trace": name, "card": smi, "traced_s": traced_s,
                "untraced_warm_median_s": statistics.median(plain_s),
                "traced_warm_median_s": statistics.median(with_s),
                "untraced_runs_s": plain_s, "traced_runs_s": with_s,
                "overhead_share": statistics.median(with_s) / statistics.median(plain_s) - 1,
                "launches": r.stats.total_launches, **tree, "chrome_events": n_events,
                "profiled": {"wall_s": prof["wall_s"], "run_span_s": prof_tree["run_span_s"],
                             "launch_host_s": prof_tree["launch_host_s"],
                             "launch_host_s_by_mode": prof_tree["launch_host_s_by_mode"],
                             "launch_host_total_s": prof_tree["launch_host_total_s"],
                             "device_busy_s": prof["device_busy_s"],
                             "device_idle_share": prof["device_idle_share"],
                             "top_kernels_ms": prof["top_kernels_ms"]},
            })
    finally:
        telemetry.disable()
    launches = {"shuffle_reduce": sr.LAUNCHES, "edge_stream": es.LAUNCHES}
    assert launches["shuffle_reduce"] > 0 and launches["edge_stream"] > 0, launches
    del accs
    shutil.rmtree(store)
    rows.append({"phase": "artifacts", "launches": launches,
                 "phase_s": time.perf_counter() - t_phase})
    return rows, launches


def _same_bindings(engine, fresh) -> list:
    """Keys of ``engine``'s graph bindings and degree/weight buffers that
    differ from ``fresh``'s (tensors by ``torch.equal``, the work list's
    tensors one by one); empty when the refresh matches a fresh bind."""
    bad = []
    for key, want in fresh.gb.items():
        got = engine.gb[key]
        if isinstance(want, torch.Tensor):
            ok = got.dtype == want.dtype and torch.equal(got, want)
        elif isinstance(want, tuple) and all(isinstance(t, torch.Tensor) for t in want):
            ok = len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
        else:
            ok = got == want
        if not ok:
            bad.append(key)
    bad += [key for key, want in fresh._initial.items()
            if not torch.equal(engine._initial[key], want)]
    return bad


def _busy(prof: dict) -> dict:
    """The device-time part of a :func:`profile_run` reading."""
    return {k: prof[k] for k in ("wall_s", "device_busy_s", "device_idle_share",
                                 "top_kernels_ms")}


def _real_edges(graph):
    """The updated graph's real edges (its free padding slots left out)."""
    real = ~graph._free_slot_mask()
    w = graph.weights[real].astype(np.int64) if graph.weights is not None else None
    return graph.src[real], graph.dst[real], w


def streaming_phase(repro_torch, sources, g, g_small, sr, es, seed: int, smi: str) -> tuple:
    """Phase 4d: ``StreamingSession`` over a graph padded to its geometric
    bucket, one session per program, each bound from
    ``program.lower(graph=g, bucket=True)``: the R19 graph for BFS_ECP and
    uncached SSSP (the fresh-bind checks), ``g_small`` (rmat(16, 32)) for
    cached SSSP, WCC and PAGERANK, whose R19 binds and refreshes (~40 s a
    program) were cut to keep the script inside its limit. After every additions-only
    delta the query is a host repair, held bit for bit to a full run on
    the card at the same version (``ss.session.run``) and to the oracle on
    the updated graph's real edges; an unseen root is a full run that
    lowers nothing. BFS_ECP then takes a removal delta (a full run, equal
    to the oracle), and its refreshed bindings, the work list included,
    must equal a fresh bind's tensor for tensor, as must SSSP's under
    ``Target(cache=False)``. PAGERANK is not monotone: every query after
    an update is a full run. Logs a line per program as it ends; returns
    the launches."""
    from repro_torch import GraphDelta, StreamingSession, Target

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    launches = {"shuffle_reduce": 0, "edge_stream": 0}
    plans = [  # (row name, program, target, params, a removal delta, a fresh bind, graph)
        ("BFS_ECP", "BFS_ECP", None, {"root": 0}, True, True, g),
        ("SSSP", "SSSP", None, {"root": 0}, False, False, g_small),
        ("SSSP_no_cache", "SSSP", Target(cache=False), {"root": 0}, False, True, g),
        ("WCC", "WCC", None, {}, False, False, g_small),
        ("PAGERANK", "PAGERANK", None, {"iters": 20}, False, False, g_small),
    ]

    def oracle(name, graph, params, relabel):
        src, dst, w = _real_edges(graph)
        n, lv = graph.n_vertices, graph.n_vertices_logical
        if name == "BFS_ECP":
            return "old_level", bfs_levels(n, src, dst, params["root"])
        if name == "SSSP":
            return "SP", sssp_dist(n, src, dst, w, params["root"])
        if name == "WCC":
            lane = degree_lanes(n, graph.src, graph.dst) if relabel else None
            return "comp", wcc_labels(n, src, dst, lane)
        return "rank", pagerank(lv, src, dst, params["iters"])

    def check(name, graph, params, res, relabel) -> dict:
        t0 = time.perf_counter()
        prop, want = oracle(name, graph, params, relabel)
        oracle_s.append(time.perf_counter() - t0)
        got = res.properties[prop]
        if name == "PAGERANK":
            lv = graph.n_vertices_logical
            got = got[:lv]
            assert np.all(np.isfinite(got)), "PAGERANK: a rank is not finite"
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
            assert np.allclose(got, want, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL), \
                f"PAGERANK after an update: max rel err {rel.max():.3e}"
            return {"rtol": PAGERANK_RTOL, "atol": PAGERANK_ATOL,
                    "max_rel_err": float(rel.max())}
        bad = int((got.astype(np.int64) != want).sum())
        assert got.shape == want.shape and bad == 0, \
            f"{name}: {bad} vertices differ from the oracle after an update"
        return {"exact": True}

    for row_name, name, target, params, removal, fresh_bind, graph in plans:
        t_prog = time.perf_counter()
        oracle_s = []
        prog = repro_torch.compile(getattr(sources, name))
        relabel = (target or Target()).cache  # the hub relabel is on
        acc = prog.lower(target, graph=graph, bucket=True)
        padded = graph.pad_to(acc.shape.n_vertices, acc.shape.n_edges)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ss = StreamingSession(prog, padded, accelerator=acc)
        torch.cuda.synchronize()
        bind_s = time.perf_counter() - t0
        sr.LAUNCHES = 0
        es.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = ss.run(**params)
        first_s = time.perf_counter() - t0
        chunks = [int(ss.session.engine.gb["es_split"].chunks.shape[0])]
        profile_v0 = _busy(profile_run(lambda: ss.session.run(**params)))
        # the unseen roots' frontier pads, touched once before any update
        unseen = ([{"root": 1 + i} for i in range(STREAM_ADD_DELTAS)] if "root" in params
                  else [])
        for p in unseen:
            ss.session.run(**p)
        steps = []
        for i in range(STREAM_ADD_DELTAS):
            edges = rng.integers(0, ss.graph.n_vertices_logical,
                                 size=(STREAM_DELTA, 2)).astype(np.int32)
            w = (rng.integers(1, 64, size=STREAM_DELTA).astype(np.float32)
                 if name == "SSSP" else None)
            version = ss.update(GraphDelta(added_edges=edges, added_weights=w))
            inc_before, full_before = ss.incremental_runs, ss.full_runs
            t0 = time.perf_counter()
            res = ss.run(**params)
            query_s = time.perf_counter() - t0
            full_s, full_compile_s = [], []
            warm = set(acc.library.warm_keys)
            for _ in range(1 + WARM_RUNS):  # the first full run at this version, then warm
                t0 = time.perf_counter()
                full = ss.session.run(**params)
                full_s.append(time.perf_counter() - t0)
                full_compile_s.append(full.stats.compile_time_s)
            new_keys = sorted(set(acc.library.warm_keys) - warm)
            if name == "PAGERANK":  # not monotone: the query was a full run
                assert ss.incremental_runs == 0 and ss.full_runs == full_before + 1
                assert _identical(full, res), "PAGERANK: two full runs differ"
            else:
                assert ss.incremental_runs == inc_before + 1, f"{name}: not a repair"
                assert _identical_props(full, res), f"{name}: repair differs from a full run"
            assert res.version == version == ss.version
            # nothing is lowered again: compile time only for a frontier pad
            # no earlier run of the library touched
            assert not any(k[0] == "full" for k in new_keys), new_keys
            assert (full_compile_s[0] == 0.0) == (not new_keys), (full_compile_s, new_keys)
            assert not any(full_compile_s[1:]), full_compile_s
            step = {"version": version, "n_added": STREAM_DELTA,
                    "update_apply_s": ss.update_apply_s[-1],
                    "apply_updates_s": ss.update_graph_s[-1],
                    "refresh_graph_s": ss.update_refresh_s[-1],
                    "update_rest_s": ss.update_apply_s[-1] - ss.update_graph_s[-1]
                    - ss.update_refresh_s[-1],
                    "query": "full" if name == "PAGERANK" else "repair",
                    "query_s": query_s, "host_iterations": res.stats.host_iterations,
                    "full_run_s": full_s, "full_warm_s": statistics.median(full_s[1:]),
                    "full_compile_time_s": full_compile_s,
                    "profile": _busy(profile_run(lambda: ss.session.run(**params))),
                    "new_warm_keys": [list(k) for k in new_keys],
                    "oracle": check(name, ss.graph, params, full, relabel)}
            if unseen:
                warm = set(acc.library.warm_keys)
                r = ss.run(**unseen[i])
                new = sorted(set(acc.library.warm_keys) - warm)
                assert ss.full_runs == full_before + 1, f"{name}: the unseen root was no full run"
                assert not any(k[0] == "full" for k in new), new
                assert (r.stats.compile_time_s == 0.0) == (not new), \
                    f"{name}: unseen root compiled {r.stats.compile_time_s} s, keys {new}"
                step["unseen"] = {**unseen[i], "compile_time_s": r.stats.compile_time_s,
                                  "new_warm_keys": [list(k) for k in new]}
            steps.append(step)
            chunks.append(int(ss.session.engine.gb["es_split"].chunks.shape[0]))
        if removal:
            real = np.flatnonzero(~ss.graph._free_slot_mask())
            pick = np.sort(rng.choice(real, size=STREAM_REMOVE, replace=False))
            rem = np.stack([ss.graph.src[pick], ss.graph.dst[pick]], axis=1)
            full_before = ss.full_runs
            version = ss.update(GraphDelta(removed_edges=rem))
            t0 = time.perf_counter()
            res = ss.run(**params)
            query_s = time.perf_counter() - t0
            assert ss.full_runs == full_before + 1, f"{name}: a removal was repaired"
            steps.append({"version": version, "n_removed": STREAM_REMOVE,
                          "update_apply_s": ss.update_apply_s[-1],
                          "apply_updates_s": ss.update_graph_s[-1],
                          "refresh_graph_s": ss.update_refresh_s[-1],
                          "query": "full", "query_s": query_s,
                          "compile_time_s": res.stats.compile_time_s,
                          "oracle": check(name, ss.graph, params, res, relabel)})
        peak = torch.cuda.max_memory_allocated()
        # WCC's edge kernel writes both endpoints: it commits through
        # shuffle_reduce alone, and the phase as a whole launches both
        phase_launches = {"shuffle_reduce": sr.LAUNCHES, "edge_stream": es.LAUNCHES}
        assert sum(phase_launches.values()) > 0, (row_name, phase_launches)
        fresh = None
        if fresh_bind:
            # the check that catches a stale binding: the accelerator bound
            # to the updated graph afresh
            last = ss.run(**params)
            t0 = time.perf_counter()
            sess = acc.bind(ss.graph)
            torch.cuda.synchronize()
            fresh_bind_s = time.perf_counter() - t0
            again = sess.run(**params)
            assert _identical_props(again, last), f"{name}: a fresh bind's run differs"
            bad = _same_bindings(ss.session.engine, sess.engine)
            assert not bad, f"{name}: refreshed bindings differ from a fresh bind's: {bad}"
            fresh = {"bind_s": fresh_bind_s, "identical_run": True, "bindings_equal": True,
                     "keys_compared": len(sess.engine.gb) + len(sess.engine._initial)}
            del sess, again
        for k, n in phase_launches.items():
            launches[k] += n
        log({
            "phase": "streaming", "program": row_name, "params": params, "card": smi,
            "target": (target or Target()).describe(),
            "bucket": [acc.shape.n_vertices, acc.shape.n_edges],
            "graph": "R19" if graph is g else f"rmat-{STREAM_SMALL_SCALE}-{EDGE_FACTOR}",
            "logical": [graph.n_vertices_logical, graph.n_edges_logical],
            "bind_s": bind_s, "first_run_s": first_s, "profile_v0": profile_v0,
            "steps": steps, "es_split_chunks": chunks, "fresh_bind": fresh,
            "counters": {"version": ss.version, "updates": ss.updates,
                         "incremental_runs": ss.incremental_runs, "full_runs": ss.full_runs,
                         "cache_hits": ss.cache_hits, "rebuckets": ss.rebuckets},
            "launches": phase_launches, "max_memory_allocated": peak, "oracle_s": oracle_s,
            "program_s": time.perf_counter() - t_prog,
            # each update costs a bind (~17 s at R19): BFS_ECP's second
            # additions-only delta was cut to keep the phase near 300 s
            "reduced": ({"additions_only_deltas": [2, STREAM_ADD_DELTAS]}
                        if row_name == "BFS_ECP" else {} if graph is g else
                        {"graph": ["R19", f"rmat-{STREAM_SMALL_SCALE}-{EDGE_FACTOR}"]}),
        })
        ss.close()
        del ss, acc, padded, first
        gc.collect()
        torch.cuda.empty_cache()
    assert launches["shuffle_reduce"] > 0 and launches["edge_stream"] > 0, launches
    log({"phase": "streaming", "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# 4e. graph serving and autotune
# ---------------------------------------------------------------------------

# the reference tests' racy fixture: a plain `=` scatter whose value varies
# per edge (GT101); admission must refuse it before the registry sees it
RACY_GT = """
element Vertex end
const edges: edgeset{Vertex}(Vertex, Vertex) = load(argv(1));
const vertices: vertexset{Vertex};
const P: vector{Vertex}(int);
func initP(v: Vertex)
    P[v] = 0;
end
func upd(src: Vertex, dst: Vertex)
    P[dst] = P[src] + 1;
end
func main()
    vertices.init(initP);
    edges.process(upd);
end
"""
SERVE_BFS, SERVE_SSSP, SERVE_PAGERANK = 64, 16, 4  # requests of the cold service
SERVE_TENANTS = {"a": 2.0, "b": 1.0}
TUNE_SCALE = 16  # the autotune graph: rmat(16, 16), a trial is a bind


def _submit_wave(svc, g, requests) -> tuple:
    """Submit every ``(program, tenant, params)`` at once; returns the
    results in order, each request's latency (submit to its future's
    resolution, host clock) and the wave's seconds."""
    t_done = [0.0] * len(requests)
    futs = []
    t0 = time.perf_counter()
    for i, (name, tenant, p) in enumerate(requests):
        fut = svc.submit(name, g, tenant=tenant, **p)
        t_sub = time.perf_counter()
        fut.add_done_callback(lambda f, i=i, t=t_sub: t_done.__setitem__(
            i, time.perf_counter() - t))
        futs.append(fut)
    results = [f.result(timeout=600) for f in futs]
    return results, t_done, time.perf_counter() - t0


def _latency(requests, lat) -> dict:
    """p50 and p99 (ms, exact over the wave) per program and per tenant."""
    out: dict = {}
    for key in ("program", "tenant"):
        groups: dict = {}
        for (name, tenant, _), s in zip(requests, lat):
            groups.setdefault(name if key == "program" else tenant, []).append(s * 1e3)
        out[key] = {k: {"n": len(v), "p50_ms": float(np.percentile(v, 50)),
                        "p99_ms": float(np.percentile(v, 99))} for k, v in groups.items()}
    return out


def serving_phase(repro_torch, sources, generators, g, sessions, results, oracle_of, sr, es,
                  seed: int, scale: int, smi: str, here: str) -> dict:
    """Phase 4e: the served graph query, ``repro_torch.serve()`` ->
    ``GraphService.submit`` -> scheduler batch -> ``ArtifactRegistry``
    (load or lower, bind) -> ``run_many``, on the R19 graph of the main
    phase. Analysis first (host only): the eight sources and the two
    embedded twins give no error, and a racy program is refused at
    admission with no registry entry and no bind. A cold service then
    answers 64 BFS_ECP, 16 SSSP and 4 PAGERANK requests submitted at once
    across two weighted tenants, every answer bit for bit the main phase's
    session run of the same parameters (some roots also the oracles'), and
    the same requests again on the resident entries; the embedded BFS twin
    lands on the text program's entry. A second service on the same store
    gives its first answer from the warm artifact. AutoTuner (its defaults)
    searches BFS_ECP and SSSP on rmat(16, 16); a fresh tuner makes no
    trial, ``lower(tuned=True)`` is a lookup that stamps the manifest, and
    a service with the lookup on answers as the base target does. Last,
    ``python -m repro_torch.launch.serve --graph bfs`` runs as a child.
    Both graph kernels' counters are set to 0 after the reference answers
    and read at the end; returns the launches."""
    from repro_torch import ProgramRejected, Target, telemetry as tel
    from repro_torch.algorithms import embedded
    from repro_torch.autotune import AutoTuner, TuningCache, tuning_dir_for
    from repro_torch.serving import NAMED_ALGORITHMS

    t_phase = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        # -- analysis (host only) -----------------------------------------
        t0 = time.perf_counter()
        analyzed = {}
        for name in ("BFS_ECP", "BFS_HYBRID", "PAGERANK", "SSSP", "PPR", "CGAW", "WCC",
                     "KCORE"):
            res = repro_torch.analyze(getattr(sources, name))
            assert res.ok, f"{name}: {res.render()}"
            analyzed[name] = {"certificate": res.certificate, "codes": list(res.codes())}
        for name in ("BFS_ECP_EMBEDDED", "PAGERANK_EMBEDDED"):
            res = repro_torch.analyze(getattr(embedded, name))
            assert res.ok, f"{name}: {res.render()}"
            analyzed[name] = {"certificate": res.certificate, "codes": list(res.codes())}
        analysis_s = time.perf_counter() - t0

        # -- the main phase's session answers for the served parameters ---
        rng = np.random.default_rng(seed + 4)
        roots = [0] + [int(r) for r in rng.choice(np.arange(1, g.n_vertices),
                                                  SERVE_BFS - 1, replace=False)]
        requests = ([("bfs", "ab"[i % 2], {"root": r}) for i, r in enumerate(roots)]
                    + [("sssp", "ab"[i % 2], {"root": r})
                       for i, r in enumerate(roots[:SERVE_SSSP])]
                    + [("pagerank", "ab"[i % 2], {"iters": 20}) for i in range(SERVE_PAGERANK)])
        main_of = {"bfs": "BFS_ECP", "sssp": "SSSP", "pagerank": "PAGERANK"}
        t0 = time.perf_counter()
        want = []
        for name, _, p in requests:
            if name == "pagerank":
                want.append(results["PAGERANK"][1])  # the main phase's warm run, iters 20
            else:
                want.append(sessions[main_of[name]].run(**p))
        reference_s = time.perf_counter() - t0

        # -- the cold service ------------------------------------------------
        sr.LAUNCHES = 0
        es.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        svc = repro_torch.serve(store, device="cuda", tenant_weights=SERVE_TENANTS)
        before = svc.registry.info()
        try:
            svc.submit(RACY_GT, g, tenant="a", root=0)
            raise AssertionError("the racy program was admitted")
        except ProgramRejected as e:
            rejected = [d.code for d in e.diagnostics]
        assert rejected == ["GT101"], rejected
        assert svc.registry.info() == before and before["resident"] == 0
        assert svc.registry.lowerings == 0
        waves = []
        for wave in ("cold", "resident"):
            n_sr, n_es = sr.LAUNCHES, es.LAUNCHES
            got, lat, wave_s = _submit_wave(svc, g, requests)
            for (name, tenant, p), a, b in zip(requests, want, got):
                assert _identical_props(a, b), \
                    f"served {name} {p} ({wave}) differs from the session's run"
            waves.append({"wave": wave, "requests": len(requests), "wave_s": wave_s,
                          "queries_per_s": len(requests) / wave_s,
                          "latency": _latency(requests, lat),
                          "launches": {"shuffle_reduce": sr.LAUNCHES - n_sr,
                                       "edge_stream": es.LAUNCHES - n_es}})
        cold_launches = waves[0]["launches"]
        assert cold_launches["shuffle_reduce"] > 0, "shuffle_reduce never launched in 4e"
        assert cold_launches["edge_stream"] > 0, "edge_stream never launched in 4e"
        # a few answers against the oracles as well
        checked = []
        for i in (0, 1, SERVE_BFS, SERVE_BFS + SERVE_SSSP):
            name, _, p = requests[i]
            prop, oracle = oracle_of(main_of[name], p)
            x = got[i].properties[prop]
            if name == "pagerank":
                assert np.allclose(x, oracle, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL), name
            else:
                assert np.array_equal(x.astype(np.int64), oracle), f"served {name} {p}: oracle"
            checked.append({name: p})
        # the embedded twin lands on the text program's resident entry
        entries = {k[0][:12]: e for k, e in svc.registry._residents.items()}
        binds = {k: e.accelerator.binds for k, e in entries.items()}
        lowerings = svc.registry.lowerings
        twin = svc.run(embedded.BFS_ECP_EMBEDDED, g, root=roots[0])
        assert _identical_props(want[0], twin), "the embedded twin's answer differs"
        assert svc.registry.lowerings == lowerings and len(svc.registry._residents) == 3
        assert {k: e.accelerator.binds for k, e in
                ((k[0][:12], e) for k, e in svc.registry._residents.items())} == binds
        stats = svc.stats()
        entry_rows = {e.accelerator.program.fingerprint[:12]: {
            "bind_s": e.bind_s, "binds": e.accelerator.binds, "queries": e.queries,
            "batched": (e.session._batch_session is not None
                        and e.session._batch_session.engine.engine is e.session.engine)}
            for e in svc.registry._residents.values()}
        peak = torch.cuda.max_memory_allocated()
        svc.close()
        del svc
        gc.collect()
        torch.cuda.empty_cache()
        log({"phase": "serving", "service": "cold", "card": smi, "analysis": analyzed,
             "analysis_s": analysis_s, "rejected": {"program": "racy", "codes": rejected,
                                                    "registry_unchanged": True},
             "reference_s": reference_s, "waves": waves, "oracle_checked": checked,
             "embedded_twin": {"same_entry": True, "lowerings": lowerings},
             "entries": entry_rows, "max_memory_allocated": peak,
             "stats": {"queries": stats["queries"], "tenants": stats["tenants"],
                       "programs": stats["programs"], "batches": stats["batches"],
                       "registry": stats["registry"], "tuning": stats["tuning"]}})

        # -- the warm service: a second service on the same store ---------
        t0 = time.perf_counter()
        warm_svc = repro_torch.serve(store, device="cuda")
        first = warm_svc.run("bfs", g, root=roots[0])
        first_answer_s = time.perf_counter() - t0
        reg = warm_svc.stats()["registry"]
        (entry,) = warm_svc.registry._residents.values()
        modes = sorted({k.mode for k in entry.accelerator.report().kernels})
        nvcc_cached = {n: info["cached"] for n, info in entry.accelerator.library.builds.items()}
        assert _identical_props(want[0], first), "the warm service's answer differs"
        assert reg["artifact_hits"] == 1 and reg["cold_lowerings"] == 0, reg
        assert warm_svc.registry.lowerings == 0 and modes == ["aot-loaded"], modes
        assert all(nvcc_cached.values()), nvcc_cached
        log({"phase": "serving", "service": "warm", "card": smi,
             "first_answer_s": first_answer_s, "bind_s": entry.bind_s,
             "compile_time_s": first.stats.compile_time_s, "modes": modes,
             "nvcc_cached": nvcc_cached, "registry": reg,
             "old_level_sha256": level_digest(first.properties["old_level"])})
        warm_svc.close()
        del warm_svc, entry, first
        gc.collect()
        torch.cuda.empty_cache()

        # -- autotune on rmat(16, 16) ----------------------------------------
        tune_scale = min(TUNE_SCALE, scale)
        gt = generators.rmat(tune_scale, 16, seed=seed, weighted=True)
        tune_store = os.path.join(store, "tuned")
        tuned_rows = {}
        for name, p in (("bfs", {"root": 0}), ("sssp", {"root": 0})):
            prog = repro_torch.compile(NAMED_ALGORITHMS[name])
            cache = TuningCache(tuning_dir_for(tune_store))
            tuner = AutoTuner(cache, device="cuda")
            t0 = time.perf_counter()
            report = tuner.tune(prog, gt, params=p)
            tune_s = time.perf_counter() - t0
            assert not report.cache_hit and report.trials >= 2, report.describe()
            assert report.config.objective_s <= report.config.baseline_s * 1.0001
            # the winner's objective (launch spans, host clocks) beside the
            # profiler's device busy time for the same traced run
            sess = report.accelerator.bind(gt)
            sess.run(**p)
            holder = {}
            tel.enable()
            try:
                prof = profile_run(lambda s=sess, p=p: holder.__setitem__("r", s.run(**p)))
            finally:
                tel.disable()
            objective_s = AutoTuner._objective_from_trace(holder["r"].trace, prof["wall_s"])
            del sess
            fresh = AutoTuner(TuningCache(tuning_dir_for(tune_store)), device="cuda")
            again = fresh.tune(prog, gt, params=p)
            assert again.cache_hit and again.trials == 0 and again.config == report.config
            t0 = time.perf_counter()
            acc = prog.lower(graph=gt, tuned=True,
                             tuning_cache=TuningCache(tuning_dir_for(tune_store)))
            lookup_s = time.perf_counter() - t0
            assert acc.tuned == report.config.to_dict() and acc.target == report.config.target
            with open(os.path.join(acc.save(os.path.join(store, f"tuned-{name}")),
                                   "manifest.json")) as f:
                assert json.load(f)["tuned"] == acc.tuned, "the manifest lacks the stamp"
            del acc
            tuned_rows[name] = {
                "graph": f"rmat-{tune_scale}-16", "vertices": gt.n_vertices, "edges": gt.n_edges,
                "trials": report.trials, "candidates": report.candidates,
                "pruned": list(report.pruned), "winner": report.config.target.describe(),
                "objective_s": report.config.objective_s, "baseline_s": report.config.baseline_s,
                "speedup": report.config.speedup, "tune_s": tune_s,
                "measurements": report.measurements,
                "winner_traced_run": {"objective_s": objective_s,
                                      "device_busy_s": prof["device_busy_s"],
                                      "wall_s": prof["wall_s"],
                                      "device_idle_share": prof["device_idle_share"]},
                "fresh_tuner_trials": again.trials, "lower_tuned_s": lookup_s,
                "manifest_stamped": True}
        # a service with the lookup on against one on the base target
        base_target = Target()
        sets = {"bfs": [{"root": r} for r in range(8)], "sssp": [{"root": r} for r in range(4)]}
        answers = {}
        for lookup in (True, False):
            with repro_torch.serve(tune_store, device="cuda", autotune=lookup,
                                   target=None if lookup else base_target) as tsvc:
                futs = [(n, tsvc.submit(n, gt, **p)) for n in sets for p in sets[n]]
                answers[lookup] = [(n, f.result(timeout=600)) for n, f in futs]
                tstats = tsvc.stats()
                targets = {e.accelerator.program.fingerprint[:12]: e.accelerator.target.describe()
                           for e in tsvc.registry._residents.values()}
            if lookup:
                hits = tstats["queries"]["tuned_hits"]
                assert hits >= 1, tstats["queries"]
                tuned_targets = targets
            else:
                assert tstats["queries"]["tuned_hits"] == 0
        for (n, a), (_, b) in zip(answers[True], answers[False]):
            assert _identical_props(b, a), f"tuned {n} differs from the base target's"
        log({"phase": "serving", "autotune": tuned_rows, "card": smi,
             "tuned_service": {"tuned_hits": hits, "targets": tuned_targets,
                               "answers_equal_base": len(answers[True])},
             "reduced": {"autotune_graph": f"rmat-{tune_scale}-16 (a trial is a bind; "
                                           f"not R19)"}})

        # -- the CLI, as a child process ------------------------------------
        env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--graph", "bfs",
             "--queries", "16", "--pool", "2", "--artifact-dir", os.path.join(store, "cli")],
            capture_output=True, text=True, env=env, cwd=here, timeout=600)
        cli_s = time.perf_counter() - t0
        assert out.returncode == 0, f"serve --graph bfs exited {out.returncode}: " \
                                    f"{out.stderr[-2000:]}"
        lines = out.stdout.splitlines()
        assert any(line.startswith("answered 16 queries") for line in lines), lines[:8]
        launches = {"shuffle_reduce": sr.LAUNCHES, "edge_stream": es.LAUNCHES}
        log({"phase": "serving", "cli": "python -m repro_torch.launch.serve --graph bfs "
                                        "--queries 16 --pool 2", "rc": out.returncode,
             "process_s": cli_s, "head": lines[:5]})
        log({"phase": "serving", "launches": launches,
             "phase_s": time.perf_counter() - t_phase})
        return launches
    finally:
        shutil.rmtree(store, ignore_errors=True)


# ---------------------------------------------------------------------------
# 4f. the distributed engine
# ---------------------------------------------------------------------------


def _dist_stages(eng, name: str) -> int:
    """Supersteps one launch of kernel ``name`` runs on the distributed
    engine ``eng``: its edge stages that distribute (the reference's rule)."""
    from repro_torch.core import mir

    kern = eng.module.kernels[name]
    stages = kern.edge_stages if isinstance(kern, mir.PipelineKernel) else [kern]
    return sum(1 for st in stages
               if st.kind is mir.KernelKind.EDGE and eng._dist_kernel(st.name) is not None)


def superstep_row(eng, main_eng, sr, dev: str) -> dict:
    """The device time of one superstep of ``eng``'s distributed edge
    kernel, stage by stage (apply, the shuffle's copies, the reduce), beside
    one full launch of the same kernel by the single-device engine
    ``main_eng``, both on ``main_eng``'s state: the superstep's combined
    update must equal the full launch's (bit for bit for min and integer
    results, within ``rtol=DIST_RTOL, atol=DIST_ATOL`` for a float sum); and one
    superstep launches ``shuffle_reduce`` once per shard."""
    from repro_torch.core import backend
    from repro_torch.core.dist_engine import shuffle

    kname, entry = next((k, e) for k, e in eng._dist_lowered.items() if e is not None)
    step, out_prop, op, src_props = entry
    dg = eng._dist_graph
    props = {p: main_eng.state[p] for p in src_props}
    scalars = main_eng._kernel_scalars(kname)
    before = sr.LAUNCHES
    red = step(props, scalars)
    assert sr.LAUNCHES - before == dg.n_devices, (kname, sr.LAUNCHES - before)
    cur = main_eng.state[out_prop]
    got = backend.combine(op, cur, red[: main_eng.graph.n_vertices].to(cur.dtype))
    lk = main_eng._kernel(kname)
    want = lk.run_full(main_eng.state, scalars)[out_prop]
    if got.dtype == torch.float32 and op == "+":
        assert torch.allclose(got, want, rtol=DIST_RTOL, atol=DIST_ATOL), kname
        agree = {"rtol": DIST_RTOL, "atol": DIST_ATOL,
                 "max_abs_err": float((got - want).abs().max())}
    else:
        assert torch.equal(got, want), kname
        agree = {"exact": True}
    sent = step.apply(props, scalars)
    recv = shuffle(dg, sent)
    stages = {
        "apply": device_ms(lambda: step.apply(props, scalars)),
        "move": device_ms(lambda: shuffle(dg, sent)),
        "reduce": device_ms(lambda: step.reduce(recv, dev), focus="shuffle_reduce"),
        "superstep": device_ms(lambda: step(props, scalars)),
        "single_device_full_launch": device_ms(lambda: lk.run_full(main_eng.state, scalars)),
    }
    return {"kernel": kname, "op": op, "agree": agree,
            "device_ms": {k: v["ms"] for k, v in stages.items()},
            "kernels_per_call": {k: v["kernels_per_call"] for k, v in stages.items()},
            "reduce_shuffle_reduce_ms": stages["reduce"]["focus_ms"],
            "shuffle_reduce_launches_per_superstep": dg.n_devices}


def distributed_phase(repro_torch, sources, generators, g, sessions, results, params,
                      batch_rows, sr, es, seed: int, smi: str, here: str) -> dict:
    """Phase 4f: ``Target(kind="distributed", n_devices=4)`` on the main
    phase's R19 graph, its four shards sharing the one card (every
    shuffle copy stays on it; no link between cards is measured). For
    BFS_ECP, SSSP and PAGERANK (iters 20): one bind, one cold run (it
    partitions the graph) and five warm runs; BFS_ECP and SSSP bit for bit
    the main phase's single-device runs, PAGERANK within ``rtol=DIST_RTOL,
    atol=DIST_ATOL`` of it, within the oracle's tolerance and the same bits on
    two runs; launches equal, one superstep per launch of a distributable
    edge stage, at least one ``shuffle_reduce`` per shard and superstep.
    Each line gives the partition (its seconds, the edges per shard, the
    reference's padded slots and bytes beside the stored ones), the warm
    median beside the main phase's, a profiled warm run, the superstep's
    stages' device time beside a single-device full launch, and peak
    memory; one PAGERANK iteration runs under
    ``torch.cuda.set_sync_debug_mode("error")``. BFS_ECP bound again with
    ``Target(kind="distributed", n_devices=1)`` (bit for bit). PAGERANK
    batched at K = 16 (the batch phase's iters) on the same engine: every
    lane a sequential distributed run's bits, one superstep a round. Then, on rmat(16, 16): a distributed
    ``StreamingSession`` repairs BFS_ECP after a 4,096-edge addition (equal
    to a full distributed run), ``repro_torch.serve(dir,
    backend="distributed")`` answers 16 BFS_ECP roots as a single-device
    session does, and the serving CLI runs with ``--backend distributed``
    as a child. The launches returned are the distributed path's own: both
    graph kernels' counters are set to 0 just before each group of
    distributed runs and read just after it, so the profiles, the
    superstep timings and the single-device comparisons count nothing."""
    from repro_torch import GraphDelta, GraphShape, StreamingSession, Target
    from repro_torch.core import DistEngine

    t_phase = time.perf_counter()
    target = Target(kind="distributed", n_devices=DIST_DEVICES)
    mesh = target.mesh("cuda")
    launches = {"shuffle_reduce": 0, "edge_stream": 0}

    def counted(fn):
        """``fn()`` with the counters set to 0 just before and read into
        ``launches`` just after."""
        sr.LAUNCHES = 0
        es.LAUNCHES = 0
        try:
            return fn()
        finally:
            launches["shuffle_reduce"] += sr.LAUNCHES
            launches["edge_stream"] += es.LAUNCHES

    def runs(sess, p, n):
        """One cold run and ``n`` warm ones: their seconds, the last run
        and the ``shuffle_reduce``/``edge_stream`` launches per warm run."""
        t0 = time.perf_counter()
        cold = sess.run(**p)
        cold_s = time.perf_counter() - t0
        sr0, es0 = sr.LAUNCHES, es.LAUNCHES
        warm_runs_s = []
        for _ in range(n):
            t0 = time.perf_counter()
            warm = sess.run(**p)
            warm_runs_s.append(time.perf_counter() - t0)
        return cold, cold_s, warm, warm_runs_s, (sr.LAUNCHES - sr0) / n, (es.LAUNCHES - es0) / n

    dist = {}
    for name in ("BFS_ECP", "SSSP", "PAGERANK"):
        gc.collect()
        torch.cuda.empty_cache()
        prog = repro_torch.compile(getattr(sources, name))
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sess = prog.bind(g, target=target)
        bind_s = time.perf_counter() - t0
        eng = sess.engine
        assert isinstance(eng, DistEngine) and eng.mesh == mesh, (type(eng), eng.mesh)
        cold, cold_s, warm, warm_runs_s, sr_per_run, es_per_run = counted(
            lambda: runs(sess, params[name], WARM_RUNS))
        dg = eng._dist_graph
        assert dg is not None and dg.n_devices == DIST_DEVICES
        peak = torch.cuda.max_memory_allocated()
        _, main_warm, _, main_runs_s = results[name]
        st = warm.stats
        assert st.kernel_launches == main_warm.stats.kernel_launches, name
        supersteps = sum(n * _dist_stages(eng, k) for k, n in st.kernel_launches.items())
        assert st.dist_supersteps == supersteps > 0, (name, st.dist_supersteps, supersteps)
        assert sr_per_run >= supersteps * DIST_DEVICES, (name, sr_per_run, supersteps)
        assert _identical_props(cold, warm) and cold.host_env == warm.host_env, \
            f"{name}: two distributed runs differ"
        if name == "PAGERANK":
            got, want = warm.properties["rank"], main_warm.properties["rank"]
            assert np.allclose(got, want, rtol=DIST_RTOL, atol=DIST_ATOL), name
            oracle = pagerank(g.n_vertices, g.src, g.dst, params[name]["iters"])
            assert np.allclose(got, oracle, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL), name
            agree = {"single_device": {"rtol": DIST_RTOL, "atol": DIST_ATOL,
                                       "max_abs_err": float(np.abs(got - want).max())},
                     "oracle": {"rtol": PAGERANK_RTOL, "atol": PAGERANK_ATOL},
                     "two_runs_same_bits": True}
        else:
            assert _identical_props(main_warm, warm) and warm.host_env == main_warm.host_env, \
                f"{name}: the distributed run differs from the single-device run"
            agree = {"single_device_bits": True}
        prof = profile_run(lambda s=sess, n=name: s.run(**params[n]))
        step = superstep_row(eng, sessions[name].engine, sr, eng.device)
        row = {
            "phase": "distributed", "program": name, "params": params[name], "card": smi,
            "devices": DIST_DEVICES, "mesh": mesh, "bind_s": bind_s,
            "partition_s": dg.partition_s, "cold_s": cold_s,
            "warm_s": statistics.median(warm_runs_s), "warm_runs_s": warm_runs_s,
            "single_device_warm_s": statistics.median(main_runs_s),
            "shard_edges": dg.shard_edges, "received_edges": dg.recv_len,
            "slots": {"padded": dg.padded_slots, "emax": dg.emax, "stored": g.n_edges,
                      "padded_bytes": dg.padded_slots * PADDED_SLOT_BYTES,
                      "stored_bytes": dg.stored_bytes},
            "supersteps": st.dist_supersteps, "kernel_launches": st.total_launches,
            "full_launches": st.full_launches, "compacted_launches": st.compacted_launches,
            "shuffle_reduce_per_run": sr_per_run,
            "supersteps_x_devices": supersteps * DIST_DEVICES,
            "edge_stream_per_run": es_per_run, "edges_traversed": st.edges_traversed,
            "oracle_or_single_device": agree, "superstep": step, **_busy(prof),
            "resident_bytes_before": resident, "max_memory_allocated": peak,
        }
        if name == "PAGERANK":
            # one warm iteration (the fused pipeline: a superstep and the
            # vertex stage) must read nothing back to the host
            pipe = next(k for k in st.kernel_launches if "__" in k)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                counted(lambda: eng.launch(pipe))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            row["sync_free_iteration"] = pipe
        log(row)
        dist[name] = (sess, warm)

    # -- one shard: BFS_ECP bound again with n_devices=1 ---------------------
    del dist["BFS_ECP"], dist["SSSP"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sess = repro_torch.compile(sources.BFS_ECP).bind(
        g, target=Target(kind="distributed", n_devices=1))
    bind_s = time.perf_counter() - t0
    assert sess.engine.mesh == mesh[:1], sess.engine.mesh
    t0 = time.perf_counter()
    one = counted(lambda: sess.run(**params["BFS_ECP"]))
    one_s = time.perf_counter() - t0
    assert sess.engine._dist_graph.n_devices == 1
    assert _identical_props(results["BFS_ECP"][1], one) and \
        one.host_env == results["BFS_ECP"][1].host_env, "BFS_ECP on one shard"
    log({"phase": "distributed", "program": "BFS_ECP", "devices": 1, "card": smi,
         "bind_s": bind_s, "run_s": one_s,
         "partition_s": sess.engine._dist_graph.partition_s,
         "supersteps": one.stats.dist_supersteps, "single_device_bits": True})
    del sess, one
    gc.collect()
    torch.cuda.empty_cache()

    # -- PAGERANK batched on the same engine (the batch phase's iters) -------
    rng = np.random.default_rng(seed)
    rng.choice(np.arange(1, g.n_vertices), 63, replace=False)  # the batch phase's roots
    sets = [{"iters": int(i)} for i in rng.integers(16, 21, BATCH_K)]
    sess, _ = dist["PAGERANK"]
    torch.cuda.reset_peak_memory_stats()

    def batches():
        t0 = time.perf_counter()
        cold = sess.run_many(sets, batched=True)
        cold_s = time.perf_counter() - t0
        warm_s = []
        for _ in range(BATCH_WARM_RUNS):
            t0 = time.perf_counter()
            warm = sess.run_many(sets, batched=True)
            warm_s.append(time.perf_counter() - t0)
        return cold, cold_s, warm, warm_s, sr.LAUNCHES

    cold, cold_s, warm, warm_s, sr_batches = counted(batches)
    st = warm[0].stats
    rounds = max(p["iters"] for p in sets)
    assert st.batch_size == BATCH_K and st.dist_supersteps == rounds, \
        (st.batch_size, st.dist_supersteps, rounds)
    assert sr_batches >= (1 + BATCH_WARM_RUNS) * rounds * DIST_DEVICES, sr_batches
    for p, a, c in zip(sets, warm, cold):
        want = counted(lambda p=p: sess.run(**p))
        assert _identical_props(want, a) and _identical_props(want, c) and \
            a.host_env == want.host_env, f"batched PAGERANK {p}"
    med = statistics.median(warm_s)
    single = next(r for r in batch_rows if r["program"] == "PAGERANK")
    prof = profile_run(lambda: sess.run_many(sets, batched=True))
    log({"phase": "distributed", "program": "PAGERANK", "batched": BATCH_K, "card": smi,
         "iters": [p["iters"] for p in sets], "cold_s": cold_s, "warm_s": med,
         "warm_runs_s": warm_s, "queries_per_s": BATCH_K / med,
         "single_device_batch_queries_per_s": single["queries_per_s"],
         "supersteps_per_batch": st.dist_supersteps, "launches_per_batch": st.total_launches,
         "lanes_bit_identical": BATCH_K, **_busy(prof),
         "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del dist, sess, cold, warm
    gc.collect()
    torch.cuda.empty_cache()

    # -- the other surfaces, on rmat(16, 16) --------------------------------
    small = generators.rmat(DIST_SMALL_SCALE, 16, seed=seed)
    prog = repro_torch.compile(sources.BFS_ECP)
    shape = GraphShape.bucket_for(small.n_vertices, small.n_edges)
    t0 = time.perf_counter()
    ss = StreamingSession(prog, small.pad_to(shape.n_vertices, shape.n_edges),
                          backend="distributed", target=target)
    try:
        def stream():
            ss.run(root=0)
            rng = np.random.default_rng(seed + 1)
            lv = ss.graph.n_vertices_logical
            ss.update(GraphDelta(
                added_edges=rng.integers(0, lv, (STREAM_DELTA, 2)).astype(np.int32)))
            return ss.run(root=0), ss.session.run(root=0)

        repaired, full = counted(stream)
        assert ss.incremental_runs == 1 and isinstance(ss.session.engine, DistEngine)
        assert full.stats.dist_supersteps > 0
        assert _identical_props(full, repaired), "distributed streaming repair"
        stream_s = time.perf_counter() - t0
    finally:
        ss.close()
    store = tempfile.mkdtemp(prefix="chip_smoke_distributed_")
    try:
        roots = list(range(16))
        alone = prog.bind(small)
        want = [alone.run(root=r) for r in roots]
        t0 = time.perf_counter()

        def served():
            with repro_torch.serve(store, backend="distributed", workers=2, max_batch=8) as svc:
                got = [f.result(timeout=600) for f in
                       [svc.submit("bfs", small, root=r) for r in roots]]
                return got, sorted({k[1].kind for k in svc.registry._residents})

        got, kinds = counted(served)
        serve_s = time.perf_counter() - t0
        assert kinds == ["distributed"], kinds
        for r, a, b in zip(roots, want, got):
            assert _identical_props(a, b), f"served distributed BFS_ECP root {r}"
        env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--graph", "bfs",
             "--queries", "8", "--backend", "distributed",
             "--artifact-dir", os.path.join(store, "cli")],
            capture_output=True, text=True, env=env, cwd=here, timeout=600)
        cli_s = time.perf_counter() - t0
        assert out.returncode == 0, f"serve --backend distributed exited {out.returncode}: " \
                                    f"{out.stderr[-2000:]}"
        lines = out.stdout.splitlines()
        assert any(line.startswith("answered 8 queries") for line in lines), lines[:8]
    finally:
        shutil.rmtree(store, ignore_errors=True)
    assert launches["shuffle_reduce"] > 0, "shuffle_reduce never launched in 4f"
    log({"phase": "distributed", "graph": f"rmat-{DIST_SMALL_SCALE}-16", "card": smi,
         "streaming": {"repair_equals_full_distributed_run": True, "seconds": stream_s},
         "served": {"answers": len(roots), "single_device_bits": True, "seconds": serve_s},
         "cli": {"command": "python -m repro_torch.launch.serve --graph bfs --queries 8 "
                            "--backend distributed", "rc": out.returncode,
                 "process_s": cli_s, "head": lines[:4]},
         "reduced": {"surfaces_graph": f"rmat-{DIST_SMALL_SCALE}-16 (each surface is a "
                                       f"further bind; not R19)"}})
    log({"phase": "distributed", "launches": launches,
         "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# oracles (numpy / scipy, independent of the port)
# ---------------------------------------------------------------------------


def bfs_levels(n: int, src: np.ndarray, dst: np.ndarray, root: int) -> np.ndarray:
    """BFS_ECP's old_level: 1 at the root, BFS depth + 1, -1 unreached."""
    order = np.argsort(src, kind="stable")
    indices = dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    level = np.full(n, -1, dtype=np.int64)
    level[root] = 1
    frontier = np.array([root], dtype=np.int64)
    depth = 1
    while frontier.size:
        starts, counts = indptr[frontier], indptr[frontier + 1] - indptr[frontier]
        total = int(counts.sum())
        base = np.repeat(starts - np.cumsum(counts) + counts, counts)
        nb = indices[base + np.arange(total)]
        nb = np.unique(nb[level[nb] < 0])
        depth += 1
        level[nb] = depth
        frontier = nb
    return level.astype(np.int32)


def sssp_dist(n: int, src, dst, w, root: int) -> np.ndarray:
    """scipy Dijkstra after reducing parallel edges to their minimum weight
    (scipy sums duplicate entries); unreached -> the program's INF."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    # one sort orders the edges (src, dst) and each edge's weights: the
    # weight sits in the key's low bits (weights are positive integers)
    bits = max(1, int(w.max()).bit_length())
    key = np.sort(((src.astype(np.int64) * n + dst) << bits) | w.astype(np.int64))
    edge = key >> bits
    first = np.ones(key.shape[0], dtype=bool)
    first[1:] = edge[1:] != edge[:-1]
    edge, w_min = edge[first], key[first] & ((1 << bits) - 1)
    mat = csr_matrix((w_min.astype(np.float64), (edge // n, edge % n)), shape=(n, n))
    d = dijkstra(mat, directed=True, indices=root)
    return np.where(np.isinf(d), SSSP_INF, d).astype(np.int64)


def wcc_labels(n: int, src, dst, lane=None) -> np.ndarray:
    """WCC's comp: the smallest id of each weakly connected component
    (scipy's labelling, then each component's minimum). The program labels
    a vertex with its lane id (``comp[v] = v``), which under the hub
    relabel is its degree rank: ``lane`` maps vertex -> lane id (None: the
    vertex id)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    mat = csr_matrix((np.ones(src.shape[0], dtype=np.int8), (src, dst)), shape=(n, n))
    _, labels = connected_components(mat, directed=True, connection="weak")
    key = np.arange(n, dtype=np.int64) if lane is None else lane.astype(np.int64)
    low = np.full(labels.max() + 1, n, dtype=np.int64)
    np.minimum.at(low, labels, key)
    return low[labels]


def degree_lanes(n: int, src, dst) -> np.ndarray:
    """Vertex -> lane id under the hub relabel: vertices by (in + out)
    degree over every physical edge, descending, as the hub cache orders
    them (numpy's default argsort of the negated degrees)."""
    deg = np.bincount(src, minlength=n).astype(np.int64) + np.bincount(dst, minlength=n)
    lane = np.empty(n, dtype=np.int64)
    lane[np.argsort(-deg)] = np.arange(n, dtype=np.int64)
    return lane


def pagerank(n: int, src, dst, iters: int, damp: float = 0.85) -> np.ndarray:
    """The PAGERANK program's iteration in float64 (dangling mass drops):
    each step's contributions are one sparse product over the edges."""
    from scipy.sparse import csr_matrix

    deg = np.bincount(src, minlength=n).astype(np.float64)
    inv = np.divide(1.0, deg, out=np.zeros(n), where=deg > 0)
    edges = csr_matrix((np.ones(src.shape[0]), (dst, src)), shape=(n, n))
    rank = np.full(n, 1.0 / n)
    for _ in range(iters):
        rank = (1.0 - damp) / n + damp * (edges @ (rank * inv))
    return rank


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


#: the phases after the device and the build, in the order they run:
#: 3 (``kernels``), 4-4f (``graph``: R19's main path, batches, artifacts,
#: streaming, serving, the distributed engine), 5 (``lm``), 4g
#: (``lm_families``), 4h (``ssm_families``), 4i (``train``)
PHASES = ("kernels", "graph", "lm", "lm_families", "ssm_families", "train")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=19, help="RMAT scale (19 = R19)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load-artifact", metavar="DIR",
                    help="phase 4c's fresh process: load DIR, bind the graph, one BFS_ECP run")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="for development runs, a comma-separated subset of "
                         f"{','.join(PHASES)} to run after the device and the build (default: "
                         "all; the last lines then name only the kernels those phases ran)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"--phases: unknown {sorted(phases - set(PHASES))}; choose from {PHASES}")
    t_start = time.perf_counter()

    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    if args.load_artifact:
        return artifact_child(args.load_artifact, args.scale, args.seed)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.models import moe as moe_mod

    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log({"phase": "device", **card})

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", info["log"])]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill", info["log"])]
        log({"phase": "build", "source": f"src/repro_torch/csrc/{name}.cu",
             "seconds": round(info["seconds"], 3), "cached": info["cached"],
             "ptxas": {"kernels": len(regs), "max_registers": max(regs, default=None),
                       "spill_bytes": sum(spills)}})
    log({"phase": "build", "total_seconds": round(build_s, 3)})
    for name in ("shuffle_reduce", "edge_stream"):  # 256 threads a block (reduce_ops.cuh)
        entries = [{"entry": row["entry"], "registers": row.get("registers"),
                    "spill_store_bytes": row.get("spill_store_bytes"),
                    "theoretical_occupancy": register_occupancy(row["registers"])
                    if "registers" in row else None}
                   for row in ptxas_kernels(built[name]["log"])]
        log({"phase": "build", "source": f"src/repro_torch/csrc/{name}.cu", "kernels": entries})
    fa_ptxas = ptxas_kernels(built["flash_attention"]["log"])
    FA_PTXAS.extend(fa_ptxas)
    log({"phase": "build", "source": "src/repro_torch/csrc/flash_attention.cu",
         "tile_kernels": tile_resources(fa_ptxas, fa), "decode_kernels": decode_kernels(fa_ptxas)})
    sm90_lib = _build.load("flash_attention_sm90")
    sm90_log = built["flash_attention_sm90"]["log"]
    sm90 = ptxas_kernels(sm90_log)
    for row in sm90:  # the template arguments: Dqk, value slice, keys a stage, consumers
        row["dqk"], row["dv_slice"], row["keys"], row["consumers"] = (
            int(x) for x in re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                                      row["entry"]).groups())
        # the form's dynamic shared memory: a kv head of 1 row takes one
        # consumer, of 65 two where the instantiation has that form
        row["dynamic_smem_bytes"] = sm90_lib.repro_flash_attention_sm90_smem_bytes(
            row["dqk"], row["dv_slice"], 1 if row["consumers"] == 1 else 65)
    spilled = [r["entry"] for r in sm90 if r.get("spill_store_bytes")]
    log({"phase": "build", "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "kernels": sm90, "spilled": spilled,
         "ptxas_warnings": [line.strip() for line in sm90_log.splitlines() if "warning" in line],
         # ptxas's notes where it serialises wgmma (C7515, C7520): none expected
         "wgmma_notes": [line.strip() for line in sm90_log.splitlines() if "wgmma" in line]})
    assert not spilled, f"the tensor-core forward spills: {spilled}"

    bwd90_lib = _build.load("flash_attention_bwd_sm90")
    bwd90_lib.repro_flash_attention_bwd_sm90_smem_bytes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    bwd90 = ptxas_kernels(built["flash_attention_bwd_sm90"]["log"])
    bwd90_smem = {}
    for dqk, dv in ((32, 32), (64, 64), (128, 128), (192, 128)):
        pair = (ctypes.c_int * 2)()
        assert bwd90_lib.repro_flash_attention_bwd_sm90_smem_bytes(dqk, dv, pair) == 0
        bwd90_smem[f"{dqk}x{dv}"] = {"dkdv": pair[0], "dq": pair[1]}
    spilled = [r["entry"] for r in bwd90 if r.get("spill_store_bytes")]
    log({"phase": "build", "source": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
         "kernels": bwd90, "dynamic_smem_bytes": bwd90_smem, "spilled": spilled,
         "ptxas_warnings": [line.strip() for line in
                            built["flash_attention_bwd_sm90"]["log"].splitlines()
                            if "warning" in line]})
    assert not spilled, f"the tensor-core backward spills: {spilled}"
    bwd32_lib = _build.load("flash_attention_bwd")
    bwd32_lib.repro_flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    bwd32 = ptxas_kernels(built["flash_attention_bwd"]["log"])
    bwd32_smem = {f"{dqk}x{dv}": bwd32_lib.repro_flash_attention_bwd_smem_bytes(dqk, dv)
                  for dqk, dv in ((32, 32), (64, 64), (128, 128), (192, 128))}
    spilled = [r["entry"] for r in bwd32 if r.get("spill_store_bytes")]
    log({"phase": "build", "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "kernels": bwd32, "dynamic_smem_bytes": bwd32_smem, "spilled": spilled,
         "ptxas_warnings": [line.strip() for line in
                            built["flash_attention_bwd"]["log"].splitlines()
                            if "warning" in line]})
    assert not spilled, f"the float32 backward spills: {spilled}"

    rows, launches, family_rows = {}, {}, {}
    f32_tile = f32_decode = 0

    def count(name: str, n: int) -> None:
        launches[name] = launches.get(name, 0) + n

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    if phases & {"kernels", "graph"}:
        graph_phases(args, phases, smi, here, built, rows, launches)

    # -- 5. the LM path -------------------------------------------------------
    mods = (fa, md, get_config, Model, serve)
    if "lm" in phases:
        kimi = lm_phase(mods, dev, args.seed)
        log(kimi)
        count("flash_attention_sm90", kimi["launches"]["flash_attention_sm90"])
        count("moe_gather", kimi["launches"]["moe_gather"])
        gc.collect()
        torch.cuda.empty_cache()
        qwen = qwen_phase(mods, dev, args.seed)
        log(qwen)
        count("flash_attention", qwen["launches"]["flash_attention_tile"]  # the f32 path
              + qwen["launches"]["flash_attention_decode"])
        count("flash_decode", qwen["launches"]["flash_attention_decode"])
        gc.collect()
        torch.cuda.empty_cache()
        log(qwen_prefill_phase(mods, ref, dev, args.seed))
        gc.collect()
        torch.cuda.empty_cache()
        prefill_f32 = qwen_prefill_f32_phase(mods, ref, dev, args.seed)
        log(prefill_f32)
        f32_tile += qwen["launches"]["flash_attention_tile"] + \
            prefill_f32["launches_per_forward"]["flash_attention_tile"]
        count("flash_attention", prefill_f32["launches_per_forward"]["flash_attention_tile"])
        f32_decode += qwen["launches"]["flash_attention_decode"]
        gc.collect()
        torch.cuda.empty_cache()

    # -- 4g. MLA, the ring-buffer decode, M-RoPE and the frontend stubs -------
    if "lm_families" in phases:
        _, family, family_launches = lm_families_phase(mods, ref, dev, args.seed, smi)
        family_rows.update(family)
        count("flash_attention_sm90", family_launches["flash_attention_sm90"])
        count("moe_gather", family_launches["moe_gather"])
        count("flash_attention", family_launches["flash_attention_tile"]
              + family_launches["flash_attention_decode"])
        count("flash_decode", family_launches["flash_attention_decode"])
        f32_tile += family_launches["flash_attention_tile"]
        f32_decode += family_launches["flash_attention_decode"]
        gc.collect()
        torch.cuda.empty_cache()

    # -- 4h. Mamba2 with zamba2's shared windowed attention, and xLSTM --------
    if "ssm_families" in phases:
        _, ssm_rows, ssm_launches = ssm_families_phase(mods, ref, dev, args.seed, smi)
        family_rows.update(ssm_rows)
        count("flash_attention_sm90", ssm_launches["flash_attention_sm90"])
        count("flash_attention", ssm_launches["flash_attention_tile"]
              + ssm_launches["flash_attention_decode"])
        count("flash_decode", ssm_launches["flash_attention_decode"])
        f32_tile += ssm_launches["flash_attention_tile"]
        f32_decode += ssm_launches["flash_attention_decode"]
        gc.collect()
        torch.cuda.empty_cache()

    # -- 4i. training: the backward kernels, qwen3-0.6b, deepseek-v2 ----------
    if "train" in phases:
        train_rows, train_launches = train_phase(
            mods, ref, moe_mod, dev, args.seed, smi,
            {torch.bfloat16: bwd90, torch.float32: bwd32})
        for name in ("flash_attention_sm90", "moe_gather", "flash_attention_bwd",
                     "flash_attention_bwd_f32", "moe_gather_bwd"):
            count(name, train_launches[name])
        rows["flash_attention_bwd"] = train_rows["flash_attention_bwd_qwen3"]
        rows["flash_attention_bwd_f32"] = train_rows["flash_attention_bwd_qwen3_f32"]
        rows["moe_gather_bwd"] = train_rows["moe_gather_bwd"]
    kernels = summary(rows, launches, family_rows, f32_tile, f32_decode,
                      train_rows if "train" in phases else {})
    log({"phase": "done", "elapsed_s": time.perf_counter() - t_start, "phases": sorted(phases),
         "profiler": PROFILE_WINDOWS})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def graph_phases(args, phases: set, smi: str, here: str, built: dict, rows: dict,
                 launches: dict) -> None:
    """Phases 3 (``kernels``: every kernel against its plain version on
    the graph's and the LM's shapes) and 4-4f (``graph``: the main path on
    R19, its profiles, batches, artifacts, streaming, serving and the
    distributed engine), as ``phases`` asks; fills ``rows`` and
    ``launches``."""
    import repro_torch
    from repro_torch.algorithms import sources
    from repro_torch.graph import generators
    from repro_torch.configs import get_config
    from repro_torch.kernels import edge_stream as es
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    from repro_torch.kernels import shuffle_reduce as sr
    from repro_torch.models import moe as moe_mod

    dev = "cuda"
    fa_ptxas = ptxas_kernels(built["flash_attention"]["log"])

    # -- graph and the SSSP bind (whose bindings give the main-path shape) --
    t0 = time.perf_counter()
    g = generators.rmat(args.scale, EDGE_FACTOR, seed=args.seed, weighted=True)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sessions = {"SSSP": repro_torch.compile(sources.SSSP).bind(g, device=dev)}
    bind_s = {"SSSP": time.perf_counter() - t0}
    log({"phase": "graph", "name": f"rmat-{args.scale}-{EDGE_FACTOR}",
         "vertices": g.n_vertices, "edges": g.n_edges, "generate_s": round(gen_s, 3),
         "bind_s": round(bind_s["SSSP"], 3)})

    # -- 3. kernels vs plain versions ----------------------------------------
    if "kernels" in phases:
        small = kernel_tests(sr, es, ref, dev)
        log({"phase": "kernels", "reference_shapes": small})
        eng = sessions["SSSP"].engine
        graph_rows = main_shape_kernels(sr, es, ref, eng.gb, eng.state["__weight__"], dev)
        rows.update(graph_rows)
        for name, row in graph_rows.items():
            log({"phase": "kernels", "kernel": name, **row})
        es_ptxas = ptxas_kernels(built["edge_stream"]["log"])
        for name, row in batched_kernels(sr, es, ref, eng.gb, eng.state["__weight__"], dev,
                                         es_ptxas).items():
            log({"phase": "kernels", "kernel": name, **row})
        gc.collect()
        torch.cuda.empty_cache()
        log({"phase": "kernels", "skewed_edge_stream": skewed_edge_stream(sr, es, ref, dev)})
        log({"phase": "kernels", "skewed_shuffle_reduce": skewed_shuffle_reduce(sr, ref, dev)})
        log({"phase": "kernels", "reference_shapes_lm": lm_kernel_tests(fa, md, ref, dev)})
        lm_rows = lm_main_shape_kernels(fa, md, ref, moe_mod, get_config(KIMI), dev)
        lm_rows["flash_attention_qwen3_forward"] = qwen_forward_row(fa, ref, get_config(QWEN), dev)
        lm_rows["flash_attention_decode"]["ptxas"] = decode_resources(
            fa_ptxas, 128, lm_rows["flash_attention_decode"]["decode"]["row_tile"])
        lm_rows.update(f32_decode_rows(fa, ref, get_config(QWEN), dev, fa_ptxas))
        for name, row in lm_rows.items():
            log({"phase": "kernels", "kernel": name, **row})
        rows.update(lm_rows)
        log({"phase": "kernels", "flash_attention_route_sweep": route_sweep(fa, ref, dev),
             "decode_max_rows": fa.DECODE_MAX_ROWS})
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()

    # -- 4. the main path ---------------------------------------------------
    if "graph" not in phases:
        return
    src_np, dst_np = g.src, g.dst
    oracles = {
        "BFS_ECP": ("old_level", lambda: bfs_levels(g.n_vertices, src_np, dst_np, 0)),
        "PAGERANK": ("rank", lambda: pagerank(g.n_vertices, src_np, dst_np, 20)),
        "SSSP": ("SP", lambda: sssp_dist(g.n_vertices, src_np, dst_np,
                                         g.weights.astype(np.int64), 0)),
    }
    params = {"BFS_ECP": {"root": 0}, "PAGERANK": {"iters": 20}, "SSSP": {"root": 0}}
    for name in ("BFS_ECP", "PAGERANK"):
        t0 = time.perf_counter()
        sessions[name] = repro_torch.compile(getattr(sources, name)).bind(g, device=dev)
        bind_s[name] = time.perf_counter() - t0
    sr.LAUNCHES = 0
    es.LAUNCHES = 0
    results, resident, peak = {}, {}, {}
    for name in ("BFS_ECP", "PAGERANK", "SSSP"):
        sess = sessions[name]
        resident[name] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cold = sess.run(**params[name])
        cold_s = time.perf_counter() - t0
        warm_runs_s = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            warm = sess.run(**params[name])
            warm_runs_s.append(time.perf_counter() - t0)
        peak[name] = torch.cuda.max_memory_allocated()
        results[name] = (cold, warm, cold_s, warm_runs_s)
    launches.update({"shuffle_reduce": sr.LAUNCHES, "edge_stream": es.LAUNCHES})
    for name, (cold, warm, cold_s, warm_runs_s) in results.items():
        warm_s = statistics.median(warm_runs_s)
        prop, oracle = oracles[name]
        want = oracle()
        got = warm.properties[prop]
        assert got.shape == want.shape and np.all(np.isfinite(got)), name
        for k in cold.properties:
            assert np.array_equal(cold.properties[k], warm.properties[k]), \
                f"{name}: cold and warm runs differ in {k}"
        if name == "PAGERANK":
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
            assert np.allclose(got, want, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL), \
                f"PAGERANK: max rel err {rel.max():.3e}"
            agree = {"rtol": PAGERANK_RTOL, "atol": PAGERANK_ATOL,
                     "max_rel_err": float(rel.max()),
                     "max_abs_err": float(np.abs(got - want).max())}
        else:
            bad = int((got.astype(np.int64) != want).sum())
            assert bad == 0, f"{name}: {bad} vertices differ from the oracle"
            agree = {"exact": True, "reached": int((want != (-1 if name == "BFS_ECP"
                                                             else SSSP_INF)).sum())}
        st = warm.stats
        log({"phase": "main", "program": name, "params": params[name],
             "bind_s": round(bind_s[name], 3), "cold_s": cold_s, "warm_s": warm_s,
             "warm_runs_s": warm_runs_s,
             "edges_traversed": st.edges_traversed,
             "gteps": st.edges_traversed / warm_s / 1e9,
             "kernel_launches": st.total_launches, "full_launches": st.full_launches,
             "compacted_launches": st.compacted_launches,
             "host_iterations": st.host_iterations,
             "frontier_masks": st.frontier_masks, "frontier_mask_s": st.frontier_mask_s,
             "resident_bytes": resident[name], "max_memory_allocated": peak[name],
             "oracle": agree})
    assert launches["shuffle_reduce"] > 0, "shuffle_reduce never launched on the main path"
    assert launches["edge_stream"] > 0, "edge_stream never launched on the main path"
    log({"phase": "main", "launches": launches})

    # -- where a warm run's time goes (outside the counted main path) -------
    for name in results:
        log({"phase": "profile", "program": name,
             **profile_run(lambda n=name: sessions[n].run(**params[n]))})
        log({"phase": "profile", "program": name, "shuffle_reduce_launches":
             shuffle_reduce_launches(sr, lambda n=name: sessions[n].run(**params[n]))})

    # -- 4b. the batched path ---------------------------------------------
    def oracle_of(name: str, p: dict):
        if name == "BFS_ECP":
            return "old_level", bfs_levels(g.n_vertices, src_np, dst_np, p["root"])
        if name == "SSSP":
            return "SP", sssp_dist(g.n_vertices, src_np, dst_np, g.weights.astype(np.int64),
                                   p["root"])
        return "rank", pagerank(g.n_vertices, src_np, dst_np, p["iters"])

    batch_rows, batch_launches = batch_phase(repro_torch, sources, sessions, g, oracle_of, sr,
                                             es, args.seed, smi)
    for row in batch_rows:
        log(row)
    for name, n in batch_launches.items():
        launches[name] += n
    log({"phase": "batch", "launches": batch_launches})

    # -- 4c. accelerator artifacts and tracing -------------------------------
    art_rows, art_launches = artifact_phase(repro_torch, sources, generators, g, results,
                                            bind_s, params, sr, es, args.scale, args.seed, smi)
    for row in art_rows:
        log(row)
    for name, n in art_launches.items():
        launches[name] += n

    # -- 4d. streaming updates ------------------------------------------------
    g_stream = generators.rmat(STREAM_SMALL_SCALE, EDGE_FACTOR, seed=args.seed, weighted=True)
    stream_launches = streaming_phase(repro_torch, sources, g, g_stream, sr, es, args.seed, smi)
    del g_stream
    for name, n in stream_launches.items():
        launches[name] += n

    # -- 4e. graph serving and autotune ---------------------------------------
    serve_launches = serving_phase(repro_torch, sources, generators, g, sessions, results,
                                   oracle_of, sr, es, args.seed, args.scale, smi, here)
    for name, n in serve_launches.items():
        launches[name] += n

    # -- 4f. the distributed engine --------------------------------------------
    dist_launches = distributed_phase(repro_torch, sources, generators, g, sessions, results,
                                      params, batch_rows, sr, es, args.seed, smi, here)
    for name, n in dist_launches.items():
        launches[name] += n
    del sessions, results
    gc.collect()
    torch.cuda.empty_cache()


def summary(rows: dict, launches: dict, family_rows: dict, f32_tile: int, f32_decode: int,
            train_rows: dict) -> list:
    """The kernels line: each kernel of the run's phases with its row (the
    one its phase timed) and its launches on the main path."""
    meta = {
        "shuffle_reduce": ("src/repro_torch/csrc/shuffle_reduce.cu",
                           "src/repro/kernels/shuffle_reduce.py:146"),
        "edge_stream": ("src/repro_torch/csrc/edge_stream.cu",
                        "src/repro/kernels/edge_stream.py:143"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:103"),
        "flash_attention_sm90": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                                 "src/repro/kernels/flash_attention.py:103"),
        "flash_decode": ("src/repro_torch/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:103"),
        "moe_gather": ("src/repro_torch/csrc/moe_gather.cu",
                       "src/repro/kernels/moe_dispatch.py:72"),
        # the backward kernels: no Pallas counterpart (the reference trains
        # through XLA's autodiff); each differentiates the kernel named
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                                "src/repro/kernels/flash_attention.py:103"),
        "flash_attention_bwd_f32": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                    "src/repro/kernels/flash_attention.py:103"),
        "moe_gather_bwd": ("src/repro_torch/csrc/moe_gather.cu",
                           "src/repro/kernels/moe_dispatch.py:72"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        key = "flash_attention_decode_qwen3" if name == "flash_decode" else name
        if key not in rows or name not in launches:  # a phase --phases left out
            continue
        row = rows[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "ok": True,
        })
        if "row_rel_check" in row:
            kernels[-1]["row_rel_err"] = row["row_rel_check"]["row_rel_err"]
        if name in ("flash_attention_bwd", "flash_attention_bwd_f32", "moe_gather_bwd"):
            kernels[-1]["replaces_note"] = (
                "the backward of the kernel named: it has no Pallas counterpart, the reference "
                "differentiates through XLA")
        if name.startswith("flash_attention_bwd"):  # phase 4i's backward rows of its dtype
            kernels[-1]["row_rel_err" if name == "flash_attention_bwd" else "grad_err"] = \
                row["grad_err"]
            kernels[-1]["shapes"] = {
                key: {k: r[k] for k in ("dtype", "kernel_ms", "plain_ms", "library_ms",
                                        "library_backend", "bound_ms", "bound_by",
                                        "max_abs_err", "grad_rule", "grad_err", "shape")}
                for key, r in train_rows.items()
                if key.startswith("flash_attention_bwd_") and r["dtype"] == row["dtype"]}
        prefix = {"flash_attention_sm90": "flash_attention_sm90_",
                  "flash_attention": "flash_attention_tile_",
                  "flash_decode": "flash_attention_decode_"}.get(name)
        if prefix:  # the new families' widths (phases 4g and 4h)
            kernels[-1]["shapes"] = {
                key: {"max_abs_err": r["max_abs_err"], "ms": r.get("kernel_device_ms",
                                                                   r["kernel_ms"]),
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r.get("library_device_ms", r["library_ms"]),
                      "timing": ("device" if r.get("device_timing") == "profiler"
                                 else "events"),
                      "q": r["shape"]["q"], "k": r["shape"]["k"], "v": r["shape"]["v"]}
                for key, r in family_rows.items() if key.startswith(prefix)}
        if name == "flash_attention":  # the float32 calls: decode route + tile route
            kernels[-1].update({"decode_launches": f32_decode,
                                "tile_launches": f32_tile, "device_ms": row["kernel_device_ms"],
                                "library_device_ms": row["library_device_ms"],
                                "tile": row["tile"]})
        if name == "flash_decode":  # at decode size the host paces the loop: device times
            kernels[-1].update({"ms": row["kernel_device_ms"],
                                "library_ms": row["library_device_ms"],
                                "host_paced_ms": row["kernel_ms"],
                                "timing": ("device" if row.get("device_timing") == "profiler"
                                           else "events"),
                                "splits": row["decode"]["splits"]})
    return kernels


if __name__ == "__main__":
    sys.exit(main())
