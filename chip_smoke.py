#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``rag_llm_k8s_tpu_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA card

1. Set-up: prints the card (``nvidia-smi`` name and power limit), builds the
   hand-written kernels from ``rag_llm_k8s_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, started together); a failed build is fatal.
2. Kernel phases: each kernel against its plain PyTorch version on the card,
   at the shapes its path gives it (the paged kernels at B = 8 over an arena
   with NaN in every block no row owns; the four int8-cache kernels with NaN
   in every scale outside a window; the dense decode and chunk kernels,
   bf16 and int8, also at B = 2 with ragged windows, edges mid-tile and
   mid-split, an empty one but for the int8 chunk; the four q8 kernels and
   the bf16 paged decode also against their plain split-then-merge versions
   at the kernel's own plan; the kNN at Q = 1, 8 and 9 against its plain
   version and its plain two-pass version at the kernel's plan, with ties
   planted across part boundaries and planted faults in the two-pass
   version that the check must reject; ``phase_continuous_kernels``: kernels
   3 and 5 at B = 8 with per-row windows, 9 and 10 at the verify's S = 8
   with an inactive row),
   with its time, the plain version's time, one PyTorch library call
   computing the same function (``library_ms``, a yardstick the port never
   calls; none reads a paged arena or an int8 cache), all as device time per
   call (``time_ms``: calls queued behind a spin kernel, so a wrapper's host
   time is not counted; the dense decode and chunk phases and the q8 decode
   phases also print the host's time to launch one call), the least time
   the card could take (``bound_ms``, from this run's inputs) and, for an
   int8 kernel, its bf16 counterpart's time at the same shape.
3. Staged boot (``phase_staged_boot``): a directory staged in a temporary
   folder (Llama-3.1-8B ``config.json`` at full width with 2 layers, 4 bf16
   shards of seeded random values; bge-m3 at full size; the fixture
   ``tokenizer.json`` files; two PDFs), booted with
   ``server.main.build_service()`` from ``AppConfig.from_env`` in bf16 and in
   int8 (every tensor against the staged one bit for bit, the int8 ones
   against ``models.loader.quantize_np``), a second time from the
   converted-parameter cache and the persisted index, and as ``python -m
   rag_llm_k8s_tpu_torch.server.main`` over HTTP, drained by SIGTERM with a
   request in flight (answered 200, exit code 0). After the continuous
   phases, the durable lifecycle on the same directory
   (``phase_warm_restart``): ``server.main`` with the
   flight WAL on and the continuous paged engine, SIGKILLed with 3 requests
   mid-decode; a restart resumes them (each journals its WAL-proven tokens
   first and completes in the new epoch); with the prefix cache on, a
   SIGTERM drain writes the warmth manifest and the next boot rehydrates
   it; in this process each resumed continuation is held to an
   uninterrupted greedy run, and the windows are timed with a WAL and
   without.
4. Model phase: a Llama-3.1-8B prefill (full width and depth, seeded random
   bf16 weights) through the kernels against the same forward through the
   plain attention.
5. Service phase: the port's RagService over the 8B decoder and a full
   bge-m3 encoder, built as ``server/main.py`` builds it (the fixture BPE
   and Unigram tokenizers, the C++ merge loop, a ``BatchScheduler`` and the
   retrieve coalescer); PDFs through ``/upload_pdf``, then synthetic chunks
   up to 65,536 vectors (the fused-path cap), then ``/generate`` and
   ``/query`` requests with default sampling and with greedy, one long
   question (host path) and one >4096-token prompt (chunked prefill). The
   launch counters are zeroed just before and read just after; every kernel
   must have run. Then the latency leg (``phase_query_latency``): 24 fused
   solo ``/query`` one at a time, p50 and p95 of ``total_ms`` and its parts,
   and a burst of 8 that must run a kNN pass of 8 queries and a batched
   ``engine.generate``.
   Then the observability surface (``phase_observability``): span trees
   with a W3C ``traceparent`` against the timings, ``/metrics`` under the
   exposition grammar with counts moved by exactly the requests answered,
   the ``/debug`` gate, and ``POST /profile``: a ``torch.profiler`` trace of
   one served request whose kernel events must match the launch counters
   one for one (busy share, one decode forward, top ops and idle gaps
   printed), and a capture window over two live requests.
   Then the KV prefix cache (``phase_prefix_cache``): (a) kernels 3-6 (bf16
   and int8 cache) at the shapes only the prefixed path gives them (segment
   buckets at offsets off every tile, the suffix buckets at a ~2,900-token
   prefix, decode over that cache) against their plain versions, timed with
   SDPA beside the bf16 ones; (b) a service with ``TPU_RAG_PREFIX_CACHE=1``
   (``reuse="exact"``, the head pinned at warmup): one query as a miss and a
   hit (the same tokens), the cached-prefix logits against a cold prefill's
   (a planted fault must fall outside), the launch counters zeroed before
   and read after (the dense decode and chunk kernels and no paged one;
   under int8 KV the q8 pair and no bf16 cache kernel), and 12 prefixed
   requests' ``total_ms`` beside the fused path's; (c) chunk reuse over a
   shuffled chunk order (re-rotated chunks' layer-0 K against the cold
   prefill's, the un-rotated fault rejected; ``rope_rerotate`` on the card
   equal to the CPU); (d) tiering: warm demotion frees device memory, a cold
   spill's swap-in restores the same bytes, a planted ``kv_swap_in`` fault
   recomputes and leaks no host buffer.
6. Continuous phases: 8 concurrent ``/generate`` requests from threads
   through a ``ContinuousScheduler`` (paged arena, interleaved admission)
   over the same model and store, counters zeroed before and read after
   (kNN, flash, paged decode and paged chunk must all have run, the pool
   must drain to 0 blocks, and the service's scrape must count one time to
   first token per request and one ``device_fetch`` step per window); the last greedy request alone must give
   its text from the batch (then, as a yardstick, through the plain paged
   attention); then the resilience layer on the same model
   (``phase_resilience``: a ``decode_step`` fault mid-burst resubmits every
   request in flight with the tokens it had emitted, an ``insert`` fault,
   retries used up, the breaker opened by real resets and healed, deadlines,
   the admission gate's 429s, the drain, a ``generate`` fault on the one-shot
   service; the incident bundles its breaker flip, reset storm and 504s
   spool); then a phase-separated continuous engine run. Between the two,
   the goodput ledger (``phase_goodput``): the latency leg's solo
   ``/query`` (under two tenants) and bursts through interleaved and
   (greedy, held until all are queued) phase-separated admission,
   each window kind's MFU and bandwidth use at the H100's peaks, the
   requests' chip time against the scheduler's busy time, the ledger's own
   cost per window, ``/slo``, and the device gauges against the allocator. Then the rest
   of the continuous engine: the dense continuous cache
   (``phase_continuous_dense``: a service with ``TPU_RAG_KV_PAGED=0``, its
   bytes and launches, and a dense engine teacher-forced along a paged
   engine's greedy run, each draw's logits within the noise limit, a
   differing pick only at a near-tie), the paged verify
   (``phase_spec_paged``: bursts with the verify off, on with prompt
   lookup, on with each row drafting its own spec-off stream, and that at
   ``decode_sync_steps = 4``; the same teacher-forced check with the plain
   stream as the drafts) and engine tasks (``phase_engine_tasks``: a
   retier task and a raising task on the scheduler thread mid-burst).
   Then the disaggregated tier (``phase_disagg``): a prefill-role and a
   decode-role paged engine behind a ``Router`` over 8 RAG prompts, greedy
   and seeded, beside a unified engine (WAL off and on): every request
   migrates, each migration's blocks equal on both sides (bytes, card ms of
   the gather and the scatter, host ms, bound printed), no block left;
   engine level, each draw of both engines held to a plain run (flash only
   on the prefill side, the paged decode only on the decode side, NaN in
   every decode-side block before the imports); a verify-enabled decode
   tier drafting recorded streams; int8 KV (payload and scale planes); a
   planted ``migrate`` fault.
   Then the shadow quality auditor (``phase_quality``): kernels 4 and 6 at
   the scorer's S = 256 chunks over a 3,072-slot cache; ``score_exact``
   over a delivered greedy stream through the chunk kernel against its
   plain version (argmax chains equal but at near-ties, ``max_logit``
   within the noise limit, exactly 32 x n chunk-kernel launches); forced
   audits of the one-shot, prefix-hit, warm-tier, chunk-reuse and
   paged-verify streams earlier phases delivered (byte-identity streams
   clean or within the noise bound, lossy ones within 0.15); a planted
   fault twice (diverged at its position, one ``quality_divergence``
   bundle, ``/debug/quality`` equal to the journal's report, the quality
   SLO fed); a sampled stream counted as a ``sampled`` skip; decode windows
   at B = 8 with an audit in flight against none. Then the journal replay
   (``phase_replay``): ``phase_goodput``'s phase-separated burst re-driven
   from its journal through a fresh engine by the ``LockstepDriver`` (the
   same decisions and tokens), and simulated with a step model calibrated
   on that journal (steps/s against the measured, >= 100x real time, the
   H100 roofline model, ``pool_plan``).
7. Yardstick: one greedy request through the decode kernel and again
   through the plain decode attention.
8. int8 slice: ``quantize_llama`` of the same model (prefill logits against
   the bf16 weights, one decode and one verify forward each way), then an int8 one-shot
   service (``weight_quant="int8", kv_quant="int8"``) over the same store
   (phase 4's requests plus a forced speculative one; the q8 cache kernels
   must run and the bf16 ones must not), the int8 continuous burst at
   ``kv_block_size=32`` (phase 5, without the plain yardstick) and an int8
   phase-separated engine run, then the dense continuous and verify phases
   at 48 new tokens; after the int8 service, one forced audit of its greedy
   stream (``phase_quality_q8``: the scorer on ``chunk_prefill_attention_q8``).

``--phases a,b`` runs the named phases (and those they read) in the bare
command's order. Prints one line per phase and its seconds, the card line
and a ``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
when there is no CUDA card, a kernel fails to build or launch, or anything
disagrees.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense tensor-core bf16
FP32_FLOPS = 67e12  # CUDA-core fp32
# SM clock cycles per millisecond for the spin kernel of time_ms: at least
# the H100's 1.98 GHz boost clock, so the spin lasts at least as long as asked
SPIN_CYCLES_PER_MS = 2.0e6
# Attention (bf16 outputs, fp32 accumulation on both sides, randn inputs) is
# held to the scale of what it is compared with, since a decode output over
# ~4,000 keys is only ~0.02 in size: the error's RMS over the plain output's
# RMS within 2**-7, and its largest element within 2**-6 of the plain output's
# largest magnitude. Both sides round the softmax weights to bf16 before the
# PV product at different running maxima, which alone leaves a relative RMS
# error of ~3e-3 (a CPU emulation of the kernel's tiling), so 2**-7 is ~2.7x
# that noise. Each phase also plants faults in the plain version's arguments
# (a window edge or causal offset off by one key, another layer) and fails
# unless the check rejects every one of them.
ATTN_RMS_TOL = 2.0**-7
ATTN_MAX_TOL = 2.0**-6
KNN_RTOL = 1e-5  # fp32 distances (no TF32 on either side)
ONE_SHOT_KERNELS = ("knn_topk", "flash_attention", "decode_attention", "chunk_prefill_attention")
CONTINUOUS_KERNELS = ("knn_topk", "flash_attention", "paged_decode_attention", "paged_chunk_attention")
BF16_CACHE_KERNELS = ("decode_attention", "chunk_prefill_attention", "paged_decode_attention",
                      "paged_chunk_attention")
# int8 weights and int8 KV: the cache kernels are the q8 ones, and the bf16
# cache kernels must not launch at all (prefill still attends over the fresh
# K/V through flash_attention and only writes int8)
INT8 = dict(weight_quant="int8", kv_quant="int8")
ONE_SHOT_Q8 = ("knn_topk", "flash_attention", "decode_attention_q8", "chunk_prefill_attention_q8")
CONTINUOUS_Q8 = ("knn_topk", "flash_attention", "paged_decode_attention_q8", "paged_chunk_attention_q8")
# int8 weights against bf16 weights, prefill logits of the random 8B model:
# at depth 2 the JAX package's own bounds for quantized logits
# (tests/test_quant.py: relative RMS error < 0.08, cosine > 0.995, there on
# a 2-layer model). Random weights amplify any perturbation layer after
# layer (bf16 rounding alone reaches ~6 % at full depth, PERF.md), so at
# full depth the gate only asks that the int8 logits stay nearer the bf16
# ones than the bf16 logits' own size (relative RMS error < 1).
Q8_DEPTH2_RMS, Q8_DEPTH2_COS, Q8_FULL_RMS = 0.08, 0.995, 1.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn(i)`` (``i`` the iteration
    index): ``iters`` calls queued behind a spin kernel that outlasts the
    host's time to launch them, so the card runs them back to back and the
    wrapper's host time is not counted; the mean between two events. (One
    call between two events on an idle card would time the host's launch
    of it for any kernel faster than its Python wrapper.)"""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * (1.5 * iters * one_ms + 2.0)))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def launch_us(fn, iters: int = 64) -> float:
    """Host microseconds to launch one call of ``fn(i)`` (mean; the card is
    not waited for)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def device_us(fn, iters: int = 20) -> str:
    """Device microseconds per call of each kernel ``fn(i)`` launches
    (``torch.profiler``), as ``name=us`` pairs, the slowest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    times = []
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        total = e.cuda_time_total if total is None else total
        if total > 0:  # a kernel's name without its template arguments
            name = e.key.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0].split("::")[-1].split()
            times.append((total / iters, name[-1] if name else e.key))
    return " ".join(f"{name}={us:.2f}" for us, name in sorted(times, reverse=True))


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, mask):
    """One PyTorch call computing the same attention (yardstick only):
    ``q [B, S, H, hd]``-style inputs as ``[B, heads, S, hd]`` views."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def _knn_ok(got, want):
    """Whether the kernel's ``(dists, ids)`` agree with a plain version's
    ``want`` (computed for k + 1): distances within ``KNN_RTOL``, and ids
    equal at every place of the top k that no near-tie makes ambiguous (two
    distinct distances of the top k + 1 within ``KNN_RTOL``). An exact tie
    is not ambiguous: both sides give the lowest id first (the planted ties
    are exact small-integer arithmetic on both). Returns (ok, max abs error
    of the distances)."""
    import torch

    (kv, ki), (pv, pi) = got, want
    k = kv.shape[1]
    err = ((kv - pv[:, :k]).abs() / pv[:, :k].abs().clamp_min(1.0)).max().item()
    gap = (pv[:, 1:] - pv[:, :-1]) / pv[:, 1:].abs().clamp_min(1.0)
    near = (gap > 0) & (gap <= KNN_RTOL)  # [Q, k]: places j and j + 1
    ambiguous = near.clone()
    ambiguous[:, 1:] |= near[:, :-1]
    ids_ok = bool(((ki == pi[:, :k]) | ambiguous[:, :k]).all())
    return err <= KNN_RTOL and ids_ok, (kv - pv[:, :k]).abs().max().item()


def phase_knn(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import knn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    # the fused retrieve's store: 65,536 x 1024 fp32, 36 padded rows, so the
    # last part holds real rows and padded ones
    N_pad, D, n_valid = 65536, 1024, 65500
    emb = torch.randn(N_pad, D, device=dev, generator=g)
    emb = emb / emb.norm(dim=1, keepdim=True)
    emb[n_valid:] = 0
    # planted ties: three small-integer vectors (every dot product exact),
    # each on the two rows that straddle a part boundary and once more in
    # the last part; their queries must get those rows, lowest id first
    rpp = knn.knn_launch_plan(1, N_pad, _sms())["rows_per_part"]
    last = (N_pad - 1) // rpp * rpp
    planted = torch.randint(-1, 2, (3, D), device=dev, generator=g).float()
    tie_rows = [[p * rpp - 1, p * rpp, last + 7 * j + 3] for j, p in enumerate((50, 100, 150))]
    for j, r in enumerate(tie_rows):
        emb[r] = planted[j]
    norms = torch.full((1, N_pad), knn.BIG, device=dev)
    norms[0, :n_valid] = (emb[:n_valid] ** 2).sum(1)

    def unit(Q):
        q = torch.randn(Q, D, device=dev, generator=g)
        return q / q.norm(dim=1, keepdim=True)

    # (Q, k, queries, the planted ones' places among them): the main path's
    # Q = 1, a full chunk of 8 queries and two chunks (8 + 1), timed; and a
    # chunk of 3 (the 8-query kernel with 5 queries masked), its last query
    # planted, k = 3 (so the planted row in the last part counts)
    cases = [(1, 5, unit(1), []), (8, 5, torch.cat([planted, unit(5)]), [0, 1, 2]),
             (9, 8, torch.cat([unit(6), planted]), [6, 7, 8]), (3, 3, torch.cat([unit(2), planted[2:]]), [2])]
    worst = 0.0
    for Q, k, q, tie_q in cases:
        plan = knn.knn_launch_plan(Q, N_pad, _sms())
        got = knn.knn_topk(q, emb, norms, k=k)
        torch.cuda.synchronize()
        plain = knn.knn_topk_xla(q, emb, norms, k=k + 1)
        parts = knn.knn_part_lists(q, emb, norms, k + 1, plan)
        for name, want in (("the plain version", plain),
                           ("the split plain version at the kernel's plan", knn.knn_merge_lists(*parts, k + 1))):
            ok, err = _knn_ok(got, want)
            if not ok:
                fail(f"knn Q={Q} k={k}: disagrees with {name} (distance err {err:.3g}, rel tol {KNN_RTOL})")
            worst = max(worst, err)
        ties = {j: tie_rows[[torch.equal(q[j], u) for u in planted].index(True)][:k] for j in tie_q}
        for j, r in ties.items():
            if got[1][j, :len(r)].tolist() != r or got[0][j, :len(r)].abs().max().item():
                fail(f"knn Q={Q} k={k}: planted ties {r} came out {got[1][j, :len(r)].tolist()}")
        if tie_q:
            # planted faults in the split plain version: the check must reject
            # each (the part holding a planted query's second tied row)
            p = ties[tie_q[0]][1] // rpp
            shifted = parts[1].clone()
            shifted[:, p] = torch.where(shifted[:, p] >= 0, shifted[:, p] + 1, shifted[:, p])
            for fault, want in ((f"ids of part {p} shifted by one", knn.knn_merge_lists(parts[0], shifted, k + 1)),
                                ("the last part dropped",
                                 knn.knn_merge_lists(parts[0][:, :-1], parts[1][:, :-1], k + 1))):
                if _knn_ok(got, want)[0]:
                    fail(f"knn Q={Q} k={k}: the check accepts a planted fault ({fault})")
        del parts
        if Q not in (1, 8, 9):
            print(f"phase knn Q={Q} k={k} {_plan_line(plan)}: agrees (5 of the chunk's 8 queries masked), "
                  f"planted tie held, planted faults rejected", flush=True)
            continue
        ms = time_ms(lambda i: knn.knn_topk(q, emb, norms, k=k))
        host_us = launch_us(lambda i: knn.knn_topk(q, emb, norms, k=k))
        split_us = device_us(lambda i: knn.knn_topk(q, emb, norms, k=k))
        plain_ms = time_ms(lambda i: knn.knn_topk_xla(q, emb, norms, k=k), iters=5)
        valid = emb[:n_valid]
        lib_ms = time_ms(lambda i: torch.topk(torch.cdist(q, valid), k, largest=False), iters=5)
        nbytes = (Q * D + N_pad * D + N_pad) * 4 + Q * k * 8
        b_ms, b_by = bound(nbytes, 2.0 * Q * N_pad * D, FP32_FLOPS)
        earlier = {1: " earlier_design_ms=0.1992 (the previous design, PERF.md §6)",
                   8: " earlier_design_ms=0.4917 (the previous design, PERF.md §6)"}.get(Q, "")
        print(f"phase knn Q={Q} N_pad={N_pad} n_valid={n_valid} D={D} k={k} {_plan_line(plan)}: "
              f"max_abs_err={worst:.3g} (rel tol {KNN_RTOL}; against the plain and split plain versions, "
              f"planted ties {'held' if tie_q else 'none'}, planted faults {'rejected' if tie_q else 'none'}) "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"host_us={host_us:.1f} device_us: {split_us}{earlier}", flush=True)
        row = dict(shape=f"Q={Q} N_pad={N_pad} D={D} k={k}", ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, host_us=host_us)
        if Q == 1:
            rows["knn_topk"] = row
        else:
            rows["knn_topk"][f"queries_{Q}"] = row
    rows["knn_topk"]["max_abs_err"] = worst
    del emb
    torch.cuda.empty_cache()
    _knn_any_width(g)


def _knn_any_width(g):
    """The kernel at a width other than bge-m3's (D known at run time):
    768 and 20, one query and a masked chunk of 3, against the plain and
    split plain versions, a planted tie across a part boundary."""
    import torch

    from rag_llm_k8s_tpu_torch.ops import knn

    dev = torch.device("cuda")
    N_pad, n_valid = 8192, 8100
    for D in (768, 20):
        emb = torch.randn(N_pad, D, device=dev, generator=g)
        emb = emb / emb.norm(dim=1, keepdim=True)
        emb[n_valid:] = 0
        rpp = knn.knn_launch_plan(1, N_pad, _sms())["rows_per_part"]
        planted = torch.randint(-1, 2, (D,), device=dev, generator=g).float()
        tie = [3 * rpp - 1, 3 * rpp]
        emb[tie] = planted
        norms = torch.full((1, N_pad), knn.BIG, device=dev)
        norms[0, :n_valid] = (emb[:n_valid] ** 2).sum(1)
        for Q, k in ((1, 5), (3, 8)):
            worst = 0.0
            q = torch.randn(Q, D, device=dev, generator=g)
            q = torch.cat([q[:-1] / q[:-1].norm(dim=1, keepdim=True), planted[None]])
            got = knn.knn_topk(q, emb, norms, k=k)
            torch.cuda.synchronize()
            plan = knn.knn_launch_plan(Q, N_pad, _sms())
            for name, want in (("the plain version", knn.knn_topk_xla(q, emb, norms, k=k + 1)),
                               ("the split plain version at the kernel's plan",
                                knn.knn_topk_split_xla(q, emb, norms, k + 1, plan))):
                ok, err = _knn_ok(got, want)
                if not ok:
                    fail(f"knn D={D} Q={Q} k={k}: disagrees with {name} (distance err {err:.3g}, "
                         f"rel tol {KNN_RTOL})")
                worst = max(worst, err)
            if got[1][-1, :2].tolist() != tie or got[0][-1, :2].abs().max().item():
                fail(f"knn D={D} Q={Q} k={k}: planted ties {tie} came out {got[1][-1, :2].tolist()}")
            ms = time_ms(lambda i: knn.knn_topk(q, emb, norms, k=k))
            print(f"phase knn D={D} Q={Q} k={k} N_pad={N_pad} {_plan_line(plan)}: agrees with the plain and "
                  f"split plain versions (rel tol {KNN_RTOL}), planted tie held, max_abs_err={worst:.3g} "
                  f"ms={ms:.4f}", flush=True)


def _attn_err(got, want):
    """(max abs error, its limit, relative RMS error) of ``got`` against ``want``."""
    d = got.float() - want.float()
    w = want.float()
    return d.abs().max().item(), ATTN_MAX_TOL * w.abs().max().item(), (d.norm() / w.norm()).item()


def _attn_check(name, got, want):
    """Fails unless ``got`` agrees with the plain output ``want``; returns
    (max abs error, relative RMS error)."""
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err, lim, rms = _attn_err(got, want)
    if err > lim or rms > ATTN_RMS_TOL:
        fail(f"{name}: max abs err {err:.3g} (limit {lim:.3g}), rel rms {rms:.3g} (tol {ATTN_RMS_TOL:.3g})")
    return err, rms


def _attn_faults(name, got, faulty):
    """Each plain output in ``faulty`` comes from a wrong argument (a window
    edge or causal offset off by one key, or another layer); the check must
    reject ``got`` against every one. Returns the smallest relative RMS
    error among them."""
    least = math.inf
    for fault, want in faulty.items():
        err, lim, rms = _attn_err(got, want)
        if err <= lim and rms <= ATTN_RMS_TOL:
            fail(f"{name}: the check accepts a planted fault ({fault}: rel rms {rms:.3g})")
        least = min(least, rms)
    return least


def _rows_fail(got, want):
    """Per-row ``_attn_err`` over the rows ``want`` is not all zero:
    (max abs error, relative RMS error, whether any row breaks the
    tolerance). Each row is held to its own scale, so a fault in a long,
    small-valued row is not hidden by the short rows' larger outputs."""
    worst_err = worst_rms = 0.0
    broken = False
    for b in range(want.shape[0]):
        if not want[b].abs().max().item():
            continue
        err, lim, rms = _attn_err(got[b], want[b])
        worst_err, worst_rms = max(worst_err, err), max(worst_rms, rms)
        broken = broken or err > lim or rms > ATTN_RMS_TOL
    return worst_err, worst_rms, broken


def _paged_check(name, got, want):
    """``_attn_check`` row by row; a row whose plain output is all zero
    (``kv_len = 0``) must come out all zero."""
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    for b in range(want.shape[0]):
        if not want[b].abs().max().item() and got[b].abs().max().item():
            fail(f"{name}: row {b} has no visible key and must write zeros")
    err, rms, broken = _rows_fail(got, want)
    if broken:
        fail(f"{name}: a row breaks the tolerance (max abs err {err:.3g}, rel rms {rms:.3g})")
    return err, rms


def _paged_faults(name, got, faulty):
    """``_attn_faults`` row by row: each planted fault must break the
    tolerance in at least one row. Returns the least, over the faults, of
    the largest per-row relative RMS error."""
    least = math.inf
    for fault, want in faulty.items():
        _, rms, broken = _rows_fail(got, want)
        if not broken:
            fail(f"{name}: the check accepts a planted fault ({fault}: largest row rel rms {rms:.3g})")
        least = min(least, rms)
    return least


def _attn_line(err, rms, fault_rms):
    return (f"max_abs_err={err:.3g} rel_rms={rms:.3g} (tol {ATTN_RMS_TOL:.3g}, max <= "
            f"{ATTN_MAX_TOL:.3g} x max|plain|) planted faults rejected (least rel_rms {fault_rms:.3g})")


def phase_flash(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    worst, worst_rms = 0.0, 0.0
    # Llama prefill: B=1, S=4096, H=32, K=8, hd=128, causal, 100 left-pad slots;
    # bge-m3: H=K=16, hd=64, bidirectional, right-padded rows (kv_len). The
    # planted fault moves each window edge by one key (the bge-m3 row of
    # length 1 keeps its key, so the fault does not rest on an empty row).
    # Both kernel designs (chunk_design_plan: "chunk", "ws") are checked and
    # timed at each shape; the plan's own design is the kernel's row.
    cases = [
        ("llama", 1, 4096, 32, 8, 128, True, [100], [4096]),
        ("bge-m3", 8, 512, 16, 16, 64, False, [0] * 8, [512, 300, 77, 1, 512, 400, 256, 9]),
    ]
    for tag, B, S, H, K, hd, causal, ks_l, kl_l in cases:
        q = torch.randn(B, S, H, hd, device=dev, generator=g).to(bf)
        k = torch.randn(B, S, K, hd, device=dev, generator=g).to(bf)
        v = torch.randn(B, S, K, hd, device=dev, generator=g).to(bf)
        ks = torch.tensor(ks_l, device=dev, dtype=torch.int32)
        kl = torch.tensor(kl_l, device=dev, dtype=torch.int32)
        plan = A.chunk_design_plan(B, S, H, K, S, hd, _sms())
        want = A.attention_xla(q, k, v, ks, kl, causal)
        got = {d: A.flash_attention(q, k, v, ks, kl, causal=causal, design=d) for d in A.CHUNK_DESIGNS}
        torch.cuda.synchronize()
        for d, out in got.items():
            err, rms = _attn_check(f"flash {tag} ({d})", out, want)
            worst, worst_rms = max(worst, err), max(worst_rms, rms)
            if causal and not (out[:, : ks_l[0]] == 0).all():
                fail(f"flash ({d}): fully masked rows must be zero")
        del want
        if causal:
            faulty = {"kv_start+1": A.attention_xla(q, k, v, ks + 1, kl, causal)}
        else:
            faulty = {"kv_len-1": A.attention_xla(q, k, v, ks, (kl - 1).clamp_min(1), causal)}
        fault_rms = min(_attn_faults(f"flash {tag} ({d})", out, faulty) for d, out in got.items())
        del faulty, got
        design_ms = {d: time_ms(lambda i: A.flash_attention(q, k, v, ks, kl, causal=causal, design=d))
                     for d in A.CHUNK_DESIGNS}
        ms = design_ms[plan["design"]]
        host_us = launch_us(lambda i: A.flash_attention(q, k, v, ks, kl, causal=causal), iters=16)
        plain_ms = time_ms(lambda i: A.attention_xla(q, k, v, ks, kl, causal), iters=3, warmup=1)
        pos = torch.arange(S, device=dev)
        mask = (pos[None, None, :] >= ks[:, None, None]) & (pos[None, None, :] < kl[:, None, None])
        if causal:
            mask = mask & (pos[None, None, :] <= pos[None, :, None])
        qt, kt, vt, m4 = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
        lib_ms = time_ms(lambda i: sdpa(qt, kt, vt, m4), iters=5)
        # (query, key) pairs computed on; every query row of a bidirectional
        # case sees its whole window
        pairs = mask.expand(B, S, S).sum().item()
        nbytes = (q.numel() * 2 + k.numel() + v.numel()) * 2
        b_ms, b_by = bound(nbytes, 4.0 * H * hd * pairs, BF16_FLOPS)
        print(f"phase flash {tag} B={B} S={S} H={H} K={K} hd={hd} causal={causal} {_plan_line(plan)}: "
              f"{_attn_line(err, rms, fault_rms)} ms={ms:.4f} "
              f"({' '.join(f'{d}_ms={t:.4f}' for d, t in design_ms.items())}) plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) host_us={host_us:.1f}", flush=True)
        row = dict(shape=f"B={B} S={S} H={H} K={K} hd={hd} causal={causal}", design=plan["design"],
                   ms=ms, design_ms=design_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, host_us=host_us)
        if tag == "llama":
            rows["flash_attention"] = row
        else:
            rows["flash_attention"]["bge_m3"] = row
        del q, k, v
        torch.cuda.empty_cache()

    # B = 2, ragged, causal, at the Llama width: row 0's window starts
    # mid-tile (left pad 37), row 1's starts at 300 and ends mid-tile at 777
    # (its queries past 777 see [300, 777)); NaN in K/V outside each window
    # for the kernels, zeros for the plain version. The value rows at the two
    # edges the planted faults move are scaled by 8, so one key more or less
    # moves its row's output far past the bf16 noise.
    B2, S2, H, K, hd = 2, 1024, 32, 8, 128
    ks_l, kl_l = [37, 300], [S2, 777]
    q = torch.randn(B2, S2, H, hd, device=dev, generator=g).to(bf)
    kz = torch.randn(B2, S2, K, hd, device=dev, generator=g).to(bf)
    vz = torch.randn(B2, S2, K, hd, device=dev, generator=g).to(bf)
    vz[0, ks_l[0]] *= 8
    vz[1, kl_l[1] - 1] *= 8
    kn, vn = kz.clone(), vz.clone()
    for b, (a, e) in enumerate(zip(ks_l, kl_l)):
        for nan_t, zero_t in ((kn, kz), (vn, vz)):
            nan_t[b, :a] = float("nan")
            nan_t[b, e:] = float("nan")
            zero_t[b, :a] = 0
            zero_t[b, e:] = 0
    ks, kl = (torch.tensor(x, device=dev, dtype=torch.int32) for x in (ks_l, kl_l))
    plan = A.chunk_design_plan(B2, S2, H, K, S2, hd, _sms())
    want = A.attention_xla(q, kz, vz, ks, kl, True)
    got = {d: A.flash_attention(q, kn, vn, ks, kl, causal=True, design=d) for d in A.CHUNK_DESIGNS}
    torch.cuda.synchronize()
    e2 = r2 = 0.0
    for d, out in got.items():
        err, rms = _paged_check(f"flash ragged ({d}, NaN outside the windows)", out, want)
        e2, r2 = max(e2, err), max(r2, rms)
        for b, a in enumerate(ks_l):
            if not (out[b, :a] == 0).all():
                fail(f"flash ragged ({d}): row {b}'s fully masked queries must be zero")
    first = lambda t, dl, row: t + torch.tensor([dl if b == row else 0 for b in range(B2)],  # noqa: E731
                                                device=dev, dtype=torch.int32)
    faulty = {
        "kv_start+1 (row 0)": A.attention_xla(q, kz, vz, first(ks, 1, 0), kl, True),
        "kv_len-1 (row 1)": A.attention_xla(q, kz, vz, ks, first(kl, -1, 1), True),
    }
    f2 = min(_paged_faults(f"flash ragged ({d})", out, faulty) for d, out in got.items())
    print(f"phase flash ragged B={B2} S={S2} H={H} K={K} hd={hd} causal=True windows={list(zip(ks_l, kl_l))} "
          f"{_plan_line(plan)}: {_attn_line(e2, r2, f2)} (row by row, designs {list(got)})", flush=True)
    rows["flash_attention"].update(max_abs_err=max(worst, e2), rel_rms=max(worst_rms, r2))
    del q, kz, vz, kn, vn, got, faulty
    torch.cuda.empty_cache()


def _sharpen_edges(q, k_caches, layer, write_index, kv_start):
    """Adds 9x the unit mean query direction of each (position, kv head) to
    the keys that query row's mask turns on or off: ``write_index + t`` (the
    last key it sees), ``write_index + t + 1`` (the first it must not) and,
    for row 0, ``kv_start``. Each such key then carries ~1 % of its row's
    softmax weight instead of ~0.07 %, so a mask off by one key moves the
    output by tens of percent (the plain version's rel RMS change is 0.1-2
    at these shapes), while the other ~4,000 random keys still set the
    rounding noise."""
    B, S, H, hd = q.shape
    K = k_caches[0].shape[2]
    u = q.float().reshape(B, S, K, H // K, hd).sum(3)
    u = (9.0 * u / u.norm(dim=-1, keepdim=True)).transpose(1, 2)  # [B, K, S, hd]
    for kc in k_caches:
        lay = kc[layer].float()
        lay[:, :, write_index:write_index + S] += u
        # the first key past the last row's window, where the cache has one
        n = min(S, lay.shape[2] - write_index - 1)
        lay[:, :, write_index + 1:write_index + 1 + n] += u[:, :, :n]
        lay[:, :, kv_start] += u[:, :, 0]
        kc[layer] = lay.to(kc.dtype)


def _cache_pair(L, B, K, T, hd, ks, kl, g):
    """A random bf16 cache pair with NaN outside ``[ks, kl)`` and its
    zero-filled twin. The kernel gets both and must agree with the plain
    version on the twin either way: it never lets an out-of-window slot
    into a product (the plain version would, 0 * NaN = NaN)."""
    return _ragged_cache_pair(L, B, K, T, hd, [ks] * B, [kl] * B, g)


def _ragged_cache_pair(L, B, K, T, hd, ks_l, kl_l, g):
    """``_cache_pair`` with a window per batch row: NaN outside row b's
    ``[ks_l[b], kl_l[b])`` for the kernel, zeros for the plain version."""
    import torch

    kc = torch.randn(L, B, K, T, hd, device="cuda", generator=g).to(torch.bfloat16)
    vc = torch.randn(L, B, K, T, hd, device="cuda", generator=g).to(torch.bfloat16)
    kz, vz = kc.clone(), vc.clone()
    for b, (ks, kl) in enumerate(zip(ks_l, kl_l)):
        for c, z in ((kc, kz), (vc, vz)):
            c[:, b, :, :ks] = float("nan")
            c[:, b, :, kl:] = float("nan")
            z[:, b, :, :ks] = 0
            z[:, b, :, kl:] = 0
    return kc, vc, kz, vz


def _sms():
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def _plan_line(plan):
    return " ".join(f"{k}={v}" for k, v in plan.items())


def phase_decode(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    L, B, K, T, H, hd = 32, 1, 8, 4352, 32, 128
    ks_i, kl_i = 100, 4200
    kc, vc, kz, vz = _cache_pair(L, B, K, T, hd, ks_i, kl_i, g)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(torch.bfloat16)
    ks = torch.tensor([ks_i], device=dev, dtype=torch.int32)
    kl = torch.tensor([kl_i], device=dev, dtype=torch.int32)
    layer = 17
    _sharpen_edges(q, (kc, kz), layer, kl_i - 1, ks_i)  # the query sits at the frontier
    want = A.decode_attention_xla(q, kz, vz, ks, kl, layer)
    got = A.decode_attention(q, kc, vc, ks, kl, layer)
    err, rms = map(max, zip(
        _attn_check("decode", A.decode_attention(q, kz, vz, ks, kl, layer), want),
        _attn_check("decode (NaN outside the window)", got, want),
    ))
    fault_rms = _attn_faults("decode", got, {
        "kv_start+1": A.decode_attention_xla(q, kz, vz, ks + 1, kl, layer),
        "kv_len-1": A.decode_attention_xla(q, kz, vz, ks, kl - 1, layer),
        "layer-1": A.decode_attention_xla(q, kz, vz, ks, kl, layer - 1),
    })
    # each call reads another layer, as a decode step does: its window is
    # not left in the 50 MB L2 by the previous call
    ms = time_ms(lambda i: A.decode_attention(q, kc, vc, ks, kl, i % L), iters=64)
    host_us = launch_us(lambda i: A.decode_attention(q, kc, vc, ks, kl, i % L))
    plain_ms = time_ms(lambda i: A.decode_attention_xla(q, kz, vz, ks, kl, i % L), iters=8)
    pos = torch.arange(T, device=dev)
    mask = ((pos >= ks_i) & (pos < kl_i))[None, None, None, :]
    qt = q.transpose(1, 2)
    lib_ms = time_ms(lambda i: sdpa(qt, kz[i % L], vz[i % L], mask), iters=8)
    live = kl_i - ks_i
    nbytes = 2 * B * K * live * hd * 2 + 2 * q.numel() * 2
    b_ms, b_by = bound(nbytes, 4.0 * B * H * hd * live, BF16_FLOPS)
    print(f"phase decode L={L} B={B} K={K} T={T} H={H} hd={hd} window=[{ks_i},{kl_i}) "
          f"{_plan_line(A.decode_launch_plan(B, K, T, _sms()))}: "
          f"{_attn_line(err, rms, fault_rms)} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) host_us={host_us:.1f}", flush=True)
    rows["decode_attention"] = dict(
        shape=f"L=32 B=1 K=8 T={T} H=32 hd=128 live={live}", ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, rel_rms=rms,
    )
    del kc, vc, kz, vz

    # B = 2, ragged: row 0's window starts and ends mid-tile and mid-split
    # (16-key tiles, 128-key splits at this grid), row 1's is empty and must
    # write zeros; checked row by row
    B2, ks_l, kl_l = 2, [37, 2000], [3333, 2000]
    kc, vc, kz, vz = _ragged_cache_pair(L, B2, K, T, hd, ks_l, kl_l, g)
    q = torch.randn(B2, 1, H, hd, device=dev, generator=g).to(torch.bfloat16)
    ks, kl = (torch.tensor(x, device=dev, dtype=torch.int32) for x in (ks_l, kl_l))
    _sharpen_edges(q, (kc, kz), layer, kl_l[0] - 1, ks_l[0])
    want = A.decode_attention_xla(q, kz, vz, ks, kl, layer)
    got = A.decode_attention(q, kc, vc, ks, kl, layer)
    torch.cuda.synchronize()
    e2, r2 = map(max, zip(
        _paged_check("decode B=2", A.decode_attention(q, kz, vz, ks, kl, layer), want),
        _paged_check("decode B=2 (NaN outside the windows)", got, want),
    ))
    first = lambda t, d: t + torch.tensor([d, 0], device=dev, dtype=torch.int32)  # noqa: E731
    f2 = _paged_faults("decode B=2", got, {
        "kv_start+1 (row 0)": A.decode_attention_xla(q, kz, vz, first(ks, 1), kl, layer),
        "kv_len-1 (row 0)": A.decode_attention_xla(q, kz, vz, ks, first(kl, -1), layer),
    })
    print(f"phase decode B={B2} windows={list(zip(ks_l, kl_l))} {_plan_line(A.decode_launch_plan(B2, K, T, _sms()))}: "
          f"{_attn_line(e2, r2, f2)} (row by row)", flush=True)
    rows["decode_attention"].update(max_abs_err=max(err, e2), rel_rms=max(rms, r2))
    del kc, vc, kz, vz
    torch.cuda.empty_cache()


def phase_chunk(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    L, B, K, H, hd = 32, 1, 8, 32, 128
    worst, worst_rms = 0.0, 0.0
    # the speculative verify (S = k + 1 = 16 near the 4096 bucket's frontier)
    # and a long prompt's second chunk (S = 4096 at write_index 4096)
    for tag, S, wi, T in (("verify", 16, 4100, 4352), ("long-prompt", 4096, 4096, 8448)):
        ks_i, kl_i = 100, wi + S
        Lc = L if S == 16 else 4  # the 4096-wide case needs fewer layers to stay cold
        kc, vc, kz, vz = _cache_pair(Lc, B, K, T, hd, ks_i, kl_i, g)
        q = torch.randn(B, S, H, hd, device=dev, generator=g).to(torch.bfloat16)
        ks = torch.tensor([ks_i], device=dev, dtype=torch.int32)
        kl = torch.tensor([kl_i], device=dev, dtype=torch.int32)
        layer = Lc // 2 + 1
        _sharpen_edges(q, (kc, kz), layer, wi, ks_i)
        want = A.chunk_attention_xla(q, kz, vz, ks, kl, layer, wi)
        plan = A.chunk_design_plan(B, S, H, K, T, hd, _sms())
        # the long prompt's one-split plan takes either design: check and time both
        designs = list(A.CHUNK_DESIGNS) if plan["n_splits"] == 1 else [plan["design"]]
        got = A.chunk_prefill_attention(q, kc, vc, ks, kl, layer, wi)
        err, rms = map(max, zip(
            _attn_check(f"chunk {tag}", A.chunk_prefill_attention(q, kz, vz, ks, kl, layer, wi), want),
            *(_attn_check(f"chunk {tag} ({d}, NaN outside the window)",
                          A.chunk_prefill_attention(q, kc, vc, ks, kl, layer, wi, design=d), want)
              for d in designs),
        ))
        worst, worst_rms = max(worst, err), max(worst_rms, rms)
        del want
        faulty = {
            "write_index+1": A.chunk_attention_xla(q, kz, vz, ks, kl, layer, wi + 1),
            "write_index-1": A.chunk_attention_xla(q, kz, vz, ks, kl, layer, wi - 1),
        }
        if S == 16:
            # window edges: on 1 of 4,096 long-prompt rows they move the
            # whole output too little to plant there
            faulty["kv_start+1"] = A.chunk_attention_xla(q, kz, vz, ks + 1, kl, layer, wi)
            faulty["kv_len-1"] = A.chunk_attention_xla(q, kz, vz, ks, kl - 1, layer, wi)
        fault_rms = _attn_faults(f"chunk {tag}", got, faulty)
        del faulty
        del got
        design_ms = {d: time_ms(lambda i: A.chunk_prefill_attention(q, kc, vc, ks, kl, i % Lc, wi, design=d),
                                iters=64 if S == 16 else 16) for d in designs}
        ms = design_ms[plan["design"]]
        host_us = launch_us(lambda i: A.chunk_prefill_attention(q, kc, vc, ks, kl, i % Lc, wi), iters=16)
        plain_ms = time_ms(lambda i: A.chunk_attention_xla(q, kz, vz, ks, kl, i % Lc, wi),
                           iters=3 if S > 16 else 8, warmup=1)
        pos = torch.arange(T, device=dev)
        qpos = wi + torch.arange(S, device=dev)
        mask = (pos[None, :] >= ks_i) & (pos[None, :] < kl_i) & (pos[None, :] <= qpos[:, None])
        qt, m4 = q.transpose(1, 2), mask[None, None]
        lib_ms = time_ms(lambda i: sdpa(qt, kz[i % Lc], vz[i % Lc], m4), iters=5)
        pairs = mask.sum().item()
        nbytes = 2 * B * K * (kl_i - ks_i) * hd * 2 + 2 * q.numel() * 2
        b_ms, b_by = bound(nbytes, 4.0 * H * hd * pairs, BF16_FLOPS)
        print(f"phase chunk {tag} S={S} write_index={wi} T={T} H={H} K={K} hd={hd} {_plan_line(plan)}: "
              f"{_attn_line(err, rms, fault_rms)} ms={ms:.4f} "
              f"({' '.join(f'{d}_ms={t:.4f}' for d, t in design_ms.items())}) plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) host_us={host_us:.1f}", flush=True)
        if tag == "verify":
            rows["chunk_prefill_attention"] = dict(
                shape=f"S=16 write_index={wi} T={T} H=32 K=8 hd=128", ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            )
        else:
            rows["chunk_prefill_attention"]["long_prompt"] = dict(
                shape=f"S=4096 write_index={wi} T={T} H=32 K=8 hd=128", design=plan["design"], ms=ms,
                design_ms=design_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        del kc, vc, kz, vz, q
        torch.cuda.empty_cache()

    # B = 2, ragged, at the verify's width: row 0's window starts and ends
    # mid-tile and mid-split (64-key tiles, 256-key splits at this grid),
    # row 1's window is empty and every one of its queries must write zeros
    S, wi, T, B2 = 16, 4100, 4352, 2
    ks_l, kl_l = [100, 4116], [wi + S, 4116]
    kc, vc, kz, vz = _ragged_cache_pair(L, B2, K, T, hd, ks_l, kl_l, g)
    q = torch.randn(B2, S, H, hd, device=dev, generator=g).to(torch.bfloat16)
    ks, kl = (torch.tensor(x, device=dev, dtype=torch.int32) for x in (ks_l, kl_l))
    layer = L // 2 + 1
    _sharpen_edges(q, (kc, kz), layer, wi, ks_l[0])
    want = A.chunk_attention_xla(q, kz, vz, ks, kl, layer, wi)
    got = A.chunk_prefill_attention(q, kc, vc, ks, kl, layer, wi)
    torch.cuda.synchronize()
    e2, r2 = map(max, zip(
        _paged_check("chunk B=2", A.chunk_prefill_attention(q, kz, vz, ks, kl, layer, wi), want),
        _paged_check("chunk B=2 (NaN outside the windows)", got, want),
    ))
    first = lambda t, d: t + torch.tensor([d, 0], device=dev, dtype=torch.int32)  # noqa: E731
    f2 = _paged_faults("chunk B=2", got, {
        "write_index+1": A.chunk_attention_xla(q, kz, vz, ks, kl, layer, wi + 1),
        "write_index-1": A.chunk_attention_xla(q, kz, vz, ks, kl, layer, wi - 1),
        "kv_start+1 (row 0)": A.chunk_attention_xla(q, kz, vz, first(ks, 1), kl, layer, wi),
        "kv_len-1 (row 0)": A.chunk_attention_xla(q, kz, vz, ks, first(kl, -1), layer, wi),
    })
    print(f"phase chunk B={B2} S={S} write_index={wi} windows={list(zip(ks_l, kl_l))} "
          f"{_plan_line(A.chunk_design_plan(B2, S, H, K, T, hd, _sms()))}: {_attn_line(e2, r2, f2)} (row by row)",
          flush=True)
    del kc, vc, kz, vz, q
    torch.cuda.empty_cache()
    rows["chunk_prefill_attention"].update(max_abs_err=max(worst, e2), rel_rms=max(worst_rms, r2))


def _paged_arena(L, K, bs, hd, B, MB, kv_len, layer, g):
    """A random bf16 arena pair of B * MB + 1 blocks (block 0 the null
    block), rows' tables filled from a shuffled permutation of the pool up to
    each row's live blocks (null beyond), NaN in every unassigned block and
    every frontier tail, and the zero-filled twin the plain version gets.
    Only ``layer`` and ``layer - 1`` are filled; the other layers stay zero."""
    import torch

    dev = torch.device("cuda")
    N = B * MB + 1
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(11)) + 1
    tables = torch.zeros((B, MB), dtype=torch.int32)
    used, nxt = [], 0
    for b, n in enumerate(kv_len):
        nb = -(-n // bs)
        tables[b, :nb] = perm[nxt:nxt + nb].to(torch.int32)
        used.append(perm[nxt:nxt + nb])
        nxt += nb
    used = torch.cat(used).to(dev)
    arenas, twins = [], []
    for _ in range(2):
        a = torch.zeros((L, N, K, bs, hd), dtype=torch.bfloat16, device=dev)
        for lay in (layer - 1, layer):
            a[lay] = torch.randn((N, K, bs, hd), device=dev, generator=g).to(torch.bfloat16)
        twin = a.clone()
        live = torch.zeros(N, dtype=torch.bool, device=dev)
        live[used] = True
        a[:, ~live] = float("nan")
        twin[:, ~live] = 0
        for b, n in enumerate(kv_len):
            if n % bs:
                blk = int(tables[b, n // bs])
                a[:, blk, :, n % bs:] = float("nan")
                twin[:, blk, :, n % bs:] = 0
        arenas.append(a)
        twins.append(twin)
    return arenas, twins, tables.to(dev)


def _sharpen_paged(q, k_arenas, layer, tables, write_index, kv_len, n_real):
    """``_sharpen_edges`` for the arena: adds 9x the unit mean query
    direction of each (row, real lane, kv head) to the keys its causal mask
    turns on last (``write_index + t``) and off first (``+ 1``), inside the
    row's window, so a mask or table off by one key moves the output far
    past the bf16 noise."""
    import torch

    B, S, H, hd = q.shape
    K, bs = k_arenas[0].shape[2], k_arenas[0].shape[3]
    u = q.float().reshape(B, S, K, H // K, hd).sum(3)
    u = 9.0 * u / u.norm(dim=-1, keepdim=True)  # [B, S, K, hd]
    idx, vals = [], []
    for b in range(B):
        for t in range(n_real[b]):
            for pos in (write_index[b] + t, write_index[b] + t + 1):
                if pos < kv_len[b]:
                    idx.append((int(tables[b, pos // bs]), pos % bs))
                    vals.append(u[b, t])
    if not idx:
        return
    phys = torch.tensor([i for i, _ in idx], device=q.device)
    slot = torch.tensor([s for _, s in idx], device=q.device)
    add = torch.stack(vals)  # [M, K, hd]
    for a in k_arenas:
        lay = a[layer].float().permute(0, 2, 1, 3).contiguous()  # [N, bs, K, hd]
        lay.index_put_((phys, slot), add, accumulate=True)
        a[layer] = lay.permute(0, 2, 1, 3).to(a.dtype)


def _paged_bound(kv_len, K, hd, q_bytes, pairs, H):
    """Each live key and value read once, q read and out written once."""
    nbytes = 2 * sum(kv_len) * K * hd * 2 + 2 * q_bytes
    return bound(nbytes, 4.0 * H * hd * pairs, BF16_FLOPS)


def phase_paged_decode(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    L, B, H, K, hd, bs, MB, layer = 32, 8, 32, 8, 128, 16, 272, 31
    kv_l = [4351, 3100, 1800, 600, 17, 16, 1, 0]
    (ka, va), (kz, vz), tables = _paged_arena(L, K, bs, hd, B, MB, kv_l, layer, g)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(torch.bfloat16)
    kv_len = torch.tensor(kv_l, dtype=torch.int32, device=dev)
    # the query sits at each row's frontier: its last key is sharpened
    _sharpen_paged(q, (ka, kz), layer, tables, [n - 1 for n in kv_l], kv_l, [1 if n else 0 for n in kv_l])
    # split plan from the capacity MB * bs, as the wrapper plans it
    plan = A.decode_launch_plan(B, K, MB * bs, _sms())
    want = A.paged_decode_attention_xla(q, kz, vz, tables, kv_len, layer)
    got = A.paged_decode_attention(q, ka, va, tables, kv_len, layer)
    torch.cuda.synchronize()
    err, rms = map(max, zip(
        _paged_check("paged_decode", A.paged_decode_attention(q, kz, vz, tables, kv_len, layer), want),
        _paged_check("paged_decode (NaN outside the live blocks)", got, want),
        _paged_check("paged_decode (against the split plain version)", got, A.paged_decode_attention_split_xla(
            q, kz, vz, tables, kv_len, layer, plan["split_keys"])),
    ))
    short = kv_len.clone()
    short[0] -= 1
    swapped = tables.clone()
    swapped[4, [0, 1]] = swapped[4, [1, 0]]
    fault_rms = _paged_faults("paged_decode", got, {
        "kv_len-1 (row 0)": A.paged_decode_attention_xla(q, kz, vz, tables, short, layer),
        "table entries 0,1 of row 4 swapped": A.paged_decode_attention_xla(q, kz, vz, swapped, kv_len, layer),
        "layer-1": A.paged_decode_attention_xla(q, kz, vz, tables, kv_len, layer - 1),
    })
    # alternate the two filled layers so one call's blocks are not left in L2
    call = lambda i: A.paged_decode_attention(q, ka, va, tables, kv_len, layer - i % 2)  # noqa: E731
    ms = time_ms(call, iters=64)
    host_us = launch_us(call)
    plain_ms = time_ms(lambda i: A.paged_decode_attention_xla(q, kz, vz, tables, kv_len, layer - i % 2), iters=8)
    split_us = device_us(call)
    # the split cap (ops.attention.DECODE_SPLIT_TILES) against longer and
    # shorter splits; 64 tiles leaves the capacity plan uncut
    cap, cap_ms = A.DECODE_SPLIT_TILES, {}
    try:
        for tiles in (64, 16, 8, 4):
            A.DECODE_SPLIT_TILES = tiles
            cap_ms[A.decode_launch_plan(B, K, MB * bs, _sms())["split_keys"] // 16] = time_ms(call, iters=32)
    finally:
        A.DECODE_SPLIT_TILES = cap
    b_ms, b_by = _paged_bound(kv_l, K, hd, q.numel() * 2, sum(kv_l), H)
    print(f"phase paged_decode B={B} H={H} K={K} hd={hd} bs={bs} MB={MB} layer={layer} kv_len={kv_l} "
          f"{_plan_line(plan)}: {_attn_line(err, rms, fault_rms)} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms=none (no single PyTorch call reads a paged arena) bound_ms={b_ms:.4f} ({b_by}) "
          f"host_us={host_us:.1f} device_us: {split_us} "
          f"ms_by_split_tiles={' '.join(f'{t}:{v:.4f}' for t, v in cap_ms.items())} "
          f"earlier_design_ms=0.0722 (the previous design, PERF.md §6)", flush=True)
    rows["paged_decode_attention"] = dict(
        shape=f"B=8 H=32 K=8 hd=128 bs=16 MB=272 live_keys={sum(kv_l)}", ms=ms, plain_ms=plain_ms,
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, rel_rms=rms, host_us=host_us,
    )
    del ka, va, kz, vz
    torch.cuda.empty_cache()


def phase_paged_chunk(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    L, B, S, H, K, hd, bs, MB, layer = 32, 8, 64, 32, 8, 128, 16, 272, 31
    # the mixed window: rows 0-3 decode (one real lane at the frontier),
    # rows 4-6 prompt chunks of 64 at offsets 0, 1024 and 4032, row 7 a
    # bystander
    wi_l = [4350, 3000, 1799, 599, 0, 1024, 4032, 0]
    n_real = [1, 1, 1, 1, 64, 64, 64, 0]
    kv_l = [w + n for w, n in zip(wi_l, n_real)]
    (ka, va), (kz, vz), tables = _paged_arena(L, K, bs, hd, B, MB, kv_l, layer, g)
    q = torch.randn(B, S, H, hd, device=dev, generator=g).to(torch.bfloat16)
    kv_len = torch.tensor(kv_l, dtype=torch.int32, device=dev)
    wi = torch.tensor(wi_l, dtype=torch.int32, device=dev)
    _sharpen_paged(q, (ka, kz), layer, tables, wi_l, kv_l, n_real)
    want = A.paged_chunk_attention_xla(q, kz, vz, tables, kv_len, layer, wi)
    got = A.paged_chunk_attention(q, ka, va, tables, kv_len, layer, wi)
    torch.cuda.synchronize()
    err, rms = map(max, zip(
        _paged_check("paged_chunk", A.paged_chunk_attention(q, kz, vz, tables, kv_len, layer, wi), want),
        _paged_check("paged_chunk (NaN outside the live blocks)", got, want),
    ))
    short = kv_len.clone()
    short[0] -= 1
    swapped = tables.clone()
    swapped[5, [1, 64]] = swapped[5, [64, 1]]
    faulty = {
        "kv_len-1 (row 0)": A.paged_chunk_attention_xla(q, kz, vz, tables, short, layer, wi),
        "table entries 1,64 of row 5 swapped": A.paged_chunk_attention_xla(q, kz, vz, swapped, kv_len, layer, wi),
        "layer-1": A.paged_chunk_attention_xla(q, kz, vz, tables, kv_len, layer - 1, wi),
    }
    for d in (1, -1):
        moved = wi.clone()
        moved[5] += d
        faulty[f"write_index{d:+d} (row 5)"] = A.paged_chunk_attention_xla(q, kz, vz, tables, kv_len, layer, moved)
    fault_rms = _paged_faults("paged_chunk", got, faulty)
    del faulty
    ms = time_ms(lambda i: A.paged_chunk_attention(q, ka, va, tables, kv_len, layer - i % 2, wi), iters=16)
    plain_ms = time_ms(lambda i: A.paged_chunk_attention_xla(q, kz, vz, tables, kv_len, layer - i % 2, wi),
                       iters=5, warmup=1)
    # (query position, key) pairs every lane computes on, junk lanes included
    pairs = sum(min(w + t + 1, n) for w, n in zip(wi_l, kv_l) for t in range(S))
    b_ms, b_by = _paged_bound(kv_l, K, hd, q.numel() * 2, pairs, H)
    print(f"phase paged_chunk B={B} S={S} H={H} K={K} hd={hd} bs={bs} write_index={wi_l} kv_len={kv_l} "
          f"{_plan_line(A.chunk_launch_plan(B, S, H, K, MB * bs, _sms()))}: "
          f"{_attn_line(err, rms, fault_rms)} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms=none (no single PyTorch call reads a paged arena) bound_ms={b_ms:.4f} ({b_by})",
          flush=True)
    rows["paged_chunk_attention"] = dict(
        shape=f"B=8 S=64 H=32 K=8 hd=128 bs=16 write_index={wi_l}", ms=ms, plain_ms=plain_ms,
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, rel_rms=rms,
    )
    del ka, va, kz, vz
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# int8 KV kernel phases
# ---------------------------------------------------------------------------

def q8_key_bytes(K, hd):
    """Bytes one key of one layer costs in the int8 cache: K and V payload
    plus their fp32 scales (2,112 at K = 8, hd = 128)."""
    return 2 * K * hd + 2 * K * 4


def _quantize(c):
    """int8 payload and fp32 scales of a bf16 cache or arena, a layer at a time."""
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    q = torch.empty(c.shape, dtype=torch.int8, device=c.device)
    s = torch.empty(c.shape[:-1], dtype=torch.float32, device=c.device)
    for lay in range(c.shape[0]):
        q[lay], s[lay] = A.quantize_kv(c[lay])
    return q, s


def _q8_pair(with_nan, twin, g):
    """The int8 form of a bf16 cache or arena pair (``with_nan`` holds NaN
    in every slot outside its windows and in every block no row owns,
    ``twin`` zeros there): the plain version's payload and scales, quantized
    from the twin, and the kernel's, where each such slot holds a NaN scale
    and random int8 payload instead."""
    import torch

    q8, s = _quantize(twin)
    bad = torch.isnan(with_nan[..., 0])
    junk = torch.randint(-127, 128, q8.shape, dtype=torch.int8, device=q8.device, generator=g)
    return (q8, s), (torch.where(bad[..., None], junk, q8), torch.where(bad, float("nan"), s))


def _scale_rows(g, *vs):
    """Each value row of each tensor in ``vs`` (one shape) times the same
    random factor in [0.5, 1.5), so that the v-scales differ from the
    k-scales row by row (a swapped pair must show); NaN stays NaN."""
    import torch

    f = torch.rand(vs[0].shape[:-1], device=vs[0].device, generator=g)[..., None] + 0.5
    return [(v.float() * f).to(v.dtype) for v in vs]


def phase_decode_q8(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    L, B, K, T, H, hd = 32, 1, 8, 4352, 32, 128
    ks_i, kl_i = 100, 4200
    kc, vc, kz, vz = _cache_pair(L, B, K, T, hd, ks_i, kl_i, g)
    vc, vz = _scale_rows(g, vc, vz)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(torch.bfloat16)
    ks = torch.tensor([ks_i], device=dev, dtype=torch.int32)
    kl = torch.tensor([kl_i], device=dev, dtype=torch.int32)
    layer = 17
    _sharpen_edges(q, (kc, kz), layer, kl_i - 1, ks_i)
    (k8, ksz), (k8x, ksn) = _q8_pair(kc, kz, g)
    (v8, vsz), (v8x, vsn) = _q8_pair(vc, vz, g)
    plan = A.decode_launch_plan(B, K, T, _sms())
    want = A.decode_attention_xla_q8(q, k8, v8, ksz, vsz, ks, kl, layer)
    got = A.decode_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, layer)
    err, rms = map(max, zip(
        _attn_check("decode_q8", A.decode_attention_q8(q, k8, v8, ksz, vsz, ks, kl, layer), want),
        _attn_check("decode_q8 (NaN scales outside the window)", got, want),
        _attn_check("decode_q8 (against the split plain version)", got, A.decode_attention_split_xla_q8(
            q, k8, v8, ksz, vsz, ks, kl, layer, plan["split_keys"])),
    ))
    fault_rms = _attn_faults("decode_q8", got, {
        "kv_start+1": A.decode_attention_xla_q8(q, k8, v8, ksz, vsz, ks + 1, kl, layer),
        "kv_len-1": A.decode_attention_xla_q8(q, k8, v8, ksz, vsz, ks, kl - 1, layer),
        "layer-1": A.decode_attention_xla_q8(q, k8, v8, ksz, vsz, ks, kl, layer - 1),
        "k/v scales swapped": A.decode_attention_xla_q8(q, k8, v8, vsz, ksz, ks, kl, layer),
    })
    # each call reads another layer, as a decode step does
    ms = time_ms(lambda i: A.decode_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, i % L), iters=64)
    host_us = launch_us(lambda i: A.decode_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, i % L))
    plain_ms = time_ms(lambda i: A.decode_attention_xla_q8(q, k8, v8, ksz, vsz, ks, kl, i % L), iters=8)
    bf16_ms = time_ms(lambda i: A.decode_attention(q, kc, vc, ks, kl, i % L), iters=64)
    split_us = device_us(lambda i: A.decode_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, i % L))
    live = kl_i - ks_i
    b_ms, b_by = bound(B * live * q8_key_bytes(K, hd) + 2 * q.numel() * 2, 4.0 * B * H * hd * live, BF16_FLOPS)
    print(f"phase decode_q8 L={L} B={B} K={K} T={T} H={H} hd={hd} window=[{ks_i},{kl_i}) {_plan_line(plan)}: "
          f"{_attn_line(err, rms, fault_rms)} ms={ms:.4f} plain_ms={plain_ms:.4f} bf16_kernel_ms={bf16_ms:.4f} "
          f"library_ms=none (no single PyTorch call reads an int8 cache) bound_ms={b_ms:.4f} ({b_by}) "
          f"host_us={host_us:.1f} device_us: {split_us}", flush=True)
    rows["decode_attention_q8"] = dict(
        shape=f"L=32 B=1 K=8 T={T} H=32 hd=128 live={live}", ms=ms, plain_ms=plain_ms, bf16_kernel_ms=bf16_ms,
        library_ms=None, bound_ms=b_ms, bound_by=b_by, host_us=host_us,
    )
    del kc, vc, kz, vz, k8, v8, k8x, v8x

    # B = 2, ragged: row 0's window starts and ends mid-tile and mid-split
    # (16-key tiles, 128-key splits at this grid), row 1's is empty and must
    # write zeros; NaN scales outside both; checked row by row
    B2, ks_l, kl_l = 2, [37, 2000], [3333, 2000]
    kc, vc, kz, vz = _ragged_cache_pair(L, B2, K, T, hd, ks_l, kl_l, g)
    vc, vz = _scale_rows(g, vc, vz)
    q = torch.randn(B2, 1, H, hd, device=dev, generator=g).to(torch.bfloat16)
    ks, kl = (torch.tensor(x, device=dev, dtype=torch.int32) for x in (ks_l, kl_l))
    _sharpen_edges(q, (kc, kz), layer, kl_l[0] - 1, ks_l[0])
    (k8, ksz), (k8x, ksn) = _q8_pair(kc, kz, g)
    (v8, vsz), (v8x, vsn) = _q8_pair(vc, vz, g)
    plain = lambda *a, **kw: A.decode_attention_xla_q8(q, *a, **kw)  # noqa: E731
    plan = A.decode_launch_plan(B2, K, T, _sms())
    want = plain(k8, v8, ksz, vsz, ks, kl, layer)
    got = A.decode_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, layer)
    torch.cuda.synchronize()
    e2, r2 = map(max, zip(
        _paged_check("decode_q8 B=2", A.decode_attention_q8(q, k8, v8, ksz, vsz, ks, kl, layer), want),
        _paged_check("decode_q8 B=2 (NaN scales outside the windows)", got, want),
        _paged_check("decode_q8 B=2 (against the split plain version)", got, A.decode_attention_split_xla_q8(
            q, k8, v8, ksz, vsz, ks, kl, layer, plan["split_keys"])),
    ))
    first = lambda t, d: t + torch.tensor([d, 0], device=dev, dtype=torch.int32)  # noqa: E731
    f2 = _paged_faults("decode_q8 B=2", got, {
        "kv_start+1 (row 0)": plain(k8, v8, ksz, vsz, first(ks, 1), kl, layer),
        "kv_len-1 (row 0)": plain(k8, v8, ksz, vsz, ks, first(kl, -1), layer),
        "k/v scales swapped": plain(k8, v8, vsz, ksz, ks, kl, layer),
    })
    print(f"phase decode_q8 B={B2} windows={list(zip(ks_l, kl_l))} {_plan_line(plan)}: "
          f"{_attn_line(e2, r2, f2)} (row by row)", flush=True)
    rows["decode_attention_q8"].update(max_abs_err=max(err, e2), rel_rms=max(rms, r2))
    del kc, vc, kz, vz, k8, v8, k8x, v8x
    torch.cuda.empty_cache()


def phase_chunk_q8(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    L, B, K, H, hd = 32, 1, 8, 32, 128
    worst, worst_rms = 0.0, 0.0
    for tag, S, wi, T in (("verify", 16, 4100, 4352), ("long-prompt", 4096, 4096, 8448)):
        ks_i, kl_i = 100, wi + S
        Lc = L if S == 16 else 4
        kc, vc, kz, vz = _cache_pair(Lc, B, K, T, hd, ks_i, kl_i, g)
        vc, vz = _scale_rows(g, vc, vz)
        q = torch.randn(B, S, H, hd, device=dev, generator=g).to(torch.bfloat16)
        ks = torch.tensor([ks_i], device=dev, dtype=torch.int32)
        kl = torch.tensor([kl_i], device=dev, dtype=torch.int32)
        layer = Lc // 2 + 1
        _sharpen_edges(q, (kc, kz), layer, wi, ks_i)
        (k8, ksz), (k8x, ksn) = _q8_pair(kc, kz, g)
        (v8, vsz), (v8x, vsn) = _q8_pair(vc, vz, g)
        plain = lambda *a, **kw: A.chunk_attention_xla_q8(q, *a, **kw)  # noqa: E731
        plan = A.chunk_launch_plan(B, S, H, K, T, _sms())
        want = plain(k8, v8, ksz, vsz, ks, kl, layer, wi)
        split_want = A.chunk_attention_split_xla_q8(q, k8, v8, ksz, vsz, ks, kl, layer, wi, plan["split_keys"],
                                                    plan["block_rows"])
        got = A.chunk_prefill_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, layer, wi)
        err, rms = map(max, zip(
            _attn_check(f"chunk_q8 {tag}", A.chunk_prefill_attention_q8(q, k8, v8, ksz, vsz, ks, kl, layer, wi),
                        want),
            _attn_check(f"chunk_q8 {tag} (NaN scales outside the window)", got, want),
            _attn_check(f"chunk_q8 {tag} (against the split plain version)", got, split_want),
        ))
        worst, worst_rms = max(worst, err), max(worst_rms, rms)
        del want, split_want
        faulty = {
            "write_index+1": plain(k8, v8, ksz, vsz, ks, kl, layer, wi + 1),
            "write_index-1": plain(k8, v8, ksz, vsz, ks, kl, layer, wi - 1),
            "k/v scales swapped": plain(k8, v8, vsz, ksz, ks, kl, layer, wi),
        }
        if S == 16:
            faulty["kv_start+1"] = plain(k8, v8, ksz, vsz, ks + 1, kl, layer, wi)
            faulty["kv_len-1"] = plain(k8, v8, ksz, vsz, ks, kl - 1, layer, wi)
        fault_rms = _attn_faults(f"chunk_q8 {tag}", got, faulty)
        del faulty, got
        ms = time_ms(lambda i: A.chunk_prefill_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, i % Lc, wi), iters=16)
        plain_ms = time_ms(lambda i: plain(k8, v8, ksz, vsz, ks, kl, i % Lc, wi),
                           iters=3 if S > 16 else 8, warmup=1)
        bf16_ms = time_ms(lambda i: A.chunk_prefill_attention(q, kc, vc, ks, kl, i % Lc, wi), iters=16)
        qpos = wi + torch.arange(S, device=dev)
        pos = torch.arange(T, device=dev)
        pairs = ((pos[None, :] >= ks_i) & (pos[None, :] < kl_i) & (pos[None, :] <= qpos[:, None])).sum().item()
        b_ms, b_by = bound(B * (kl_i - ks_i) * q8_key_bytes(K, hd) + 2 * q.numel() * 2, 4.0 * H * hd * pairs,
                           BF16_FLOPS)
        print(f"phase chunk_q8 {tag} S={S} write_index={wi} T={T} H={H} K={K} hd={hd} {_plan_line(plan)}: "
              f"{_attn_line(err, rms, fault_rms)} ms={ms:.4f} plain_ms={plain_ms:.4f} bf16_kernel_ms={bf16_ms:.4f} "
              f"library_ms=none (no single PyTorch call reads an int8 cache) bound_ms={b_ms:.4f} ({b_by})",
              flush=True)
        if tag == "verify":
            rows["chunk_prefill_attention_q8"] = dict(
                shape=f"S=16 write_index={wi} T={T} H=32 K=8 hd=128", ms=ms, plain_ms=plain_ms,
                bf16_kernel_ms=bf16_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
            )
        else:
            rows["chunk_prefill_attention_q8"]["long_prompt"] = dict(
                ms=ms, plain_ms=plain_ms, bf16_kernel_ms=bf16_ms, bound_ms=b_ms, bound_by=b_by)
        del kc, vc, kz, vz, k8, v8, k8x, v8x, q
        torch.cuda.empty_cache()

    # B = 2, ragged, at the verify's width: row 0's window starts mid-tile,
    # row 1's starts mid-tile and ends mid-tile inside the chunk (its queries
    # t >= 9 see up to key 4108); NaN scales outside both; checked row by row
    S, wi, T, B2 = 16, 4100, 4352, 2
    ks_l, kl_l = [37, 2085], [wi + S, wi + 9]
    kc, vc, kz, vz = _ragged_cache_pair(L, B2, K, T, hd, ks_l, kl_l, g)
    vc, vz = _scale_rows(g, vc, vz)
    q = torch.randn(B2, S, H, hd, device=dev, generator=g).to(torch.bfloat16)
    ks, kl = (torch.tensor(x, device=dev, dtype=torch.int32) for x in (ks_l, kl_l))
    layer = L // 2 + 1
    _sharpen_edges(q, (kc, kz), layer, wi, ks_l[0])
    (k8, ksz), (k8x, ksn) = _q8_pair(kc, kz, g)
    (v8, vsz), (v8x, vsn) = _q8_pair(vc, vz, g)
    plain = lambda *a, **kw: A.chunk_attention_xla_q8(q, *a, **kw)  # noqa: E731
    plan = A.chunk_launch_plan(B2, S, H, K, T, _sms())
    want = plain(k8, v8, ksz, vsz, ks, kl, layer, wi)
    got = A.chunk_prefill_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, layer, wi)
    torch.cuda.synchronize()
    e2, r2 = map(max, zip(
        _paged_check("chunk_q8 B=2", A.chunk_prefill_attention_q8(q, k8, v8, ksz, vsz, ks, kl, layer, wi), want),
        _paged_check("chunk_q8 B=2 (NaN scales outside the windows)", got, want),
        _paged_check("chunk_q8 B=2 (against the split plain version)", got, A.chunk_attention_split_xla_q8(
            q, k8, v8, ksz, vsz, ks, kl, layer, wi, plan["split_keys"], plan["block_rows"])),
    ))
    row = lambda t, d, b: t + torch.tensor([d * (b == 0), d * (b == 1)], device=dev, dtype=torch.int32)  # noqa: E731
    f2 = _paged_faults("chunk_q8 B=2", got, {
        "write_index+1": plain(k8, v8, ksz, vsz, ks, kl, layer, wi + 1),
        "write_index-1": plain(k8, v8, ksz, vsz, ks, kl, layer, wi - 1),
        "kv_start+1 (row 0)": plain(k8, v8, ksz, vsz, row(ks, 1, 0), kl, layer, wi),
        "kv_len-1 (row 1)": plain(k8, v8, ksz, vsz, ks, row(kl, -1, 1), layer, wi),
        "k/v scales swapped": plain(k8, v8, vsz, ksz, ks, kl, layer, wi),
    })
    print(f"phase chunk_q8 B={B2} S={S} write_index={wi} windows={list(zip(ks_l, kl_l))} {_plan_line(plan)}: "
          f"{_attn_line(e2, r2, f2)} (row by row)", flush=True)
    del kc, vc, kz, vz, k8, v8, k8x, v8x, q
    torch.cuda.empty_cache()
    rows["chunk_prefill_attention_q8"].update(max_abs_err=max(worst, e2), rel_rms=max(worst_rms, r2))


def _paged_q8_case(L, B, K, hd, bs, MB, layer, kv_l, g):
    """``_paged_arena`` at ``bs`` with the value rows of its two filled
    layers rescaled (``_scale_rows``); the keys stay bf16 until the caller
    sharpens them, then ``_q8_arena`` quantizes."""
    (ka, va), (kz, vz), tables = _paged_arena(L, K, bs, hd, B, MB, kv_l, layer, g)
    for lay in (layer - 1, layer):
        va[lay], vz[lay] = _scale_rows(g, va[lay], vz[lay])
    return (ka, va), (kz, vz), tables


def _q8_arena(ka, va, kz, vz, g):
    (k8, ksz), (k8x, ksn) = _q8_pair(ka, kz, g)
    (v8, vsz), (v8x, vsn) = _q8_pair(va, vz, g)
    return (k8, ksz, v8, vsz), (k8x, ksn, v8x, vsn)


def phase_paged_decode_q8(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    L, B, H, K, hd, bs, MB, layer = 32, 8, 32, 8, 128, 32, 136, 31
    kv_l = [4351, 3100, 1800, 600, 17, 16, 1, 0]
    (ka, va), (kz, vz), tables = _paged_q8_case(L, B, K, hd, bs, MB, layer, kv_l, g)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(torch.bfloat16)
    kv_len = torch.tensor(kv_l, dtype=torch.int32, device=dev)
    _sharpen_paged(q, (ka, kz), layer, tables, [n - 1 for n in kv_l], kv_l, [1 if n else 0 for n in kv_l])
    (k8, ksz, v8, vsz), (k8x, ksn, v8x, vsn) = _q8_arena(ka, va, kz, vz, g)
    plain = A.paged_decode_attention_xla_q8
    plan = A.decode_launch_plan(B, K, MB * bs, _sms())
    want = plain(q, k8, v8, ksz, vsz, tables, kv_len, layer)
    got = A.paged_decode_attention_q8(q, k8x, v8x, ksn, vsn, tables, kv_len, layer)
    torch.cuda.synchronize()
    err, rms = map(max, zip(
        _paged_check("paged_decode_q8", A.paged_decode_attention_q8(q, k8, v8, ksz, vsz, tables, kv_len, layer),
                     want),
        _paged_check("paged_decode_q8 (NaN scales outside the live blocks)", got, want),
        _paged_check("paged_decode_q8 (against the split plain version)", got, A.paged_decode_attention_split_xla_q8(
            q, k8, v8, ksz, vsz, tables, kv_len, layer, plan["split_keys"])),
    ))
    short = kv_len.clone()
    short[0] -= 1
    swapped = tables.clone()
    swapped[3, [0, 18]] = swapped[3, [18, 0]]  # a full block and row 3's frontier block
    fault_rms = _paged_faults("paged_decode_q8", got, {
        "kv_len-1 (row 0)": plain(q, k8, v8, ksz, vsz, tables, short, layer),
        "table entries 0,18 of row 3 swapped": plain(q, k8, v8, ksz, vsz, swapped, kv_len, layer),
        "layer-1": plain(q, k8, v8, ksz, vsz, tables, kv_len, layer - 1),
        "k/v scales swapped": plain(q, k8, v8, vsz, ksz, tables, kv_len, layer),
    })
    call = lambda i: A.paged_decode_attention_q8(q, k8x, v8x, ksn, vsn, tables, kv_len, layer - i % 2)  # noqa: E731
    ms = time_ms(call, iters=64)
    host_us = launch_us(call)
    plain_ms = time_ms(lambda i: plain(q, k8, v8, ksz, vsz, tables, kv_len, layer - i % 2), iters=8)
    bf16_ms = time_ms(lambda i: A.paged_decode_attention(q, ka, va, tables, kv_len, layer - i % 2), iters=32)
    split_us = device_us(call)
    # the split cap (ops.attention.DECODE_SPLIT_TILES: a warp walks its
    # tiles one after another) against longer and shorter splits; 64 tiles
    # leaves the capacity plan uncut
    cap, cap_ms = A.DECODE_SPLIT_TILES, {}
    try:
        for tiles in (64, 16, 8, 4):
            A.DECODE_SPLIT_TILES = tiles
            cap_ms[A.decode_launch_plan(B, K, MB * bs, _sms())["split_keys"] // 16] = time_ms(call, iters=32)
    finally:
        A.DECODE_SPLIT_TILES = cap
    b_ms, b_by = bound(sum(kv_l) * q8_key_bytes(K, hd) + 2 * q.numel() * 2, 4.0 * H * hd * sum(kv_l), BF16_FLOPS)
    print(f"phase paged_decode_q8 B={B} H={H} K={K} hd={hd} bs={bs} MB={MB} layer={layer} kv_len={kv_l} "
          f"{_plan_line(plan)}: "
          f"{_attn_line(err, rms, fault_rms)} ms={ms:.4f} plain_ms={plain_ms:.4f} bf16_kernel_ms={bf16_ms:.4f} "
          f"library_ms=none (no single PyTorch call reads an int8 arena) bound_ms={b_ms:.4f} ({b_by}) "
          f"host_us={host_us:.1f} device_us: {split_us} "
          f"ms_by_split_tiles={' '.join(f'{t}:{v:.4f}' for t, v in cap_ms.items())}", flush=True)
    rows["paged_decode_attention_q8"] = dict(
        shape=f"B=8 H=32 K=8 hd=128 bs=32 MB=136 live_keys={sum(kv_l)}", ms=ms, plain_ms=plain_ms,
        bf16_kernel_ms=bf16_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, rel_rms=rms,
        host_us=host_us,
    )
    del ka, va, kz, vz, k8, v8, k8x, v8x
    torch.cuda.empty_cache()


def phase_paged_chunk_q8(rows):
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    L, B, S, H, K, hd, bs, MB, layer = 32, 8, 64, 32, 8, 128, 32, 136, 31
    wi_l = [4350, 3000, 1799, 599, 0, 1024, 4032, 0]
    n_real = [1, 1, 1, 1, 64, 64, 64, 0]
    kv_l = [w + n for w, n in zip(wi_l, n_real)]
    (ka, va), (kz, vz), tables = _paged_q8_case(L, B, K, hd, bs, MB, layer, kv_l, g)
    q = torch.randn(B, S, H, hd, device=dev, generator=g).to(torch.bfloat16)
    kv_len = torch.tensor(kv_l, dtype=torch.int32, device=dev)
    wi = torch.tensor(wi_l, dtype=torch.int32, device=dev)
    _sharpen_paged(q, (ka, kz), layer, tables, wi_l, kv_l, n_real)
    (k8, ksz, v8, vsz), (k8x, ksn, v8x, vsn) = _q8_arena(ka, va, kz, vz, g)
    plain = A.paged_chunk_attention_xla_q8
    plan = A.chunk_launch_plan(B, S, H, K, MB * bs, _sms())
    want = plain(q, k8, v8, ksz, vsz, tables, kv_len, layer, wi)
    got = A.paged_chunk_attention_q8(q, k8x, v8x, ksn, vsn, tables, kv_len, layer, wi)
    torch.cuda.synchronize()
    err, rms = map(max, zip(
        _paged_check("paged_chunk_q8",
                     A.paged_chunk_attention_q8(q, k8, v8, ksz, vsz, tables, kv_len, layer, wi), want),
        _paged_check("paged_chunk_q8 (NaN scales outside the live blocks)", got, want),
        _paged_check("paged_chunk_q8 (against the split plain version)", got, A.paged_chunk_attention_split_xla_q8(
            q, k8, v8, ksz, vsz, tables, kv_len, layer, wi, plan["split_keys"], plan["block_rows"])),
    ))
    short = kv_len.clone()
    short[0] -= 1
    swapped = tables.clone()
    swapped[5, [1, 32]] = swapped[5, [32, 1]]  # block 32 holds row 5's chunk: causality tells them apart
    faulty = {
        "kv_len-1 (row 0)": plain(q, k8, v8, ksz, vsz, tables, short, layer, wi),
        "table entries 1,32 of row 5 swapped": plain(q, k8, v8, ksz, vsz, swapped, kv_len, layer, wi),
        "layer-1": plain(q, k8, v8, ksz, vsz, tables, kv_len, layer - 1, wi),
        "k/v scales swapped": plain(q, k8, v8, vsz, ksz, tables, kv_len, layer, wi),
    }
    for d in (1, -1):
        moved = wi.clone()
        moved[5] += d
        faulty[f"write_index{d:+d} (row 5)"] = plain(q, k8, v8, ksz, vsz, tables, kv_len, layer, moved)
    fault_rms = _paged_faults("paged_chunk_q8", got, faulty)
    del faulty
    ms = time_ms(lambda i: A.paged_chunk_attention_q8(q, k8x, v8x, ksn, vsn, tables, kv_len, layer - i % 2, wi),
                 iters=16)
    plain_ms = time_ms(lambda i: plain(q, k8, v8, ksz, vsz, tables, kv_len, layer - i % 2, wi), iters=5, warmup=1)
    bf16_ms = time_ms(lambda i: A.paged_chunk_attention(q, ka, va, tables, kv_len, layer - i % 2, wi), iters=16)
    pairs = sum(min(w + t + 1, n) for w, n in zip(wi_l, kv_l) for t in range(S))
    b_ms, b_by = bound(sum(kv_l) * q8_key_bytes(K, hd) + 2 * q.numel() * 2, 4.0 * H * hd * pairs, BF16_FLOPS)
    print(f"phase paged_chunk_q8 B={B} S={S} H={H} K={K} hd={hd} bs={bs} write_index={wi_l} kv_len={kv_l} "
          f"{_plan_line(plan)}: "
          f"{_attn_line(err, rms, fault_rms)} ms={ms:.4f} plain_ms={plain_ms:.4f} bf16_kernel_ms={bf16_ms:.4f} "
          f"library_ms=none (no single PyTorch call reads an int8 arena) bound_ms={b_ms:.4f} ({b_by})", flush=True)
    rows["paged_chunk_attention_q8"] = dict(
        shape=f"B=8 S=64 H=32 K=8 hd=128 bs=32 write_index={wi_l}", ms=ms, plain_ms=plain_ms,
        bf16_kernel_ms=bf16_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, rel_rms=rms,
    )
    del ka, va, kz, vz, k8, v8, k8x, v8x
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the continuous engine's new shapes (the dense decode and the verify)
# ---------------------------------------------------------------------------

# the dense continuous decode (kernels 3 and 5): B = 8 rows left-padded to
# the 4,096 bucket (kv_start = 4096 - prompt length) at their own frontiers,
# row 7 inactive and parked over [0, 1), as the engine parks it
CONT_KS = [1196, 0, 850, 1203, 17, 400, 1100, 0]
CONT_KL = [4340, 4097, 4200, 4351, 4150, 4120, 4301, 1]
# the verify forward (kernels 9 and 10): S = K + 1 = 8 lanes at each row's
# frontier, nd drafts a row (kv_len = write_index + 1 + nd), row 7 inactive
# (its table all null, write_index 0, kv_len 1)
VERIFY_WI = [4300, 3000, 2911, 2950, 3100, 17, 4344, 0]
VERIFY_ND = [7, 0, 3, 7, 1, 5, 6, 0]


def _sharpen_rows(q, k_caches, layer, ks_l, kl_l):
    """``_sharpen_edges`` for per-row windows: each row's query direction
    added to the keys its window turns on first and last (``kv_start[b]``,
    ``kv_len[b] - 1``) and off first (``kv_start[b] - 1``, ``kv_len[b]``),
    so a window off by one key in any row shows."""
    B, _, H, hd = q.shape
    K, T = k_caches[0].shape[2], k_caches[0].shape[3]
    u = q.float().reshape(B, K, H // K, hd).sum(2)
    u = 9.0 * u / u.norm(dim=-1, keepdim=True)  # [B, K, hd]
    for kc in k_caches:
        lay = kc[layer].float()
        for b, (ks, kl) in enumerate(zip(ks_l, kl_l)):
            for pos in (ks - 1, ks, kl - 1, kl):
                if 0 <= pos < T:
                    lay[b, :, pos] += u[b]
        kc[layer] = lay.to(kc.dtype)


def _cont_decode_case(q8, g):
    """Kernel 3 (or 5) at the dense continuous decode's shape: B = 8 rows
    with their own ``[kv_start, kv_len)`` (``CONT_KS``, ``CONT_KL``) over a
    ``[L, 8, 8, 4352, 128]`` cache, NaN outside each row's window for the
    kernel (NaN scales and random payload under int8), zeros for the plain
    version, checked row by row; planted faults must be rejected. Returns
    the kernel's name and its row of numbers."""
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    L, B, K, T, H, hd, layer = 4, 8, 8, 4352, 32, 128, 2
    kc, vc, kz, vz = _ragged_cache_pair(L, B, K, T, hd, CONT_KS, CONT_KL, g)
    if q8:
        vc, vz = _scale_rows(g, vc, vz)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(torch.bfloat16)
    ks, kl = (torch.tensor(x, device=dev, dtype=torch.int32) for x in (CONT_KS, CONT_KL))
    _sharpen_rows(q, (kc, kz), layer, CONT_KS, CONT_KL)
    name = "decode_attention_q8" if q8 else "decode_attention"
    if q8:
        (k8, ksz), (k8x, ksn) = _q8_pair(kc, kz, g)
        (v8, vsz), (v8x, vsn) = _q8_pair(vc, vz, g)
        del kc, vc
        kern = lambda lay: A.decode_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, lay)  # noqa: E731
        plain = lambda lay, ks=ks, kl=kl: A.decode_attention_xla_q8(q, k8, v8, ksz, vsz, ks, kl, lay)  # noqa: E731
    else:
        kern = lambda lay: A.decode_attention(q, kc, vc, ks, kl, lay)  # noqa: E731
        plain = lambda lay, ks=ks, kl=kl: A.decode_attention_xla(q, kz, vz, ks, kl, lay)  # noqa: E731
    got = kern(layer)
    torch.cuda.synchronize()
    err, rms = _paged_check(f"{name} dense continuous", got, plain(layer))
    one = lambda t, b, d: t + torch.tensor([d if i == b else 0 for i in range(B)], device=dev,  # noqa: E731
                                           dtype=torch.int32)
    fault_rms = _paged_faults(f"{name} dense continuous", got, {
        "kv_start+1 (row 0)": plain(layer, ks=one(ks, 0, 1)),
        "kv_start-1 (row 5)": plain(layer, ks=one(ks, 5, -1)),
        "kv_len-1 (row 3)": plain(layer, kl=one(kl, 3, -1)),
        "kv_len+1 (row 4)": plain(layer, kl=one(kl, 4, 1)),
        "layer-1": plain(layer - 1),
    })
    del got
    ms = time_ms(lambda i: kern(i % L), iters=64)
    host_us = launch_us(lambda i: kern(i % L))
    plain_ms = time_ms(lambda i: plain(i % L), iters=8)
    live = sum(b - a for a, b in zip(CONT_KS, CONT_KL))
    key_bytes = q8_key_bytes(K, hd) if q8 else 2 * K * hd * 2
    b_ms, b_by = bound(live * key_bytes + 2 * q.numel() * 2, 4.0 * H * hd * live, BF16_FLOPS)
    row = dict(case="dense continuous decode", shape=f"B=8 T={T} H=32 K=8 hd=128 kv_start={CONT_KS} "
               f"kv_len={CONT_KL}", ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err, rel_rms=rms, host_us=host_us, library_ms=None)
    lib = "none (no single PyTorch call reads an int8 cache)"
    if not q8:
        pos = torch.arange(T, device=dev)
        mask = ((pos[None, :] >= ks[:, None]) & (pos[None, :] < kl[:, None]))[:, None, None, :]
        qt = q.transpose(1, 2)
        row["library_ms"] = time_ms(lambda i: sdpa(qt, kz[i % L], vz[i % L], mask), iters=8)
        lib = f"{row['library_ms']:.4f} (SDPA)"
    print(f"phase continuous_kernels (a) {name} {row['shape']} "
          f"{_plan_line(A.decode_launch_plan(B, K, T, _sms()))}: {_attn_line(err, rms, fault_rms)} (row by row) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={b_ms:.4f} ({b_by}) "
          f"host_us={host_us:.1f}", flush=True)
    return name, row


def _verify_chunk_case(q8, g):
    """Kernel 9 (or 10) at the verify forward's shape: B = 8 rows of S = 8
    lanes at their frontiers (``VERIFY_WI``, ``VERIFY_ND``), kv_len = wi + 1
    + nd, row 7 inactive (its table all null, reading slot 0 of the null
    block, which the inactive rows' own writes keep finite), NaN in every
    block no row owns and every frontier tail, checked row by row with
    planted faults. bf16 blocks of 16, int8 blocks of 32."""
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    L, B, S, H, K, hd, layer = 4, 8, 8, 32, 8, 128, 3
    bs = 32 if q8 else 16
    MB = 4352 // bs
    wi_l, nd_l = VERIFY_WI, VERIFY_ND
    kv_l = [w + 1 + n for w, n in zip(wi_l, nd_l)]
    (ka, va), (kz, vz), tables = _paged_q8_case(L, B, K, hd, bs, MB, layer, kv_l, g)
    # row 7 is inactive: null table; its former block is no row's (NaN),
    # and slot 0 of the null block holds finite junk, NaN past it
    old = int(tables[7, 0])
    tables[7] = 0
    for a, z in ((ka, kz), (va, vz)):
        for lay in (layer - 1, layer):
            a[lay, 0], z[lay, 0] = float("nan"), 0
            a[lay, 0, :, 0] = z[lay, 0, :, 0] = z[lay, old, :, 0]
        a[:, old], z[:, old] = float("nan"), 0
    q = torch.randn(B, S, H, hd, device=dev, generator=g).to(torch.bfloat16)
    kv_len = torch.tensor(kv_l, dtype=torch.int32, device=dev)
    wi = torch.tensor(wi_l, dtype=torch.int32, device=dev)
    n_real = [n + 1 for n in nd_l[:7]] + [0]
    _sharpen_paged(q, (ka, kz), layer, tables, wi_l, kv_l, n_real)
    name = "paged_chunk_attention_q8" if q8 else "paged_chunk_attention"
    if q8:
        (k8, ksz, v8, vsz), (k8x, ksn, v8x, vsn) = _q8_arena(ka, va, kz, vz, g)
        kern = lambda lay: A.paged_chunk_attention_q8(q, k8x, v8x, ksn, vsn, tables, kv_len, lay, wi)  # noqa: E731
        plain = lambda lay, t=tables, kl=kv_len, w=wi: A.paged_chunk_attention_xla_q8(  # noqa: E731
            q, k8, v8, ksz, vsz, t, kl, lay, w)
    else:
        kern = lambda lay: A.paged_chunk_attention(q, ka, va, tables, kv_len, lay, wi)  # noqa: E731
        plain = lambda lay, t=tables, kl=kv_len, w=wi: A.paged_chunk_attention_xla(  # noqa: E731
            q, kz, vz, t, kl, lay, w)
    got = kern(layer)
    torch.cuda.synchronize()
    err, rms = _paged_check(f"{name} verify", got, plain(layer))
    short = kv_len.clone()
    short[0] -= 1
    # row 2's second block and its frontier block, whose keys the lanes'
    # causal masks tell apart
    last = (kv_l[2] - 1) // bs
    swapped = tables.clone()
    swapped[2, [1, last]] = swapped[2, [last, 1]]
    faulty = {"kv_len-1 (row 0)": plain(layer, kl=short), "layer-1": plain(layer - 1),
              f"table entries 1,{last} of row 2 swapped": plain(layer, t=swapped)}
    for d in (1, -1):
        moved = wi.clone()
        moved[3] += d
        faulty[f"write_index{d:+d} (row 3)"] = plain(layer, w=moved)
    fault_rms = _paged_faults(f"{name} verify", got, faulty)
    del got, faulty
    ms = time_ms(lambda i: kern(layer - i % 2), iters=32)
    host_us = launch_us(lambda i: kern(layer - i % 2))
    plain_ms = time_ms(lambda i: plain(layer - i % 2), iters=5, warmup=1)
    pairs = sum(min(w + t + 1, n) for w, n in zip(wi_l, kv_l) for t in range(S))
    key_bytes = q8_key_bytes(K, hd) if q8 else 2 * K * hd * 2
    b_ms, b_by = bound(sum(kv_l) * key_bytes + 2 * q.numel() * 2, 4.0 * H * hd * pairs, BF16_FLOPS)
    row = dict(case="verify S=8", shape=f"B=8 S=8 H=32 K=8 hd=128 bs={bs} write_index={wi_l} nd={nd_l}",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, rel_rms=rms,
               host_us=host_us, library_ms=None)
    lib = "none (no single PyTorch call reads an int8 arena)"
    if not q8:
        # the yardstick: SDPA over a dense copy of each row's blocks (the
        # gather is outside the timing; the port never calls this)
        T = MB * bs
        dense = [a[lay][tables.long()].permute(0, 2, 1, 3, 4).reshape(B, K, T, hd)
                 for a in (kz, vz) for lay in (layer, layer - 1)]
        pos = torch.arange(T, device=dev)
        qpos = wi[:, None] + torch.arange(S, device=dev)[None, :]
        mask = ((pos[None, None, :] < kv_len[:, None, None]) & (pos[None, None, :] <= qpos[:, :, None]))[:, None]
        qt = q.transpose(1, 2)
        row["library_ms"] = time_ms(lambda i: sdpa(qt, dense[i % 2], dense[2 + i % 2], mask), iters=16)
        lib = f"{row['library_ms']:.4f} (SDPA over a dense copy)"
        del dense
    print(f"phase continuous_kernels (a) {name} {row['shape']} kv_len={kv_l} "
          f"{_plan_line(A.chunk_launch_plan(B, S, H, K, MB * bs, _sms()))}: {_attn_line(err, rms, fault_rms)} "
          f"(row by row) ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={b_ms:.4f} ({b_by}) "
          f"host_us={host_us:.1f}", flush=True)
    return name, row


def phase_continuous_kernels(rows):
    """(a) of the dense continuous and verify phases: kernels 3 and 5 with
    per-row windows, kernels 9 and 10 at S = 8, each against its plain
    version (bf16 timed beside SDPA)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(31)
    for case in (_cont_decode_case, _verify_chunk_case):
        for q8 in (False, True):
            name, row = case(q8, g)
            rows[name].setdefault("continuous_shapes", []).append(row)
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# model + service phases
# ---------------------------------------------------------------------------


TOKENIZER_FIXTURES = "tests/fixtures/tokenizers/"
LLM_TOKENIZER = TOKENIZER_FIXTURES + "bpe_multi.json"  # byte-level BPE, the Llama side
ENC_TOKENIZER = TOKENIZER_FIXTURES + "unigram_norm.json"  # Unigram, the bge-m3 side


def real_tokenizers():
    """The port's tokenizers over the repository's ``tokenizer.json``
    fixtures (no trained tokenizer ships with it): BPE for Llama, Unigram
    for bge-m3. The BPE merge loop must be the C++ one."""
    from rag_llm_k8s_tpu_torch.tokenizer import load_tokenizer

    llm, enc = load_tokenizer(LLM_TOKENIZER), load_tokenizer(ENC_TOKENIZER)
    if not llm.native:
        fail("the native BPE merge loop (native/bpe.cpp) did not build or load")
    return llm, enc


def make_pdf(text: str) -> bytes:
    content = f"BT /F1 12 Tf ({text}) Tj ET".encode()
    return b"".join([
        b"%PDF-1.4\n",
        b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n",
        b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj\n",
        b"3 0 obj << /Type /Page /Parent 2 0 R /Contents 4 0 R "
        b"/Resources << /Font << /F1 5 0 R >> >> >> endobj\n",
        b"4 0 obj << /Length %d >> stream\n%s\nendstream endobj\n" % (len(content), content),
        b"5 0 obj << /Type /Font /Subtype /Type1 /BaseFont /Helvetica >> endobj\n",
        b"%%EOF",
    ])


WORDS = ("kernel tile memory cache token query chunk vector index decode prefill "
         "attention bandwidth device stream warp block shared register latency").split()


def words(rng, n):
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), size=n))


def _sdpa_attention(q, k, v, kv_start, kv_len, causal=True):
    """The prefill attention as one SDPA call (yardstick); rows with no
    visible key come back as zeros, as in the kernel."""
    import torch

    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    m = (pos[None, None, :] >= kv_start[:, None, None]) & (pos[None, None, :] < kv_len[:, None, None])
    if causal:
        m = m & (pos[None, None, :] <= pos[None, :, None])
    o = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), m[:, None])
    return torch.nan_to_num(o.transpose(1, 2), nan=0.0)


def phase_model(model, cfg):
    """Llama-3.1-8B prefill logits with the prefill attention through the
    kernel, the plain version and SDPA (all bf16 on the card). Random
    weights amplify bf16 rounding layer after layer, so the kernel passes
    when its distance from the plain forward stays within twice SDPA's
    distance from it (the bf16 noise floor), at depth 2 and at full depth."""
    import torch
    from torch import nn

    from rag_llm_k8s_tpu_torch.models import llama as L
    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    B, S, npad = 1, 256, 40
    tokens = torch.randint(3, 259, (B, S), device=dev, generator=g)
    pad = torch.ones((B, S), dtype=torch.int64, device=dev)
    pad[:, :npad] = 0
    ks, _ = L.mask_window(pad)
    pos = (torch.cumsum(pad, -1) - 1).clamp_min(0)
    impls = {"kernel": A.flash_attention, "plain": A.attention_xla, "sdpa": _sdpa_attention}
    layers = model.layers

    def logits(depth, impl):
        L.flash_attention = impl
        model.layers = nn.ModuleList(list(layers)[:depth])
        try:
            cache = L.make_kv_cache(cfg, B, S, torch.bfloat16, dev)
            with torch.inference_mode():
                return model(tokens, pos, cache, ks, torch.full((B,), S, device=dev), 0)[0, npad:].float()
        finally:
            L.flash_attention = A.flash_attention
            model.layers = layers

    for depth in (2, cfg.num_layers):
        out = {name: logits(depth, fn) for name, fn in impls.items()}
        if not torch.isfinite(out["kernel"]).all():
            fail("model: non-finite logits")
        ref = out["plain"]

        def rel(x):
            return ((x - ref).norm() / ref.norm()).item()

        def top1(x):
            return (x.argmax(-1) == ref.argmax(-1)).float().mean().item()

        print(f"phase model llama-3.1-8b prefill S={S} ({npad} pad) depth={depth}: logits vs plain "
              f"rel_rms kernel={rel(out['kernel']):.4g} sdpa={rel(out['sdpa']):.4g} "
              f"top1 kernel={top1(out['kernel']):.4f} sdpa={top1(out['sdpa']):.4f}", flush=True)
        if rel(out["kernel"]) > max(2 * rel(out["sdpa"]), 1e-3):
            fail("model: kernel forward strays past the bf16 noise floor")


def _launch_check(path, launches, need, forbid):
    print(f"launches on the {path}: {json.dumps(launches)}", flush=True)
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the {path}: {missing}")
    stray = [k for k in forbid if launches[k]]
    if stray:
        fail(f"kernels launched on the {path} that it must not run: {stray}")


def phase_service(service_bits, tag="bf16", ingest=True, need=ONE_SHOT_KERNELS, forbid=(),
                  force_spec=False):
    """The one-shot service: ingestion (once), then fused ``/generate`` and
    ``/query`` with default and greedy sampling, both decode loops (the
    speculative one forced when ``force_spec``), a long question (host path)
    and a >4096-token prompt (chunked prefill). The launch counters are
    zeroed before and read after: each kernel of ``need`` must have run and
    none of ``forbid``."""
    import numpy as np
    import torch

    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.engine import assemble_rag_tokens
    from rag_llm_k8s_tpu_torch.ops import _build

    svc, client, engine, store = service_bits
    rng = np.random.default_rng(0 if ingest else 1)
    dev = engine.device
    dim = store.dim
    _build.reset_launches()
    t0 = time.monotonic()
    if ingest:
        # three PDFs of ~250 words each: one chunk apiece through the encoder
        for i in range(3):
            r = client.post("/upload_pdf", files={"file": (f"doc{i}.pdf", make_pdf(words(rng, 250)))})
            if r.status_code != 200:
                fail(f"upload_pdf: {r.status_code} {r.get_json()}")
        n_pdf = store.ntotal
        # synthetic chunks up to the fused-path cap: unit vectors + short rows
        n_syn = 65536 - n_pdf
        vecs = rng.standard_normal((n_syn, dim), dtype=np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        meta = [{"filename": f"synthetic-{i // 16}.pdf", "chunk_id": i % 16, "text": words(rng, 30)}
                for i in range(n_syn)]
        store.add(list(vecs), meta)
        toks, _ = store.token_snapshot()
        print(f"phase service ingest: pdf_chunks={n_pdf} total_vectors={store.ntotal} "
              f"sidecar={tuple(toks.shape)} s={time.monotonic() - t0:.1f}", flush=True)

    greedy = SamplingConfig(do_sample=False)
    default = engine.sampling
    requests = [
        ("/generate", "which kernel tiles the shared memory?", default),
        ("/query", "how does the cache stream tokens?", default),
        ("/generate", "what bounds the decode latency?", greedy),
        ("/query", "where is the vector index kept?", greedy),
    ]
    served = []
    for route, question, sampling in requests:
        engine.sampling = sampling
        before = dataclasses.replace(engine.stats)
        launched = dict(_build.LAUNCHES)
        r = client.post(route, json_body={"prompt": question})
        body = r.get_json()
        if r.status_code != 200 or not isinstance(body.get("generated_text"), str):
            fail(f"{route}: {r.status_code} {body}")
        if "Document '" not in body.get("context", "") or not all(
            math.isfinite(v) for v in body["timings"].values()
        ):
            fail(f"{route}: malformed response {body}")
        st = engine.stats
        path = "speculative" if st.spec_verify_steps > before.spec_verify_steps else "vanilla"
        served.append(path)
        print(f"request {tag} {route} sampling={'greedy' if sampling is greedy else 'default'} "
              f"path={path} decode_tokens={st.decode_tokens - before.decode_tokens} "
              f"verify_steps={st.spec_verify_steps - before.spec_verify_steps} "
              f"launches={json.dumps({n: c - launched[n] for n, c in _build.LAUNCHES.items()})} "
              f"timings={json.dumps(body['timings'])}", flush=True)
    engine.sampling = default
    # both decode loops must have served a fused request
    for mode, path in (("off", "vanilla"), ("prompt_lookup", "speculative")):
        if path not in served or (force_spec and mode == "prompt_lookup"):
            ec = engine.engine_config
            engine.engine_config = dataclasses.replace(ec, speculative=mode)
            steps = engine.stats.spec_verify_steps
            r = client.post("/query", json_body={"prompt": "what does the warp block share?"})
            engine.engine_config = ec
            if r.status_code != 200:
                fail(f"forced {mode}: {r.status_code} {r.get_json()}")
            print(f"request {tag} /query forced speculative={mode} "
                  f"verify_steps={engine.stats.spec_verify_steps - steps} "
                  f"timings={json.dumps(r.get_json()['timings'])}", flush=True)
    # host path: a question whose tail overflows the 128-token fused bucket
    r = client.post("/generate", json_body={"prompt": words(rng, 40) + "?"})
    if r.status_code != 200:
        fail(f"long question: {r.status_code} {r.get_json()}")
    print(f"request {tag} /generate long-question path=host timings={json.dumps(r.get_json()['timings'])}",
          flush=True)
    # chunked prefill: a prompt past the 4096 bucket
    t = time.monotonic()
    long_prompt = [engine.config.bos_token_id] + list(rng.integers(3, 259, size=5000))
    out = engine.generate([long_prompt], max_new_tokens=32)[0]
    print(f"request {tag} engine.generate prompt=5001 tokens (chunked prefill) new_tokens={len(out)} "
          f"s={time.monotonic() - t:.2f}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _launch_check(f"{tag} one-shot path", launches, need, forbid)

    # the device-assembled prompt is token-identical to the host mirror
    question = "which kernel tiles the shared memory?"
    _, packed, k_eff, _ = svc._retrieve(question, allow_device=True)
    toks, lens = store.token_snapshot()
    a_ids, b_ids = svc._a_ids(), svc._b_ids(question)
    S = max(engine.engine_config.prompt_buckets)
    b_pad = torch.zeros(engine.RAG_TAIL_BUCKET, dtype=torch.int64, device=dev)
    b_pad[: len(b_ids)] = torch.tensor(b_ids, device=dev)
    dev_tokens, dev_mask = assemble_rag_tokens(
        torch.tensor(a_ids, device=dev), b_pad, len(b_ids), packed, toks, lens, S,
        min(3, k_eff), engine.pad_id,
    )
    host = packed.cpu().numpy()
    results = store.results_at(host[0, k_eff:].astype(np.int64), host[0, :k_eff])
    _, want_ids = svc._piecewise_prompt(question, results)
    m = dev_mask[0].bool()
    if dev_tokens[0][m].tolist() != list(want_ids):
        fail("device prompt assembly differs from the host mirror")
    print(f"phase service prompt assembly: device == host ({len(want_ids)} tokens)", flush=True)
    return launches


CONT_QUESTIONS = [
    "which kernel tiles the shared memory?",
    "how does the cache stream tokens?",
    "what bounds the decode latency?",
    "where is the vector index kept?",
    "what does the warp block share?",
    "how is the prefill chunk scheduled?",
    "which register holds the query?",
    "what limits the device bandwidth?",
]


def phase_continuous_service(service_bits, tag="bf16", block_size=16, need=CONTINUOUS_KERNELS, forbid=(),
                             plain_yardstick=True):
    """8 concurrent /generate requests through a ContinuousScheduler over
    the shared 8B model (interleaved admission, 64-token chunks, blocks of
    ``block_size``): 6 with default sampling, 2 greedy, the last greedy one
    submitted after the others so that it is the last admission and decodes
    in plain windows, as it does alone. Then that request alone: same text
    (and, with ``plain_yardstick``, again through the plain paged
    attention)."""
    import threading

    import torch

    from rag_llm_k8s_tpu_torch.ops import _build
    from rag_llm_k8s_tpu_torch.server.app import RagService, build_scheduler, create_app

    svc1, _, engine, store = service_bits
    ec = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=True,
                             kv_block_size=block_size, interleave_prefill=True, prefill_chunk_tokens=64)
    t = time.monotonic()
    sched = build_scheduler(engine, ec)
    cont = sched.engine
    svc = RagService(dataclasses.replace(svc1.config, engine=ec), engine, svc1.llm_tokenizer,
                     svc1.encoder, svc1.encoder_tokenizer, store, scheduler=sched)
    svc.ready = True
    client = create_app(svc).test_client()
    mode = client.get("/healthz").get_json()["engine_mode"]
    planes = [cont.arena.k, cont.arena.v, cont.arena.k_scale, cont.arena.v_scale]
    arena_gb = sum(t.numel() * t.element_size() for t in planes if t is not None) / 1e9
    print(f"phase continuous {tag} build: engine_mode={mode} pool_blocks={cont.kv_pool.usable_blocks()} "
          f"(+1 null) arena_gb={arena_gb:.2f} shared_weights={cont.model is engine.model} "
          f"s={time.monotonic() - t:.1f}", flush=True)
    if mode != "continuous-interleaved" or cont.model is not engine.model:
        fail(f"continuous service: engine_mode {mode!r}, weights shared {cont.model is engine.model}")

    greedy = {6, 7}
    greedy_sampling = dataclasses.replace(svc.config.sampling, do_sample=False)
    results = [None] * len(CONT_QUESTIONS)

    def answer_greedy(question):
        # per-request sampling is the Python API (/generate reads no
        # sampling field, as in the JAX service)
        try:
            return 200, svc.answer(question, sampling=greedy_sampling)
        except Exception as e:  # noqa: BLE001 — reported as the route would
            return 500, {"error": str(e)}

    def ask(i):
        if i in greedy:
            results[i] = answer_greedy(CONT_QUESTIONS[i])
            return
        r = client.post("/generate", json_body={"prompt": CONT_QUESTIONS[i]})
        results[i] = (r.status_code, r.get_json())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    before = dataclasses.replace(cont.stats)
    m0, _ = _scrape(client)
    t0 = time.monotonic()
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(CONT_QUESTIONS))]
    for th in threads[:-1]:
        th.start()
    time.sleep(1.0)  # the probe is the last admission
    threads[-1].start()
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if any(th.is_alive() for th in threads):
        fail("continuous service: a request did not finish within 900 s")
    st = cont.stats
    for i, (code, body) in enumerate(results):
        if code != 200 or not isinstance(body.get("generated_text"), str) or "Document '" not in body.get(
            "context", ""
        ):
            fail(f"continuous /generate {i}: {code} {body}")
        print(f"request {tag} continuous /generate {i} sampling={'greedy' if i in greedy else 'default'} "
              f"timings={json.dumps(body['timings'])}", flush=True)
    dec = st.decode_tokens - before.decode_tokens
    CONT_SUMMARY[tag] = {"requests": len(results), "wall_s": round(wall, 2), "decode_tok_per_s": round(dec / wall, 1),
                         "ms_per_window": round(1e3 * (st.decode_window_s + st.mixed_window_s - before.decode_window_s
                                                      - before.mixed_window_s) / max(st.windows - before.windows, 1), 1),
                         "arena_gb": round(arena_gb, 2)}
    print(f"phase continuous_service {tag}: requests={len(results)} wall_s={wall:.2f} decode_tokens={dec} "
          f"decode_tok_per_s={dec / wall:.1f} {_windows(st, before)} "
          f"preemptions={st.preemptions - before.preemptions} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    _launch_check(f"{tag} continuous path", launches, need, forbid)
    if cont.kv_pool.blocks_in_use():
        fail(f"continuous service: {cont.kv_pool.blocks_in_use()} blocks still in use after the drain")
    # the burst in the service's own scrape
    m1, scrape_ms = _scrape(client)
    ttft = m1[("rag_time_to_first_token_seconds_count", "")] - m0[("rag_time_to_first_token_seconds_count", "")]
    key = ("rag_continuous_step_seconds_count", '{phase="device_fetch"}')
    fetches = m1[key] - m0[key]
    in_use = m1[("rag_kv_pool_blocks_in_use", "")]
    print(f"phase continuous_service {tag} metrics: ttft_count+={ttft:g} device_fetch_count+={fetches:g} "
          f"windows+={st.windows - before.windows} kv_pool_blocks_in_use={in_use:g} "
          f"ttft_sum_s+={m1[('rag_time_to_first_token_seconds_sum', '')] - m0[('rag_time_to_first_token_seconds_sum', '')]:.3f} "
          f"scrape_ms={scrape_ms:.2f}", flush=True)
    if ttft != len(results) or fetches != st.windows - before.windows or in_use != 0:
        fail(f"continuous service metrics: TTFT count +{ttft} for {len(results)} requests, device_fetch "
             f"+{fetches} for {st.windows - before.windows} windows, {in_use} blocks in use")
    # the probe alone, through the kernels, then (yardstick, after the
    # counters were read) through the plain paged attention
    from rag_llm_k8s_tpu_torch.models import llama as L
    from rag_llm_k8s_tpu_torch.ops import attention as A

    solo = {}
    try:
        for impl in ("kernel", "plain") if plain_yardstick else ("kernel",):
            if impl == "plain":
                L.paged_decode_attention = A.paged_decode_attention_xla
                L.paged_chunk_attention = A.paged_chunk_attention_xla
            before = dataclasses.replace(cont.stats)
            launched = dict(_build.LAUNCHES)
            code, body = answer_greedy(CONT_QUESTIONS[-1])
            torch.cuda.synchronize()
            if code != 200:
                fail(f"continuous /generate alone ({impl}): {code} {body}")
            solo[impl] = body
            alone = {k: _build.LAUNCHES[k] - launched[k] for k in need}
            print(f"request {tag} continuous /generate alone through the {impl} paged attention (greedy, "
                  f"request {len(results) - 1}'s question): same_text_as_in_the_batch="
                  f"{body['generated_text'] == results[-1][1]['generated_text']} {_windows(cont.stats, before)} "
                  f"launches={json.dumps(alone)} timings={json.dumps(body['timings'])}", flush=True)
    finally:
        L.paged_decode_attention = A.paged_decode_attention
        L.paged_chunk_attention = A.paged_chunk_attention
    if solo["kernel"]["generated_text"] != results[-1][1]["generated_text"]:
        fail("continuous service: the greedy request alone differs from its text in the batch")
    svc.shutdown()
    cont.arena = None
    torch.cuda.empty_cache()
    return launches


def _windows(st, before):
    """Windows run since ``before``, each kind with its mean host-clock time
    from first launch to token fetch."""
    n_verify = st.spec_verify_steps - before.spec_verify_steps
    n_mixed = st.mixed_windows - before.mixed_windows
    out = []
    for kind, n, s in (("decode", st.windows - before.windows - n_mixed - n_verify,
                        st.decode_window_s - before.decode_window_s),
                       ("mixed", n_mixed, st.mixed_window_s - before.mixed_window_s),
                       ("verify", n_verify, st.verify_window_s - before.verify_window_s)):
        out.append(f"{kind}_windows={n} ms_per_{kind}_window={1e3 * s / max(n, 1):.1f}")
    return " ".join(out)


def phase_continuous_engine(service_bits, tag="bf16", block_size=16, decode_kernel="paged_decode_attention",
                            forbid=()):
    """Phase-separated admission (interleave off): four prompts of mixed
    length admitted as one group (two share a bucket and prefill together),
    32 greedy tokens each, through the prefill written into the blocks, the
    paged decode kernel and the block growth."""
    import numpy as np
    import torch

    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
    from rag_llm_k8s_tpu_torch.ops import _build

    engine = service_bits[2]
    ec = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=True,
                             kv_block_size=block_size, interleave_prefill=False)
    cont = ContinuousEngine(engine.config, engine.model, SamplingConfig(do_sample=False), ec,
                            engine.dtypes, engine.device, engine.pad_id)
    rng = np.random.default_rng(3)
    lens = [300, 450, 1500, 3000]
    prompts = [[engine.config.bos_token_id] + [int(x) for x in rng.integers(3, 259, n - 1)] for n in lens]
    _build.reset_launches()
    torch.cuda.synchronize()
    t = time.monotonic()
    out = {}
    for i, res in enumerate(cont.admit_many([(i, p, 32, None) for i, p in enumerate(prompts)])):
        if isinstance(res, BaseException):
            fail(f"continuous engine: admission {i} failed: {res!r}")
        if res[1] is not None:
            out[i] = res[1]
    t_admit = time.monotonic() - t
    while cont.has_active():
        out.update(dict(cont.step()))
    torch.cuda.synchronize()
    s = time.monotonic() - t
    launches = dict(_build.LAUNCHES)
    vocab = engine.config.vocab_size
    bad = [i for i in range(len(prompts))
           if i not in out or not 0 < len(out[i]) <= 32 or not all(0 <= x < vocab for x in out[i])]
    print(f"phase continuous_engine {tag} (phase-separated admission): prompt_lens={lens} "
          f"new_tokens={[len(out.get(i, [])) for i in range(len(prompts))]} prefill_calls={cont.stats.prefill_calls} "
          f"{_windows(cont.stats, type(cont.stats)())} "
          f"admit_s={t_admit:.2f} s={s:.2f} launches={json.dumps(launches)}", flush=True)
    if bad:
        fail(f"continuous engine: malformed streams for prompts {bad}")
    if launches["flash_attention"] <= 0 or launches[decode_kernel] <= 0:
        fail("continuous engine: admission prefill or paged decode never launched")
    if any(launches[k] for k in forbid):
        fail(f"continuous engine: a kernel of {forbid} launched")
    if cont.kv_pool.blocks_in_use():
        fail(f"continuous engine: {cont.kv_pool.blocks_in_use()} blocks still in use")
    cont.arena = None
    torch.cuda.empty_cache()


RES_QUESTIONS = CONT_QUESTIONS[:4]
# case (a)'s fault comes at the first window where this many rows decode,
# one of them with this many tokens emitted (the prompts prefill 64 tokens a
# window, so the others are still prefilling or just decoding)
FAULT_ROWS, FAULT_EMITTED = 2, 8


def phase_resilience(service_bits, max_new: int = 48):
    """The resilience layer on the full-width 8B service, through the HTTP
    test client, one line per case: (a) a ``decode_step`` fault in the
    middle of a burst of 4 greedy requests on the continuous service (every
    request 200, one reset, every request in flight resubmitted with the
    tokens it had emitted, no block left, ``complete.stream_fnv`` = the
    delivered stream's hash; the whole streams against an unfaulted burst
    printed, not gated: a resumed row's KV comes from a prefill); (b) an
    ``insert`` fault on a phase-separated admission; (c) a second fault that
    uses up the retries: 500, no block left; (d) real resets opening the
    breaker: ``/healthz`` 503, ``?live=1`` 200, 503 ``breaker_open`` with
    ``Retry-After``, 200 once the window has passed; (e) deadlines: 504 at
    ``decode`` with a decoding row evicted (it holds tokens) and its blocks
    back within one window, a header deadline,
    400 for malformed values; (f) the admission gate at 2 running + 1
    queued: 6 requests behind a barrier give 3 x 200 and 3 x 429; (g) the
    drain: 202, the request in flight 200, new work 503 ``draining``,
    ``/healthz`` draining, ``exit_fn`` called; (h) a ``generate`` fault on
    the one-shot service: one 500, then 200. Each case gets its own
    ``RagService`` (breaker, gate, drain) over the shared continuous
    scheduler, greedy, ``max_new`` tokens. The incident spool: every case's
    service spools into one temporary directory, removed at the end; (d)
    must spool a ``reset_storm`` and a ``breaker_open`` bundle and (e) one
    ``deadline_exceeded`` bundle for its two 504s (the second inside the
    cooldown is suppressed), each listed by ``/debug/incidents`` and loaded
    through ``?id=`` with its journal, metrics snapshot, config fingerprint
    and traces."""
    import shutil
    import tempfile
    import threading

    import torch

    from rag_llm_k8s_tpu_torch.core.config import ResilienceConfig, SamplingConfig
    from rag_llm_k8s_tpu_torch.obs import flight
    from rag_llm_k8s_tpu_torch.ops import _build
    from rag_llm_k8s_tpu_torch.resilience import faults
    from rag_llm_k8s_tpu_torch.server.app import RagService, build_scheduler, create_app

    svc1, client1, engine, store = service_bits
    greedy = SamplingConfig(do_sample=False, max_new_tokens=max_new)
    ec = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=True, kv_block_size=16,
                             interleave_prefill=True, prefill_chunk_tokens=64)
    base_res = ResilienceConfig()
    sched = build_scheduler(engine, ec, base_res)
    cont = sched.engine
    cont.sampling = greedy  # /generate reads no sampling field: the engine's own is greedy here
    made = []
    spool = tempfile.mkdtemp(prefix="incidents_")
    # the read-only /debug routes armed (TPU_RAG_DEBUG=1), the spool here
    fl = dataclasses.replace(svc1.config.flight, spool_dir=spool, debug_endpoints=True)

    def service(scheduler=sched, engine_config=ec, **res):
        svc = RagService(dataclasses.replace(svc1.config, engine=engine_config, flight=fl,
                                             resilience=dataclasses.replace(base_res, **res)),
                         engine, svc1.llm_tokenizer, svc1.encoder, svc1.encoder_tokenizer, store, scheduler=scheduler)
        svc.ready = True
        made.append(svc)
        return svc, create_app(svc).test_client()

    def post(client, body, headers=None):
        r = client.post("/generate", json_body=body, headers=headers)
        return r.status_code, r.get_json(), r.headers.get("Retry-After")

    def burst(client, questions, barrier=True):
        out = [None] * len(questions)
        start = threading.Barrier(len(questions), timeout=60)

        def ask(i):
            if barrier:
                start.wait()
            out[i] = post(client, {"prompt": questions[i]})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(questions))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if any(th.is_alive() for th in threads):
            fail("resilience: a request did not finish within 600 s")
        return out

    def bundles(svc, client, case, want):
        """The case's service spooled ``want`` (trigger -> bundles) by its
        own count, and ``/debug/incidents`` lists them, each loaded through
        ``?id=`` (the directory also holds the earlier cases' bundles)."""
        fam = svc.metrics.get_family("rag_incident_bundles_total")
        got = {t: int(fam.labels(trigger=t).value) for t in want}
        listed = client.get("/debug/incidents").get_json()["incidents"]
        if not {t for t in want} <= {b["trigger"] for b in listed}:
            fail(f"resilience ({case}): /debug/incidents lists {[b['trigger'] for b in listed]}")
        for b in listed:
            if b["trigger"] in want:
                full = client.get(f"/debug/incidents?id={b['id']}").get_json()
                keys = ("journal", "metrics", "config_fingerprint", "traces")
                if not all(full.get(k) is not None for k in keys) or not full["config_fingerprint"].get("sha256"):
                    fail(f"resilience ({case}): bundle {b['id']} lacks one of {keys}")
                print(f"resilience ({case}) incident bundle {b['id']}: journal_events={len(full['journal'])} "
                      f"metrics={len(full['metrics'])} traces={len(full['traces'])} "
                      f"config_sha256={full['config_fingerprint']['sha256'][:12]}", flush=True)
        if got != want:
            fail(f"resilience ({case}): incident bundles {got}, want {want}")

    def no_blocks(case):
        t = time.monotonic()
        while cont.kv_pool.blocks_in_use() and time.monotonic() - t < 5.0:
            time.sleep(0.01)
        if cont.kv_pool.blocks_in_use():
            fail(f"resilience ({case}): {cont.kv_pool.blocks_in_use()} blocks still in use")

    # capture each delivered stream (ids) by request id
    delivered = {}
    real_deliver = sched._deliver

    def deliver(item, tokens):
        real_deliver(item, tokens)
        delivered[item.request_id] = list(item.result)

    sched._deliver = deliver
    # arm a site at a given window of the continuous engine, or at the first
    # window where plan["when"]() holds
    plan = {"at": {}, "when": None, "snap": None, "t_fault": None, "t_resumed": None, "window": 0}
    real_step = cont.step

    def step():
        plan["window"] += 1
        site = plan["at"].pop(plan["window"], None)
        if site is None and plan["when"] is not None and plan["when"]():
            site, plan["when"] = "decode_step", None
        if site is not None:
            # what each row had emitted when the window failed
            plan["snap"] = {s.request_id: list(s.tokens) for s in cont.slots if s.active}
            plan["done_before"] = len(flight.recorder().snapshot(etype="complete"))
            plan["fault_window"] = plan["window"]
            plan["t_fault"] = time.monotonic()
            faults.arm(site)
        out = real_step()
        if plan["t_fault"] is not None and plan["t_resumed"] is None:
            plan["t_resumed"] = time.monotonic()
        return out

    cont.step = step
    try:
        # (a) a decode fault mid-burst
        svc, client = service()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        clean = burst(client, RES_QUESTIONS)
        clean_wall = time.monotonic() - t0
        if any(c != 200 for c, _, _ in clean):
            fail(f"resilience (a) unfaulted burst: {[(c, b) for c, b, _ in clean]}")
        clean_ids = dict(delivered)
        delivered.clear()
        flight.recorder().clear()
        resubmitted = svc.metrics.get_family("rag_inflight_retries_total").labels(outcome="resubmitted")
        resets0, resub0 = svc.metrics.counter("rag_engine_resets_total").value, resubmitted.value
        _build.reset_launches()
        plan.update(window=0, at={}, snap=None, t_fault=None, t_resumed=None, when=lambda: (
            sum(1 for s in cont.slots if s.active) >= FAULT_ROWS
            and max(len(s.tokens) for s in cont.slots if s.active) >= FAULT_EMITTED))
        t0 = time.monotonic()
        faulted = burst(client, RES_QUESTIONS)
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        if any(c != 200 for c, _, _ in faulted):
            fail(f"resilience (a): {[(c, b) for c, b, _ in faulted]}")
        if plan["snap"] is None:
            fail(f"resilience (a): in {plan['window']} windows never {FAULT_ROWS} rows decoded at once")
        in_flight = len(RES_QUESTIONS) - plan["done_before"]
        resets = flight.recorder().snapshot(etype="reset")
        resub = [e for e in flight.recorder().snapshot(etype="resubmit") if e["outcome"] == "resubmitted"]
        no_blocks("a")
        rids = [b["request_id"] for _, b, _ in faulted]
        bad_prefix = [r for r, toks in plan["snap"].items() if delivered.get(r, [])[:len(toks)] != toks]
        bad_fnv = [r for r in rids if [e["stream_fnv"] for e in flight.recorder().snapshot(request_id=r, etype="complete")]
                   != [flight.stream_hash(delivered[r])]]
        same = sum(delivered[r] == clean_ids.get(c["request_id"]) for r, (_, c, _) in zip(rids, clean))
        print(f"resilience (a) decode_step fault at window {plan['fault_window']} of a burst of 4: "
              f"codes={[c for c, _, _ in faulted]} resets={len(resets)} in_flight={in_flight} "
              f"decoding_rows={resets[0]['in_flight'] if resets else None} "
              f"resubmitted={len(resub)} n_emitted={[e['n_emitted'] for e in resub]} "
              f"blocks_in_use={cont.kv_pool.blocks_in_use()} "
              f"fault_to_resumed_window_ms={1e3 * (plan['t_resumed'] - plan['t_fault']):.1f} "
              f"total_ms={[b['timings']['total_ms'] for _, b, _ in faulted]} "
              f"unfaulted_total_ms={[b['timings']['total_ms'] for _, b, _ in clean]} "
              f"wall_s={wall:.2f} unfaulted_wall_s={clean_wall:.2f} "
              f"streams_equal_to_unfaulted={same}/4 (printed, not gated) launches={json.dumps(launches)} "
              f"rag_engine_resets_total+={svc.metrics.counter('rag_engine_resets_total').value - resets0:g} "
              f"rag_inflight_retries_total{{outcome=resubmitted}}+={resubmitted.value - resub0:g}",
              flush=True)
        if (svc.metrics.counter("rag_engine_resets_total").value - resets0 != 1
                or resubmitted.value - resub0 != in_flight):
            fail("resilience (a): the scrape's resets and resubmissions do not match the recovery")
        if len(resets) != 1 or len(resub) != in_flight or in_flight < 2 or not plan["snap"]:
            fail(f"resilience (a): {len(resets)} resets, {len(resub)} resubmitted of {in_flight} in flight, "
                 f"{len(plan['snap'] or {})} decoding (want 1, all, >= 2, >= 1)")
        if bad_prefix or bad_fnv:
            fail(f"resilience (a): streams not continued from their emitted tokens {bad_prefix} "
                 f"or stream_fnv mismatches {bad_fnv}")
        _launch_check("resilience recovery path", launches, ("paged_decode_attention", "paged_chunk_attention"),
                      ())

        # (c) a second fault uses up the one retry
        svc, client = service()
        plan.update(window=0, at={}, t_fault=None)
        faults.arm("decode_step", times=2)
        code, body, _ = post(client, {"prompt": RES_QUESTIONS[0]})
        no_blocks("c")
        print(f"resilience (c) decode_step x2 with one retry: code={code} body={json.dumps(body)} "
              f"blocks_in_use={cont.kv_pool.blocks_in_use()}", flush=True)
        if code != 500 or body != {"error": "injected fault at site 'decode_step'"} or faults.armed():
            fail(f"resilience (c): {code} {body}")

        # (d) real resets inside a short window open the breaker
        svc, client = service(breaker_window_s=10.0)
        sched.retries = svc.breaker.threshold
        plan.update(window=0, at={2: "decode_step", 4: "decode_step", 6: "decode_step"}, t_fault=None)
        try:
            code, body, _ = post(client, {"prompt": RES_QUESTIONS[1]})
        finally:
            sched.retries = base_res.inflight_retries
            plan["at"] = {}
        h = client.get("/healthz")
        live = client.get("/healthz?live=1")
        shed = post(client, {"prompt": RES_QUESTIONS[1]})
        wait_s = svc.breaker.retry_after_s()
        time.sleep(wait_s + 0.1)
        h2 = client.get("/healthz")
        after = post(client, {"prompt": RES_QUESTIONS[1]})
        print(f"resilience (d) {svc.breaker.threshold} resets in {svc.breaker.window_s:.0f} s: request={code} "
              f"healthz={h.status_code} {json.dumps({k: h.get_json()[k] for k in ('status', 'breaker_open', 'breaker_recent_resets')})} "
              f"live={live.status_code} generate={shed[0]} {json.dumps(shed[1])} retry_after={shed[2]} "
              f"waited_s={wait_s:.2f} then healthz={h2.status_code} generate={after[0]}", flush=True)
        if (code != 200 or h.status_code != 503 or h.get_json()["breaker_open"] is not True or live.status_code != 200
                or shed[0] != 503 or shed[1].get("reason") != "breaker_open" or not shed[2] or int(shed[2]) < 1
                or h2.status_code != 200 or after[0] != 200):
            fail("resilience (d): the breaker did not open and heal as it should")
        bundles(svc, client, "d", {"reset_storm": 1, "breaker_open": 1})

        # (e) deadlines: two unfaulted runs of one request place its decode
        # (flight events: ``admit`` carries the first token, then
        # ``complete``); the deadline falls half way between the later run's
        # first token and the earlier run's end, the span both runs were
        # decoding in. Runs of one request differ by ~15-30 % on one host
        # (first tokens 1,627 and 1,885 ms in one call; a deadline placed 30 %
        # into the faster run's decode expired before a third run's first
        # token). Each evicted row must hold tokens: an expiry before the
        # first token would evict a prefilling row, which also answers 504 at
        # stage "decode"
        svc, client = service()
        placed = []
        for _ in range(2):
            flight.recorder().clear()
            code, body, _ = post(client, {"prompt": RES_QUESTIONS[2]})
            if code != 200:
                fail(f"resilience (e): the unfaulted request: {code} {body}")
            evs = {e["type"]: e["t_ms"] for e in flight.recorder().timeline(body["request_id"])["events"]}
            pre_ms = body["timings"]["total_ms"] - evs["complete"]  # before the scheduler: retrieve, assemble
            placed.append((pre_ms + evs["admit"], pre_ms + evs["complete"]))
        first_ms, done_ms = max(f for f, _ in placed), min(d for _, d in placed)
        if done_ms <= first_ms:
            fail(f"resilience (e): the two runs share no decoding span: {placed}")
        dl_ms = round(first_ms + 0.5 * (done_ms - first_ms))
        flight.recorder().clear()
        t = time.monotonic()
        code, body, _ = post(client, {"prompt": RES_QUESTIONS[2], "deadline_ms": dl_ms})
        t504 = time.monotonic()
        # the row is evicted before its error is delivered: its blocks are
        # back by the time the 504 is (allow one window)
        while cont.kv_pool.blocks_in_use() and time.monotonic() - t504 < 0.1:
            time.sleep(0.001)
        freed_ms = (time.monotonic() - t504) * 1e3
        no_blocks("e")
        hcode, hbody, _ = post(client, {"prompt": RES_QUESTIONS[2]}, headers={"x-request-deadline-ms": str(dl_ms)})
        no_blocks("e")  # the header request's eviction may trail its 504
        evicted = [e["n_tokens"] for e in flight.recorder().snapshot(etype="evict")]
        bad = [post(client, {"prompt": "x", "deadline_ms": v})[0] for v in (0, "x", "inf")]
        print(f"resilience (e) deadline_ms={dl_ms} (two unfaulted runs: first token at "
              f"{[round(f) for f, _ in placed]} ms, done at {[round(d) for _, d in placed]} ms): "
              f"code={code} body={json.dumps(body)} answered_after_ms="
              f"{(t504 - t) * 1e3:.0f} blocks_back_within_ms={freed_ms:.1f} header deadline: {hcode} "
              f"{json.dumps(hbody)} evicted_rows_tokens={evicted} malformed 0/'x'/'inf': {bad}", flush=True)
        if ((code, body.get("stage")) != (504, "decode") or (hcode, hbody.get("stage")) != (504, "decode")
                or bad != [400] * 3 or freed_ms > 100.0):
            fail("resilience (e): deadlines not honoured")
        if len(evicted) != 2 or min(evicted) < 1:
            fail(f"resilience (e): evicted rows held {evicted} tokens; want two rows evicted mid-decode")
        # two 504s, one bundle: the header request's fell inside the cooldown
        bundles(svc, client, "e", {"deadline_exceeded": 1})

        # (f) the admission gate: 2 running + 1 queued
        svc, client = service(admission_max_concurrency=2, admission_max_queue=1)
        out = burst(client, CONT_QUESTIONS[:6])
        codes = sorted(c for c, _, _ in out)
        shed = [(b, ra) for c, b, ra in out if c == 429]
        print(f"resilience (f) 6 requests at 2 running + 1 queued: codes={codes} "
              f"shed={json.dumps(shed[:1])}", flush=True)
        if codes != [200] * 3 + [429] * 3 or any(int(ra) < 1 or b.get("reason") != "queue_full" for b, ra in shed):
            fail(f"resilience (f): {out}")

        # (g) the drain
        svc, client = service()
        exits = []
        svc.lifecycle.exit_fn = lambda: exits.append(time.monotonic())
        inflight = []
        th = threading.Thread(target=lambda: inflight.append(post(client, {"prompt": RES_QUESTIONS[3]})))
        th.start()
        t = time.monotonic()
        while svc.admission.active == 0 and time.monotonic() - t < 30:
            time.sleep(0.005)
        d = client.post("/drain")
        t_drain = time.monotonic()
        new = post(client, {"prompt": RES_QUESTIONS[3]})
        h = client.get("/healthz")
        th.join(timeout=600)
        drained = svc.lifecycle.wait_drained(60)
        print(f"resilience (g) drain with one request in flight: drain={d.status_code} {json.dumps(d.get_json())} "
              f"new={new[0]} {json.dumps(new[1])} healthz={h.status_code} {h.get_json()['status']} "
              f"in_flight={inflight[0][0] if inflight else None} state={svc.lifecycle.state} "
              f"drain_to_drained_s={(exits[0] - t_drain) if exits else float('nan'):.2f} exit_fn_calls={len(exits)}",
              flush=True)
        if (d.status_code != 202 or new[0] != 503 or new[1].get("reason") != "draining" or h.status_code != 503
                or h.get_json()["status"] != "draining" or not inflight or inflight[0][0] != 200 or not drained
                or len(exits) != 1):
            fail("resilience (g): the drain did not run as it should")

        # (b) an insert fault on a phase-separated admission
        for s in made:
            s.retrieve_coalescer.shutdown()
        made.clear()
        sched._deliver = real_deliver
        cont.step = real_step
        sched.shutdown()
        cont.arena = None
        torch.cuda.empty_cache()
        ec_ps = dataclasses.replace(ec, interleave_prefill=False)
        sched = build_scheduler(engine, ec_ps, base_res)
        cont = sched.engine
        cont.sampling = greedy
        svc, client = service(scheduler=sched, engine_config=ec_ps)
        flight.recorder().clear()
        faults.arm("insert")
        code, body, _ = post(client, {"prompt": RES_QUESTIONS[0]})
        resub = flight.recorder().snapshot(etype="resubmit")
        resets = flight.recorder().snapshot(etype="reset")
        code2, body2, _ = post(client, {"prompt": RES_QUESTIONS[0]})
        no_blocks("b")
        print(f"resilience (b) insert fault on a phase-separated admission: code={code} resets={len(resets)} "
              f"resubmits={[(e['outcome'], e['n_emitted']) for e in resub]} blocks_in_use="
              f"{cont.kv_pool.blocks_in_use()} same_text_as_unfaulted="
              f"{body.get('generated_text') == body2.get('generated_text')} (printed, not gated)", flush=True)
        if code != 200 or len(resets) != 1 or [(e["outcome"], e["n_emitted"]) for e in resub] != [("resubmitted", 0)]:
            fail(f"resilience (b): {code} {body}")
        sched.shutdown()
        cont.arena = None

        # (h) a generate fault on the one-shot service (a long question takes
        # the host path, through the BatchScheduler into engine.generate)
        rng = __import__("numpy").random.default_rng(5)
        q = words(rng, 40) + "?"
        samp = engine.sampling
        engine.sampling = dataclasses.replace(samp, max_new_tokens=max_new)
        try:
            faults.arm("generate")
            first = post(client1, {"prompt": q})
            second = post(client1, {"prompt": q})
        finally:
            engine.sampling = samp
        print(f"resilience (h) generate fault on the one-shot service: first={first[0]} {json.dumps(first[1])} "
              f"then={second[0]}", flush=True)
        if first[:2] != (500, {"error": "injected fault at site 'generate'"}) or second[0] != 200:
            fail("resilience (h): the one-shot service did not fail once and then serve")
    finally:
        faults.clear()
        for s in made:
            s.retrieve_coalescer.shutdown()
        sched.shutdown()
        cont.arena = None
        torch.cuda.empty_cache()
        shutil.rmtree(spool, ignore_errors=True)
    return launches


GOODPUT_TENANTS = ("tenant-a", "tenant-b")
GOODPUT_MAX_READING = 1.05  # no card exceeds its peak: a reading past this is wrong arithmetic
GOODPUT_RECORDS = ("record_prefill", "record_prefill_px", "record_decode", "record_mixed", "record_verify",
                   "record_preempt_stall")


def _armed(svc):
    """The service with its read-only ``/debug`` routes armed
    (``TPU_RAG_DEBUG=1``)."""
    svc.config = dataclasses.replace(svc.config, flight=dataclasses.replace(svc.config.flight,
                                                                            debug_endpoints=True))
    return svc


def _kind_delta(before, after):
    """Per window kind between two ledger states: windows, busy seconds and
    the busy-weighted mean MFU and bandwidth use of the windows between."""
    out = {}
    for kind, ks in after["kinds"].items():
        b = before["kinds"].get(kind, {})
        busy = ks["busy_s"] - b.get("busy_s", 0.0)
        n = int(ks["windows"] - b.get("windows", 0))
        if n:
            out[kind] = {"windows": n, "busy_s": busy,
                         "mfu": (ks["mfu_w"] - b.get("mfu_w", 0.0)) / busy if busy > 0 else 0.0,
                         "bw_util": (ks["bw_w"] - b.get("bw_w", 0.0)) / busy if busy > 0 else 0.0}
    return out


def _rounded(kinds):
    return {k: {f: round(v, 6) if isinstance(v, float) else v for f, v in ks.items()} for k, ks in kinds.items()}


def _timed_ledger(cont):
    """Wrap the engine's ``record_*`` calls and its ``goodput_window``
    journaling with ``perf_counter``: ``{"record": [s...], "journal": [s...]}``
    per call. Returns the samples and an undo."""
    led = cont.ledger
    samples = {"record": [], "journal": []}
    real = {n: getattr(led, n) for n in GOODPUT_RECORDS}
    real_journal = cont._journal_window

    def wrap(fn, into):
        def timed_call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                samples[into].append(time.perf_counter() - t)
        return timed_call

    for n, fn in real.items():
        setattr(led, n, wrap(fn, "record"))
    cont._journal_window = wrap(real_journal, "journal")

    def undo():
        for n, fn in real.items():
            setattr(led, n, fn)
        cont._journal_window = real_journal

    return samples, undo


def _goodput_burst(svc, client, questions, tenants, hold=False):
    """The questions at once from threads, each under its tenant
    (``tenant_id``); fails unless every one is a 200 with chip time. With
    ``hold``, an engine task holds the scheduler until every request is
    queued, so the burst admits as one group (``_held_burst``)."""
    import threading

    out = [None] * len(questions)
    gate = threading.Event()
    if hold:
        svc.scheduler.run_on_engine(lambda e: gate.wait(120))

    def ask(i):
        r = client.post("/generate", json_body={"prompt": questions[i], "tenant_id": tenants[i % len(tenants)]})
        out[i] = (r.status_code, r.get_json())

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(questions))]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 60
    while hold and time.monotonic() < deadline:
        with svc.scheduler._queue.mutex:
            queued = sum(1 for it in svc.scheduler._queue.queue if it is not None and not callable(it))
        if queued >= len(questions) or not any(th.is_alive() for th in threads):
            break
        time.sleep(0.005)
    gate.set()
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads):
        fail("goodput: a burst request did not finish within 600 s")
    for i, (code, body) in enumerate(out):
        if code != 200 or body["timings"].get("chip_ms", 0.0) <= 0:
            fail(f"goodput burst request {i}: {code} {body}")
    return [b for _, b in out]


def _check_windows(events, what):
    """Every ``goodput_window`` event's categories sum to its ``dur_ms``."""
    from rag_llm_k8s_tpu_torch.obs import goodput

    bad = [e for e in events if abs(sum(e.get(c, 0.0) for c in goodput.WINDOW_CATEGORIES) - e["dur_ms"]) > 0.01]
    if not events or bad:
        fail(f"goodput ({what}): {len(bad)} of {len(events)} windows do not sum to their duration: {bad[:2]}")


def _check_readings(kinds, want, what):
    """MFU and bandwidth use of each kind in ``want`` present and <= 1.05."""
    for kind in want:
        k = kinds.get(kind)
        if k is None or k["windows"] < 1:
            fail(f"goodput ({what}): no {kind} windows ({kinds})")
        if not 0.0 < k["bw_util"] <= GOODPUT_MAX_READING or not 0.0 < k["mfu"] <= GOODPUT_MAX_READING:
            fail(f"goodput ({what}): {kind} reads MFU {k['mfu']} and bandwidth use {k['bw_util']}: past the "
                 f"card's peak (or none)")


def phase_goodput(service_bits, max_new: int = 48):
    """The goodput ledger, SLOs, tenants and device gauges on the card, over
    the one-shot service and continuous services on its model (no model is
    loaded). The ledger reads the H100's peaks (989 dense bf16 TFLOP/s,
    3,350 GB/s) and the host clock of each sync window.

    (a) One-shot: ``phase_query_latency``'s solo ``/query`` (the fused path)
    under two tenants: the ``oneshot`` kind's MFU and bandwidth use
    (<= 1.05), each response's ``chip_ms`` within 2% of its
    ``generate_ms``, the tenants' chip seconds in the scrape. (b)
    Continuous, paged: a burst of 8 ``/generate`` at ``max_new`` tokens
    under two tenants through interleaved admission, and 4 greedy ones
    through phase-separated admission (their journal is what
    ``phase_replay`` re-drives): the requests' chip time against
    ``busy_seconds()`` (within 5%), every window's categories against its
    duration, ``decode``, ``mixed`` and ``prefill`` MFU and bandwidth use
    (<= 1.05), the tenants' chip seconds against the requests'. (c) The
    ledger's own cost: its ``record_*`` calls and their journaling timed
    with ``perf_counter`` per window, against the window's ms. (d) ``/slo``
    on both services. (e) The device gauges with the service idle against
    ``torch.cuda.memory_allocated(0)`` and ``total_memory``."""
    import torch

    from rag_llm_k8s_tpu_torch.obs import flight

    svc1, client1, engine, _ = service_bits
    _armed(svc1)
    # (a) the one-shot service's fused path, as phase_query_latency served it
    if "after" not in ONESHOT_LEDGER:
        fail("goodput (a): phase_query_latency recorded no solo requests")
    off, chip = ONESHOT_LEDGER["off"], ONESHOT_LEDGER["chip"]
    report = client1.get("/debug/goodput").get_json()
    kinds = _kind_delta(ONESHOT_LEDGER["before"], ONESHOT_LEDGER["after"])
    tenants = client1.get("/debug/tenants").get_json()
    print(f"phase goodput one-shot ({ONESHOT_LEDGER['n']} solo /query of phase_query_latency): "
          f"oneshot_this_phase={json.dumps(_rounded(kinds).get('oneshot'))} "
          f"oneshot_all_run={json.dumps(report['kinds'].get('oneshot'))} chip_ms_over_generate_ms_minus_1={off} "
          f"tenant_chip_s={json.dumps(chip)} tracker={json.dumps(tenants['tracker']['counts'])} "
          f"peaks_tflops_gbs={engine.ledger.roofline.peak_flops / 1e12:g}/{engine.ledger.roofline.peak_bytes / 1e9:g}",
          flush=True)
    _check_readings(kinds, ("oneshot",), "one-shot")
    if max(abs(x) for x in off) > 0.02:
        fail(f"goodput one-shot: chip_ms off generate_ms by {off}")
    if min(chip.values()) <= 0 or not set(GOODPUT_TENANTS) <= set(tenants["tracker"]["counts"]):
        fail(f"goodput one-shot: tenants' chip seconds {chip}, tracker {tenants['tracker']}")

    # (b) continuous, paged: interleaved, then phase-separated admission
    ec = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=True, kv_block_size=16,
                             interleave_prefill=True, prefill_chunk_tokens=64)
    cost = {"record": [], "journal": []}
    windows_ms = []
    for tag, cec, questions, want in (
        ("interleaved", ec, CONT_QUESTIONS, ("decode", "mixed")),
        ("phase-separated", dataclasses.replace(ec, interleave_prefill=False), CONT_QUESTIONS[:4],
         ("decode", "prefill")),
    ):
        svc, client, cont = _cont_service(service_bits, cec, max_new=max_new, greedy=tag == "phase-separated")
        _armed(svc)
        sched = svc.scheduler
        samples, undo = _timed_ledger(cont)
        seq0 = flight.recorder().events_emitted
        try:
            bodies = _goodput_burst(svc, client, questions, GOODPUT_TENANTS, hold=tag == "phase-separated")
        finally:
            undo()
        torch.cuda.synchronize()
        events = [e for e in flight.recorder().snapshot(etype="goodput_window") if e["seq"] >= seq0]
        _check_windows(events, tag)
        chip_s = sum(b["timings"]["chip_ms"] for b in bodies) / 1e3
        busy = sched.busy_seconds()
        attributed = cont.ledger.state()["attributed_s"]  # a fresh engine: these requests' alone
        rep = client.get("/debug/goodput").get_json()
        kinds = _kind_delta({"kinds": {}}, cont.ledger.state())
        tchip = {t: svc.metrics.get_family("rag_tenant_chip_seconds_total").labels(tenant=t).value
                 for t in GOODPUT_TENANTS}
        slo = client.get("/slo?force=1").get_json()
        print(f"phase goodput continuous {tag}: requests={len(bodies)} requests_chip_s={chip_s:.4f} "
              f"ledger_attributed_s={attributed:.4f} busy_s={busy:.4f} ratio={chip_s / busy:.4f} "
              f"windows={len(events)} kinds={json.dumps(_rounded(kinds))} "
              f"categories_s={json.dumps({c: v['chip_s'] for c, v in rep['categories'].items()})} "
              f"busy_frac={rep['busy_frac']} tenant_chip_s={json.dumps({t: round(v, 4) for t, v in tchip.items()})} "
              f"record_us_per_window={1e6 * sum(samples['record']) / max(len(events), 1):.1f} "
              f"journal_us_per_window={1e6 * sum(samples['journal']) / max(len(events), 1):.1f}", flush=True)
        for e in slo["slos"]:
            print(f"phase goodput continuous {tag} /slo: {e['name']} compliant={e['compliant']} "
                  f"burn={json.dumps(e['burn_rate'])} events={json.dumps(e['window_events'])}", flush=True)
        if abs(chip_s - busy) > 0.05 * busy:
            fail(f"goodput continuous {tag}: attributed {chip_s:.4f} s against busy {busy:.4f} s")
        _check_readings(kinds, want, f"continuous {tag}")
        # each request's chip_ms is rounded to 1e-4 ms before its tenant's counter adds it
        if abs(sum(tchip.values()) - attributed) > 1e-6 * len(bodies):
            fail(f"goodput continuous {tag}: tenants' chip seconds {tchip} against the ledger's {attributed:.7f}")
        if cont.kv_pool.blocks_in_use():
            fail(f"goodput continuous {tag}: {cont.kv_pool.blocks_in_use()} blocks still in use")
        if tag == "phase-separated":
            rids = {b["request_id"] for b in bodies}
            REPLAY_SOURCE.update(events=[e for e in flight.recorder().snapshot() if e["seq"] >= seq0], ec=cec,
                                 max_new=max_new, tokens={d["rid"]: d["emitted"] for d in DELIVERED["phase_goodput"]
                                                          if d["rid"] in rids})
        cost["record"] += samples["record"]
        cost["journal"] += samples["journal"]
        windows_ms += [e["dur_ms"] for e in events if e["kind"] == "decode"]
        svc.shutdown()
        cont.arena = None
        torch.cuda.empty_cache()

    # (c) the ledger's own cost, per window, against a decode window's ms
    n = max(len(cost["record"]), 1)
    rec_us, jour_us = 1e6 * sum(cost["record"]) / n, 1e6 * sum(cost["journal"]) / n
    dec_ms = statistics.median(windows_ms) if windows_ms else float("nan")
    print(f"phase goodput ledger cost: windows={len(cost['record'])} record_us_per_window={rec_us:.1f} "
          f"record_p99_us={1e6 * _pct(cost['record'], 99):.1f} journal_us_per_window={jour_us:.1f} "
          f"decode_window_ms_median={dec_ms:.2f} share_of_a_decode_window="
          f"{(rec_us + jour_us) / 1e3 / dec_ms:.5f} (the JAX package's contract: <= 0.02 at B = 8)", flush=True)

    # (d) /slo on the one-shot service, after its requests
    slo = client1.get("/slo?force=1").get_json()
    for e in slo["slos"]:
        print(f"phase goodput one-shot /slo: {e['name']} compliant={e['compliant']} "
              f"burn={json.dumps(e['burn_rate'])} events={json.dumps(e['window_events'])} "
              f"threshold_bucket_s={e.get('threshold_bucket_s')}", flush=True)

    # (e) the device gauges with the service idle
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated(0)
    m, _ = _scrape(client1)
    a1 = torch.cuda.memory_allocated(0)
    use, lim = m[("rag_device_hbm_bytes_in_use", '{device="0"}')], m[("rag_device_hbm_bytes_limit", '{device="0"}')]
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"phase goodput devices: rag_device_hbm_bytes_in_use={use:.0f} memory_allocated_before={a0} "
          f"after={a1} rag_device_hbm_bytes_limit={lim:.0f} total_memory={total}", flush=True)
    if not (a0 == a1 == use) or lim != total:
        fail("goodput: the device gauges disagree with the allocator")


def _forward_ms(engine, reps: int = 5, model=None, kv_quant: str = "bf16", width: int = 1,
                cache_len: int = 4352, slot: int = 4199):
    """One forward of ``model`` (default: the engine's; B=1) over ``width``
    tokens at ``slot`` of a ``cache_len``-slot cache of ``kv_quant`` (a
    decode step at width 1, a speculative verify at width 16), issued on an
    idle card: the median host time to issue it, and to its end."""
    import torch

    from rag_llm_k8s_tpu_torch.models import llama as L

    dev = engine.device
    model = model or engine.model
    cache = L.make_kv_cache(engine.config, 1, cache_len, torch.bfloat16, dev, kv_quant)
    tok = torch.full((1, width), 7, dtype=torch.int64, device=dev)
    pos = slot + torch.arange(width, device=dev)[None]
    ks = torch.zeros(1, dtype=torch.int64, device=dev)
    kl = torch.full((1,), slot + width, dtype=torch.int64, device=dev)
    issued, ended = [], []
    with torch.inference_mode():
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(tok, pos, cache, ks, kl, slot, chunked=width > 1)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            if i:  # the first is a warm-up
                issued.append((t1 - t0) * 1e3)
                ended.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(issued), statistics.median(ended)


def phase_plain_decode(service_bits):
    """Yardstick, run after the main path's counters are read: one greedy
    request on the vanilla decode loop through the decode kernel, then the
    same request with the plain decode attention swapped into the model,
    each timed by the service (``timings.generate_ms``); and one decode
    forward each way, to show whether the host's launches or the card
    set the step's time."""
    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.models import llama as L
    from rag_llm_k8s_tpu_torch.ops import attention as A

    _, client, engine, _ = service_bits
    ec, sampling = engine.engine_config, engine.sampling
    engine.engine_config = dataclasses.replace(ec, speculative="off")
    engine.sampling = SamplingConfig(do_sample=False)
    got = {}
    try:
        for impl, fn in (("kernel", A.decode_attention), ("plain", A.decode_attention_xla)):
            L.decode_attention = fn
            steps = engine.stats.decode_tokens
            r = client.post("/generate", json_body={"prompt": "which kernel tiles the shared memory?"})
            if r.status_code != 200:
                fail(f"decode yardstick ({impl}): {r.status_code} {r.get_json()}")
            body = r.get_json()
            got[impl] = (body["timings"]["generate_ms"], engine.stats.decode_tokens - steps,
                         body["generated_text"])
            issued, ended = _forward_ms(engine)
            print(f"phase decode yardstick: one decode forward through the {impl} attention: "
                  f"issued in {issued:.2f} ms, ended after {ended:.2f} ms (host clock)", flush=True)
    finally:
        L.decode_attention = A.decode_attention
        engine.engine_config, engine.sampling = ec, sampling
    (k_ms, k_n, k_txt), (p_ms, p_n, p_txt) = got["kernel"], got["plain"]
    print(f"phase decode yardstick (greedy, vanilla decode): generate_ms kernel={k_ms:.1f} "
          f"({k_n} decode tokens) plain={p_ms:.1f} ({p_n} decode tokens) "
          f"kernel/plain={k_ms / p_ms:.3f} same_text={k_txt == p_txt}", flush=True)


def phase_model_q8(model, qmodel, cfg, engine):
    """int8 weights against bf16 weights on the same random 8B model: the
    logits of an S = 4096 prefill (100 left-pad slots) at depth 2 and at
    full depth, gated as ``Q8_DEPTH2_*`` / ``Q8_FULL_RMS`` say; then one
    decode forward and one 16-token verify forward each way (the int8 model
    with an int8 and with a bf16 cache)."""
    import torch
    from torch import nn

    from rag_llm_k8s_tpu_torch.models import llama as L

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    B, S, npad = 1, 4096, 100
    tokens = torch.randint(3, 259, (B, S), device=dev, generator=g)
    pad = torch.ones((B, S), dtype=torch.int64, device=dev)
    pad[:, :npad] = 0
    ks, _ = L.mask_window(pad)
    pos = (torch.cumsum(pad, -1) - 1).clamp_min(0)

    def logits(m, depth):
        layers = m.layers
        m.layers = nn.ModuleList(list(layers)[:depth])
        try:
            cache = L.make_kv_cache(cfg, B, S, torch.bfloat16, dev)
            with torch.inference_mode():
                return m(tokens, pos, cache, ks, torch.full((B,), S, device=dev), 0)[0, npad:].float()
        finally:
            m.layers = layers

    for depth in (2, cfg.num_layers):
        ref, got = logits(model, depth), logits(qmodel, depth)
        if not torch.isfinite(got).all():
            fail("model q8: non-finite logits")
        rel = ((got - ref).norm() / ref.norm()).item()
        cos = (got * ref).sum().item() / (got.norm() * ref.norm()).item()
        top1 = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"phase model_q8 llama-3.1-8b prefill S={S} ({npad} pad) depth={depth}: int8 vs bf16 weights "
              f"rel_rms={rel:.4g} cosine={cos:.6f} top1={top1:.4f}", flush=True)
        bad = rel >= Q8_DEPTH2_RMS or cos <= Q8_DEPTH2_COS if depth == 2 else rel >= Q8_FULL_RMS
        if bad:
            fail(f"model q8: int8 logits at depth {depth} stray from the bf16 ones (rel {rel:.3g}, cos {cos:.4g})")
        del ref, got
    for width, kind in ((1, "decode forward"), (16, "verify forward (16 tokens)")):
        for name, m, kvq in (("bf16 weights, bf16 KV", model, "bf16"), ("int8 weights, int8 KV", qmodel, "int8"),
                             ("int8 weights, bf16 KV", qmodel, "bf16")):
            issued, ended = _forward_ms(engine, model=m, kv_quant=kvq, width=width)
            print(f"phase model_q8 {kind} ({name}): issued in {issued:.2f} ms, ended after "
                  f"{ended:.2f} ms (host clock)", flush=True)


def _pct(values, q):
    """The ``q``-th percentile (linear interpolation between order
    statistics, numpy's default)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


LATENCY_QUESTIONS = [
    "which kernel tiles the shared memory?", "how does the cache stream tokens?",
    "what bounds the decode latency?", "where is the vector index kept?",
    "what does the warp block share?", "how is the prefill chunk scheduled?",
    "which register holds the query?", "what limits the device bandwidth?",
    "how many tokens does a chunk hold?", "what does the attention kernel read?",
]


def phase_query_latency(service_bits, n_solo: int = 24):
    """The solo ``/query`` latency leg (``bench.py`` ``measure_query_e2e``):
    ``n_solo`` fused requests one at a time through the service as
    ``server/main.py`` builds it (real tokenizers, ``BatchScheduler``,
    retrieve coalescer, full-depth bf16 8B, the 65,536-vector store,
    default sampling), with p50 and p95 of ``total_ms`` and its parts. Then
    a burst of 8 concurrent ``/query``: the kNN must run a pass of 8
    queries and ``engine.generate`` a batch of more than one. The solo
    requests alternate between two tenants, and the one-shot goodput ledger
    before and after them, each one's ``chip_ms`` against its
    ``generate_ms`` and the tenants' chip seconds are kept for
    ``phase_goodput`` (a)."""
    import threading

    import torch

    from rag_llm_k8s_tpu_torch.ops import _build

    svc, client, engine, _ = service_bits
    chip = svc.metrics.get_family("rag_tenant_chip_seconds_total")
    chip0 = {t: chip.labels(tenant=t).value for t in GOODPUT_TENANTS}
    ONESHOT_LEDGER.update(before=engine.ledger.state(), off=[])
    tok = svc.llm_tokenizer
    fused, batches = [], []
    real_rag, real_gen = engine.generate_rag, engine.generate
    engine.generate_rag = lambda *a, **kw: fused.append(1) or real_rag(*a, **kw)
    engine.generate = lambda prompts, *a, **kw: batches.append(len(prompts)) or real_gen(prompts, *a, **kw)
    try:
        native_before = tok.native_calls
        keys = ("total_ms", "tokenize_ms", "embed_retrieve_ms", "generate_ms")
        samples = {k: [] for k in keys}
        for i in range(n_solo):
            q = LATENCY_QUESTIONS[i % len(LATENCY_QUESTIONS)]
            r = client.post("/query", json_body={"prompt": f"{q} ({i})",
                                                 "tenant_id": GOODPUT_TENANTS[i % len(GOODPUT_TENANTS)]})
            body = r.get_json()
            if r.status_code != 200 or "Document '" not in body.get("context", "") or "chip_ms" not in body[
                    "timings"]:
                fail(f"latency /query {i}: {r.status_code} {body}")
            for k in keys:
                samples[k].append(body["timings"][k])
            ONESHOT_LEDGER["off"].append(round(body["timings"]["chip_ms"] / body["timings"]["generate_ms"] - 1.0, 4))
        ONESHOT_LEDGER.update(after=engine.ledger.state(), n=n_solo,
                              chip={t: round(chip.labels(tenant=t).value - chip0[t], 4) for t in GOODPUT_TENANTS})
        if len(fused) != n_solo:
            fail(f"latency: {len(fused)} of {n_solo} solo queries took the single-fetch path")
        if tok.native_calls - native_before < n_solo:
            fail("latency: the native BPE merge loop did not serve every request")
        stats = {k: {"p50": _pct(v, 50), "p95": _pct(v, 95), "min": min(v), "max": max(v)}
                 for k, v in samples.items()}
        print(f"phase query_latency solo: requests={n_solo} fused={len(fused)} "
              f"native_bpe_texts={tok.native_calls - native_before} ms {json.dumps(stats)}", flush=True)

        # a cold burst of 8: one coalesced retrieve (a kNN pass of 8) and
        # batched generates through the BatchScheduler
        results = [None] * 8
        fused.clear()
        batches.clear()
        start = threading.Barrier(8, timeout=60)  # the 8 arrive together

        def ask(i):
            start.wait()
            r = client.post("/query", json_body={"prompt": LATENCY_QUESTIONS[i]})
            results[i] = (r.status_code, r.get_json())

        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.monotonic()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        by_q = dict(_build.KNN_LAUNCHES_BY_QUERIES)
        for i, res in enumerate(results):
            if res is None or res[0] != 200 or "Document '" not in res[1].get("context", ""):
                fail(f"latency burst /query {i}: {res}")
        print(f"phase query_latency burst: requests=8 wall_s={wall:.2f} knn_launches_by_queries="
              f"{json.dumps(by_q)} generate_batches={batches} fused={len(fused)} total_ms="
              f"{[r[1]['timings']['total_ms'] for r in results]} embed_retrieve_ms="
              f"{[r[1]['timings']['embed_retrieve_ms'] for r in results]}", flush=True)
        if not by_q.get(8):
            fail("latency burst: the kNN never ran a pass of 8 queries")
        if not batches or max(batches) < 2:
            fail(f"latency burst: engine.generate never ran a batch of more than one ({batches})")
        return stats
    finally:
        engine.generate_rag, engine.generate = real_rag, real_gen


# the exposition grammar of tests/test_obs.py (text format 0.0.4, the subset
# the registry emits)
_HELP_RE = re.compile(r"^# HELP [a-zA-Z_:][a-zA-Z0-9_:]* \S.*$")
_TYPE_RE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)$")
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*"(,[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*")*\})?'
    r" (-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|NaN)$"
)


def _scrape(client):
    """``/metrics`` parsed under the strict grammar: ``({(name, labels):
    value}, ms)``."""
    t = time.monotonic()
    r = client.get("/metrics")
    ms = (time.monotonic() - t) * 1e3
    if r.status_code != 200 or not r.headers.get("Content-Type", "").startswith("text/plain"):
        fail(f"/metrics: {r.status_code} {r.headers}")
    samples = {}
    for line in r.data.decode().splitlines():
        if not line:
            continue
        if line.startswith("# HELP"):
            ok = _HELP_RE.match(line)
        elif line.startswith("# TYPE"):
            ok = _TYPE_RE.match(line)
        else:
            ok = _SAMPLE_RE.match(line)
            head, val = line.rsplit(" ", 1)
            name, brace, labels = head.partition("{")
            samples[(name, brace + labels)] = float(val)
        if not ok:
            fail(f"/metrics: a line outside the exposition grammar: {line!r}")
    return samples, ms


OBS_QUESTIONS = LATENCY_QUESTIONS[:4]


def phase_observability(service_bits, max_new_profiled: int = 16):
    """The observability surface of the one-shot service (``bits``), through
    the HTTP test client, one line per case: (a) four solo fused ``/query``
    with a ``traceparent`` and ``{"trace": true}`` (the response's trace id
    is the header's; the tree is the fused path's ``retrieve`` [``tokenize``,
    ``embed_knn``], ``generate``, ``detokenize``, as in the JAX service, and
    sums to within 5 % of ``timings.total_ms``), one long question on the
    host path (``assemble`` between ``retrieve`` and ``generate``), and a
    malformed ``traceparent`` (200, a fresh id); (b) ``/metrics`` under the
    strict grammar, counts moved by exactly the requests answered, the
    engine counters by the engine's stats, the JSON snapshot equal to the
    text; (c) ``/debug/traces`` 403 without the debug flag and the phase's
    traces with it, newest last; (d) ``POST /profile`` blocking over one
    fused request at ``max_new_profiled`` tokens: every kernel the launch
    counters saw is in the trace's kernel events with the same count; the
    card's busy share over the request, one decode forward's busy share and
    host issue time (traced, and untraced at the same shape), the top device
    ops and the longest idle gaps printed;
    (e) the window mode: 200 at once, 409 for a second capture, two
    requests inside the window, whose kernels the trace holds; ``seconds``
    0 and 301 get 400."""
    import os
    import tempfile

    import numpy as np
    import torch

    from rag_llm_k8s_tpu_torch.engine.engine import _cache_len
    from rag_llm_k8s_tpu_torch.obs import logging as obs_logging
    from rag_llm_k8s_tpu_torch.ops import _build
    from rag_llm_k8s_tpu_torch.tools import trace_summary

    svc, client, engine, _ = service_bits
    s0, _ = _scrape(client)
    st0 = dataclasses.replace(engine.stats)
    rng_words = np.random.default_rng(7)

    # (a) traces
    sent, answered = [], 0
    cases = [(q, True) for q in OBS_QUESTIONS] + [(words(rng_words, 40) + "?", False)]
    for i, (q, fused) in enumerate(cases):
        tid, caller = f"{0xabc0 + i:032x}", f"{0x5eed + i:016x}"
        r = client.post("/query", json_body={"prompt": q, "trace": True},
                        headers={"traceparent": f"00-{tid}-{caller}-01"})
        body = r.get_json()
        answered += r.status_code == 200
        if r.status_code != 200 or r.headers.get("x-trace-id") != tid:
            fail(f"observability (a) request {i}: {r.status_code} x-trace-id={r.headers.get('x-trace-id')}")
        back = obs_logging.parse_traceparent(r.headers.get("traceparent"))
        tree = body["trace"]
        top = [sp["name"] for sp in tree["spans"]]
        want = ["retrieve", "generate", "detokenize"] if fused else ["retrieve", "assemble", "generate",
                                                                     "detokenize"]
        inner = [sp["name"] for sp in tree["spans"][0].get("spans", [])]
        total = body["timings"]["total_ms"]
        span_sum = sum(sp["duration_ms"] for sp in tree["spans"])
        print(f"observability (a) {'fused' if fused else 'host'} /query {i}: x-trace-id={tid} "
              f"response span={back.span_id if back else None} spans={top} retrieve={inner} "
              f"span_sum_ms={span_sum:.1f} total_ms={total} "
              f"durations={[(sp['name'], sp['duration_ms']) for sp in tree['spans']]}", flush=True)
        if (back is None or back.trace_id != tid or back.span_id == caller or tree.get("parent_span_id") != caller
                or top != want or inner != ["tokenize", "embed_knn"] or abs(span_sum - total) > 0.05 * total):
            fail(f"observability (a) request {i}: tree {top} / {inner}, spans {span_sum:.1f} ms of {total} ms")
        sent.append(tid)
    r = client.post("/query", json_body={"prompt": OBS_QUESTIONS[0]}, headers={"traceparent": "00-zzz-yyy-01"})
    fresh = r.headers.get("x-trace-id", "")
    answered += r.status_code == 200
    print(f"observability (a) malformed traceparent: code={r.status_code} x-trace-id={fresh}", flush=True)
    if r.status_code != 200 or not re.fullmatch(r"[0-9a-f]{32}", fresh) or fresh in sent:
        fail(f"observability (a) malformed traceparent: {r.status_code} {fresh!r}")
    sent.append(fresh)

    # (b) /metrics: strict grammar, counts by the requests answered
    s1, scrape_ms = _scrape(client)
    st1 = engine.stats

    def moved(name, labels=""):
        return s1.get((name, labels), 0.0) - s0.get((name, labels), 0.0)

    n_fused = len(OBS_QUESTIONS) + 1
    want = {("rag_request_duration_seconds_count", ""): answered,
            ("rag_http_requests_total", '{code="200",route="/query"}'): answered,
            ("tpu_rag_query_single_fetch", ""): n_fused,
            ("tpu_rag_engine_decode_tokens", ""): st1.decode_tokens - st0.decode_tokens,
            ("tpu_rag_engine_generate_calls", ""): st1.generate_calls - st0.generate_calls,
            ("tpu_rag_engine_prefill_tokens", ""): st1.prefill_tokens - st0.prefill_tokens}
    for stage, n in (("retrieve", answered), ("generate", answered), ("detokenize", answered),
                     ("assemble", answered - n_fused)):
        want[("rag_stage_duration_seconds_count", f'{{stage="{stage}"}}')] = n
    got = {k: moved(*k) for k in want}
    snap = client.get("/metrics", headers={"Accept": "application/json"}).get_json()
    s2, _ = _scrape(client)
    by_name = {}
    for (name, _), v in s2.items():
        if not name.endswith("_bucket"):
            by_name[name] = by_name.get(name, 0.0) + v
    # the scrape's own gauges can move between the two reads; the rest may not
    off = [k for k, v in snap.items()
           if not math.isclose(by_name.get(k if k.startswith("rag_") else f"tpu_rag_{k}", math.nan), v,
                               rel_tol=1e-6, abs_tol=1e-6)]
    print(f"observability (b) /metrics: families={len({n for n, _ in s1})} samples={len(s1)} "
          f"scrape_ms={scrape_ms:.2f} moved={json.dumps({f'{n}{lab}': v for (n, lab), v in got.items()})} "
          f"compile_events={s1.get(('rag_compile_events_total', ''))} "
          f"compile_seconds={s1.get(('rag_compile_seconds_total', ''))} json_mismatch={off}", flush=True)
    if any(got[k] != v for k, v in want.items()) or off or not s1.get(("rag_compile_seconds_total", ""), 0) > 0:
        fail(f"observability (b): moved {got}, want {want}; JSON/text mismatch {off}")

    # (c) the debug gate
    env_faults = os.environ.pop("TPU_RAG_FAULTS", None)
    cfg = svc.config
    try:
        closed = client.get("/debug/traces").status_code
        svc.config = dataclasses.replace(cfg, flight=dataclasses.replace(cfg.flight, debug_endpoints=True))
        r = client.get(f"/debug/traces?limit={len(sent)}")
        listed = [t["trace_id"] for t in r.get_json().get("traces", [])] if r.status_code == 200 else []
    finally:
        svc.config = cfg
        if env_faults is not None:
            os.environ["TPU_RAG_FAULTS"] = env_faults
    print(f"observability (c) /debug/traces: without the flag {closed}, with TPU_RAG_DEBUG {r.status_code} "
          f"listing {len(listed)} traces, newest last = sent order {listed == sent}", flush=True)
    if closed != 403 or r.status_code != 200 or listed != sent:
        fail(f"observability (c): {closed} / {r.status_code}, listed {listed} != sent {sent}")

    # (d) POST /profile, blocking, over one fused request. Its last decode
    # forward is also timed untraced on the same engine at the same shape,
    # just before the capture and just after it (the fused path serves at
    # the largest prompt bucket; the last of the request's decode steps
    # writes slot S + max_new - 2): the trace's card time for that forward
    # over the untraced host time is a decode step's busy share with no
    # profiler recording ops (the model alone: the range also holds the
    # step's few sampling kernels)
    S = max(engine.engine_config.prompt_buckets)
    shape = dict(cache_len=_cache_len(S + max_new_profiled), slot=S + max_new_profiled - 2)
    untraced = {"before": _forward_ms(engine, **shape)}
    tmp = tempfile.mkdtemp(prefix="profile_")
    sampling = engine.sampling
    engine.sampling = dataclasses.replace(sampling, max_new_tokens=max_new_profiled)
    try:
        torch.cuda.synchronize()
        launched = dict(_build.LAUNCHES)
        t = time.monotonic()
        r = client.post("/profile", json_body={"prompt": OBS_QUESTIONS[1], "dir": tmp})
        wall = time.monotonic() - t
        counted = {k: _build.LAUNCHES[k] - launched[k] for k in launched}
        body = r.get_json()
        if r.status_code != 200:
            fail(f"observability (d) /profile: {r.status_code} {body}")
        path = body["trace_file"]
        size_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            trace = json.load(f)
        os.remove(path)
    finally:
        engine.sampling = sampling
    ranges = trace_summary.events(trace, "user_annotation")
    t_lo = min(e["ts"] for e in ranges if e["name"] == "retrieve")
    t_hi = max(e["ts"] + e["dur"] for e in ranges if e["name"] == "detokenize")
    summ = trace_summary.summarize(trace, t_lo, t_hi)
    # the launches are matched over every kernel of the capture, which holds
    # this one request, as in (e): the kernels' device timestamps can end a
    # few ms past the host's detokenize range (466 of 480 decode kernels
    # inside it in one run)
    in_trace = trace_summary.wrapper_launches(trace_summary.events(trace, "kernel"))
    fwd = {n: trace_summary.forward(trace, n) for n in ("decode_forward", "verify_forward")}
    print(f"observability (d) /profile blocking: wall_s={wall:.2f} trace_mb={size_mb:.1f} "
          f"timings={json.dumps(body['timings'])} launches={json.dumps(counted)} "
          f"in_trace={json.dumps(in_trace)}", flush=True)
    print(f"observability (d) request trace: window_ms={summ['window_us'] / 1e3:.2f} kernels={summ['kernels']} "
          f"busy_ms={summ['busy_us'] / 1e3:.2f} busy_share={summ['busy_share']:.4f} "
          f"forwards={json.dumps(fwd)}", flush=True)
    print(f"observability (d) top device ops: {json.dumps(summ['top_ops'])}", flush=True)
    print(f"observability (d) longest idle gaps: {json.dumps(summ['gaps'])}", flush=True)
    if counted != in_trace or not any(counted.values()):
        fail(f"observability (d): launch counters {counted} != the trace's kernels {in_trace}")
    untraced["after"] = _forward_ms(engine, **shape)
    dec = fwd["decode_forward"]
    if dec is not None and dec["kernels"]:
        steps = sum(1 for e in ranges if e["name"] == "decode_forward")
        print(f"observability (d) the last decode forward untraced ({json.dumps(shape)}; the trace's request "
              f"ran {steps} decode steps): issued in / ended after "
              + ", ".join(f"{k} the capture {i:.2f} / {e:.2f} ms" for k, (i, e) in untraced.items())
              + f" (host clock); its card time in the trace {dec['busy_us'] / 1e3:.3f} ms in {dec['kernels']} "
              f"kernels; untraced busy share "
              + ", ".join(f"{k} {dec['busy_us'] / 1e3 / e:.4f}" for k, (_, e) in untraced.items()), flush=True)

    # (e) POST /profile, a window over live traffic
    bad = [client.post("/profile", json_body={"seconds": v, "dir": tmp}).status_code for v in (0, 301)]
    t = time.monotonic()
    r = client.post("/profile", json_body={"seconds": 3, "dir": tmp})
    start_ms = (time.monotonic() - t) * 1e3
    second = client.post("/profile", json_body={"seconds": 3, "dir": tmp})
    blocking = client.post("/profile", json_body={"prompt": "x", "dir": tmp}).status_code
    if r.status_code != 200:
        fail(f"observability (e): {r.status_code} {r.get_json()}")
    path, until = r.get_json()["trace_file"], second.get_json().get("until")
    engine.sampling = dataclasses.replace(sampling, max_new_tokens=max_new_profiled)
    try:
        launched = dict(_build.LAUNCHES)
        codes = [client.post("/query", json_body={"prompt": q}).status_code for q in OBS_QUESTIONS[2:4]]
        torch.cuda.synchronize()
        inside = time.time() < until - 0.2
        counted = {k: _build.LAUNCHES[k] - launched[k] for k in launched}
    finally:
        engine.sampling = sampling
    t = time.monotonic()
    while not os.path.exists(path) and time.monotonic() - t < 120:
        time.sleep(0.2)
    if not os.path.exists(path):
        fail("observability (e): the window's trace was never written")
    time.sleep(0.5)  # the export writes the file whole; let it close
    with open(path) as f:
        in_window = trace_summary.wrapper_launches(trace_summary.events(json.load(f), "kernel"))
    size_mb = os.path.getsize(path) / 1e6
    os.remove(path)
    print(f"observability (e) /profile window: start_ms={start_ms:.1f} second={second.status_code} "
          f"until={until} blocking_during={blocking} bad_seconds={bad} requests={codes} inside={inside} "
          f"trace_mb={size_mb:.1f} launches={json.dumps(counted)} in_trace={json.dumps(in_window)}", flush=True)
    if (second.status_code != 409 or blocking != 409 or bad != [400, 400] or codes != [200, 200] or not inside
            or in_window != counted):
        fail(f"observability (e): 409s {second.status_code}/{blocking}, 400s {bad}, {codes}, inside {inside}, "
             f"trace {in_window} != launches {counted}")


# ---------------------------------------------------------------------------
# the KV prefix cache and tiering (phase_prefix_cache)
# ---------------------------------------------------------------------------

PREFIX_KERNELS = ("knn_topk", "flash_attention", "decode_attention", "chunk_prefill_attention")
PREFIX_Q8 = ("knn_topk", "flash_attention", "decode_attention_q8", "chunk_prefill_attention_q8")
PAGED_KERNELS = ("paged_decode_attention", "paged_chunk_attention", "paged_decode_attention_q8",
                 "paged_chunk_attention_q8")
PREFIX_P = 4096  # PrefixCacheConfig.max_prefix_tokens, the splice buffer's width
PREFIX_TIMING_KEYS = ("prefix_resolve_ms", "prefix_reuse_frac", "prefill_tokens_skipped",
                      "prefill_tokens_skipped_frac")
# a planted fault in the prefixed logits (the prefix one token short) must
# move them past this many times the bf16 noise floor that the gate allows
PREFIX_NOISE_FACTOR = 4.0
# re-rotated bf16 K (fp32 rotation of a bf16 value, rounded again) against K
# rotated once at its position in bf16: a few bf16 roundings (2**-8 each)
PREFIX_K0_TOL = 2.0**-6


def _prefix_kernel_case(tag, S, wi, kl_i, T, q8, g, L=4, ks_i=0, phase="prefix_cache", time_q8=False):
    """One dense-cache kernel at a prefixed-path shape: ``S`` queries (1:
    decode) written at ``wi`` over the key window ``[ks_i, kl_i)`` of a
    ``T``-slot cache, NaN outside the window (NaN scales and random payload
    under int8) for the kernel, zeros for the plain version; planted
    faults must be rejected. Returns the row of numbers (times for bf16,
    and for int8 with ``time_q8``)."""
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    K, H, hd = 8, 32, 128
    layer = L // 2 + 1
    kc, vc, kz, vz = _cache_pair(L, 1, K, T, hd, ks_i, kl_i, g)
    if q8:
        vc, vz = _scale_rows(g, vc, vz)
    q = torch.randn(1, S, H, hd, device=dev, generator=g).to(torch.bfloat16)
    ks = torch.tensor([ks_i], device=dev, dtype=torch.int32)
    kl = torch.tensor([kl_i], device=dev, dtype=torch.int32)
    _sharpen_edges(q, (kc, kz), layer, wi, ks_i)
    if q8:
        (k8, ksz), (k8x, ksn) = _q8_pair(kc, kz, g)
        (v8, vsz), (v8x, vsn) = _q8_pair(vc, vz, g)
        del kc, vc, kz, vz
        if S == 1:
            kern = lambda lay: A.decode_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, lay)  # noqa: E731
            plain = lambda lay, ks=ks, kl=kl, wi=wi: A.decode_attention_xla_q8(  # noqa: E731
                q, k8, v8, ksz, vsz, ks, kl, lay)
        else:
            kern = lambda lay: A.chunk_prefill_attention_q8(q, k8x, v8x, ksn, vsn, ks, kl, lay, wi)  # noqa: E731
            plain = lambda lay, ks=ks, kl=kl, wi=wi: A.chunk_attention_xla_q8(  # noqa: E731
                q, k8, v8, ksz, vsz, ks, kl, lay, wi)
    else:
        if S == 1:
            kern = lambda lay: A.decode_attention(q, kc, vc, ks, kl, lay)  # noqa: E731
            plain = lambda lay, ks=ks, kl=kl, wi=wi: A.decode_attention_xla(q, kz, vz, ks, kl, lay)  # noqa: E731
        else:
            kern = lambda lay: A.chunk_prefill_attention(q, kc, vc, ks, kl, lay, wi)  # noqa: E731
            plain = lambda lay, ks=ks, kl=kl, wi=wi: A.chunk_attention_xla(q, kz, vz, ks, kl, lay, wi)  # noqa: E731
    name = ("decode_attention" if S == 1 else "chunk_prefill_attention") + ("_q8" if q8 else "")
    got = kern(layer)
    err, rms = _attn_check(f"{name} {tag}", got, plain(layer))
    if S == 1:
        faults = {"kv_len-1": plain(layer, kl=kl - 1), "layer-1": plain(layer - 1)}
    else:
        faults = {"write_index+1": plain(layer, wi=wi + 1), "write_index-1": plain(layer, wi=wi - 1)}
    fault_rms = _attn_faults(f"{name} {tag}", got, faults)
    del got, faults
    row = dict(shape=f"S={S} write_index={wi} window=[{ks_i},{kl_i}) T={T} H=32 K=8 hd=128", max_abs_err=err,
               rel_rms=rms)
    line = f"phase {phase} (a) {name} {tag} {row['shape']}: {_attn_line(err, rms, fault_rms)}"
    if not q8 or time_q8:
        # timed: each call reads another layer; SDPA (bf16 only) over the
        # zero-filled twin
        pos = torch.arange(T, device=dev)
        qpos = wi + torch.arange(S, device=dev)
        inside = (pos >= ks_i) & (pos < kl_i)
        mask = inside[None, :] & (pos[None, :] <= qpos[:, None]) if S > 1 else inside[None, :]
        ms = time_ms(lambda i: kern(i % L), iters=32 if S <= 128 else 8)
        plain_ms = time_ms(lambda i: plain(i % L), iters=3, warmup=1)
        key_bytes = q8_key_bytes(K, hd) if q8 else 2 * K * hd * 2
        b_ms, b_by = bound((kl_i - ks_i) * key_bytes + 2 * q.numel() * 2, 4.0 * H * hd * mask.sum().item(),
                           BF16_FLOPS)
        lib_ms, lib = None, "none (no single PyTorch call reads an int8 cache)"
        if not q8:
            qt, m4 = q.transpose(1, 2), mask[None, None]
            lib_ms = time_ms(lambda i: sdpa(qt, kz[i % L], vz[i % L], m4), iters=5)
            lib = f"{lib_ms:.4f}"
        row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        line += f" ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={b_ms:.4f} ({b_by})"
    print(line, flush=True)
    return name, row


def phase_prefix_kernels(rows):
    """(a) Kernels 3-6 at the shapes only the prefixed path gives them: the
    segment builder (a segment bucket's queries at the head's or the
    earlier chunks' length, an offset off every tile edge), the suffix
    prefill (the suffix buckets at a ~2,900-token prefix) and decode over
    that cache."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(21)
    cases = []
    for Sb, ctx in ((64, 157), (256, 1110), (1024, 157), (2048, 2063)):
        cases.append((f"segment Sb={Sb}", Sb, ctx, ctx + Sb - 13, -(-(PREFIX_P + Sb) // 128) * 128))
    plen = 2900
    for S_suf in (128, 512, 2048):
        cases.append((f"suffix S_suf={S_suf}", S_suf, plen, plen + S_suf - 37,
                      -(-(PREFIX_P + S_suf + 150) // 128) * 128))
    T_dec = -(-(PREFIX_P + 128 + 150) // 128) * 128
    cases.append((f"decode T={T_dec}", 1, plen + 91 + 74, plen + 91 + 75, T_dec))
    for q8 in (False, True):
        for tag, S, wi, kl_i, T in cases:
            name, row = _prefix_kernel_case(tag, S, wi, kl_i, T, q8, g)
            rows[name].setdefault("prefix_shapes", []).append(dict(case=tag, **row))
            torch.cuda.empty_cache()


def _prefix_service(service_bits, max_new=150, kv_quant="bf16", tiering=False, **pc):
    """A one-shot service with the prefix cache on (``pc``:
    ``PrefixCacheConfig`` fields; ``tiering``: ``KVTieringConfig`` on) over
    the main service's model, store, encoder and tokenizers, greedy, warmed
    (which pins and builds the head)."""
    from rag_llm_k8s_tpu_torch.core.config import KVTieringConfig, PrefixCacheConfig, SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
    from rag_llm_k8s_tpu_torch.server.app import RagService, create_app

    svc1, _, engine, store = service_bits
    ec = dataclasses.replace(engine.engine_config, kv_quant=kv_quant,
                             prefix_cache=PrefixCacheConfig(enabled=True, **pc),
                             kv_tiering=KVTieringConfig(enabled=tiering))
    eng = InferenceEngine(engine.config, engine.model, SamplingConfig(do_sample=False, max_new_tokens=max_new),
                          ec, engine.dtypes, engine.device)
    svc = RagService(dataclasses.replace(svc1.config, engine=ec), eng, svc1.llm_tokenizer, svc1.encoder,
                     svc1.encoder_tokenizer, store, scheduler=BatchScheduler(eng, max_wait_ms=30.0))
    svc.warmup()
    head = (f"head:{len(svc._a_ids())}",) + ((0, ()) if pc.get("reuse", "exact") == "exact" else ())
    e = eng.prefix_cache._entries.get(head)
    if e is None or not e.pinned:
        fail(f"prefix cache: the head {head} is not built and pinned at warmup")
    return svc, create_app(svc).test_client(), eng


def _prefixed_ask(svc, client, q, what):
    """One /generate that must take the prefixed path: 200, the timings
    keys, no degraded note, ``query_prefix_cached`` up by one."""
    before = svc.metrics.counter("query_prefix_cached").value
    CURRENT_STEP[0] = what
    try:
        r = client.post("/generate", json_body={"prompt": q})
    finally:
        CURRENT_STEP[0] = ""
    body = r.get_json()
    if r.status_code != 200 or "Document '" not in body.get("context", ""):
        fail(f"prefix_cache {what}: {r.status_code} {body}")
    t = body["timings"]
    if body.get("degraded") or any(k not in t for k in PREFIX_TIMING_KEYS) or not all(
            math.isfinite(v) for v in t.values()):
        fail(f"prefix_cache {what}: not served by the prefixed path: {body}")
    if svc.metrics.counter("query_prefix_cached").value != before + 1:
        fail(f"prefix_cache {what}: query_prefix_cached did not rise")
    return t


def _segments_of(svc, q):
    results, _ = svc._retrieve(q)
    return svc._prompt_segments(q, results), results


def _logits_prefixed(eng, b_ids, cp):
    import torch

    with torch.inference_mode(), eng._run_lock:
        logits, _, _ = eng.prefill_prefixed(b_ids, cp, 1)
    return logits[0, -1].float()


def _cold_prefill(eng, ids, plain=False):
    """A cold prefill of ``ids``, left-padded to the largest bucket as the
    engine pads it, through the kernels or (``plain``) the plain attention:
    ``(last-token logits, cache, slot of the first token)``."""
    import torch

    from rag_llm_k8s_tpu_torch.models import llama as L
    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = eng.device
    S = max(eng.engine_config.prompt_buckets)
    n = len(ids)
    toks = torch.full((1, S), eng.pad_id, dtype=torch.int64, device=dev)
    toks[0, S - n:] = torch.tensor(ids, device=dev)
    ks = torch.full((1,), S - n, dtype=torch.int64, device=dev)
    pos = (torch.arange(S, device=dev) - (S - n)).clamp_min(0)[None]
    if plain:
        L.flash_attention = A.attention_xla
    try:
        with torch.inference_mode():
            cache = eng._new_cache(S)
            logits = eng.model(toks, pos, cache, ks, torch.full((1,), S, device=dev), 0, last_logit_only=True)
        return logits[0, -1].float(), cache, S - n
    finally:
        L.flash_attention = A.flash_attention


def _logits_cold(eng, ids, plain=False):
    return _cold_prefill(eng, ids, plain)[0]


def _rel(x, ref):
    return ((x - ref).norm() / ref.norm()).item()


def _check_prefixed_logits(eng, cp, segments, b_ids, what):
    """The cached-prefix prefill's last-token logits against a cold prefill
    of the same prompt through the plain attention, within
    ``PREFIX_NOISE_FACTOR`` times the kernels' own cold distance from it
    (the bf16 noise floor; random weights amplify rounding layer after
    layer, ``phase_model``). A planted fault, the prefix without its last
    chunk, must fall outside; the prefix one token short is printed."""
    ids = [t for _, seg in segments for t in seg] + list(b_ids)
    ref = _logits_cold(eng, ids, plain=True)
    floor = _rel(_logits_cold(eng, ids), ref)
    lim = max(PREFIX_NOISE_FACTOR * floor, 1e-3)
    got = _rel(_logits_prefixed(eng, b_ids, cp), ref)
    no_last = _rel(_logits_prefixed(eng, b_ids, dataclasses.replace(cp, length=cp.length - len(segments[-1][1]))),
                   ref)
    short = _rel(_logits_prefixed(eng, b_ids, dataclasses.replace(cp, length=cp.length - 1)), ref)
    print(f"phase prefix_cache {what}: last-token logits vs the cold plain prefill ({len(ids)} tokens) "
          f"rel_rms={got:.4g} (cold kernels {floor:.4g}, limit {lim:.4g}); planted fault without the last "
          f"chunk rel_rms={no_last:.4g}; the prefix one token short {short:.4g}", flush=True)
    if not got <= lim:
        fail(f"prefix_cache {what}: the cached-prefix logits stray past the noise floor")
    if no_last <= lim:
        fail(f"prefix_cache {what}: the check accepts a planted fault (the prefix without its last chunk)")
    return got


def phase_prefix_cache(service_bits, rows, fused_stats):
    """The prefixed solo path on the card (``TPU_RAG_PREFIX_CACHE=1``): (a)
    kernels 3-6 at its shapes; (b) a service with ``reuse="exact"`` (bf16,
    then int8 KV): a miss and a hit with the same tokens, the logits against
    a cold prefill, the launch counters (zeroed just before, read just
    after), and 12 requests' latency beside the fused path's; (c) chunk
    reuse over a shuffled chunk order, and ``rope_rerotate`` on the card
    against the CPU; (d) tiering: warm (int8 in place), cold (host spill and
    swap-in) and a planted ``kv_swap_in`` fault."""
    import torch

    from rag_llm_k8s_tpu_torch.ops import _build
    from rag_llm_k8s_tpu_torch.ops import attention as A
    from rag_llm_k8s_tpu_torch.resilience import faults

    timed(phase_prefix_kernels, rows)

    # (b) the prefixed service, exact reuse, bf16
    svc, client, eng = _prefix_service(service_bits)
    cache = eng.prefix_cache
    streams = []
    real = eng.generate_prefixed
    eng.generate_prefixed = lambda *a, **kw: streams.append(real(*a, **kw)) or streams[-1]
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        q = LATENCY_QUESTIONS[0]
        miss = _prefixed_ask(svc, client, q, "(b) miss")
        hit = _prefixed_ask(svc, client, q, "(b) hit")
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        _launch_check("prefixed bf16 path", launches, PREFIX_KERNELS, PAGED_KERNELS + PREFIX_Q8[2:])
        if streams[0] != streams[1] or len(streams[0]) == 0:
            fail(f"prefix_cache (b): the miss and the hit gave different tokens ({streams[0][:8]} / "
                 f"{streams[1][:8]})")
        if not hit["prefill_tokens_skipped_frac"] > miss["prefill_tokens_skipped_frac"]:
            fail(f"prefix_cache (b): the hit skipped no more prefill than the miss ({miss} / {hit})")
        st = cache.counters()
        print(f"phase prefix_cache (b) exact bf16: miss prefix_resolve_ms={miss['prefix_resolve_ms']} "
              f"generate_ms={miss['generate_ms']} skipped_frac={miss['prefill_tokens_skipped_frac']} | hit "
              f"prefix_resolve_ms={hit['prefix_resolve_ms']} generate_ms={hit['generate_ms']} "
              f"skipped_frac={hit['prefill_tokens_skipped_frac']} tokens={len(streams[0])} (miss == hit) "
              f"cache={json.dumps(st)}", flush=True)
        (_, segments, b_ids), _ = _segments_of(svc, q)
        print(f"phase prefix_cache (b) prompt: segments {[len(ids) for _, ids in segments]} (head first), "
              f"suffix {len(b_ids)} tokens", flush=True)
        cp = cache.prefix_for(segments)
        _check_prefixed_logits(eng, cp, segments, b_ids, "(b) exact bf16")
        del cp
        # the prefill a hit saves, on the card's clock: a miss's resolve, a
        # hit's, the suffix prefill over the prefix, and a cold prefill of
        # the same prompt at the largest bucket (the fused path's), each
        # between two syncs
        (_, seg2, b2), _ = _segments_of(svc, f"{LATENCY_QUESTIONS[9]} (synced)")
        synced = {}
        for name, fn in (("miss_resolve", lambda: cache.prefix_for(seg2)),
                         ("hit_resolve", lambda: cache.prefix_for(seg2)),
                         ("suffix_prefill", lambda: _logits_prefixed(eng, b2, cache.prefix_for(seg2))),
                         ("cold_prefill_4096", lambda: _logits_cold(eng, [t for _, x in seg2 for t in x] + b2))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            synced[name] = round((time.perf_counter() - t0) * 1e3, 2)
        print(f"phase prefix_cache (b) synced ms: {json.dumps(synced)} (segments "
              f"{[len(ids) for _, ids in seg2]}, suffix {len(b2)})", flush=True)
        # latency with the fused leg's default sampling: 6 questions, each
        # asked twice (a miss, then a memo hit)
        eng.sampling = service_bits[2].sampling
        samples = {"miss": [], "hit": []}
        for i in range(1, 7):
            for kind in ("miss", "hit"):
                t = _prefixed_ask(svc, client, f"{LATENCY_QUESTIONS[i]} ({i})", f"(b) latency {i}")
                samples[kind].append(t)
        stats = {}
        for kind, ts in (("all", samples["miss"] + samples["hit"]), ("miss", samples["miss"]),
                         ("hit", samples["hit"])):
            stats[kind] = {k: {"p50": _pct([t[k] for t in ts], 50), "p95": _pct([t[k] for t in ts], 95)}
                           for k in ("total_ms", "prefix_resolve_ms", "generate_ms")}
        print(f"phase prefix_cache (b) solo latency (default sampling, as the fused leg): prefixed requests=12 "
              f"ms {json.dumps(stats)} | fused "
              f"(phase_query_latency, this call) total_ms p50={fused_stats['total_ms']['p50']:.2f} "
              f"p95={fused_stats['total_ms']['p95']:.2f} | cache_bytes={cache.counters()['prefix_cache_bytes']}",
              flush=True)
    finally:
        eng.generate_prefixed = real
        svc.shutdown()
    del svc, client, eng, cache
    torch.cuda.empty_cache()

    # (b) int8 KV: the q8 pair serves, the bf16 cache kernels never launch
    svc, client, eng = _prefix_service(service_bits, max_new=16, kv_quant="int8")
    streams.clear()
    real = eng.generate_prefixed
    eng.generate_prefixed = lambda *a, **kw: streams.append(real(*a, **kw)) or streams[-1]
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        q = LATENCY_QUESTIONS[7]
        miss = _prefixed_ask(svc, client, q, "(b) int8 miss")
        hit = _prefixed_ask(svc, client, q, "(b) int8 hit")
        torch.cuda.synchronize()
        _launch_check("prefixed int8-KV path", dict(_build.LAUNCHES), PREFIX_Q8, PAGED_KERNELS + BF16_CACHE_KERNELS)
        if streams[0] != streams[1]:
            fail("prefix_cache (b) int8: the miss and the hit gave different tokens")
        print(f"phase prefix_cache (b) exact int8-KV: miss prefix_resolve_ms={miss['prefix_resolve_ms']} hit "
              f"prefix_resolve_ms={hit['prefix_resolve_ms']} skipped_frac={hit['prefill_tokens_skipped_frac']} "
              f"cache={json.dumps(eng.prefix_cache.counters())}", flush=True)
    finally:
        eng.generate_prefixed = real
        svc.shutdown()
    del svc, client, eng
    torch.cuda.empty_cache()

    # (c) chunk reuse, tiering on (for (d)), every chunk hot enough to shift
    svc, client, eng = _prefix_service(service_bits, max_new=16, tiering=True, reuse="chunk", chunk_hot_min=0.0)
    cache = eng.prefix_cache
    try:
        q = LATENCY_QUESTIONS[8]
        _prefixed_ask(svc, client, q, "(c) canonical")
        (context, segments, b_ids), results = _segments_of(svc, q)
        n_ctx = len(segments) - 1
        if n_ctx < 2:
            fail(f"prefix_cache (c): {n_ctx} chunk segment(s), no order to shuffle")
        before = cache.chunk_reuse_counters()
        # the same chunks retrieved in another order: the last one first
        shuffled = [results[n_ctx - 1]] + list(results[: n_ctx - 1]) + list(results[n_ctx:])
        timings, notes = {}, []
        resp = svc._answer_prefixed(q, shuffled, timings, time.monotonic(), notes)
        if resp is None or notes:
            fail(f"prefix_cache (c): the shuffled request fell off the prefixed path ({notes})")
        after = cache.chunk_reuse_counters()
        moved = {k: after[k] - before[k] for k in after}
        if moved["rerotated"] + moved["spliced"] <= 0:
            fail(f"prefix_cache (c): no chunk was re-rotated or spliced ({moved})")
        _, seg_shuf, _ = svc._prompt_segments(q, shuffled)
        cp = cache.prefix_for(seg_shuf)
        ids_shuf = [t for _, s in seg_shuf for t in s] + list(b_ids)
        ref = _logits_cold(eng, ids_shuf, plain=True)
        got = _rel(_logits_prefixed(eng, b_ids, cp), ref)
        # layer 0's K depends on the token and its position only: the
        # re-rotated blocks must give the cold prefill's, to bf16 rounding
        _, cold, start = _cold_prefill(eng, ids_shuf)
        plen = cp.length
        k0_cold = cold.k[0, 0, :, start : start + plen].float()
        k0 = _rel(cp.planes[0][0, 0, :, :plen].float(), k0_cold)
        del cp, cold
        # the planted fault: the same reuse with the re-rotation left out
        # (canonical K at the shifted positions), in a cache of its own
        from rag_llm_k8s_tpu_torch.engine.prefix_cache import PrefixCache

        alt = PrefixCache(eng.engine_config.prefix_cache, eng)
        alt.prefix_for(segments)
        rotate = eng.rerotate_segment_kv
        eng.rerotate_segment_kv = lambda planes, delta: planes
        try:
            k0_bad = _rel(alt.prefix_for(seg_shuf).planes[0][0, 0, :, :plen].float(), k0_cold)
        finally:
            eng.rerotate_segment_kv = rotate
            alt.clear()
        del k0_cold
        print(f"phase prefix_cache (c) chunk reuse: outcomes {json.dumps(moved)} prefix_resolve_ms="
              f"{timings['prefix_resolve_ms']:.2f} skipped_frac={timings['prefill_tokens_skipped_frac']:.4f}; "
              f"layer-0 K of the {plen}-token shuffled prefix vs the cold prefill's rel_rms={k0:.4g} (limit "
              f"{PREFIX_K0_TOL:.4g}; planted fault without the re-rotation {k0_bad:.4g}); last-token logits vs the "
              f"cold plain prefill rel_rms={got:.4g} (limit {Q8_FULL_RMS})", flush=True)
        if not k0 <= PREFIX_K0_TOL or k0_bad <= PREFIX_K0_TOL or not got < Q8_FULL_RMS:
            fail("prefix_cache (c): the re-rotated chunks' K or the logits stray past their limits, or the "
                 "check accepts the un-rotated fault")
        # rope_rerotate on the card against the CPU: the same bits (fp64
        # products and sums are IEEE on both; cos/sin come from the host)
        ek = next(k for k, e in cache._entries.items() if not e.pinned and e.tier == "hot")
        blk = cache._entries[ek].planes[0]
        from rag_llm_k8s_tpu_torch.models.llama import rope_frequencies

        invf = rope_frequencies(eng.config, blk.device)
        on_card = A.rope_rerotate(blk, 417, invf)
        on_cpu = A.rope_rerotate(blk.cpu(), 417, invf.cpu())
        kq, ksc = A.quantize_kv(blk.float())
        q_card = A.rope_rerotate_q8(kq, ksc, -417, invf)
        q_cpu = A.rope_rerotate_q8(kq.cpu(), ksc.cpu(), -417, invf.cpu())
        same = (torch.equal(on_card.cpu(), on_cpu) and torch.equal(q_card[0].cpu(), q_cpu[0])
                and torch.equal(q_card[1].cpu(), q_cpu[1]))
        t_rot = time_ms(lambda i: A.rope_rerotate(blk, 417 + i, invf), iters=5, warmup=1)
        print(f"phase prefix_cache (c) rope_rerotate on the card {tuple(blk.shape)} bf16: equal to the CPU "
              f"(bf16 and int8) {same}; ms={t_rot:.4f}", flush=True)
        if not same:
            fail("prefix_cache (c): rope_rerotate on the card differs from the CPU")
        # no reference to an entry's planes may outlive its demotion below
        del blk, on_card, on_cpu, kq, ksc, q_card, q_cpu

        # (d) tiering on the same cache
        cp_hot = cache.prefix_for(segments)
        hot = _logits_prefixed(eng, b_ids, cp_hot)
        del cp_hot
        torch.cuda.synchronize()
        mem0, st0 = torch.cuda.memory_allocated(), cache.tier_stats()
        n_warm = cache.force_demote("warm")
        torch.cuda.synchronize()
        mem1, st1 = torch.cuda.memory_allocated(), cache.tier_stats()
        dev0, dev1 = st0["tier_hot_bytes"] + st0["tier_warm_bytes"], st1["tier_hot_bytes"] + st1["tier_warm_bytes"]
        if n_warm <= 0 or not dev1 < dev0 or not mem1 < mem0:
            fail(f"prefix_cache (d) warm: {n_warm} demoted, device bytes {dev0} -> {dev1}, allocated {mem0} -> {mem1}")
        with cache._lock:
            for k in list(cache._assembled):
                cache._pop_assembled(k)
        _prefixed_ask(svc, client, q, "(d) warm")
        warm = _logits_prefixed(eng, b_ids, cache.prefix_for(segments))
        rel_warm = _rel(warm, hot)
        print(f"phase prefix_cache (d) warm: {n_warm} entries demoted, cache device bytes {dev0} -> {dev1}, "
              f"allocated {mem0} -> {mem1}; the next answer's logits vs hot rel_rms={rel_warm:.4g} "
              f"(limit {Q8_FULL_RMS}) tiers {json.dumps(cache.tier_stats())}", flush=True)
        if not rel_warm < Q8_FULL_RMS:
            fail("prefix_cache (d) warm: the int8 round trip strays past the int8 limit")
        # cold: host spill, then a swap-in that must restore the same bytes
        with cache._lock:
            for k in list(cache._assembled):
                cache._pop_assembled(k)
        snap = {k: tuple(p.clone() for p in e.planes) for k, e in cache._entries.items()
                if not e.pinned and e.tier != "cold"}
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated()
        n_cold = cache.force_demote("cold")
        torch.cuda.synchronize()
        mem3, st3 = torch.cuda.memory_allocated(), cache.tier_stats()
        t0 = time.perf_counter()
        cache.prefix_for(segments)
        torch.cuda.synchronize()
        swap_ms = (time.perf_counter() - t0) * 1e3
        st4 = cache.tier_stats()
        swapped = [k for k in snap if k in cache._entries and cache._entries[k].tier != "cold"
                   and k[0] in {s for s, _ in segments}]
        identical = all(all(torch.equal(a, b) for a, b in zip(cache._entries[k].planes, snap[k])) for k in swapped)
        print(f"phase prefix_cache (d) cold: {n_cold} entries spilled ({st3['tier_cold_host_bytes']} host bytes), "
              f"allocated {mem2} -> {mem3}; resolve with {st4['swap_ins_demand'] - st3['swap_ins_demand']} "
              f"swap-ins ms={swap_ms:.2f}; {len(swapped)} swapped-in entries byte-identical {identical}", flush=True)
        if n_cold <= 0 or not mem3 < mem2 or not swapped or not identical:
            fail("prefix_cache (d) cold: the spill freed nothing or the swap-in changed the bytes")
        del snap
        # a planted kv_swap_in fault: recompute, no leaked host buffer
        with cache._lock:
            for k in list(cache._assembled):
                cache._pop_assembled(k)
        cache.force_demote("cold")
        fb0 = cache.tier_stats()["swap_in_fallbacks"]
        faults.arm("kv_swap_in")
        try:
            cp = cache.prefix_for(segments)
        finally:
            faults.clear()
        st5 = cache.tier_stats()
        cold_keys = {k for k, e in cache._entries.items() if e.tier == "cold"}
        spilled = {m["key"] for m in cache.spill.manifest()}
        leak = spilled != cold_keys or cache.entry_bytes != sum(e.nbytes for e in cache._entries.values())
        print(f"phase prefix_cache (d) kv_swap_in fault: fallbacks {fb0} -> {st5['swap_in_fallbacks']}, "
              f"recomputed {cp.computed_tokens} tokens, spill entries {len(spilled)} = cold entries "
              f"{len(cold_keys)}, leak {leak}", flush=True)
        if st5["swap_in_fallbacks"] != fb0 + 1 or cp.computed_tokens <= 0 or leak:
            fail("prefix_cache (d): the planted kv_swap_in fault did not fall back cleanly")
        del cp
        _prefixed_ask(svc, client, q, "(d) after the fault")
    finally:
        svc.shutdown()
    del svc, client, eng, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the dense continuous cache, the paged verify and engine tasks
# ---------------------------------------------------------------------------

# the paged continuous service's numbers, per tag, printed beside the dense ones
CONT_SUMMARY = {}
SPEC_K = 7  # EngineConfig.spec_paged_tokens' default
# the engine-level identity checks: RAG-length prompts (two in the 4,096
# bucket, one in the 2,048, one in the 4,096 again), each followed for
# FOLLOW_TOKENS greedy tokens (int8: FOLLOW_TOKENS_Q8)
FOLLOW_LENS = [2906, 3050, 1500, 2999]
FOLLOW_TOKENS, FOLLOW_TOKENS_Q8 = 40, 24


def _cont_service(service_bits, ec, max_new=None, greedy=False):
    """A continuous service over the main service's model, store, encoder
    and tokenizers: ``build_scheduler`` as ``server/main.py`` calls it, or,
    with ``max_new``, the same engine with its token budget cut (and, with
    ``greedy``, greedy sampling)."""
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
    from rag_llm_k8s_tpu_torch.server.app import RagService, build_scheduler, create_app

    svc1, _, engine, store = service_bits
    if max_new is None:
        sched = build_scheduler(engine, ec)
    else:
        sampling = dataclasses.replace(engine.sampling, max_new_tokens=max_new,
                                       **({"do_sample": False} if greedy else {}))
        cont = ContinuousEngine(engine.config, engine.model, sampling, ec, engine.dtypes, engine.device, engine.pad_id)
        sched = ContinuousScheduler(cont)
    svc = RagService(dataclasses.replace(svc1.config, engine=ec), engine, svc1.llm_tokenizer, svc1.encoder,
                     svc1.encoder_tokenizer, store, scheduler=sched)
    svc.ready = True
    return svc, create_app(svc).test_client(), sched.engine


def _burst(svc, client, questions, greedy=False):
    """The questions at once from threads (``/generate``, or greedy through
    ``RagService.answer``); returns the bodies, wall seconds and the decode
    tokens the continuous engine counted. Fails unless every one is a 200
    with a context."""
    import threading

    import torch

    sampling = dataclasses.replace(svc.config.sampling, do_sample=False) if greedy else None
    out = [None] * len(questions)
    eng = svc.scheduler.engine

    def ask(i):
        if greedy:
            try:
                out[i] = (200, svc.answer(questions[i], sampling=sampling))
            except Exception as e:  # noqa: BLE001 — reported as the route would
                out[i] = (500, {"error": str(e)})
        else:
            r = client.post("/generate", json_body={"prompt": questions[i]})
            out[i] = (r.status_code, r.get_json())

    dec0 = eng.stats.decode_tokens
    t0 = time.monotonic()
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(questions))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if any(th.is_alive() for th in threads):
        fail("a continuous burst did not finish within 900 s")
    for i, (code, body) in enumerate(out):
        if code != 200 or not isinstance(body.get("generated_text"), str) or "Document '" not in body.get(
                "context", ""):
            fail(f"continuous burst request {i}: {code} {body}")
    return [b for _, b in out], wall, eng.stats.decode_tokens - dec0


def _follow_prompts(engine):
    import numpy as np

    rng = np.random.default_rng(41)
    return [[engine.config.bos_token_id] + [int(x) for x in rng.integers(3, 259, n - 1)] for n in FOLLOW_LENS]


def _record_plain(cont, prompts, max_new, admit=None):
    """Greedy streams of ``prompts`` through a plain continuous engine at
    ``decode_sync_steps = 1`` (each admitted alone, then decoded together),
    with the logits of every draw kept on the card: ``(streams, logits)``,
    ``logits[j][i]`` the fp32 ``[V]`` logits that drew token ``i`` of
    request ``j``. ``admit(j, prompt)`` replaces the admission (default
    ``admit_many``), returning ``(row, finished)`` or an exception."""
    row_of, logits, out = {}, [[] for _ in prompts], {}
    real = cont._sample

    def sample(lg, positions, rows=None):
        tok = real(lg, positions, rows)
        if rows is not None:
            for k, r in enumerate(rows.tolist()):
                logits[row_of[r]].append(lg[k].float().clone())
        else:
            for r, j in row_of.items():
                if cont.slots[r].active and cont.slots[r].request_id == j:
                    logits[j].append(lg[r].float().clone())
        return tok

    cont._sample = sample
    try:
        for j, p in enumerate(prompts):
            row_of[cont.free_slots()[0]] = j
            res = cont.admit_many([(j, p, max_new, None)])[0] if admit is None else admit(j, p)
            if isinstance(res, BaseException):
                fail(f"recording a plain stream: admission {j} failed: {res!r}")
            if res[1] is not None:
                out[j] = res[1]
        while cont.has_active():
            out.update(dict(cont.step()))
    finally:
        del cont._sample
    streams = [out[j] for j in range(len(prompts))]
    return streams, [lg[:len(s)] for lg, s in zip(logits, streams)]


class _Follow:
    """Teacher-forces an engine's greedy rows along a recorded plain run
    (``_record_plain``) through its real windows: every draw (a plain
    step's, or each plane of a verify window) is held to the plain run's
    logits at the same token within ``limit`` (relative RMS); where the
    engine's own pick differs from the plain stream's token, the plain
    logits' margin between the two must lie within twice the largest logit
    difference there (a near-tie that the measured difference explains).
    Then the plain token is fed on, so every token of every stream is
    compared. With ``drafts``, verify windows get the plain stream's next
    tokens as drafts: ``drafts(window, rows)`` names the rows that draft in
    a window."""

    def __init__(self, cont, streams, logits, limit, drafts=None):
        self.cont, self.streams, self.logits, self.limit = cont, streams, logits, limit
        self.rows, self.start, self.offered = {}, {}, {}
        self.calls = self.window = self.compared = self.planes = self.planes_agreed = 0
        self.worst, self.forks, self.routes = 0.0, [], []
        real_sample, real_targets, real_step = cont._sample, cont._sample_targets, cont.step
        real_worth = cont._verify_worthwhile

        def step():
            self.start = {r: len(cont.slots[r].tokens) for r in self.live_rows()}
            self.calls = 0
            self.offered = {}
            out = real_step()
            self.window += 1
            return out

        def sample(lg, positions, rows=None):
            tok = real_sample(lg, positions, rows)
            seen = [(k, r, 0) for k, r in enumerate(rows.tolist())] if rows is not None else [
                (r, r, s + self.calls) for r, s in self.start.items()]
            for k, r, i in seen:
                g = self._see(r, i, lg[k], tok[k])
                if g is not None:
                    tok[k] = g
            self.calls += rows is None
            return tok

        def targets(lg, positions):
            t = real_targets(lg, positions)
            for r, s in self.start.items():
                nd = self.offered.get(r, 0)
                for p in range(nd + 1):
                    own = int(t[r, p])
                    g = self._see(r, s + p, lg[r, p], own)
                    if g is None:
                        break
                    if p < nd:
                        self.planes += 1
                        self.planes_agreed += own == g
                    t[r, p] = g
            return t

        def worth(d):
            ok = real_worth(d)
            self.routes.append(ok)
            return ok

        cont.step, cont._sample, cont._sample_targets, cont._verify_worthwhile = step, sample, targets, worth
        if drafts is not None:
            def draft_for_slots():
                out = {}
                rows = self.live_rows()
                chosen = drafts(self.window, sorted(rows))
                for r in rows:
                    s, j = cont.slots[r], self.rows[r]
                    k = min(cont.spec_K, s.remaining - 1, cont.T - 2 - s.kv_ub)
                    n = len(s.tokens)
                    out[r] = list(self.streams[j][n:n + k]) if r in chosen and k >= 1 else []
                self.offered = {r: len(d) for r, d in out.items()}
                return out

            cont._draft_for_slots = draft_for_slots

    def live_rows(self):
        return [r for r, j in self.rows.items() if self.cont.slots[r].active and self.cont.slots[r].request_id == j]

    def _see(self, r, i, lg, tok):
        """Row ``r``'s draw of token ``i``: the plain stream's token to feed
        on, or None past the plain stream's end."""
        j = self.rows.get(r)
        if j is None or i >= len(self.streams[j]):
            return None
        ref = self.logits[j][i]
        lg = lg.float()
        rel = _rel(lg, ref)
        self.worst = max(self.worst, rel)
        self.compared += 1
        if not rel <= self.limit:
            fail(f"follow: request {j} token {i}: logits rel rms {rel:.4g} from the plain run (limit "
                 f"{self.limit:.4g})")
        want, got = self.streams[j][i], int(tok)
        if got != want:
            delta = (lg - ref).abs().max().item()
            margin = (ref[want] - ref[got]).item()
            self.forks.append((j, i, round(margin, 4), round(delta, 4)))
            if margin > 2 * delta:
                fail(f"follow: request {j} token {i}: drew {got} where the plain run drew {want} with a "
                     f"margin {margin:.4g} past twice the logits' difference {delta:.4g}")
        return want

    def run(self, prompts, max_new):
        """Admit ``prompts`` one at a time, then step to the end."""
        out = {}
        for j, p in enumerate(prompts):
            self.rows[self.cont.free_slots()[0]] = j
            res = self.cont.admit_many([(j, p, max_new, None)])[0]
            if isinstance(res, BaseException):
                fail(f"follow: admission {j} failed: {res!r}")
            if res[1] is not None:
                out[j] = res[1]
        while self.cont.has_active():
            out.update(dict(self.cont.step()))
        for j, want in enumerate(self.streams):
            if out[j][:len(want)] != want:
                fail(f"follow: request {j}'s stream left the plain stream it was fed")

    def line(self):
        return (f"draws_compared={self.compared} worst_logits_rel_rms={self.worst:.4g} (limit {self.limit:.4g}) "
                f"near_tie_forks(request, token, plain margin, max logit diff)={self.forks}")


def _free(cont):
    """Drop an engine's cache and return its memory to the card."""
    import torch

    cont.arena = cont.cache = None
    torch.cuda.empty_cache()


def _noise_limit(one_shot, ids, what):
    """``PREFIX_NOISE_FACTOR`` times the kernels' cold-prefill distance from
    the plain attention's (the bf16 noise floor at full depth) at ``ids``."""
    floor = _rel(_logits_cold(one_shot, ids), _logits_cold(one_shot, ids, plain=True))
    lim = max(PREFIX_NOISE_FACTOR * floor, 1e-3)
    print(f"{what}: noise floor (cold prefill, kernels vs plain) rel_rms={floor:.4g}, limit {lim:.4g}", flush=True)
    return lim


def phase_continuous_dense(service_bits, tag="bf16", need=("knn_topk", "flash_attention", "decode_attention"),
                           forbid=PAGED_KERNELS, max_new=None, follow_tokens=FOLLOW_TOKENS):
    """(b) The dense continuous cache (``TPU_RAG_BATCHING=continuous``,
    ``TPU_RAG_KV_PAGED=0``): the service's device bytes and
    ``memory_allocated`` around its construction; 8 concurrent
    ``/generate`` (default sampling), then 4 greedy requests, with the
    launch counters zeroed before and read after (the dense decode and
    flash ran, no paged kernel); tokens/s and window ms beside the paged
    service's. Then the identity check: a dense engine at
    ``decode_sync_steps = 4`` followed draw by draw against a plain paged
    engine's greedy run of 4 RAG-length prompts (``_Follow``)."""
    import torch

    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
    from rag_llm_k8s_tpu_torch.ops import _build

    engine = service_bits[2]
    ec = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=False)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t = time.monotonic()
    svc, client, cont = _cont_service(service_bits, ec, max_new)
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    mode = client.get("/healthz").get_json()["engine_mode"]
    cache_b = sum(p.numel() * p.element_size() for p in cont._cache_planes())
    c = engine.config
    elt = torch.finfo(engine.dtypes.compute_dtype).bits // 8
    want_b = 2 * c.num_layers * cont.B * c.num_kv_heads * cont.T * (
        c.head_dim + 4 if ec.kv_quant == "int8" else elt * c.head_dim)
    print(f"phase continuous_dense {tag} build: engine_mode={mode} cache={list(cont.cache.k.shape)} "
          f"{cont.cache.k.dtype} cache_bytes={cache_b} (expected {want_b}) memory_allocated {m0} -> {m1} "
          f"(+{m1 - m0}) s={time.monotonic() - t:.1f}", flush=True)
    if mode != "continuous" or cont.kv_pool is not None or cache_b != want_b or m1 - m0 < cache_b:
        fail(f"dense continuous service: mode {mode!r}, cache bytes {cache_b} (want {want_b}), "
             f"allocated +{m1 - m0}")
    _build.reset_launches()
    before = dataclasses.replace(cont.stats)
    bodies, wall, dec = _burst(svc, client, CONT_QUESTIONS)
    g_bodies, g_wall, g_dec = _burst(svc, client, CONT_QUESTIONS[4:], greedy=True)
    launches = dict(_build.LAUNCHES)
    st = cont.stats
    n_win = st.windows - before.windows
    paged = CONT_SUMMARY.get(tag, {})
    print(f"phase continuous_dense {tag}: 8 requests (default sampling) wall_s={wall:.2f} decode_tokens={dec} "
          f"decode_tok_per_s={dec / wall:.1f}; 4 greedy wall_s={g_wall:.2f} decode_tokens={g_dec} "
          f"decode_tok_per_s={g_dec / g_wall:.1f}; {_windows(st, before)} "
          f"prefill_calls={st.prefill_calls - before.prefill_calls} windows={n_win} device_cache_gb={cache_b / 1e9:.2f}"
          f" | paged service (same call, interleaved admission): {json.dumps(paged)}", flush=True)
    for i, b in enumerate(bodies + g_bodies):
        print(f"request {tag} dense continuous {i} timings={json.dumps(b['timings'])}", flush=True)
    _launch_check(f"{tag} dense continuous path", launches, need, forbid)
    if cont.has_active():
        fail("dense continuous service: rows still active after the bursts")
    svc.shutdown()
    _free(cont)

    # the identity check, engine level
    prompts = _follow_prompts(engine)
    lim = _noise_limit(engine, prompts[0], f"phase continuous_dense {tag} follow")
    greedy = SamplingConfig(do_sample=False)
    bs = 32 if ec.kv_quant == "int8" else 16
    plain = ContinuousEngine(engine.config, engine.model, greedy, dataclasses.replace(
        ec, kv_paged=True, kv_block_size=bs, interleave_prefill=False, decode_sync_steps=1),
        engine.dtypes, engine.device, engine.pad_id)
    streams, logits = _record_plain(plain, prompts, follow_tokens)
    _free(plain)
    dense = ContinuousEngine(engine.config, engine.model, greedy, dataclasses.replace(ec, decode_sync_steps=4),
                             engine.dtypes, engine.device, engine.pad_id)
    f = _Follow(dense, streams, logits, lim)
    f.run(prompts, follow_tokens)
    shifted = min(_rel(logits[j][i + 1], logits[j][i]) for j in range(len(prompts))
                  for i in range(len(logits[j]) - 1))
    print(f"phase continuous_dense {tag} follow (decode_sync_steps=4, fed the paged engine's greedy run, "
          f"{len(prompts)} prompts of {FOLLOW_LENS} tokens, {follow_tokens} tokens each): {f.line()}; planted "
          f"fault (each draw against the next token's logits) least rel_rms={shifted:.4g}", flush=True)
    if shifted <= lim:
        fail("dense continuous follow: the check accepts logits one token off")
    _free(dense)
    return launches


def _recorded_drafts(cont, recorded, every=None):
    """A drafter for the paged verify over a service burst (it replaces
    ``_draft_for_slots``): each row drafts the next tokens of the stream the
    same request gave with the verify off (``recorded``: prompt ids ->
    tokens), while its tokens still follow that stream. ``every(window,
    rows)`` names the rows that draft in a window (default all). Prompt
    lookup finds nothing to draft in the output of random weights, which
    never repeats itself (``phase_spec_paged``'s first burst), so this is
    how a burst drives the verify windows, their routing and acceptance."""
    n_win = [0]
    real_step = cont.step

    def step():
        n_win[0] += 1
        return real_step()

    def drafts():
        out = {}
        rows = [r for r, s in enumerate(cont.slots) if s.active]
        chosen = rows if every is None else every(n_win[0], rows)
        for r in rows:
            s = cont.slots[r]
            n = len(s.tokens)
            want = recorded.get(tuple(s.history[:len(s.history) - n]), [])
            k = min(cont.spec_K, s.remaining - 1, cont.T - 2 - s.kv_ub)
            ok = r in chosen and k >= 1 and want[:n] == s.tokens
            out[r] = list(want[n:n + k]) if ok else []
        return out

    cont.step, cont._draft_for_slots = step, drafts


def phase_spec_paged(service_bits, tag="bf16", need=("knn_topk", "flash_attention", "paged_chunk_attention"),
                     forbid=("decode_attention", "chunk_prefill_attention", "decode_attention_q8",
                             "chunk_prefill_attention_q8", "paged_decode_attention_q8",
                             "paged_chunk_attention_q8"),
                     block_size=16, max_new=None, follow_tokens=FOLLOW_TOKENS):
    """(c) The paged verify (``TPU_RAG_SPEC_PAGED=1``, K = 7, interleave
    off, so that only verify windows launch ``paged_chunk_attention``), 8
    concurrent greedy requests over RAG prompts in four bursts: the verify
    off (each request's tokens kept), on with prompt lookup (the
    deployment's drafter), on with each row drafting its own spec-off
    stream (``_recorded_drafts``: the counters zeroed before and read
    after, verify windows must run and accept), and that at
    ``decode_sync_steps = 4`` with one row drafting in even windows and all
    in odd ones, so that ``_verify_worthwhile`` answers both ways. Each
    prints its drafted, accepted and emitted tokens and windows. Then the
    identity checks, engine level, against a plain paged engine's greedy
    run (``_Follow``): every row drafting the plain stream's next tokens
    each window (each verify plane's logits against the plain step's, and
    a plane the verify rejects only at a near-tie), and at
    ``decode_sync_steps = 4`` with the same pattern of drafting rows."""
    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
    from rag_llm_k8s_tpu_torch.ops import _build

    engine = service_bits[2]
    base = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=True,
                               kv_block_size=block_size, interleave_prefill=False)
    spec = dataclasses.replace(base, spec_paged=True, spec_paged_tokens=SPEC_K)
    one_or_all = lambda w, rows: rows if w % 2 else rows[:1]  # noqa: E731
    recorded, texts, rates = {}, {}, {}
    for label, ec, drafter in (("off", base, None), ("prompt lookup", spec, None),
                               ("recorded drafts", spec, {}),
                               ("recorded drafts, sync=4", dataclasses.replace(spec, decode_sync_steps=4),
                                {"every": one_or_all})):
        svc, client, cont = _cont_service(service_bits, ec, max_new)
        sched = svc.scheduler
        if label == "off":
            real_submit = sched.submit

            def submit(prompt, *a, **k):
                out = real_submit(prompt, *a, **k)
                recorded[tuple(prompt)] = list(out)
                return out

            sched.submit = submit
        if drafter is not None:
            _recorded_drafts(cont, recorded, **drafter)
        routes = []
        real_worth = cont._verify_worthwhile
        cont._verify_worthwhile = lambda d: routes.append(real_worth(d)) or routes[-1]  # noqa: E731
        _build.reset_launches()
        before = dataclasses.replace(cont.stats)
        bodies, wall, dec = _burst(svc, client, CONT_QUESTIONS, greedy=True)
        launches = dict(_build.LAUNCHES)
        texts[label] = [b["generated_text"] for b in bodies]
        st = cont.stats
        rates[label] = dec / wall
        drafted = st.spec_drafted_tokens - before.spec_drafted_tokens
        accepted = st.spec_accepted_tokens - before.spec_accepted_tokens
        n_verify = st.spec_verify_steps - before.spec_verify_steps
        print(f"phase spec_paged {tag} {label}: 8 greedy requests wall_s={wall:.2f} decode_tokens={dec} "
              f"decode_tok_per_s={dec / wall:.1f} drafted_tokens={drafted} accepted_tokens={accepted} "
              f"emitted_tokens={st.spec_emitted_tokens - before.spec_emitted_tokens} "
              f"acceptance_rate={accepted / max(drafted, 1):.4f} "
              f"drafted_rows={st.spec_drafted_rows - before.spec_drafted_rows} {_windows(st, before)} "
              f"verify_worthwhile(True, False)=({sum(routes)}, {len(routes) - sum(routes)}) "
              f"texts_as_with_the_verify_off={sum(a == b for a, b in zip(texts[label], texts['off']))}/8 "
              f"launches={json.dumps(launches)}", flush=True)
        if drafter is not None:
            if n_verify <= 0 or accepted <= 0:
                fail(f"spec_paged {tag} {label}: no verify window accepted a draft in the burst")
            _launch_check(f"{tag} paged verify path ({label})", launches, need, forbid)
        if "every" in (drafter or {}) and (sum(routes) == 0 or sum(routes) == len(routes)):
            fail(f"spec_paged {tag} {label}: _verify_worthwhile did not answer both ways: {routes}")
        if cont.kv_pool.blocks_in_use():
            fail(f"spec_paged {tag} {label}: {cont.kv_pool.blocks_in_use()} blocks in use after the burst")
        svc.shutdown()
        _free(cont)
    print(f"phase spec_paged {tag}: decode tokens/s {json.dumps({k: round(v, 1) for k, v in rates.items()})}",
          flush=True)

    # the identity checks, engine level
    prompts = _follow_prompts(engine)
    lim = _noise_limit(engine, prompts[0], f"phase spec_paged {tag} follow")
    greedy = SamplingConfig(do_sample=False)
    ec1 = dataclasses.replace(base, decode_sync_steps=1)
    plain = ContinuousEngine(engine.config, engine.model, greedy, ec1, engine.dtypes, engine.device, engine.pad_id)
    streams, logits = _record_plain(plain, prompts, follow_tokens)
    _free(plain)
    for sync, pattern in ((1, lambda w, rows: rows), (4, one_or_all)):
        eng = ContinuousEngine(engine.config, engine.model, greedy, dataclasses.replace(
            ec1, spec_paged=True, spec_paged_tokens=SPEC_K, decode_sync_steps=sync), engine.dtypes,
            engine.device, engine.pad_id)
        _build.reset_launches()
        f = _Follow(eng, streams, logits, lim, drafts=pattern)
        f.run(prompts, follow_tokens)
        st = eng.stats
        print(f"phase spec_paged {tag} follow (drafts: the plain stream, decode_sync_steps={sync}): {f.line()} "
              f"verify_windows={st.spec_verify_steps} drafted={st.spec_drafted_tokens} "
              f"draft_planes_the_verify_itself_accepted={f.planes_agreed}/{f.planes} "
              f"verify_worthwhile(True, False)=({sum(f.routes)}, {len(f.routes) - sum(f.routes)}) "
              f"launches={json.dumps(dict(_build.LAUNCHES))}", flush=True)
        if st.spec_verify_steps <= 0 or f.planes <= 0:
            fail(f"spec_paged {tag} follow: no verify window judged a draft")
        if sync == 4 and (sum(f.routes) == 0 or sum(f.routes) == len(f.routes)):
            fail(f"spec_paged {tag} follow: _verify_worthwhile did not answer both ways: {f.routes}")
        if eng.kv_pool.blocks_in_use():
            fail(f"spec_paged {tag} follow: blocks still in use")
        _free(eng)


def phase_engine_tasks(service_bits, n_requests=4, max_new=48):
    """(d) Engine tasks on a dense continuous service with the prefix cache
    and tiering on (``TPU_RAG_KV_TIERING=1``, a 0.5 s hotness half-life):
    one solo request fills the cache, then during a burst a forced tier
    sweep demotes its chunks, whose mirror queues a retier task on the
    scheduler (``run_on_engine``), and a task that raises is queued beside
    it. Both must run on the scheduler's thread while rows decode, and the
    burst must finish."""
    import threading

    from rag_llm_k8s_tpu_torch.core.config import KVTieringConfig, PrefixCacheConfig

    engine = service_bits[2]
    ec = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=False,
                             prefix_cache=PrefixCacheConfig(enabled=True),
                             kv_tiering=KVTieringConfig(enabled=True, half_life_s=0.5))
    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
    from rag_llm_k8s_tpu_torch.server.app import RagService, create_app

    svc1, _, _, store = service_bits
    eng = InferenceEngine(engine.config, engine.model, dataclasses.replace(engine.sampling, max_new_tokens=max_new),
                          ec, engine.dtypes, engine.device)
    cont = ContinuousEngine(engine.config, engine.model, eng.sampling, ec, engine.dtypes, engine.device,
                            engine.pad_id)
    sched = ContinuousScheduler(cont)
    svc = RagService(dataclasses.replace(svc1.config, engine=ec), eng, svc1.llm_tokenizer, svc1.encoder,
                     svc1.encoder_tokenizer, store, scheduler=sched)
    svc.ready = True
    client = create_app(svc).test_client()
    ran = []
    real_run = sched.run_on_engine

    def traced(fn):
        def task(e):
            ran.append((getattr(fn, "__name__", "task"), threading.current_thread().name, e.has_active()))
            return fn(e)
        return real_run(task)

    sched.run_on_engine = traced
    r = client.post("/generate", json_body={"prompt": CONT_QUESTIONS[0]})
    entries = len(eng.prefix_cache._entries)
    if r.status_code != 200 or entries == 0:
        fail(f"engine tasks: the solo request ({r.status_code}) left {entries} prefix-cache entries")
    time.sleep(2.5)  # five half-lives: the chunks' hotness falls under the thresholds
    out = {}
    # greedy (a per-request sampling) keeps every request on the continuous engine
    th = threading.Thread(target=lambda: out.update(
        r=_burst(svc, client, CONT_QUESTIONS[1:1 + n_requests], greedy=True)))
    th.start()
    t_end = time.monotonic() + 120
    while not cont.has_active() and time.monotonic() < t_end:
        time.sleep(0.01)
    moved = eng.prefix_cache.retier(force=True)
    sched.run_on_engine(lambda e: 1 / 0)
    th.join(timeout=900)
    if "r" not in out:
        fail("engine tasks: the burst did not finish")
    _, wall, dec = out["r"]
    retier = [x for x in ran if x[0] == "_retier_task"]
    print(f"phase engine_tasks: prefix entries={entries} tier moves={moved} tasks run (name, thread, rows "
          f"active)={ran} burst of {n_requests} after the raising task: wall_s={wall:.2f} decode_tokens={dec}",
          flush=True)
    if not retier or any(x[1] != "continuous-scheduler" for x in ran):
        fail(f"engine tasks: no retier task ran on the scheduler thread (moves {moved}, tasks {ran})")
    if not all(x[2] for x in ran) or "<lambda>" not in [x[0] for x in ran]:
        fail(f"engine tasks: the tasks did not run during the burst: {ran}")
    svc.shutdown()
    _free(cont)
    del svc, eng


# ---------------------------------------------------------------------------
# retrieval lookahead and the continuous half of the prefix cache
# ---------------------------------------------------------------------------

LOOKAHEAD_PLEN = 2900  # a RAG prompt's prefix (head and chunks), tokens
# (case, S, write_index, real lanes) of kernels 9 and 10 on this path: the
# suffix prefill over the row's table at two suffix buckets, and chunk
# reuse's boundary window at a chunk's block-aligned offset
LOOKAHEAD_PAGED = (("suffix C=128", 128, LOOKAHEAD_PLEN, 41), ("suffix C=512", 512, LOOKAHEAD_PLEN, 300),
                   ("boundary W=16", 16, 1120, 16))
# (C, suffix tokens) of kernel 4 over the dense admission's T_build cache
LOOKAHEAD_DENSE = ((128, 41), (512, 300), (2048, 1100))
# extra pool blocks of the HTTP leg's engines: eight prestaged chains of
# ~181 blocks beside eight rows, so a burst's group never waits on them
LOOKAHEAD_SPARE_BLOCKS = 1600
SESSION_TURNS = {
    "s1": ["which kernel tiles the shared memory?", "and how does the cache stream tokens?",
           "what bounds the decode latency then?"],
    "s2": ["where is the vector index kept?", "what does the warp block share?",
           "how is the prefill chunk scheduled?"],
}


def _lookahead_paged_case(tag, S, wi, n, q8, g):
    """Kernel 9 (or 10) at a prefixed admission's shape: B = 1, ``S``
    lanes at logical ``wi``, ``n`` of them real (kv_len = wi + n; the pad
    lanes see the same window), over a 4,352-slot row, NaN in every block
    the row does not own and past its frontier; planted faults must be
    rejected. bf16 blocks of 16, int8 blocks of 32."""
    import torch

    from rag_llm_k8s_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    L, B, H, K, hd, layer = 4, 1, 32, 8, 128, 3
    bs = 32 if q8 else 16
    MB = 4352 // bs
    kv_l = [wi + n]
    (ka, va), (kz, vz), tables = _paged_q8_case(L, B, K, hd, bs, MB, layer, kv_l, g)
    q = torch.randn(B, S, H, hd, device=dev, generator=g).to(torch.bfloat16)
    kv_len = torch.tensor(kv_l, dtype=torch.int32, device=dev)
    wi_t = torch.tensor([wi], dtype=torch.int32, device=dev)
    _sharpen_paged(q, (ka, kz), layer, tables, [wi], kv_l, [n])
    name = "paged_chunk_attention_q8" if q8 else "paged_chunk_attention"
    if q8:
        (k8, ksz, v8, vsz), (k8x, ksn, v8x, vsn) = _q8_arena(ka, va, kz, vz, g)
        kern = lambda lay: A.paged_chunk_attention_q8(q, k8x, v8x, ksn, vsn, tables, kv_len, lay, wi_t)  # noqa: E731
        plain = lambda lay, t=tables, kl=kv_len, w=wi_t: A.paged_chunk_attention_xla_q8(  # noqa: E731
            q, k8, v8, ksz, vsz, t, kl, lay, w)
    else:
        kern = lambda lay: A.paged_chunk_attention(q, ka, va, tables, kv_len, lay, wi_t)  # noqa: E731
        plain = lambda lay, t=tables, kl=kv_len, w=wi_t: A.paged_chunk_attention_xla(  # noqa: E731
            q, kz, vz, t, kl, lay, w)
    got = kern(layer)
    torch.cuda.synchronize()
    err, rms = _paged_check(f"{name} lookahead {tag}", got, plain(layer))
    last = (kv_l[0] - 1) // bs
    swapped = tables.clone()
    swapped[0, [1, last]] = swapped[0, [last, 1]]
    faulty = {"kv_len-1": plain(layer, kl=kv_len - 1), "layer-1": plain(layer - 1),
              f"table entries 1,{last} swapped": plain(layer, t=swapped),
              "write_index+1": plain(layer, w=wi_t + 1), "write_index-1": plain(layer, w=wi_t - 1)}
    fault_rms = _paged_faults(f"{name} lookahead {tag}", got, faulty)
    del got, faulty
    ms = time_ms(lambda i: kern(layer - i % 2), iters=32 if S <= 128 else 16)
    plain_ms = time_ms(lambda i: plain(layer - i % 2), iters=3, warmup=1)
    pairs = sum(min(wi + t + 1, kv_l[0]) for t in range(S))
    key_bytes = q8_key_bytes(K, hd) if q8 else 2 * K * hd * 2
    b_ms, b_by = bound(kv_l[0] * key_bytes + 2 * q.numel() * 2, 4.0 * H * hd * pairs, BF16_FLOPS)
    row = dict(case=tag, shape=f"B=1 S={S} H=32 K=8 hd=128 bs={bs} write_index={wi} kv_len={kv_l[0]}",
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, rel_rms=rms,
               library_ms=None)
    lib = "none (no single PyTorch call reads an int8 arena)"
    if not q8:
        # SDPA over a dense copy of the row's blocks (gathered outside the timing)
        T = MB * bs
        dense = [a[lay][tables.long()].permute(0, 2, 1, 3, 4).reshape(B, K, T, hd)
                 for a in (kz, vz) for lay in (layer, layer - 1)]
        pos = torch.arange(T, device=dev)
        qpos = wi_t[:, None] + torch.arange(S, device=dev)[None, :]
        mask = ((pos[None, None, :] < kv_len[:, None, None]) & (pos[None, None, :] <= qpos[:, :, None]))[:, None]
        qt = q.transpose(1, 2)
        row["library_ms"] = time_ms(lambda i: sdpa(qt, dense[i % 2], dense[2 + i % 2], mask), iters=8)
        lib = f"{row['library_ms']:.4f} (SDPA over a dense copy)"
        del dense
    print(f"phase lookahead (a) {name} {tag} {row['shape']} "
          f"{_plan_line(A.chunk_launch_plan(B, S, H, K, MB * bs, _sms()))}: {_attn_line(err, rms, fault_rms)} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={b_ms:.4f} ({b_by})", flush=True)
    return name, row


def phase_lookahead_kernels(rows):
    """(a) of ``phase_lookahead``: kernels 9 and 10 at a prefixed
    admission's suffix prefill (B = 1, C = 128 and 512 lanes at logical
    ``plen`` ~ 2,900) and at chunk reuse's 16-token boundary window, and
    kernel 4 at the dense admission's ``T_build = ceil128(S + P + C)``
    cache, each against its plain version (NaN outside the window for the
    kernel) and timed beside its bound and SDPA (bf16)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(51)
    for q8 in (False, True):
        for tag, S, wi, n in LOOKAHEAD_PAGED:
            name, row = _lookahead_paged_case(tag, S, wi, n, q8, g)
            rows[name].setdefault("lookahead_shapes", []).append(row)
            torch.cuda.empty_cache()
    S_b = 4096  # the continuous engine's largest bucket under the default ladder
    for C, slen in LOOKAHEAD_DENSE:
        start = S_b - (LOOKAHEAD_PLEN + slen)
        T = -(-(S_b + PREFIX_P + C) // 128) * 128
        name, row = _prefix_kernel_case(f"dense suffix C={C} T_build={T}", C, start + LOOKAHEAD_PLEN, S_b, T,
                                        False, g, ks_i=start, phase="lookahead")
        rows[name].setdefault("lookahead_shapes", []).append(dict(case=f"dense suffix C={C}", **row))
        torch.cuda.empty_cache()


def _wait_alive(sched, event, timeout):
    """``event.wait(timeout)``, cut short when the scheduler's thread has
    died (a ``fail()`` inside a window, where ``_Follow`` checks its draws)."""
    t_end = time.monotonic() + timeout
    while not event.wait(0.5):
        if not sched._worker.is_alive() or time.monotonic() > t_end:
            return event.is_set()
    return True


def _run_task(sched, fn, what, timeout=300.0):
    """``fn(engine)`` as an engine task on the scheduler's thread; waits
    for it and returns its value."""
    import threading

    box, done = {}, threading.Event()

    def task(e):
        try:
            box["out"] = fn(e)
        except BaseException as ex:  # a fail() in the task exits the scheduler thread too
            box["error"] = ex
            raise
        finally:
            done.set()

    if not sched.run_on_engine(task) or not _wait_alive(sched, done, timeout):
        fail(f"lookahead: the engine task ({what}) did not run")
    if "error" in box:
        fail(f"lookahead: the engine task ({what}) failed: {box['error']!r}")
    return box.get("out")


def _lookahead_engine(eng, bs, **kw):
    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine

    ec = dataclasses.replace(eng.engine_config, batching="continuous", kv_paged=True, kv_block_size=bs,
                             interleave_prefill=False, decode_sync_steps=1, **kw)
    return ContinuousEngine(eng.config, eng.model, SamplingConfig(do_sample=False), ec, eng.dtypes, eng.device,
                            eng.pad_id)


def _lookahead_admission(svc, eng, q, tag, bs, follow_tokens, need, forbid, dense=False):
    """(b) of ``phase_lookahead``: one RAG prompt's prefix prestaged into a
    paged engine's pool (an engine task, as the service's lookahead does
    it), the scatter's card time against its bound, then ``admit_prefixed``
    with the question as suffix (an engine task): the shared blocks mapped
    without a copy (ref count 2), ``prefill_tokens_skipped`` = plen, every
    draw followed against a cold plain admission of the whole prompt
    (``_Follow``), the launch counters, and the pool back at its baseline
    after the release. With ``dense``, the same admission over the dense
    continuous cache, with its transient peak memory."""
    import threading

    import numpy as np
    import torch

    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousScheduler
    from rag_llm_k8s_tpu_torch.ops import _build

    (_, segments, b_ids), _ = _segments_of(svc, q)
    cp = eng.prefix_cache.prefix_for(segments)
    full = [t for _, x in segments for t in x] + list(b_ids)
    lim = _noise_limit(eng, full, f"phase lookahead (b) {tag} follow")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _logits_cold(eng, full)  # the prefill the admission skips, at the largest bucket
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    plain = _lookahead_engine(eng, bs)
    streams, logits = _record_plain(plain, [full], follow_tokens)
    _free(plain)
    cont = _lookahead_engine(eng, bs)
    sched = ContinuousScheduler(cont)
    # request id 0: _Follow keys a row by its stream's index, and the
    # scheduler's own ids start at 1
    rid = 0
    try:
        base = cont.kv_pool.blocks_in_use()
        made, gen = _run_task(sched, lambda e: (e.prestage_prefix(cp), e.prestage_gen(cp.chain_key)), "prestage")
        if made != "registered":
            fail(f"lookahead (b) {tag}: prestage_prefix returned {made!r}")
        shared = list(cont._prefix_blocks[cp.chain_key][0])
        nb = len(shared)
        # the scatter alone, into scratch blocks, on the card's clock
        scratch = cont.kv_pool.alloc(nb)
        ids = np.zeros(cp.capacity // bs, np.int64)
        ids[:nb] = scratch

        def scatter(_):
            with torch.inference_mode():
                cont._scatter_prefix(cp.planes, ids)

        sc_ms = time_ms(scatter, iters=10)
        cont.kv_pool.free(scratch)
        nbytes = sum(p[:, :, :, :nb * bs].numel() * p.element_size() for p in cp.planes)
        sc_bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        f = _Follow(cont, streams, logits, lim)
        outs, done = {}, threading.Event()
        inner = cont.step

        def step():  # the scheduler drives the windows; keep what they finish
            r = inner()
            outs.update(dict(r))
            if rid in outs:
                done.set()
            return r

        cont.step = step

        def timed_admit(e, request_id, max_new):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            res = e.admit_prefixed(request_id, b_ids, cp, max_new)
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t_a) * 1e3

        def admit(e):
            # a first admission with a budget of one (its row retires at
            # once) takes the shape's first-use costs, then the followed one
            first_ms = timed_admit(e, rid + 1, 1)[1]
            row = e.free_slots()[0]
            f.rows[row] = 0
            res, admit_ms = timed_admit(e, rid, follow_tokens)
            if res[1] is not None:
                outs[rid] = res[1]
                done.set()
            return ([e.kv_pool.refcount(b) for b in shared], e._slot_blocks[row][:nb] == shared,
                    e.stats.prefill_tokens_skipped, (first_ms, admit_ms))

        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.monotonic()
        refs, mapped, skipped, admit_ms = _run_task(sched, admit, "admit_prefixed")
        if not _wait_alive(sched, done, 600):
            fail(f"lookahead (b) {tag}: the prefixed request did not finish")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(_build.LAUNCHES)
        if outs[rid][:len(streams[0])] != streams[0]:
            fail(f"lookahead (b) {tag}: the prefixed stream left the plain stream it was fed")
        if refs != [2] * nb or not mapped or skipped != 2 * cp.length:
            fail(f"lookahead (b) {tag}: shared blocks not mapped copy-free (refs {sorted(set(refs))}, mapped "
                 f"{mapped}) or prefill_tokens_skipped {skipped} != 2 x plen {cp.length} (two admissions)")
        _launch_check(f"{tag} paged prefixed admission", launches, need, forbid)
        kept = _run_task(sched, lambda e: e.release_prestaged(cp.chain_key, only_unused=True, gen=gen), "only_unused")
        freed = _run_task(sched, lambda e: e.release_prestaged(cp.chain_key, gen=gen), "release")
        after = _run_task(sched, lambda e: e.kv_pool.blocks_in_use(), "read the pool")
        print(f"phase lookahead (b) {tag}: prefix {cp.length} tokens ({[len(x) for _, x in segments]}), suffix "
              f"{len(b_ids)}, prestaged {nb} blocks of {bs} (gen {gen}); scatter ms={sc_ms:.4f} bound_ms="
              f"{sc_bound:.4f} (2 x {nbytes} bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); admit_prefixed as an "
              f"engine task: shared blocks ref count 2, mapped copy-free, prefill_tokens_skipped={skipped} "
              f"(two admissions), admit_ms first={admit_ms[0]:.2f} then {admit_ms[1]:.2f} (synced) against a cold "
              f"prefill of the whole prompt at the largest bucket {cold_ms:.2f}; "
              f"{follow_tokens} tokens wall_s={wall:.2f}; follow {f.line()}; release only_unused={kept} "
              f"(the admission used it), release={freed}; blocks_in_use {base} -> {after}", flush=True)
        if kept is not False or freed is not True or after != base:
            fail(f"lookahead (b) {tag}: the release left the pool at {after} blocks (baseline {base})")
    finally:
        sched.shutdown()
        _free(cont)
    if not dense:
        return
    # the dense continuous cache: the suffix prefilled into a T_build row cache
    ecd = dataclasses.replace(eng.engine_config, batching="continuous", kv_paged=False, decode_sync_steps=1)
    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine

    dcont = ContinuousEngine(eng.config, eng.model, SamplingConfig(do_sample=False), ecd, eng.dtypes, eng.device,
                             eng.pad_id)
    f = _Follow(dcont, streams, logits, lim)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    row = dcont.free_slots()[0]
    f.rows[row] = 0
    out = {}
    res = dcont.admit_prefixed(rid, b_ids, cp, follow_tokens)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - m0
    if res[1] is not None:
        out[rid] = res[1]
    while dcont.has_active():
        out.update(dict(dcont.step()))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if out[rid][:len(streams[0])] != streams[0]:
        fail(f"lookahead (b) {tag} dense: the prefixed stream left the plain stream it was fed")
    c = eng.config
    S = max(dcont.buckets)
    C = min(b for b in eng.engine_config.prefix_cache.suffix_buckets if b >= len(b_ids))
    T_build = -(-(S + cp.capacity + C) // 128) * 128
    slot_b = 2 * c.num_layers * c.num_kv_heads * c.head_dim * torch.finfo(eng.dtypes.compute_dtype).bits // 8
    print(f"phase lookahead (b) {tag} dense: T_build={T_build} slots ({T_build * slot_b} bytes of build cache) "
          f"transient peak over the engine's memory {peak} bytes; follow {f.line()}", flush=True)
    _launch_check(f"{tag} dense prefixed admission", launches, ("chunk_prefill_attention", "decode_attention"),
                  PAGED_KERNELS)
    _free(dcont)


def _lookahead_chunk_splice(svc, eng, q, follow_tokens, bs=16):
    """(c) of ``phase_lookahead``: chunk-granular pool splice. One RAG
    prompt's segments cut to whole blocks, admitted once (its exact spans
    become per-chunk registrations), then with the chunks in reverse order:
    the plan assembles, the admission gathers, re-rotates and re-prefills
    each shifted chunk's boundary window into pool blocks (``chunk_splice``,
    ``rerotate`` and ``boundary_fixup`` events), and every draw is followed
    against the same admission through the splice buffer (a planted
    ``chunk_splice`` fault declines the plan), within the cold-prefill noise
    limit. A planted ``kv_swap_in`` fault declines a prestage; both faults
    leak no block."""
    import torch

    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
    from rag_llm_k8s_tpu_torch.obs import flight
    from rag_llm_k8s_tpu_torch.ops import _build
    from rag_llm_k8s_tpu_torch.resilience import faults

    pc = dataclasses.replace(eng.engine_config.prefix_cache, reuse="chunk", chunk_hot_min=0.0)
    ec = dataclasses.replace(eng.engine_config, prefix_cache=pc)
    ceng = InferenceEngine(eng.config, eng.model, eng.sampling, ec, eng.dtypes, eng.device)
    (_, segments, b_ids), _ = _segments_of(svc, q)
    aligned = [(f"{k}:b{bs}", list(x[:len(x) // bs * bs])) for k, x in segments if len(x) >= bs]
    order2 = [aligned[0]] + aligned[:0:-1]
    cp1 = ceng.prefix_cache.prefix_for(aligned)
    cont = _lookahead_engine(ceng, bs)
    try:
        cont.admit_prefixed(0, b_ids, cp1, 1)  # a budget of one: the registrations stay
        if set(cont._chunk_regs) != {k for k, _ in aligned}:
            fail(f"lookahead (c): chunk registrations {sorted(cont._chunk_regs)} for spans {[k for k, _ in aligned]}")
        cp2 = ceng.prefix_cache.prefix_for(order2)
        counts = ceng.prefix_cache.chunk_reuse_counters()
        if cont._chunk_splice_plan(cp2) is None:
            fail(f"lookahead (c): no chunk splice plan for the reversed chunks ({counts})")
        held = cont.kv_pool.blocks_in_use()
        faults.arm("chunk_splice", 1)
        try:
            ref_streams, ref_logits = _record_plain(cont, [None], follow_tokens,
                                                    admit=lambda j, p: cont.admit_prefixed(j, b_ids, cp2,
                                                                                           follow_tokens))
        finally:
            faults.clear()
        cont.release_prestaged(cp2.chain_key)  # the fallback's chain registration: the splice must run next
        fallback_left = cont.kv_pool.blocks_in_use() - held
        full2 = [t for _, x in order2 for t in x] + list(b_ids)
        lim = _noise_limit(ceng, full2, "phase lookahead (c) follow")
        f = _Follow(cont, ref_streams, ref_logits, lim)
        seq0 = flight.recorder().events_emitted
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        f.rows[cont.free_slots()[0]] = 0
        res = cont.admit_prefixed(0, b_ids, cp2, follow_tokens)
        torch.cuda.synchronize()
        admit_ms = (time.perf_counter() - t0) * 1e3
        out = {} if res[1] is None else {0: res[1]}
        while cont.has_active():
            out.update(dict(cont.step()))
        launches = dict(_build.LAUNCHES)
        if out[0][:len(ref_streams[0])] != ref_streams[0]:
            fail("lookahead (c): the spliced stream left the splice buffer's stream it was fed")
        kinds = [e["type"] for e in flight.recorder().snapshot() if e["seq"] >= seq0]
        fired = {k: kinds.count(k) for k in ("chunk_splice", "rerotate", "boundary_fixup")}
        if not all(fired.values()):
            fail(f"lookahead (c): events {fired}")
        _launch_check("bf16 chunk-splice admission", launches, ("paged_chunk_attention", "paged_decode_attention"),
                      ("chunk_prefill_attention",))
        cont.release_prestaged(cp1.chain_key)
        free0 = cont.kv_pool.available()
        faults.arm("kv_swap_in", 1)
        try:
            swap = cont.prestage_prefix(cp1)
        finally:
            faults.clear()
        swap_leak = free0 - cont.kv_pool.available()
        for key in list(cont._chunk_regs):
            cont._drop_chunk_reg(key)
        cont.retier_registrations(lambda k: "cold")
        left = cont.kv_pool.blocks_in_use()
        print(f"phase lookahead (c): spans {[len(x) for _, x in aligned]} reversed after the head; chunk reuse "
              f"{json.dumps(counts)}; splice admission ms={admit_ms:.1f} events {fired}; follow (against the "
              f"splice buffer, chunk_splice fault planted) {f.line()}; chunk_splice fault: fallback leaked "
              f"{fallback_left} blocks; kv_swap_in fault: prestage={swap} leaked {swap_leak}; blocks after the "
              f"drops {left}", flush=True)
        if fallback_left or swap is not False or swap_leak or left:
            fail("lookahead (c): a planted fault or the drops leaked blocks")
    finally:
        _free(cont)
        ceng.prefix_cache.clear()


def _held_burst(svc, client, questions):
    """The questions at once over HTTP, with the scheduler held by an
    engine task until every request is queued, so each burst admits the
    same group (a different arrival order would change the windows'
    shapes and so the bf16 rounding): the bodies and the wall seconds."""
    import threading

    sched = svc.scheduler
    gate = threading.Event()
    sched.run_on_engine(lambda e: gate.wait(120))
    out = [None] * len(questions)

    def ask(i):
        r = client.post("/generate", json_body={"prompt": questions[i]})
        out[i] = (r.status_code, r.get_json())

    t0 = time.monotonic()
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(questions))]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        with sched._queue.mutex:
            queued = sum(1 for it in sched._queue.queue if it is not None and not callable(it))
        if queued >= len(questions) or not any(th.is_alive() for th in threads):
            break
        time.sleep(0.005)
    gate.set()
    for th in threads:
        th.join(timeout=600)
    wall = time.monotonic() - t0
    for i, (code, body) in enumerate(out):
        if code != 200 or "Document '" not in body.get("context", ""):
            fail(f"lookahead (d) burst request {i}: {code} {body}")
    return [b for _, b in out], wall, queued


def _lookahead_http(service_bits, eng):
    """(d) of ``phase_lookahead``: the service over HTTP with lookahead
    off and on (the paged continuous scheduler, prefix cache on, the same
    one-shot engine): alternating held bursts of 8 ``/generate`` whose
    greedy streams must be byte-identical, the ``lookahead_hit`` share,
    ``embed_retrieve_ms`` and ``rag_lookahead_launch_to_join_seconds``;
    then two sessions of three turns with ``session_id``: the speculations
    prestage (``rag_kv_tier_pool_blocks`` reads them), are superseded and
    released, and the pool ends at its baseline."""
    import threading

    from rag_llm_k8s_tpu_torch.core.config import LookaheadConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousScheduler
    from rag_llm_k8s_tpu_torch.server.app import RagService, create_app

    svc1, _, _, store = service_bits
    made = {}
    for on in (False, True):
        cont = _lookahead_engine(eng, 16, kv_pool_blocks=8 * 272 + LOOKAHEAD_SPARE_BLOCKS)
        cfg = dataclasses.replace(svc1.config, engine=cont.engine_config, lookahead=LookaheadConfig(enabled=on))
        svc = RagService(cfg, eng, svc1.llm_tokenizer, svc1.encoder, svc1.encoder_tokenizer, store,
                         scheduler=ContinuousScheduler(cont))
        svc.ready = True
        made[on] = (svc, create_app(svc).test_client())
    try:
        texts, lines = {}, []
        for k, on in enumerate((True, False, True, False)):
            svc, client = made[on]
            bodies, wall, queued = _held_burst(svc, client, CONT_QUESTIONS)
            got = [b["generated_text"] for b in bodies]
            texts.setdefault("first", got)
            if got != texts["first"]:
                diff = [i for i, (a, b) in enumerate(zip(got, texts["first"])) if a != b]
                fail(f"lookahead (d): burst {k} (lookahead {'on' if on else 'off'}) changed the greedy streams "
                     f"of requests {diff}")
            t = [b["timings"] for b in bodies]
            hits = [x.get("lookahead_hit") for x in t]
            lines.append(f"burst {k} lookahead={'on' if on else 'off'} queued={queued} wall_s={wall:.2f} "
                         f"embed_retrieve_ms={[round(x['embed_retrieve_ms'], 1) for x in t]}"
                         + (f" lookahead_hit={hits} hit_share={sum(h or 0 for h in hits) / len(hits):.3f}"
                            if on else ""))
        la = made[True][0].lookahead
        hist = la._m_join_wait
        _, h_sum, h_n = hist.snapshot()
        print(f"phase lookahead (d) bursts of 8, greedy streams byte-identical on and off: {' | '.join(lines)}; "
              f"rag_lookahead_launch_to_join_seconds count={h_n} mean_s={h_sum / max(h_n, 1):.4f} "
              f"p50_s={hist.quantile(0.5)}; stats {json.dumps(la.stats())}", flush=True)
        # two sessions of three turns, the sessions' turns at once
        svc, client = made[True]
        cont = svc.scheduler.engine
        fam = svc.metrics.get_family("rag_kv_tier_pool_blocks")
        seen, per_turn = 0.0, []
        before = dict(la.stats())
        for turn in range(3):
            outs = {}

            def ask(sid, q):
                r = client.post("/generate", json_body={"prompt": q, "session_id": sid})
                outs[sid] = r.status_code

            ths = [threading.Thread(target=ask, args=(sid, qs[turn])) for sid, qs in SESSION_TURNS.items()]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=600)
            if set(outs.values()) != {200}:
                fail(f"lookahead (d) session turn {turn}: {outs}")
            t_end = time.monotonic() + 30
            hot = 0.0
            while time.monotonic() < t_end:
                hot = fam.labels(tier="hot").value
                if hot > 0:
                    break
                time.sleep(0.05)
            seen = max(seen, hot)
            per_turn.append(hot)
        after = la.stats()
        la.shutdown()  # releases every speculation still staged
        rows, regs = _run_task(svc.scheduler, lambda e: (e.tier_occupancy()["rows"], len(e._prefix_blocks)),
                               "read the pool")
        _run_task(svc.scheduler, lambda e: e.retier_registrations(lambda k: "cold"), "retier to cold")
        left = _run_task(svc.scheduler, lambda e: e.kv_pool.blocks_in_use(), "read the pool")
        spec = after["launched"] - before["launched"]
        print(f"phase lookahead (d) sessions 2 x 3 turns: rag_kv_tier_pool_blocks{{tier=\"hot\"}} after each turn "
              f"{per_turn}; launched {spec:.0f}, prestaged {after['prestaged'] - before['prestaged']:.0f}, "
              f"released {after['prestage_released'] - before['prestage_released']:.0f}, waste by reason "
              f"{json.dumps({r: c.value for r, c in la._m_wasted.items()})}; after shutdown rows={rows} "
              f"registrations left by claimed futures={regs}; blocks_in_use after retier to cold {left}",
              flush=True)
        if seen <= 0 or la._m_wasted["superseded"].value < 1 or after["prestage_released"] <= before[
                "prestage_released"]:
            fail("lookahead (d) sessions: no speculation was prestaged, superseded and released")
        if rows or left:
            fail(f"lookahead (d) sessions: the pool did not return to its baseline (rows {rows}, left {left})")
    finally:
        for svc, _ in made.values():
            svc.shutdown()
            _free(svc.scheduler.engine)


def phase_lookahead(service_bits):
    """Retrieval lookahead and the continuous half of the prefix cache on
    the bf16 8B model (full width and depth): (b) prestage and a sharing
    ``admit_prefixed``, paged and dense; (c) chunk-granular pool splice;
    (d) the paged continuous service over HTTP, lookahead off and on, and
    two sessions. (a) runs with the kernel phases
    (``phase_lookahead_kernels``), (e) on the int8 model
    (``phase_lookahead_q8``)."""
    import torch

    svc, _, eng = _prefix_service(service_bits)
    try:
        q = LATENCY_QUESTIONS[2]
        _lookahead_admission(svc, eng, q, "bf16", 16, FOLLOW_TOKENS, ("paged_chunk_attention", "paged_decode_attention"),
                             ("chunk_prefill_attention", "paged_chunk_attention_q8"), dense=True)
        _lookahead_chunk_splice(svc, eng, LATENCY_QUESTIONS[3], FOLLOW_TOKENS)
        _lookahead_http(service_bits, eng)
    finally:
        svc.shutdown()
    del svc, eng
    torch.cuda.empty_cache()


def phase_lookahead_q8(service_bits):
    """(e) of ``phase_lookahead``: (b) on the int8 model with int8 KV,
    blocks of 32 and 48 new tokens; the q8 kernels run, the bf16 cache
    kernels never launch."""
    import torch

    svc, _, eng = _prefix_service(service_bits, max_new=48, kv_quant="int8")
    try:
        _lookahead_admission(svc, eng, LATENCY_QUESTIONS[4], "int8", 32, 48,
                             ("paged_chunk_attention_q8", "paged_decode_attention_q8"),
                             BF16_CACHE_KERNELS + ("chunk_prefill_attention_q8",))
    finally:
        svc.shutdown()
    del svc, eng
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, path, body=None, timeout=600):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _rss():
    """(current, peak) host RSS of this process in GB."""
    import resource

    cur = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                cur = int(line.split()[1]) * 1024
    return cur / 1e9, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _expected_llama(model, st, quant):
    """Yield ``(what, got, want)`` for every parameter of a booted (fused)
    Llama against the staged tensors ``st``: bit for bit, with the int8
    projections and head against the loader's ``quantize_np`` twin."""
    import numpy as np
    import torch

    from rag_llm_k8s_tpu_torch.models.loader import quantize_np

    dev = next(model.parameters()).device

    def staged(name):
        return st[name].to(dev)

    def linear(mod, names):
        if quant == "int8":
            qs = [quantize_np(st[n]) for n in names]
            yield (f"{names[0]} int8", mod.weight, torch.from_numpy(np.concatenate([q for q, _ in qs])).to(dev))
            yield (f"{names[0]} scale", mod.scale, torch.from_numpy(np.concatenate([s for _, s in qs])).to(dev))
        else:
            yield (names[0], mod.weight, torch.cat([staged(n) for n in names]))

    c = model.config
    yield ("model.embed_tokens.weight", model.embed.weight, staged("model.embed_tokens.weight"))
    yield ("model.norm.weight", model.final_norm.weight, staged("model.norm.weight"))
    yield from linear(model.lm_head, ["lm_head.weight"])
    for i, blk in enumerate(model.layers):
        p = f"model.layers.{i}."
        yield (p + "input_layernorm.weight", blk.input_norm.weight, staged(p + "input_layernorm.weight"))
        yield (p + "post_attention_layernorm.weight", blk.post_attn_norm.weight,
               staged(p + "post_attention_layernorm.weight"))
        yield from linear(blk.attn.wqkv, [p + f"self_attn.{x}_proj.weight" for x in "qkv"])
        yield from linear(blk.attn.wo, [p + "self_attn.o_proj.weight"])
        yield from linear(blk.mlp.w_gateup, [p + "mlp.gate_proj.weight", p + "mlp.up_proj.weight"])
        yield from linear(blk.mlp.w_down, [p + "mlp.down_proj.weight"])
    if c.tie_word_embeddings:
        fail("staged boot: the staged 8B config is untied")


def _check_boot_weights(svc, model_dir, quant):
    """Every loaded Llama and bge-m3 tensor against the staged files."""
    import glob
    import os

    import torch

    from rag_llm_k8s_tpu_torch.models.loader import _XLMR_LAYER_MAP, _XLMR_TOP_MAP
    from rag_llm_k8s_tpu_torch.utils.safetensors_io import LazyStateDict

    st = LazyStateDict(sorted(glob.glob(os.path.join(model_dir, "*.safetensors"))))
    n = 0
    for what, got, want in _expected_llama(svc.engine.model, st, quant):
        if got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"staged boot ({quant}): {what} differs from the staged tensor")
        n += 1
    est = LazyStateDict(sorted(glob.glob(os.path.join(model_dir, "bge-m3", "*.safetensors"))))
    params = dict(svc.encoder.model.named_parameters())
    names = dict(_XLMR_TOP_MAP)
    for i in range(svc.encoder.config.num_layers):
        for hf_mod, port_mod in _XLMR_LAYER_MAP.items():
            for leaf in ("weight", "bias"):
                names[f"encoder.layer.{i}.{hf_mod}.{leaf}"] = f"layers.{i}.{port_mod}.{leaf}"
    for hf_name, port_name in names.items():
        want = est[hf_name].to(params[port_name].device)
        if not torch.equal(params[port_name], want):
            fail(f"staged boot ({quant}): encoder {hf_name} differs from the staged tensor")
        n += 1
    return n


def phase_staged_boot(root=None):
    """Boot the port the way the product boots. Stage a directory (``root``,
    or a temporary one removed afterwards; Llama-3.1-8B
    ``config.json`` at full width with 2 layers, 4 bf16 shards of seeded
    random values; bge-m3 at full size, bf16, under ``bge-m3/``; the fixture
    ``tokenizer.json`` files; two PDFs), then: ``server.main.build_service()``
    from ``AppConfig.from_env`` (every tensor checked bit for bit), ingest and
    one ``/query``; the same under ``TPU_RAG_WEIGHT_QUANT=int8`` (every int8
    weight and scale against ``loader.quantize_np`` of the staged tensor; host
    RSS and device bytes printed); a second bf16 boot, which must restore the
    converted-parameter cache and reopen the index with no re-embedding; and
    ``python -m rag_llm_k8s_tpu_torch.server.main`` as a subprocess on a free
    port: ``/healthz``, ``/index_info`` and three ``/generate`` over HTTP,
    then SIGTERM with a fourth ``/generate`` in flight: that request must get
    200, the log must show the drain, and the process must exit with 0
    within the drain deadline plus 10 s. ``phase_warm_restart`` boots the
    same directory again."""
    import gc
    import os
    import shutil
    import signal
    import tempfile
    import threading

    import numpy as np
    import torch

    from rag_llm_k8s_tpu_torch.core.config import AppConfig, EncoderConfig, LlamaConfig
    from rag_llm_k8s_tpu_torch.server import main as server_main
    from rag_llm_k8s_tpu_torch.server.app import create_app
    from rag_llm_k8s_tpu_torch.utils import synth

    own = root is None
    root = tempfile.mkdtemp(prefix="staged_boot_") if own else root
    try:
        t = time.monotonic()
        rss0, peak0 = _rss()
        print(f"phase staged_boot before: host_rss_gb={rss0:.2f} host_peak_rss_gb={peak0:.2f}", flush=True)
        cfg8 = dataclasses.replace(LlamaConfig.llama_3_1_8b(), num_layers=2)
        synth.write_synth_checkpoint(root, cfg8, n_shards=4, seed=11, device="cuda")
        synth.write_hf_config(root, cfg8)
        shutil.copy(LLM_TOKENIZER, os.path.join(root, "tokenizer.json"))
        enc_dir = os.path.join(root, "bge-m3")
        synth.write_synth_encoder(enc_dir, EncoderConfig.bge_m3(), dtype=torch.bfloat16, seed=12, device="cuda")
        shutil.copy(ENC_TOKENIZER, os.path.join(enc_dir, "tokenizer.json"))
        pdf_dir = os.path.join(root, "pdfs")
        os.makedirs(pdf_dir)
        rng = np.random.default_rng(21)
        for i in range(2):
            with open(os.path.join(pdf_dir, f"staged{i}.pdf"), "wb") as f:
                f.write(make_pdf(words(rng, 250)))
        gb = sum(os.path.getsize(os.path.join(d, f)) for d in (root, enc_dir)
                 for f in os.listdir(d) if f.endswith(".safetensors")) / 1e9
        print(f"phase staged_boot stage: llama-3.1-8b width, 2 layers, 4 shards + bge-m3, "
              f"{gb:.2f} GB of safetensors s={time.monotonic() - t:.1f}", flush=True)

        # no random shadow audit, as build_service
        env = {"MODEL_PATH": root, "TPU_RAG_PDF_DIR": pdf_dir, "TPU_RAG_SHADOW_SAMPLE_RATE": "0"}
        boots = {}
        for tag, extra in (("bf16", {}), ("int8", {"TPU_RAG_WEIGHT_QUANT": "int8", "TPU_RAG_KV_QUANT": "int8"}),
                           ("bf16 again", {})):
            t = time.monotonic()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            info = {}
            svc = server_main.build_service(AppConfig.from_env({**env, **extra}), info=info)
            boot_s = time.monotonic() - t
            dev_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
            w_gb = sum(p.numel() * p.element_size() for p in svc.engine.model.parameters()) / 1e9
            quant = "int8" if "int8" in tag else "bf16"
            t = time.monotonic()
            n_checked = _check_boot_weights(svc, root, quant)
            check_s = time.monotonic() - t
            if tag == "bf16 again":
                if info.get("params_source") != "cache":
                    fail(f"staged boot: the second boot did not restore the param cache ({info})")
                if info["index_loaded_vectors"] != boots["bf16"]:
                    fail(f"staged boot: the index reopened with {info['index_loaded_vectors']} vectors, "
                         f"not {boots['bf16']}")
                n_new = 0
            else:
                if info.get("params_source") != "converted":
                    fail(f"staged boot ({tag}): expected a conversion, got {info}")
                svc.ingest_directory()
                n_new = svc.store.ntotal
                boots[tag] = n_new
            svc.ready = True
            client = create_app(svc).test_client()
            r = client.post("/query", json_body={"prompt": "which kernel tiles the shared memory?"})
            if r.status_code != 200 or "Document '" not in r.get_json().get("context", ""):
                fail(f"staged boot ({tag}): /query {r.status_code} {r.get_json()}")
            cur, peak = _rss()
            print(f"phase staged_boot {tag}: params={info['params_source']} boot_s={boot_s:.1f} "
                  f"tensors_checked={n_checked} (bit for bit{', int8 vs quantize_np' if quant == 'int8' else ''}) "
                  f"check_s={check_s:.1f} llama_weight_gb={w_gb:.3f} device_gb_added={dev_gb:.3f} "
                  f"host_rss_gb={cur:.2f} host_peak_rss_gb={peak:.2f} index_vectors={svc.store.ntotal} "
                  f"ingested={n_new} /query timings={json.dumps(r.get_json()['timings'])}", flush=True)
            svc.shutdown()
            del svc, client
            gc.collect()  # the service's threads hold it in reference cycles
            torch.cuda.empty_cache()

        # the entry point itself, as a subprocess serving HTTP
        port = _free_port()
        t = time.monotonic()
        # the server's output goes to a file: an undrained pipe could fill and block it
        log_path = os.path.join(root, "server_main.log")
        log = open(log_path, "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "rag_llm_k8s_tpu_torch.server.main"],
            env={**os.environ, **env, "TPU_RAG_PORT": str(port), "TPU_RAG_LOG_LEVEL": "INFO"},
            stdout=log, stderr=subprocess.STDOUT,
        )

        def server_log():
            with open(log_path) as f:
                return f.read()[-4000:]

        try:
            ready = None
            while time.monotonic() - t < 600:
                if proc.poll() is not None:
                    fail(f"server.main exited with {proc.returncode}:\n{server_log()}")
                try:
                    code, health = _http(port, "/healthz", timeout=5)
                    if code == 200 and health.get("status") == "ok":
                        ready = health
                        break
                except OSError:
                    pass
                time.sleep(1.0)
            if ready is None:
                fail(f"server.main: /healthz never reported ready within 600 s:\n{server_log()}")
            ready_s = time.monotonic() - t
            _, index = _http(port, "/index_info")
            if index["total_vectors"] != boots["bf16"]:
                fail(f"server.main: /index_info {index['total_vectors']} vectors, expected {boots['bf16']}")
            timings = []
            for q in LATENCY_QUESTIONS[:3]:
                code, body = _http(port, "/generate", {"prompt": q})
                if code != 200 or "Document '" not in body.get("context", ""):
                    fail(f"server.main /generate: {code} {body}")
                timings.append(body["timings"])
            print(f"phase staged_boot server.main: pid={proc.pid} port={port} ready_s={ready_s:.1f} "
                  f"healthz={json.dumps(ready)} index_vectors={index['total_vectors']} "
                  f"generate_timings={json.dumps(timings)}", flush=True)

            # SIGTERM with a /generate in flight: the request is answered,
            # then the process drains and exits with 0
            import urllib.error

            inflight = []

            def ask():
                try:
                    inflight.append(_http(port, "/generate", {"prompt": LATENCY_QUESTIONS[3]}, timeout=120))
                except urllib.error.HTTPError as e:
                    inflight.append((e.code, json.loads(e.read() or b"{}")))
                except OSError as e:
                    inflight.append((None, {"error": repr(e)}))

            th = threading.Thread(target=ask)
            th.start()
            time.sleep(0.05)  # the request is admitted within ms and runs for hundreds
            t_term = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            th.join(timeout=120)
            limit = AppConfig().resilience.drain_deadline_s + 10.0
            try:
                rc = proc.wait(timeout=limit)
            except subprocess.TimeoutExpired:
                fail(f"server.main: still running {limit:.0f} s after SIGTERM:\n{server_log()}")
            exit_s = time.monotonic() - t_term
            logged = server_log()
            began = [ln for ln in logged.splitlines() if "drain began (reason=sigterm" in ln]
            n_in_flight = int(began[0].split("in_flight=")[1].split(",")[0]) if began else 0
            print(f"phase staged_boot server.main SIGTERM: in_flight_request={inflight[0][0] if inflight else None} "
                  f"exit_code={rc} exit_s={exit_s:.2f} drain_log={began[0].split(':')[-1] if began else None} "
                  f"drained_log={'drained: exiting' in logged}", flush=True)
            if not inflight or inflight[0][0] != 200 or rc != 0 or n_in_flight < 1 or "drained: exiting" not in logged:
                fail(f"server.main SIGTERM drain: request {inflight}, exit code {rc}, "
                     f"in flight at SIGTERM {n_in_flight}:\n{logged}")
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the durable lifecycle and the disaggregated tier
# ---------------------------------------------------------------------------


def _rag_prompts(svc, questions):
    """The questions' RAG prompts as the service's host path assembles them,
    retrieved in one kNN pass: ``[(prompt ids, chunk keys)]``."""
    out = []
    for q, (results, _) in zip(questions, svc._retrieve_many(list(questions))):
        pw = svc._piecewise_prompt(q, results)
        _, ids = pw if pw is not None else svc._budgeted_prompt(q, results)
        keys = [(r.metadata.get("filename"), r.metadata.get("chunk_id"))
                for r in results[:svc.config.retrieval.context_top_n]]
        out.append((ids, keys))
    return out


def _plant_nan(cont):
    """NaN in every block of an engine's arena (the float planes: bf16
    payloads, or int8's scales), so a scatter that misses a block or a table
    that points at a released one surfaces in the decode kernel's output."""
    for t in cont._cache_planes(cont.arena):
        if t.is_floating_point():
            t.fill_(float("nan"))


class _Handoffs:
    """Instruments a prefill and a decode engine: CUDA events around every
    gather (export) and scatter (import), each import's blocks compared
    byte for byte with the packet it came from, and the packets' plane
    counts."""

    def __init__(self, src, dst):
        import torch

        self.gathers, self.scatters, self.unequal, self.planes = [], [], [], set()
        real_g, real_s, real_imp = src._gather_planes, dst._scatter_planes, dst.import_request
        self.real_gather = real_g  # untimed, for a copy of the source blocks before an export

        def nbytes(planes):
            return sum(p.numel() * p.element_size() for p in planes)

        def events():
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            return a, b

        def gather(ids):
            a, b = events()
            out = real_g(ids)
            b.record()
            self.gathers.append((a, b, nbytes(out)))
            return out

        def scatter(ids, planes):
            a, b = events()
            real_s(ids, planes)
            b.record()
            self.scatters.append((a, b, nbytes(planes)))

        def import_request(packet):
            row = real_imp(packet)
            self.planes.add(len(packet["planes"]))
            landed = dst._gather_planes(dst._slot_blocks[row])
            if not all(torch.equal(a, b) for a, b in zip(landed, packet["planes"])):
                self.unequal.append(packet["request_id"])
            return row

        src._gather_planes, dst._scatter_planes, dst.import_request = gather, scatter, import_request

    def line(self):
        """Per migration: bytes, the gather's and the scatter's card ms, and
        the bound (each reads and writes the packet once, at the HBM rate)."""
        import torch

        torch.cuda.synchronize()
        g = [a.elapsed_time(b) for a, b, _ in self.gathers]
        s = [a.elapsed_time(b) for a, b, _ in self.scatters]
        nb = [n for _, _, n in self.gathers]
        if not nb:
            return "migrations=0"
        bound = [4 * n / HBM_BYTES_PER_S * 1e3 for n in nb]
        return (f"migrations={len(nb)} packet_mib(min/mean/max)={min(nb) / 2**20:.1f}/"
                f"{statistics.mean(nb) / 2**20:.1f}/{max(nb) / 2**20:.1f} gather_card_ms(mean/max)="
                f"{statistics.mean(g):.4f}/{max(g):.4f} scatter_card_ms(mean/max)={statistics.mean(s):.4f}/"
                f"{max(s):.4f} bound_ms_per_handoff(mean)={statistics.mean(bound):.4f} (bytes: gather and "
                f"scatter each read and write the packet) handoff_card_ms_over_bound(mean)="
                f"{statistics.mean((x + y) / b for x, y, b in zip(g, s, bound)):.2f}")


def _route_burst(router, prompts, samp, max_new=None, seeds=None):
    """The prompts through ``router`` at once from threads: ``(streams,
    per-request host ms, wall s, request ids)``."""
    import threading

    import torch

    out, ms, rids = [None] * len(prompts), [None] * len(prompts), [None] * len(prompts)

    def ask(i):
        info = {}
        t0 = time.monotonic()
        try:
            out[i] = router.submit(prompts[i][0], max_new_tokens=max_new, sampling=samp, info=info,
                                   seed=None if seeds is None else seeds[i], chunk_keys=prompts[i][1])
        except Exception as e:  # noqa: BLE001 — reported below
            out[i] = e
        ms[i] = (time.monotonic() - t0) * 1e3
        rids[i] = info.get("request_id")

    t0 = time.monotonic()
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if any(th.is_alive() for th in threads):
        fail("a routed burst did not finish within 900 s")
    bad = [(i, o) for i, o in enumerate(out) if not isinstance(o, list) or not o]
    if bad:
        fail(f"routed burst: requests failed or returned nothing: {bad}")
    return out, ms, wall, rids


def _route_events(n0, rids):
    """The routed requests' ``route_decision`` events and the host-clock ms
    from each ``migrate_begin`` to its ``migrate_done``."""
    from rag_llm_k8s_tpu_torch.obs import flight

    evs = [e for e in flight.recorder().snapshot() if e["seq"] >= n0 and e.get("rid") in set(rids)]
    rd = {e["rid"]: e for e in evs if e["type"] == "route_decision"}
    beg = {e["rid"]: e["t"] for e in evs if e["type"] == "migrate_begin"}
    done = {e["rid"]: e["t"] for e in evs if e["type"] == "migrate_done"}
    host = [1e3 * (done[r] - beg[r]) for r in beg if r in done]
    return rd, host


def phase_disagg(service_bits, max_new: int = 150, q8_max_new: int = 48, follow_tokens=FOLLOW_TOKENS):
    """(a) Pool roles (``TPU_RAG_POOL_ROLE=prefill`` / ``decode`` over paged
    arenas, phase-separated admission, as the deployment's two role tiers
    run): a prefill-role and a decode-role engine, each with its own
    scheduler, behind a ``Router``, on the main 8B model and store.

    - A unified paged scheduler first: 8 RAG prompts greedy with the WAL
      off and on (window ms each), and seeded: per-request host ms.
    - The same prompts through the router, greedy (the launch counters
      zeroed before the retrieve and read after: kNN, flash and the paged
      decode ran, no other cache kernel) and seeded: every request in
      ``disagg`` mode, every migration's blocks byte-identical on both
      sides, per-migration bytes, card ms, host ms and bound, the decode
      engine's tokens/s, the affinity hits over the repeated compositions,
      no block left on either engine.
    - Identity, engine level: 4 of the prompts through a prefill engine and
      a decode engine (NaN in every block of its arena before the imports),
      each draw held to a plain unified engine's recorded greedy run
      (``_Follow``): flash only on the prefill side, the paged decode only
      on the decode side, the exported blocks equal the imported ones.
    - A decode engine with ``spec_paged`` drafting each row's greedy
      stream (``_recorded_drafts``): verify windows accept, and
      ``paged_chunk_attention`` runs.
    - int8 KV at blocks of 32, ``q8_max_new`` tokens: packets carry payload
      and scale planes, ``paged_decode_attention_q8`` runs and no bf16 cache
      kernel.
    - The ``migrate`` fault planted once: the decode engine resets, the
      request re-prefills there and completes."""
    import torch

    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
    from rag_llm_k8s_tpu_torch.obs import flight
    from rag_llm_k8s_tpu_torch.ops import _build
    from rag_llm_k8s_tpu_torch.resilience import faults
    from rag_llm_k8s_tpu_torch.server.router import Replica, Router

    svc1, _, engine, _ = service_bits
    base = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=True, kv_block_size=16,
                               interleave_prefill=False, decode_sync_steps=1)
    greedy = dataclasses.replace(engine.sampling, do_sample=False)
    seeded = engine.sampling  # temperature 0.7, top-p 0.9
    seeds = [1000 + i for i in range(len(CONT_QUESTIONS))]

    def build(role="unified", **kw):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        cont = ContinuousEngine(engine.config, engine.model, engine.sampling,
                                dataclasses.replace(base, pool_role=role, **kw), engine.dtypes, engine.device,
                                engine.pad_id)
        torch.cuda.synchronize()
        print(f"phase disagg build {role} {kw or ''}: arena={list(cont.arena.k.shape)} {cont.arena.k.dtype} "
              f"memory_allocated +{(torch.cuda.memory_allocated() - m0) / 1e9:.3f} GB -> "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
        return cont

    def no_leaks(what, *engines):
        left = {e.pool_role: e.kv_pool.blocks_in_use() for e in engines}
        if any(left.values()):
            fail(f"disagg {what}: blocks still in use {left}")

    prompts = _rag_prompts(svc1, CONT_QUESTIONS)
    print(f"phase disagg prompts: {len(prompts)} RAG prompts of {[len(p) for p, _ in prompts]} tokens", flush=True)

    # the unified yardstick, with the WAL off and on
    uni = build()
    usched = ContinuousScheduler(uni)
    urouter = Router([Replica("unified-0", usched)])
    unified, wal_line = {}, []
    for label, samp in (("greedy", greedy), ("greedy, WAL on", greedy), ("seeded", seeded)):
        wal = None
        if "WAL" in label:
            import tempfile

            wal = flight.FlightWAL(tempfile.mkdtemp(prefix="disagg_wal_"))
            flight.configure(wal=wal)
        before = dataclasses.replace(uni.stats)
        try:
            streams, ms, wall, _ = _route_burst(urouter, prompts, samp, max_new,
                                                seeds if label == "seeded" else None)
        finally:
            if wal is not None:
                flight.configure(wal=None)
                wal.close()
        st = uni.stats
        n_win = st.windows - before.windows
        win_ms = 1e3 * (st.decode_window_s - before.decode_window_s) / max(n_win, 1)
        unified[label] = (streams, ms, wall)
        extra = ""
        if wal is not None:
            extra = (f" wal_appends={wal.appends} wal_dropped={wal.dropped} fsync_ms_per_window="
                     f"{1e3 * wal.fsync_s / max(n_win, 1):.3f}")
        wal_line.append(f"{label}: ms_per_decode_window={win_ms:.2f}{extra}")
        print(f"phase disagg unified {label}: wall_s={wall:.2f} decode_tokens={st.decode_tokens - before.decode_tokens}"
              f" request_ms(p50/max)={statistics.median(ms):.0f}/{max(ms):.0f} {_windows(st, before)}{extra}",
              flush=True)
    same = sum(a == b for a, b in zip(unified["greedy"][0], unified["greedy, WAL on"][0]))
    print(f"phase disagg WAL on vs off (unified paged engine, 8 rows, one fsync per event): {'; '.join(wal_line)}; "
          f"greedy streams equal with and without: {same}/8 (admission groups follow the threads' arrival)",
          flush=True)
    usched.shutdown()
    no_leaks("unified", uni)
    _free(uni)

    # the routed tier
    pre, dec = build("prefill"), build("decode")
    _plant_nan(dec)
    hand = _Handoffs(pre, dec)
    psched, dsched = ContinuousScheduler(pre), ContinuousScheduler(dec)
    router = Router([Replica("prefill-0", psched), Replica("decode-0", dsched)])
    routed = {}
    for label, samp in (("greedy", greedy), ("seeded", seeded)):
        n0 = flight.recorder().events_emitted
        d0 = dataclasses.replace(dec.stats)
        if label == "greedy":
            _build.reset_launches()
            prompts_now = _rag_prompts(svc1, CONT_QUESTIONS)  # the retrieve on the counted path
        streams, ms, wall, rids = _route_burst(router, prompts_now, samp, max_new,
                                               seeds if label == "seeded" else None)
        if label == "greedy":
            launches = dict(_build.LAUNCHES)
            _launch_check("disaggregated path (greedy burst)", launches,
                          ("knn_topk", "flash_attention", "paged_decode_attention"),
                          BF16_CACHE_KERNELS[:2] + ("paged_chunk_attention",) + CONTINUOUS_Q8[2:]
                          + ONE_SHOT_Q8[2:])
        rd, host = _route_events(n0, rids)
        modes = [rd[r]["mode"] for r in rids if r in rd]
        if modes != ["disagg"] * len(prompts):
            fail(f"disagg {label}: route modes {modes}")
        hits = sum(1 for r in rids if rd[r]["affinity_hit"])
        same = sum(a == b for a, b in zip(streams, unified[label][0]))
        dec_tok = dec.stats.decode_tokens - d0.decode_tokens
        u_ms = unified[label][1]
        routed[label] = streams
        print(f"phase disagg routed {label}: wall_s={wall:.2f} request_ms(p50/max) disagg="
              f"{statistics.median(ms):.0f}/{max(ms):.0f} unified={statistics.median(u_ms):.0f}/{max(u_ms):.0f} "
              f"per_request_ms disagg={[round(x) for x in ms]} unified={[round(x) for x in u_ms]} "
              f"decode_engine_tokens={dec_tok} decode_engine_tok_per_s={dec_tok / wall:.1f} "
              f"{_windows(dec.stats, d0)} migrate_host_ms(mean/max)={statistics.mean(host):.2f}/{max(host):.2f} "
              f"affinity_hits={hits}/{len(rids)} streams_as_unified={same}/{len(streams)}", flush=True)
    print(f"phase disagg handoffs (timed while the other engine's windows share the stream): {hand.line()}",
          flush=True)
    if hand.unequal or hand.planes != {2}:
        fail(f"disagg: imported blocks differ from their packets for requests {hand.unequal} "
             f"(plane counts {hand.planes})")
    no_leaks("routed", pre, dec)

    # the migrate fault, once
    n0 = flight.recorder().events_emitted
    faults.arm("migrate", times=1)
    info = {}
    try:
        out = router.submit(prompts[0][0], max_new_tokens=max_new, sampling=greedy, info=info)
    finally:
        left = faults.armed()
        faults.clear()
    chain = [e["type"] + (f":{e['outcome']}" if "outcome" in e else "")
             for e in flight.recorder().snapshot(request_id=info.get("request_id")) if e["seq"] >= n0]
    resets = [e for e in flight.recorder().snapshot(etype="reset") if e["seq"] >= n0]
    print(f"phase disagg migrate fault: tokens={len(out)} chain={chain} engine_resets={len(resets)}", flush=True)
    if left or len(resets) != 1 or "resubmit:resubmitted" not in chain or chain[-1] != "complete" or not out:
        fail(f"disagg migrate fault: armed {left}, resets {len(resets)}, chain {chain}")
    no_leaks("after the migrate fault", pre, dec)
    psched.shutdown()
    dsched.shutdown()
    _free(dec)

    # the verify on the decode tier, drafting each row's greedy stream
    recorded = {tuple(p): s for (p, _), s in zip(prompts_now, routed["greedy"])}
    sdec = build("decode", spec_paged=True, spec_paged_tokens=SPEC_K)
    _recorded_drafts(sdec, recorded)
    psched, dsched = ContinuousScheduler(pre), ContinuousScheduler(sdec)
    router = Router([Replica("prefill-0", psched), Replica("decode-0", dsched)])
    _build.reset_launches()
    d0 = dataclasses.replace(sdec.stats)
    streams, ms, wall, _ = _route_burst(router, prompts_now, greedy, max_new)
    launches = dict(_build.LAUNCHES)
    st = sdec.stats
    drafted, accepted = st.spec_drafted_tokens - d0.spec_drafted_tokens, st.spec_accepted_tokens - d0.spec_accepted_tokens
    print(f"phase disagg spec decode tier: wall_s={wall:.2f} drafted={drafted} accepted={accepted} "
          f"verify_windows={st.spec_verify_steps - d0.spec_verify_steps} {_windows(st, d0)} "
          f"streams_as_routed_greedy={sum(a == b for a, b in zip(streams, routed['greedy']))}/8", flush=True)
    if st.spec_verify_steps - d0.spec_verify_steps <= 0 or accepted <= 0:
        fail("disagg spec: no verify window accepted a draft on the decode tier")
    _launch_check("disaggregated path (verify on the decode tier; the prompts retrieved above)", launches,
                  ("flash_attention", "paged_chunk_attention"), CONTINUOUS_Q8[2:])
    no_leaks("spec", pre, sdec)
    psched.shutdown()
    dsched.shutdown()
    _free(sdec)
    _free(pre)

    # identity, engine level: prefill engine -> packet -> decode engine,
    # followed along a plain unified run
    fprompts = [p for p, _ in prompts[:4]]
    lim = _noise_limit(engine, fprompts[0], "phase disagg follow")
    plain = ContinuousEngine(engine.config, engine.model, SamplingConfig(do_sample=False), base, engine.dtypes,
                             engine.device, engine.pad_id)
    streams, logits = _record_plain(plain, fprompts, follow_tokens)
    _free(plain)
    P = ContinuousEngine(engine.config, engine.model, SamplingConfig(do_sample=False),
                         dataclasses.replace(base, pool_role="prefill"), engine.dtypes, engine.device, engine.pad_id)
    D = ContinuousEngine(engine.config, engine.model, SamplingConfig(do_sample=False),
                         dataclasses.replace(base, pool_role="decode"), engine.dtypes, engine.device, engine.pad_id)
    _plant_nan(D)
    clean = _Handoffs(P, D)  # one thread drives both engines here: the card times are the copies' own
    fp, fd = _Follow(P, streams, logits, lim), _Follow(D, streams, logits, lim)
    _build.reset_launches()
    rows = {}
    for j, p in enumerate(fprompts):
        rows[j] = P.free_slots()[0]
        fp.rows[rows[j]] = j
        res = P.admit_many([(j, p, follow_tokens, None)])[0]
        if isinstance(res, BaseException) or res[1] is not None:
            fail(f"disagg follow: admission {j}: {res!r}")
    l_pre = dict(_build.LAUNCHES)
    _build.reset_launches()
    unequal = []
    for j in range(len(fprompts)):
        before = clean.real_gather(list(P._slot_blocks[rows[j]]))
        packet = P.export_request(j)
        r2 = D.import_request(packet)
        fd.rows[r2] = j
        if not all(torch.equal(a, b) for a, b in zip(D._gather_planes(D._slot_blocks[r2]), before)):
            unequal.append(j)
    out = {}
    while D.has_active():
        out.update(dict(D.step()))
    l_dec = dict(_build.LAUNCHES)
    for j, want in enumerate(streams):
        if out[j][:len(want)] != want:
            fail(f"disagg follow: request {j}'s stream left the plain stream it was fed")
    print(f"phase disagg follow (prefill engine -> packet -> decode engine, NaN in every decode-side block "
          f"before the imports, {len(fprompts)} prompts, {follow_tokens} tokens): prefill-side "
          f"{fp.line()}; decode-side {fd.line()}; blocks_unequal={unequal} launches prefill side="
          f"{json.dumps({k: v for k, v in l_pre.items() if v})} decode side="
          f"{json.dumps({k: v for k, v in l_dec.items() if v})}", flush=True)
    print(f"phase disagg handoffs (one thread, nothing else on the card): {clean.line()}", flush=True)
    if unequal or clean.unequal:
        fail(f"disagg follow: imported blocks differ from the exported ones for requests {unequal}")
    if l_pre["flash_attention"] <= 0 or l_pre["paged_decode_attention"] or l_dec["paged_decode_attention"] <= 0 \
            or l_dec["flash_attention"]:
        fail(f"disagg follow: flash must run on the prefill engine only and the paged decode on the decode "
             f"engine only: {l_pre} / {l_dec}")
    no_leaks("follow", P, D)
    _free(P)
    _free(D)

    # int8 KV: payload and scale planes migrate
    q8 = dict(kv_quant="int8", kv_block_size=32)
    pre8, dec8 = build("prefill", **q8), build("decode", **q8)
    _plant_nan(dec8)
    hand8 = _Handoffs(pre8, dec8)
    psched, dsched = ContinuousScheduler(pre8), ContinuousScheduler(dec8)
    router = Router([Replica("prefill-q8", psched), Replica("decode-q8", dsched)])
    _build.reset_launches()
    n0 = flight.recorder().events_emitted
    streams, ms, wall, rids = _route_burst(router, prompts_now, greedy, q8_max_new)
    launches = dict(_build.LAUNCHES)
    rd, host = _route_events(n0, rids)
    print(f"phase disagg int8 KV: wall_s={wall:.2f} request_ms(p50/max)={statistics.median(ms):.0f}/{max(ms):.0f} "
          f"modes={sorted(set(e['mode'] for e in rd.values()))} migrate_host_ms(mean)={statistics.mean(host):.2f} "
          f"handoffs: {hand8.line()}", flush=True)
    _launch_check("disaggregated path (int8 KV)", launches, ("flash_attention", "paged_decode_attention_q8"),
                  BF16_CACHE_KERNELS + ("paged_chunk_attention_q8",))
    if hand8.unequal or hand8.planes != {4} or {e["mode"] for e in rd.values()} != {"disagg"}:
        fail(f"disagg int8: unequal {hand8.unequal}, plane counts {hand8.planes}, modes {rd}")
    no_leaks("int8", pre8, dec8)
    psched.shutdown()
    dsched.shutdown()
    _free(pre8)
    _free(dec8)


# the entry point phase_warm_restart boots
SERVER_MAIN = [sys.executable, "-m", "rag_llm_k8s_tpu_torch.server.main"]


def phase_warm_restart(root, max_new: int = 512, follow_tokens: int = 24, min_emitted: int = 16):
    """(b) The durable lifecycle on the staged 2-layer checkpoint
    (``phase_staged_boot``'s directory), as ``python -m
    rag_llm_k8s_tpu_torch.server.main`` with ``TPU_RAG_BATCHING=continuous``,
    ``TPU_RAG_KV_PAGED=1``, ``TPU_RAG_FLIGHT_WAL=1`` and a fresh WAL
    directory, greedy (``TPU_RAG_DO_SAMPLE=0``):

    - 3 concurrent ``/generate``; once ``scan_wal`` shows ``min_emitted``
      tokens journaled for each and no ``complete``, SIGKILL. The dead epoch must hold 3
      in-flight records with their prompts' ids and emitted tokens.
    - Restart on the same directory with ``TPU_RAG_PREFIX_CACHE=1``: ready,
      then in the new epoch a ``restore`` ``resume`` per original request,
      its tokens journaled again first (the WAL-proven tokens lead the
      delivered stream) and its ``complete``. Then 3 solo requests fill the
      prefix cache, SIGTERM: exit 0, and ``warmth_manifest.json`` holds
      entries.
    - A third boot's restore reports ``rehydrated > 0``; SIGTERM.
    - In this process, over the same checkpoint: each resumed continuation
      (prompt + emitted, re-prefilled) held to an uninterrupted greedy run
      (``_Follow``), and the continuous scheduler's window ms with a WAL
      attached and without."""
    import os
    import signal
    import tempfile
    import threading

    import torch

    from rag_llm_k8s_tpu_torch.core.config import AppConfig, SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
    from rag_llm_k8s_tpu_torch.obs import flight
    from rag_llm_k8s_tpu_torch.server import main as server_main
    from rag_llm_k8s_tpu_torch.sim import replay

    wal_dir = tempfile.mkdtemp(prefix="wal_", dir=root)
    env = {"MODEL_PATH": root, "TPU_RAG_PDF_DIR": os.path.join(root, "pdfs"), "TPU_RAG_BATCHING": "continuous",
           "TPU_RAG_KV_PAGED": "1", "TPU_RAG_FLIGHT_WAL": "1", "TPU_RAG_FLIGHT_WAL_DIR": wal_dir,
           "TPU_RAG_DO_SAMPLE": "0", "TPU_RAG_MAX_NEW_TOKENS": str(max_new), "TPU_RAG_LOG_LEVEL": "INFO",
           "TPU_RAG_SHADOW_SAMPLE_RATE": "0"}

    def start(tag, extra=None):
        port = _free_port()
        log_path = os.path.join(root, f"warm_restart_{tag}.log")
        log = open(log_path, "w")
        proc = subprocess.Popen(SERVER_MAIN, env={**os.environ, **env, **(extra or {}), "TPU_RAG_PORT": str(port)},
                                stdout=log, stderr=subprocess.STDOUT)
        return {"proc": proc, "port": port, "log": log, "path": log_path, "t0": time.monotonic()}

    def text(b):
        with open(b["path"]) as f:
            return f.read()

    def ready(b, limit=600):
        while time.monotonic() - b["t0"] < limit:
            if b["proc"].poll() is not None:
                fail(f"warm restart: server.main exited with {b['proc'].returncode}:\n{text(b)[-4000:]}")
            try:
                code, health = _http(b["port"], "/healthz", timeout=5)
                if code == 200 and health.get("status") == "ok":
                    return time.monotonic() - b["t0"]
            except OSError:
                pass
            time.sleep(0.5)
        fail(f"warm restart: /healthz never ready within {limit} s:\n{text(b)[-4000:]}")

    def stop(b, sig=signal.SIGTERM, limit=60.0):
        b["proc"].send_signal(sig)
        try:
            rc = b["proc"].wait(timeout=limit)
        except subprocess.TimeoutExpired:
            b["proc"].kill()
            b["proc"].wait()
            fail(f"warm restart: server.main outlived {limit:.0f} s after signal {sig}:\n{text(b)[-4000:]}")
        b["log"].close()
        return rc

    def epoch_events(epoch):
        return flight.scan_wal(wal_dir).get(epoch, [])

    boots = []
    try:
        # 1: three requests, SIGKILL mid-decode
        b1 = start("victim")
        boots.append(b1)
        ready_1 = ready(b1)

        def ask(q):
            try:
                _http(b1["port"], "/generate", {"prompt": q}, timeout=600)
            except OSError:
                pass  # the process dies under it

        threads = [threading.Thread(target=ask, args=(q,), daemon=True) for q in LATENCY_QUESTIONS[:3]]
        for th in threads:
            th.start()
        t_end = time.monotonic() + 300
        while time.monotonic() < t_end:
            evs = epoch_events(1)
            arrived = {e.get("rid") for e in evs if e["type"] == "arrival"}
            emitted = {r: sum(len(e["toks"]) for e in evs if e["type"] == "token_emit" and e["rid"] == r)
                       for r in arrived}
            if any(e["type"] == "complete" for e in evs):
                fail("warm restart: a request completed before the kill; raise max_new")
            if len(arrived) == 3 and min(emitted.values()) >= min_emitted:
                break
            time.sleep(0.02)
        else:
            fail(f"warm restart: the WAL never showed 3 requests mid-decode:\n{text(b1)[-3000:]}")
        t_kill = time.monotonic()
        rc1 = stop(b1, signal.SIGKILL)
        dead = replay.extract_inflight(epoch_events(1))
        recs = dead["inflight"]
        segs = [n for n in os.listdir(wal_dir) if n.startswith("wal_")]
        wal_bytes = sum(os.path.getsize(os.path.join(wal_dir, n)) for n in segs)
        print(f"phase warm_restart victim: ready_s={ready_1:.1f} killed rc={rc1} in_flight={len(recs)} "
              f"emitted={[len(r['emitted']) for r in recs]} prompt_lens={[len(r['prompt']) for r in recs]} "
              f"wal_bytes={wal_bytes} wal_segments={len(segs)} epoch1_events={len(epoch_events(1))}", flush=True)
        if len(recs) != 3 or any(not r["emitted"] or r["synthetic_prompt"] for r in recs):
            fail(f"warm restart: the dead epoch holds {dead}")

        # 2: restart with the prefix cache on; the restore resumes the three
        b2 = start("restore", {"TPU_RAG_PREFIX_CACHE": "1"})
        boots.append(b2)
        ready_2 = ready(b2)
        t_end = time.monotonic() + 300
        resumed = {}
        while time.monotonic() < t_end:
            e2 = epoch_events(2)
            by_prompt = {tuple(e.get("ids", ())): e["rid"] for e in e2 if e["type"] == "arrival"}
            completes = {e["rid"]: e for e in e2 if e["type"] == "complete"}
            resumed = {r["rid"]: by_prompt.get(tuple(r["prompt"])) for r in recs}
            if all(v in completes for v in resumed.values()):
                break
            time.sleep(0.1)
        else:
            fail(f"warm restart: the resumed requests did not complete:\n{text(b2)[-4000:]}")
        last_done_s = time.monotonic() - b2["t0"]
        resumes = {e["orig_rid"] for e in e2 if e["type"] == "restore" and e.get("phase") == "resume"}
        lead_ok, n_tokens = [], []
        for r in recs:
            new = resumed[r["rid"]]
            toks = [e["toks"] for e in e2 if e["type"] == "token_emit" and e["rid"] == new]
            lead_ok.append(bool(toks) and toks[0] == r["emitted"])
            n_tokens.append(completes[new]["n_tokens"])
        print(f"phase warm_restart restore: ready_s={ready_2:.1f} last_resumed_complete_s={last_done_s:.1f} "
              f"(from the restart) resumed={sorted(resumes)} wal_proven_tokens_lead={lead_ok} "
              f"delivered_tokens={n_tokens} emitted_before={[len(r['emitted']) for r in recs]}", flush=True)
        if resumes != {r["rid"] for r in recs} or not all(lead_ok) or any(
                n < len(r["emitted"]) for n, r in zip(n_tokens, recs)):
            fail(f"warm restart: resumes {resumes}, WAL-proven tokens lead {lead_ok}, tokens {n_tokens}")
        for q in LATENCY_QUESTIONS[3:6]:
            code, body = _http(b2["port"], "/generate", {"prompt": q})
            if code != 200:
                fail(f"warm restart: /generate after the restore {code} {body}")
        rc2 = stop(b2)
        with open(os.path.join(wal_dir, "warmth_manifest.json")) as f:
            manifest = json.load(f)["entries"]
        print(f"phase warm_restart drain: rc={rc2} warmth_manifest_entries={len(manifest)} "
              f"tokens={[e['tokens'] for e in manifest]}", flush=True)
        if rc2 != 0 or not manifest:
            fail(f"warm restart: SIGTERM rc {rc2}, manifest {manifest}:\n{text(b2)[-3000:]}")

        # 3: the next boot rehydrates the manifest
        b3 = start("rehydrate", {"TPU_RAG_PREFIX_CACHE": "1"})
        boots.append(b3)
        ready_3 = ready(b3)
        t_end = time.monotonic() + 120
        line = None
        while time.monotonic() < t_end and line is None:
            line = next((ln for ln in text(b3).splitlines() if "WAL restore:" in ln), None)
            time.sleep(0.2)
        rehydrated = int(line.split("rehydrated=")[1].split()[0]) if line else 0
        rc3 = stop(b3)
        rehy = [e for e in epoch_events(3) if e["type"] == "restore" and e.get("phase") == "rehydrate"]
        print(f"phase warm_restart rehydrate: ready_s={ready_3:.1f} log={line!r} restore_rehydrate_events="
              f"{len(rehy)} rc={rc3}", flush=True)
        if rehydrated <= 0 or not rehy or rc3 != 0:
            fail(f"warm restart: the third boot rehydrated {rehydrated} ({line!r}), rc {rc3}")
        segs = [n for n in os.listdir(wal_dir) if n.startswith("wal_")]
        print(f"phase warm_restart WAL: segments={len(segs)} bytes="
              f"{sum(os.path.getsize(os.path.join(wal_dir, n)) for n in segs)} epochs={sorted(flight.scan_wal(wal_dir))}"
              f" kill_to_ready_s={ready_2 + (b2['t0'] - t_kill):.1f}", flush=True)
    finally:
        for b in boots:
            if b["proc"].poll() is None:
                b["proc"].kill()
                b["proc"].wait()
            if not b["log"].closed:
                b["log"].close()

    # in this process: the continuations against an uninterrupted run, and
    # the window ms with the WAL on and off
    svc = server_main.build_service(AppConfig.from_env({k: v for k, v in env.items() if "WAL" not in k}))
    engine = svc.engine
    greedy = SamplingConfig(do_sample=False)
    ec = dataclasses.replace(engine.engine_config, decode_sync_steps=1)
    ns = [len(r["emitted"]) for r in recs]
    lim = _noise_limit(engine, recs[0]["prompt"], "phase warm_restart follow")
    plain = ContinuousEngine(engine.config, engine.model, greedy, ec, engine.dtypes, engine.device, engine.pad_id)
    full, logits = _record_plain(plain, [r["prompt"] for r in recs], max(ns) + follow_tokens)
    _free(plain)
    same = [sum(a == b for a, b in zip(f[:n], r["emitted"])) for f, n, r in zip(full, ns, recs)]
    resume = ContinuousEngine(engine.config, engine.model, greedy, ec, engine.dtypes, engine.device, engine.pad_id)
    f = _Follow(resume, [s[n:n + follow_tokens] for s, n in zip(full, ns)],
                [lg[n:n + follow_tokens] for lg, n in zip(logits, ns)], lim)
    f.run([r["prompt"] + s[:n] for r, s, n in zip(recs, full, ns)], follow_tokens)
    print(f"phase warm_restart follow (prompt + emitted re-prefilled, {follow_tokens} tokens on, against the "
          f"uninterrupted greedy run): {f.line()}; the dead process's WAL-proven tokens equal to this process's "
          f"uninterrupted run: {same} of {ns}", flush=True)
    _free(resume)
    sched = svc.scheduler
    qs = [r["prompt"] for r in recs]
    lines = []
    for label in ("off", "on"):
        wal = None
        if label == "on":
            wal = flight.FlightWAL(tempfile.mkdtemp(prefix="wal_ab_", dir=root))
            flight.configure(wal=wal)
        before = dataclasses.replace(sched.engine.stats)
        try:
            outs = [None] * len(qs)
            ths = [threading.Thread(target=lambda i=i: outs.__setitem__(i, sched.submit(qs[i], 128, sampling=greedy)))
                   for i in range(len(qs))]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=600)
        finally:
            if wal is not None:
                flight.configure(wal=None)
                wal.close()
        st = sched.engine.stats
        n_win = st.windows - before.windows
        extra = "" if wal is None else (f" wal_appends={wal.appends} fsync_ms_per_window="
                                        f"{1e3 * wal.fsync_s / max(n_win, 1):.3f}")
        lines.append(f"WAL {label}: windows={n_win} ms_per_decode_window="
                     f"{1e3 * (st.decode_window_s - before.decode_window_s) / max(n_win, 1):.3f}{extra}")
    print(f"phase warm_restart window ms (2-layer staged model, 3 rows, 128 tokens): {'; '.join(lines)}", flush=True)
    svc.shutdown()
    del svc, engine, sched
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the shadow quality auditor and the journal replay (slice 17)
# ---------------------------------------------------------------------------

# the warm-tier and splice per-logit tolerance an audit's err is held to
QUALITY_TOL = 0.15
# a ~3,050-token RAG prompt and answer, left-padded to 12 chunks of 256:
# the scorer's cache of ceil(S / 128) * 128 slots
SHADOW_S, SHADOW_PAD = 3072, 22
# the kinds of stream the auditor's contracts hold to its noise bound (the
# byte-identity ones) and to QUALITY_TOL (the lossy ones)
EXACT_APPROX = {"prefix_reuse", "spec_verify"}
LOSSY_APPROX = {"warm_tier", "splice", "rerotate", "boundary_fixup"}


def _shadow_kernel_shapes(rows):
    """Kernels 4 and 6 at the scorer's shape: S = 256 for the first chunk
    (window [22, 256), its first 22 queries padding) and the last one
    (write_index 2,816 over [22, 3,072)) of a 3,050-token sequence in a
    3,072-slot cache, against their plain versions, timed with SDPA beside
    the bf16 one."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(23)
    for q8 in (False, True):
        for tag, wi in (("first chunk", 0), ("last chunk", SHADOW_S - 256)):
            name, row = _prefix_kernel_case(f"scorer {tag}", 256, wi, wi + 256, SHADOW_S, q8, g,
                                            ks_i=SHADOW_PAD, phase="quality", time_q8=True)
            rows[name].setdefault("shadow_shapes", []).append(dict(case=tag, **row))
            torch.cuda.empty_cache()


def _delivered(phase, kv_quant="bf16", want=(), avoid=(), any_of=(), greedy=True, step=None):
    """The first stream ``phase`` delivered (at ``step``, when given) whose
    fingerprint holds every approximation of ``want``, one of ``any_of``
    (when given) and none of ``avoid``, or None."""
    for d in DELIVERED.get(phase, ()):
        ap = set(d["approx"])
        if (d["greedy"] == greedy and d["kv_quant"] == kv_quant and set(want) <= ap and not ap & set(avoid)
                and (not any_of or ap & set(any_of)) and (d["prompt"] or not greedy)
                and (step is None or d.get("step") == step)):
            return d
    return None


def _audits(aud, streams, what, timeout=300.0):
    """Audit ``streams`` (``(tag, stream)``) on ``aud`` with ``force=True``
    and return each audit's ``shadow_audit`` event from the journal, in
    order, with the host seconds the audits took."""
    from rag_llm_k8s_tpu_torch.obs import flight

    seq0 = flight.recorder().events_emitted
    t0 = time.monotonic()
    for _, s in streams:
        aud.observe(s["emitted"], approx=tuple(s["approx"]), prompt_ids=s["prompt"], force=True)
    if not aud.drain(timeout=timeout):
        fail(f"quality {what}: the audits did not finish within {timeout} s")
    secs = time.monotonic() - t0
    evs = [e for e in flight.recorder().snapshot(etype="shadow_audit") if e["seq"] >= seq0]
    if len(evs) != len(streams):
        fail(f"quality {what}: {len(evs)} shadow_audit events for {len(streams)} audits")
    return evs, secs


def _score_agreement(k, p, stream):
    """The kernel scorer's (``k``) and the plain one's (``p``) argmax
    chains over one teacher-forced ``stream``: where they pick differently,
    the pick the stream took is the other side's, and that side's margin
    between its own pick and it must lie within twice the largest logit
    difference between the two sides (``_Follow``'s near-tie rule). Returns
    ``(largest logit difference, forks, unexplained forks)``."""
    import numpy as np

    mk, mp, ck, cp = (np.asarray(x, np.float64) for x in (k["max_logit"], p["max_logit"], k["chosen_logit"],
                                                         p["chosen_logit"]))
    ak, ap = np.asarray(k["argmax"]), np.asarray(p["argmax"])
    delta = float(max(np.abs(mk - mp).max(), np.abs(ck - cp).max()))
    forks, bad = [], []
    for t in np.nonzero(ak != ap)[0].tolist():
        e = int(stream[t])
        # the stream's token is one side's pick: the other side's margin to it
        margin = mp[t] - cp[t] if e == ak[t] else mk[t] - ck[t] if e == ap[t] else abs(mk[t] - mp[t])
        forks.append((t, int(ak[t]), int(ap[t]), round(float(margin), 4)))
        if margin > 2 * delta:
            bad.append(forks[-1])
    return delta, forks, bad


def _audit_overhead(service_bits, stream, n_windows=12):
    """(e) Paged decode windows at B = 8 (phase-separated, 8 RAG prompts)
    with one forced audit in flight against none, in turns none, audit,
    audit, none: each ``step()`` ends in its token fetch, so its host ms is
    the window's. The audit runs on the one-shot engine from the auditor's
    thread; the service's headroom gate reads its own (idle) scheduler, so
    it never defers the audit. Returns the line's numbers."""
    import torch

    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine

    svc1, _, engine, _ = service_bits
    aud = svc1.shadow
    ec = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=True, kv_block_size=16,
                             interleave_prefill=False, max_batch_size=len(CONT_QUESTIONS))
    cont = ContinuousEngine(engine.config, engine.model, SamplingConfig(do_sample=False), ec, engine.dtypes,
                            engine.device, engine.pad_id)
    prompts = [ids for ids, _ in _rag_prompts(svc1, CONT_QUESTIONS)]
    res = cont.admit_many([(i, p, 4 * n_windows + 80, None) for i, p in enumerate(prompts)])
    if any(isinstance(r, BaseException) or r[1] is not None for r in res):
        fail(f"quality (e): an admission failed or ended at once: {res}")

    def window():
        t = time.perf_counter()
        cont.step()
        return 1e3 * (time.perf_counter() - t)

    busy = lambda: bool(aud._queue) or aud._inflight  # noqa: E731
    for _ in range(2):
        window()  # warm
    turns = []
    for label in ("none", "audit", "audit", "none"):
        if label == "none":
            turns.append((label, [window() for _ in range(n_windows)], 0.0))
            continue
        t0 = time.monotonic()
        aud.observe(stream["emitted"], approx=tuple(stream["approx"]), prompt_ids=stream["prompt"], force=True)
        ms = []
        while busy() or not ms:
            ms.append(window())
        turns.append((label, ms, time.monotonic() - t0))
    if not cont.has_active():
        fail("quality (e): the rows ended before the measurement did")
    torch.cuda.synchronize()
    _free(cont)
    base = statistics.mean([m for lab, ms, _ in turns if lab == "none" for m in ms])
    during = [m for lab, ms, _ in turns if lab == "audit" for m in ms]
    audit_s = statistics.mean([s for lab, _, s in turns if lab == "audit"])
    extra_ms = sum(during) - base * len(during)
    # at sample_rate 0.05 a burst of 8 answers of 150 tokens draws 0.4 audits
    # over 150 windows of the unaudited length
    share = 0.05 * 8 * (extra_ms / 2) / (150 * base)
    print(f"phase quality (e) overhead: paged decode windows at B=8 ms per turn "
          f"{json.dumps({f'{i}:{lab}': [round(m, 2) for m in ms] for i, (lab, ms, _) in enumerate(turns)})} "
          f"mean_without={base:.2f} mean_with_an_audit_in_flight={statistics.mean(during):.2f} "
          f"windows_per_audit={len(during) / 2:.1f} audit_s={audit_s:.3f} extra_window_ms_per_audit={extra_ms / 2:.1f} "
          f"projected_share_of_decode_time_at_sample_rate_0.05={share:.4f} (the JAX package's contract: <= 0.02; "
          f"printed, not gated)", flush=True)


def phase_quality(service_bits, rows):
    """The shadow quality auditor on the card (``obs/shadow.py``,
    ``InferenceEngine.score_exact``; the service's auditor is present with
    ``sample_rate=0``, so only these forced audits run). (a) Kernels 4 and 6
    at the scorer's shape (``_shadow_kernel_shapes``); then ``score_exact``
    over the one-shot greedy stream ``phase_service`` delivered, once through
    ``chunk_prefill_attention`` and once with its plain version swapped into
    the model: argmax chains equal but at near-ties, ``max_logit`` within 4x
    the cold prefill's noise floor, the audit's launches exactly 32 x n
    chunk kernels and no other attention kernel, its ms and memory. (b)
    Forced audits of streams earlier phases delivered: one-shot greedy,
    prefix-cache hit, forced warm-tier hit, chunk reuse (where it spliced)
    and a paged-verify stream; the byte-identity ones clean or diverged at a
    near-tie within the noise bound, the lossy ones within 0.15. (c) A
    planted fault: a token far below the exact max, twice: diverged at its
    position with err > 0.15, one ``quality_divergence`` bundle that loads,
    ``/debug/quality`` equal to ``render_report`` over the journal, and the
    quality SLO fed. (d) A default (sampled) ``/query`` stream, forced:
    skipped as ``sampled``. (e) Decode windows with an audit in flight
    against none (``_audit_overhead``)."""
    import numpy as np
    import torch

    from rag_llm_k8s_tpu_torch.models import llama as L
    from rag_llm_k8s_tpu_torch.obs import flight
    from rag_llm_k8s_tpu_torch.obs import shadow
    from rag_llm_k8s_tpu_torch.ops import _build
    from rag_llm_k8s_tpu_torch.ops import attention as A

    svc1, client1, engine, _ = service_bits
    aud = svc1.shadow
    if aud is None or aud.config.sample_rate != 0.0:
        fail(f"quality: the service's auditor is not present at sample_rate 0 ({aud and aud.config})")
    _armed(svc1)

    # (a) the scorer's kernels, then the scorer against its plain version
    timed(_shadow_kernel_shapes, rows)
    one = _delivered("phase_service", avoid=LOSSY_APPROX)
    if one is None:
        fail(f"quality (a): phase_service delivered no greedy bf16 stream: {DELIVERED.get('phase_service')}")
    prompt, emitted = one["prompt"], one["emitted"]
    n_chunks = -(-(len(prompt) + len(emitted)) // engine._SCORE_CHUNK)
    lim = _noise_limit(engine, prompt, "phase quality (a)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    _build.reset_launches()
    t0 = time.perf_counter()
    k = engine.score_exact(prompt, emitted)
    kern_ms = 1e3 * (time.perf_counter() - t0)
    launches = {n: c for n, c in _build.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated() - mem0
    k2_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        engine.score_exact(prompt, emitted)
        k2_ms.append(1e3 * (time.perf_counter() - t0))
    L.chunk_prefill_attention = A.chunk_attention_xla
    try:
        t0 = time.perf_counter()
        p = engine.score_exact(prompt, emitted)
        plain_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        L.chunk_prefill_attention = A.chunk_prefill_attention
    rel = _rel(torch.tensor(k["max_logit"]), torch.tensor(p["max_logit"]))
    delta, forks, bad = _score_agreement(k, p, emitted)
    # a fork the kernels' own noise explains has a margin within 2 delta,
    # so an err (half the margin) within delta
    noise_err = delta
    print(f"phase quality (a) scorer: prompt={len(prompt)} emitted={len(emitted)} chunks={n_chunks} "
          f"approx={one['approx']} ms kernel={kern_ms:.1f} then {[round(m, 1) for m in k2_ms]} plain={plain_ms:.1f} "
          f"peak_extra_bytes={peak} launches={json.dumps(launches)} max_logit_rel_rms={rel:.4g} (limit {lim:.4g}) "
          f"largest_logit_difference={delta:.4f} noise_err_bound={noise_err:.4f} "
          f"argmax_agree={int(np.sum(np.asarray(k['argmax']) == np.asarray(p['argmax'])))}/{len(emitted)} "
          f"forks(pos, kernel, plain, margin)={forks} kernel_chain_is_the_stream="
          f"{[int(t) for t in k['argmax']] == list(emitted)}", flush=True)
    if launches != {"chunk_prefill_attention": 32 * n_chunks}:
        fail(f"quality (a): one audit of {n_chunks} chunks launched {launches}, not "
             f"{{'chunk_prefill_attention': {32 * n_chunks}}}")
    if not rel <= lim:
        fail(f"quality (a): max_logit rel rms {rel:.4g} past the limit {lim:.4g}")
    if bad:
        fail(f"quality (a): argmax forks past the near-tie rule: {bad}")

    # (b) the streams earlier phases delivered, audited
    picks = [("one-shot greedy", one),
             ("prefix-cache hit", _delivered("phase_prefix_cache", want={"prefix_reuse"}, avoid=LOSSY_APPROX)),
             # the forced warm-tier hit: its entries, hot again at the hit,
             # serve the int8 round trip's planes but no longer name the
             # warm tier (PrefixCache._promote_locked, as in JAX)
             ("warm-tier hit", _delivered("phase_prefix_cache", step="(d) warm")),
             ("chunk reuse", _delivered("phase_prefix_cache", any_of=LOSSY_APPROX - {"warm_tier"},
                                        avoid={"warm_tier"})),
             ("paged verify", _delivered("phase_spec_paged", want={"spec_verify"}))]
    missing = [t for t, s in picks if s is None and t != "chunk reuse"]
    if missing:
        fail(f"quality (b): no delivered stream for {missing}: "
             f"{ {ph: [(d['approx'], d['greedy'], d['kv_quant']) for d in v] for ph, v in DELIVERED.items()} }")
    picks = [(t, s) for t, s in picks if s is not None]
    # the divergence burst spools one bundle: at the second divergence of
    # (b) or (c), whichever comes first (the 30 s cooldown holds the rest)
    incidents0 = {b["id"] for b in client1.get("/debug/incidents").get_json()["incidents"]}
    evs, secs = _audits(aud, picks, "(b)")
    over = []
    for (tag, s), ev in zip(picks, evs):
        ap = set(s["approx"]) | ({"warm_tier"} if s.get("step") == "(d) warm" else set())
        line = (f"phase quality (b) audit {tag}: prompt={len(s['prompt'])} emitted={len(s['emitted'])} "
                f"outcome={ev['outcome']} pos={ev.get('pos')} err={ev.get('err')} approx={ev.get('approx')}")
        if ev["outcome"] not in ("clean", "diverged"):
            fail(f"quality (b) {tag}: the audit came back {ev}")
        if ap <= EXACT_APPROX and ev["outcome"] == "diverged" and not ev["err"] <= noise_err:
            fail(f"quality (b) {tag}: a byte-identity stream diverged with err {ev['err']} past the noise bound "
                 f"{noise_err:.4f}")
        if ap & LOSSY_APPROX and ev["outcome"] == "diverged":
            # the audit's evidence, recomputed: half the exact gap at pos
            sc = engine.score_exact(s["prompt"], s["emitted"])
            gap = sc["max_logit"][ev["pos"]] - sc["chosen_logit"][ev["pos"]]
            line += f" exact_gap_at_pos={gap:.6f}"
            if abs(ev["err"] - max(gap, 0.0) / 2) > 1e-5:
                fail(f"quality (b) {tag}: err {ev['err']} is not half the exact gap {gap:.6f} at pos {ev['pos']}")
            if ev["err"] > QUALITY_TOL:
                over.append((tag, ev["err"]))
        print(line, flush=True)
        if "warm_tier" in ap and not ev.get("err", 0.0) <= QUALITY_TOL:
            fail(f"quality (b) {tag}: err {ev['err']} past the {QUALITY_TOL} tolerance")
    # chunk reuse's drift at full depth on random weights is past the
    # tolerance the reference pins on small models (PERF.md §6):
    # the audit measures it, and this run reports it
    print(f"phase quality (b): {len(picks)} audits in {secs:.2f} s; past the {QUALITY_TOL} tolerance: "
          f"{over or 'none'}", flush=True)

    # (c) a planted fault: the first delivered token (a stream's first
    # divergence can come no earlier) replaced by one far below the max
    pos = 0
    bad_stream = None
    for cand in np.random.default_rng(5).integers(3, 256, 16).tolist():
        if cand == emitted[pos]:
            continue
        trial = list(emitted[:pos]) + [int(cand)] + list(emitted[pos + 1:])
        sc = engine.score_exact(prompt, trial)
        gap = sc["max_logit"][pos] - sc["chosen_logit"][pos]
        if gap > 4 * QUALITY_TOL:
            bad_stream = dict(one, emitted=trial)
            break
    if bad_stream is None:
        fail("quality (c): no candidate token lies far below the exact max")
    evs, _ = _audits(aud, [("fault", bad_stream), ("fault again", bad_stream)], "(c)")
    for ev in evs:
        if ev["outcome"] != "diverged" or ev["pos"] != pos or not ev["err"] > QUALITY_TOL:
            fail(f"quality (c): the planted fault at {pos} audited {ev}")
    new = [b for b in client1.get("/debug/incidents").get_json()["incidents"] if b["id"] not in incidents0]
    if [b["trigger"] for b in new] != ["quality_divergence"]:
        fail(f"quality (c): the burst spooled {[b['trigger'] for b in new]}")
    bundle = client1.get(f"/debug/incidents?id={new[0]['id']}").get_json()
    in_bundle = [e["type"] for e in bundle.get("journal", [])]
    if in_bundle.count("quality_divergence") < 2:
        fail(f"quality (c): the bundle's journal holds {in_bundle.count('quality_divergence')} divergences")
    print(f"phase quality (c) planted fault: pos={pos} outcomes={[(e['outcome'], e['pos'], e['err']) for e in evs]} "
          f"bundle={new[0]['id']} journal_events={len(in_bundle)}", flush=True)

    # (d) a default /query's stream (temperature 0.7), forced: a sampled skip
    sampled = _delivered("phase_query_latency", greedy=False)
    if sampled is None:
        fail("quality (d): phase_query_latency delivered no sampled stream")
    before = aud.stats()["skip_sampled"]
    aud.observe(sampled["emitted"], approx=tuple(sampled["approx"]), eligible=False, force=True)
    aud.drain(timeout=30)
    if aud.stats()["skip_sampled"] != before + 1:
        fail("quality (d): a forced sampled stream was not counted as a sampled skip")

    # the report against the journal, the families and the SLO
    report = client1.get("/debug/quality").get_json()["report"]
    journal = flight.recorder().snapshot(etype="shadow_audit")
    if report != shadow.render_report(shadow.state_from_events(journal)):
        fail(f"quality: /debug/quality differs from the journal's report: {report}")
    time.sleep(0.3)  # past the scrape's 0.25 s memo of the auditor's counts
    m, _ = _scrape(client1)
    slo = {e["name"]: e for e in client1.get("/slo?force=1").get_json()["slos"]}["quality_p99_logit_err"]
    judged = report["audits"]["clean"] + report["audits"]["diverged"]
    print(f"phase quality report: {json.dumps(report)} rag_quality_logit_err_count="
          f"{m.get(('rag_quality_logit_err_count', ''))} skipped_sampled="
          f"{m.get(('rag_quality_skipped_total', '{reason=\"sampled\"}'))} slo={json.dumps(slo)}", flush=True)
    if m.get(("rag_quality_logit_err_count", "")) != judged or max(slo["window_events"].values()) != judged:
        fail(f"quality: the histogram ({m.get(('rag_quality_logit_err_count', ''))}) and the SLO "
             f"({slo['window_events']}) do not count the {judged} judged audits")

    # (e) the audit's cost to live decode windows
    _audit_overhead(service_bits, one)


def phase_quality_q8(qbits):
    """(f) One forced audit on the int8 service of the greedy stream its
    ``phase_service`` delivered: the scorer runs ``chunk_prefill_attention_q8``
    32 x n times and no bf16 cache kernel."""
    from rag_llm_k8s_tpu_torch.ops import _build

    svc, _, eng, _ = qbits
    s = _delivered("phase_service", kv_quant="int8")
    if s is None:
        fail("quality (f): the int8 service delivered no greedy stream")
    n_chunks = -(-(len(s["prompt"]) + len(s["emitted"])) // eng._SCORE_CHUNK)
    _build.reset_launches()
    evs, secs = _audits(svc.shadow, [("int8", s)], "(f)")
    launches = {n: c for n, c in _build.LAUNCHES.items() if c}
    ev = evs[0]
    print(f"phase quality (f) int8 audit: prompt={len(s['prompt'])} emitted={len(s['emitted'])} chunks={n_chunks} "
          f"outcome={ev['outcome']} pos={ev.get('pos')} err={ev.get('err')} approx={ev.get('approx')} s={secs:.2f} "
          f"launches={json.dumps(launches)}", flush=True)
    if launches != {"chunk_prefill_attention_q8": 32 * n_chunks}:
        fail(f"quality (f): the int8 audit launched {launches}")
    if ev["outcome"] not in ("clean", "diverged"):
        fail(f"quality (f): the int8 audit came back {ev}")


def phase_replay(service_bits):
    """The journal replay and the simulator on the card's own journal. (a)
    ``extract_trace`` of ``phase_goodput``'s phase-separated burst (4 greedy
    requests, 48 tokens), re-driven through a fresh ``ContinuousEngine`` of
    the same configuration with the ``LockstepDriver``: the decision
    streams (``diff_journals``) and the token streams must be identical.
    (b) ``CalibratedStepModel.from_journal`` over the burst's windows, the
    same trace simulated: simulated against measured decode steps/s, the
    speedup (>= 100), the roofline model at the H100's peaks against the
    measured windows, and ``pool_plan`` of the card's journal."""
    import torch

    from rag_llm_k8s_tpu_torch.core.config import SamplingConfig
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
    from rag_llm_k8s_tpu_torch.obs import flight
    from rag_llm_k8s_tpu_torch.sim import replay, simulator

    src = REPLAY_SOURCE
    if not src:
        fail("replay: phase_goodput recorded no burst")
    recorded, ec = src["events"], src["ec"]
    engine = service_bits[2]
    trace = replay.extract_trace(recorded)
    rids = [a["rid"] for a in trace["arrivals"]]
    cont = ContinuousEngine(engine.config, engine.model, SamplingConfig(do_sample=False, max_new_tokens=src["max_new"]),
                            ec, engine.dtypes, engine.device, engine.pad_id)
    seq0 = flight.recorder().events_emitted
    t0 = time.monotonic()
    drv = replay.LockstepDriver(cont, emit=flight.emit)
    results = drv.drive(trace)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    redriven = [e for e in flight.recorder().snapshot() if e["seq"] >= seq0]
    _free(cont)
    diff = replay.diff_journals(recorded, redriven)
    same_tokens = {r: results.get(r) == src["tokens"].get(r) for r in rids}
    print(f"phase replay (a) re-drive: requests={len(rids)} t_steps={[a['t_step'] for a in trace['arrivals']]} "
          f"s={wall:.2f} identical={diff['identical']} decisions={diff['decisions']} "
          f"first_divergence={json.dumps(diff['first_divergence'])} requests_diverged={diff['requests_diverged']} "
          f"errors={ {r: repr(e) for r, e in drv.errors.items()} } same_tokens={same_tokens} "
          f"occupancy={json.dumps(diff['occupancy'])}", flush=True)
    if not diff["identical"] or drv.errors or not all(same_tokens.values()) or diff["decisions"][0] < 10:
        fail("replay (a): the re-drive is not the recording")

    # (b) the simulator, calibrated on the card's journal
    windows = [e for e in recorded if e["type"] == "goodput_window"]
    steps = sum(int(e.get("steps", 1)) for e in recorded if e["type"] == "sync_window_open")
    busy_s = sum(e["dur_ms"] for e in windows) / 1e3
    measured = steps / busy_s
    sim_kw = dict(buckets=cont.buckets, max_batch_size=ec.max_batch_size, max_seq_len=ec.max_seq_len,
                  block_size=ec.kv_block_size, pool_blocks=cont.kv_pool.num_blocks - 1,
                  decode_sync_steps=ec.decode_sync_steps)
    cal = simulator.simulate(trace, step_model=simulator.CalibratedStepModel.from_journal(recorded), **sim_kw)
    roof = simulator.simulate(trace, **sim_kw)
    sdiff = replay.diff_journals(recorded, cal["journal"])
    dec = [e["dur_ms"] for e in windows if e["kind"] == "decode"]
    rf = simulator.RooflineStepModel(simulator.llama8b_roofline())
    ctx = statistics.mean(int(a["prompt_len"]) for a in trace["arrivals"]) * len(rids)
    print(f"phase replay (b) simulated: measured_decode_steps_per_s={measured:.4f} (steps={steps} busy_s={busy_s:.4f}) "
          f"calibrated_steps_per_s={cal['steps_per_s']} ratio={cal['steps_per_s'] / measured:.4f} "
          f"(the JAX package's band: 0.75-1.25) speedup_x={cal['speedup_x']} simulated_windows="
          f"{cal['windows']} decisions={sdiff['decisions']} roofline_h100_steps_per_s={roof['steps_per_s']} "
          f"roofline_over_measured={roof['steps_per_s'] / measured:.3f} decode_window_ms measured_median="
          f"{statistics.median(dec):.2f} roofline={1e3 * rf.decode(1, len(rids), int(ctx)):.2f} "
          f"pool_plan={json.dumps(simulator.pool_plan(recorded))}", flush=True)
    if not cal["speedup_x"] >= 100:
        fail(f"replay (b): the simulator ran {cal['speedup_x']}x the time it simulated, not >= 100x")
    if cal["errors"]:
        fail(f"replay (b): the simulation failed requests: {cal['errors']}")


def build_q8_service(service_bits, qmodel):
    """An int8 ``InferenceEngine`` (``weight_quant="int8", kv_quant="int8"``)
    over the already-quantized model, behind its own ``RagService`` (with a
    ``BatchScheduler``) over the same store, encoder and tokenizers."""
    from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
    from rag_llm_k8s_tpu_torch.server.app import RagService, create_app

    svc1, _, engine, store = service_bits
    ec = dataclasses.replace(engine.engine_config, **INT8)
    eng = InferenceEngine(engine.config, qmodel, engine.sampling, ec, engine.dtypes, engine.device)
    if eng.model is not qmodel:
        fail("int8 engine: the quantized model did not pass through")
    svc = RagService(dataclasses.replace(svc1.config, engine=ec), eng, svc1.llm_tokenizer, svc1.encoder,
                     svc1.encoder_tokenizer, store, scheduler=BatchScheduler(eng, max_wait_ms=30.0))
    svc.ready = True
    return svc, create_app(svc).test_client(), eng, store


def build_service():
    import atexit
    import shutil
    import tempfile

    import torch

    from rag_llm_k8s_tpu_torch.core.config import AppConfig, EncoderConfig, FlightConfig, LlamaConfig, ShadowConfig
    from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
    from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
    from rag_llm_k8s_tpu_torch.index.store import VectorStore
    from rag_llm_k8s_tpu_torch.models import convert
    from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
    from rag_llm_k8s_tpu_torch.models.llama import build_llama
    from rag_llm_k8s_tpu_torch.server.app import RagService, create_app

    dev = torch.device("cuda")
    # incident bundles (a 504, a breaker flip) go to a directory of this run's own
    spool = tempfile.mkdtemp(prefix="incidents_")
    atexit.register(shutil.rmtree, spool, True)
    # the shadow auditor present at sample_rate 0: no random draw audits a
    # request (phase_quality forces its audits); every service built from
    # this config inherits it
    cfg = AppConfig(model=LlamaConfig.llama_3_1_8b(), encoder=EncoderConfig.bge_m3(),
                    flight=FlightConfig(spool_dir=spool), shadow=ShadowConfig(sample_rate=0.0))
    _capture_deliveries()
    t = time.monotonic()
    model = convert.init_random_(
        build_llama(cfg.model, cfg.dtypes, dev, fused=True),
        torch.Generator(device=dev).manual_seed(0),
    )
    enc = convert.init_random_(
        build_encoder(cfg.encoder, cfg.dtypes, dev), torch.Generator(device=dev).manual_seed(1)
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_enc = sum(p.numel() for p in enc.parameters())
    print(f"phase build: llama-3.1-8b params={n_params} bge-m3 params={n_enc} "
          f"device_mem_gb={torch.cuda.memory_allocated() / 1e9:.2f} s={time.monotonic() - t:.1f}",
          flush=True)
    engine = InferenceEngine(cfg.model, model, cfg.sampling, cfg.engine, cfg.dtypes, dev)
    llm_tok, enc_tok = real_tokenizers()
    encoder = EncoderRunner(cfg.encoder, enc, dev)
    store = VectorStore(cfg.encoder.hidden_size, dev)
    # the one-shot service as server/main.py builds it: the coalescing
    # scheduler (so a solo query takes the single-fetch path) and the
    # service's retrieve coalescer
    svc = RagService(cfg, engine, llm_tok, encoder, enc_tok, store,
                     scheduler=BatchScheduler(engine, max_wait_ms=30.0))
    svc.ready = True
    return svc, create_app(svc).test_client(), engine, store


T_START = time.monotonic()
# the phase running now (``timed``), which names the streams it delivers,
# and the step of it (``_prefixed_ask``'s ``what``)
CURRENT_PHASE, CURRENT_STEP = [""], [""]


def timed(fn, *args, **kwargs):
    """Run one phase and print its seconds."""
    t = time.monotonic()
    outer, CURRENT_PHASE[0] = CURRENT_PHASE[0], fn.__name__
    try:
        out = fn(*args, **kwargs)
    finally:
        CURRENT_PHASE[0] = outer
    print(f"phase_seconds {fn.__name__}={time.monotonic() - t:.1f}", flush=True)
    return out


# each response a service offered to its shadow auditor, by the phase that
# delivered it (the first DELIVERED_PER_PHASE): the streams phase_quality
# audits, and the tokens phase_replay holds a re-drive to
DELIVERED = {}
DELIVERED_PER_PHASE = 64
# phase_goodput's phase-separated burst: its journal, engine config, token
# budget and delivered tokens by request id (phase_replay re-drives it)
REPLAY_SOURCE = {}
# phase_query_latency's solo requests as the one-shot goodput ledger saw
# them (phase_goodput (a) reads them)
ONESHOT_LEDGER = {}


def _capture_deliveries():
    """Record every response the port's services offer their shadow
    auditors (``RagService._shadow_observe``): tokens, fingerprint, whether
    the stream is greedy, the serving KV dtype, the request id, and for a
    greedy stream the prompt ids that served it. The auditors themselves run
    at ``sample_rate=0`` here, so the offer audits nothing."""
    from rag_llm_k8s_tpu_torch.server.app import RagService

    real = RagService._shadow_observe
    if getattr(real, "captures", False):
        return

    def observe(self, served_by, out_ids, gen_info, prompt_ids=None, prompt_fn=None, cp=None, tenant=None,
                sampling=None):
        s = sampling if sampling is not None else getattr(served_by, "sampling", None)
        greedy = not (s is not None and s.do_sample and s.temperature > 0.0)
        got = DELIVERED.setdefault(CURRENT_PHASE[0], [])
        if out_ids and len(got) < DELIVERED_PER_PHASE:
            ids = prompt_ids if prompt_ids is not None or not greedy else prompt_fn()
            got.append({"emitted": list(out_ids), "approx": self._approx_fingerprint(gen_info, cp),
                        "step": CURRENT_STEP[0], "prompt": list(ids) if ids else None, "greedy": greedy,
                        "kv_quant": served_by.engine_config.kv_quant, "rid": (gen_info or {}).get("request_id")})
        return real(self, served_by, out_ids, gen_info, prompt_ids=prompt_ids, prompt_fn=prompt_fn, cp=cp,
                    tenant=tenant, sampling=sampling)

    observe.captures = True
    RagService._shadow_observe = observe


# the names ``--phases`` takes, in the order the bare command runs them; the
# kernel phases run first, then the bf16 service phases over one model, then
# the int8 ones over its quantized copy. "lookahead" also runs its kernels
# with the kernel phases and its int8 leg with the int8 phases.
KERNEL_PHASES = ("knn", "flash", "decode", "chunk", "paged_decode", "paged_chunk", "decode_q8", "chunk_q8",
                 "paged_decode_q8", "paged_chunk_q8", "continuous_kernels")
SERVICE_PHASES = ("model", "service", "query_latency", "observability", "prefix_cache", "continuous_service",
                  "goodput", "resilience", "continuous_engine", "continuous_dense", "spec_paged", "engine_tasks",
                  "plain_decode", "disagg", "lookahead", "quality", "replay", "warm_restart")
Q8_PHASES = ("model_q8", "service_q8", "continuous_service_q8", "continuous_engine_q8", "continuous_dense_q8",
             "spec_paged_q8")
PHASES = KERNEL_PHASES + ("staged_boot",) + SERVICE_PHASES + Q8_PHASES


def _selected(names: str):
    """The phases ``--phases`` names (all when empty), with what they
    need: any service phase needs ``service`` (it fills the store),
    ``warm_restart`` boots the directory ``staged_boot`` stages, ``quality``
    audits the streams of ``prefix_cache``, ``spec_paged`` and
    ``service_q8`` (and runs its int8 audit after the last), ``replay``
    re-drives ``goodput``'s journal, and ``goodput`` reads the one-shot
    requests of ``query_latency``."""
    want = {n.strip() for n in names.split(",") if n.strip()} or set(PHASES)
    unknown = sorted(want - set(PHASES))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phase(s) {unknown}; phases: {', '.join(PHASES)}")
    if "quality" in want:
        want |= {"query_latency", "prefix_cache", "spec_paged", "service_q8"}
    if "replay" in want:
        want.add("goodput")
    if "goodput" in want:
        want.add("query_latency")
    if want & (set(SERVICE_PHASES) | set(Q8_PHASES)) - {"warm_restart"}:
        want.add("service")
    if "warm_restart" in want:
        want.add("staged_boot")
    return want


def main(argv=None) -> int:
    import argparse
    import collections

    ap = argparse.ArgumentParser(description="On-card smoke run of the PyTorch port.")
    ap.add_argument("--phases", default="", help="comma-separated phase names to run (default: every phase, in "
                    f"order): {', '.join(PHASES)}")
    want = _selected(ap.parse_args(argv).phases)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from rag_llm_k8s_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}", flush=True)
    if want != set(PHASES):
        print(f"phases: {[p for p in PHASES if p in want]}", flush=True)
    t = time.monotonic()
    reports = _build.build()
    for src, log in reports.items():
        for line in log.splitlines():
            # C7518: ptxas serialized a kernel's wgmma (a branch between a wgmma and its wait)
            if any(w in line for w in ("entry function", "registers", "spill", "C7518")):
                print(f"ptxas {src}: {line.strip()}")
    print(f"phase build kernels: {sorted(reports) or 'cached'} s={time.monotonic() - t:.1f}", flush=True)

    rows = collections.defaultdict(dict)
    for ph in KERNEL_PHASES:
        if ph in want:
            timed(globals()[f"phase_{ph}"], rows)
    if "lookahead" in want:
        timed(phase_lookahead_kernels, rows)
    torch.cuda.empty_cache()
    import atexit
    import shutil
    import tempfile

    # the staged directory stays for phase_warm_restart, which runs after
    # phase_observability: run before it, the blocking /profile trace lost
    # the first ~32 kernels of its request (PERF.md §7)
    staged = tempfile.mkdtemp(prefix="staged_boot_")
    atexit.register(shutil.rmtree, staged, True)
    if "staged_boot" in want:
        timed(phase_staged_boot, staged)

    launches, cont_launches, q_launches, q_cont = {}, {}, {}, {}
    bits = None
    if "service" in want:
        bits = timed(build_service)
        if "model" in want:
            timed(phase_model, bits[2].model, bits[2].config)
        launches = timed(phase_service, bits, forbid=ONE_SHOT_Q8[2:])
        fused_stats = {"total_ms": {"p50": 0.0, "p95": 0.0}}  # when the latency leg does not run
        if "query_latency" in want:
            # 12 solo requests, not 24: the script's time limit (PERF.md §6)
            fused_stats = timed(phase_query_latency, bits, n_solo=12)
        if "observability" in want:
            timed(phase_observability, bits)
        if "prefix_cache" in want:
            timed(phase_prefix_cache, bits, rows, fused_stats)
        if "continuous_service" in want:
            cont_launches = timed(phase_continuous_service, bits, forbid=CONTINUOUS_Q8[2:])
        if "goodput" in want:
            timed(phase_goodput, bits)
        for ph in ("resilience", "continuous_engine", "continuous_dense", "spec_paged", "engine_tasks",
                   "plain_decode", "disagg", "lookahead"):
            if ph in want:
                timed(globals()[f"phase_{ph}"], bits)
        if "quality" in want:
            timed(phase_quality, bits, rows)
        if "replay" in want:
            timed(phase_replay, bits)
    if "warm_restart" in want:
        timed(phase_warm_restart, staged)

    if want & set(Q8_PHASES) or "lookahead" in want:
        # int8 weights and int8 KV: the same 8B model quantized, the same store
        from rag_llm_k8s_tpu_torch.models.llama import quantize_llama

        t = time.monotonic()
        model = bits[2].model
        qmodel = quantize_llama(model)
        torch.cuda.synchronize()
        q_gb = sum(p.numel() * p.element_size() for n, p in qmodel.named_parameters()
                   if n.endswith((".weight", ".scale")) and p.dtype in (torch.int8, torch.float32)) / 1e9
        print(f"phase quantize llama-3.1-8b: int8 projections and head {q_gb:.2f} GB (embedding and norms shared) "
              f"device_mem_gb={torch.cuda.memory_allocated() / 1e9:.2f} s={time.monotonic() - t:.1f}", flush=True)
        if "model_q8" in want:
            timed(phase_model_q8, model, qmodel, bits[2].config, bits[2])
        qbits = build_q8_service(bits, qmodel)
        if "service_q8" in want:
            q_launches = timed(phase_service, qbits, tag="int8", ingest=False, need=ONE_SHOT_Q8,
                               forbid=BF16_CACHE_KERNELS, force_spec=True)
        if "quality" in want:
            timed(phase_quality_q8, qbits)
        if "continuous_service_q8" in want:
            q_cont = timed(phase_continuous_service, qbits, tag="int8", block_size=32, need=CONTINUOUS_Q8,
                           forbid=BF16_CACHE_KERNELS, plain_yardstick=False)
        if "continuous_engine_q8" in want:
            timed(phase_continuous_engine, qbits, tag="int8", block_size=32,
                  decode_kernel="paged_decode_attention_q8", forbid=BF16_CACHE_KERNELS)
        # the int8 legs of the later slices cut their budget to 48 tokens (the script's time limit)
        if "continuous_dense_q8" in want:
            timed(phase_continuous_dense, qbits, tag="int8",
                  need=("knn_topk", "flash_attention", "decode_attention_q8"),
                  forbid=PAGED_KERNELS + ("decode_attention", "chunk_prefill_attention"), max_new=48,
                  follow_tokens=FOLLOW_TOKENS_Q8)
        if "spec_paged_q8" in want:
            timed(phase_spec_paged, qbits, tag="int8",
                  need=("knn_topk", "flash_attention", "paged_chunk_attention_q8"),
                  forbid=BF16_CACHE_KERNELS + ("decode_attention_q8", "chunk_prefill_attention_q8"), block_size=32,
                  max_new=48, follow_tokens=FOLLOW_TOKENS_Q8)
        if "lookahead" in want:
            timed(phase_lookahead_q8, qbits)
    if bits is not None:
        if bits[0].llm_tokenizer.native_calls == 0:
            fail("the native BPE merge loop never served a request")
        print(f"native BPE merge loop: {bits[0].llm_tokenizer.native_calls} texts encoded", flush=True)
    print(f"phase_seconds total={time.monotonic() - T_START:.1f}", flush=True)
    print(f"device_mem_peak_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)

    csrc = "rag_llm_k8s_tpu_torch/ops/csrc/"
    # each kernel's entry-point source, and the file of the routine it runs
    # (attention_sm90.cuh for every attention kernel)
    sources = {"knn_topk": csrc + "knn.cu", "decode_attention": csrc + "attention_sm90.cu",
               "chunk_prefill_attention": csrc + "attention_sm90.cu",
               "paged_decode_attention": csrc + "paged_attention.cu",
               "paged_chunk_attention": csrc + "paged_attention.cu",
               **{k: csrc + "attention_q8.cu" for k in ONE_SHOT_Q8[2:] + CONTINUOUS_Q8[2:]}}
    no_routine = ("knn_topk",)
    replaces = {
        "knn_topk": "rag_llm_k8s_tpu/ops/knn.py:87",
        "flash_attention": "rag_llm_k8s_tpu/ops/attention.py:122",
        "decode_attention": "rag_llm_k8s_tpu/ops/attention.py:276",
        "chunk_prefill_attention": "rag_llm_k8s_tpu/ops/attention.py:428",
        "paged_decode_attention": "rag_llm_k8s_tpu/ops/attention.py:1134",
        "paged_chunk_attention": "rag_llm_k8s_tpu/ops/attention.py:1408",
        "decode_attention_q8": "rag_llm_k8s_tpu/ops/attention.py:787",
        "chunk_prefill_attention_q8": "rag_llm_k8s_tpu/ops/attention.py:948",
        "paged_decode_attention_q8": "rag_llm_k8s_tpu/ops/attention.py:1265",
        "paged_chunk_attention_q8": "rag_llm_k8s_tpu/ops/attention.py:1588",
    }
    # launches: each kernel's count on the path that runs it (one-shot bf16,
    # continuous bf16, one-shot int8, continuous int8); a path a --phases
    # run left out reads null
    launches = {**launches, **{k: cont_launches.get(k) for k in CONTINUOUS_KERNELS[2:]},
                **{k: q_launches.get(k) for k in ONE_SHOT_Q8[2:]}, **{k: q_cont.get(k) for k in CONTINUOUS_Q8[2:]}}
    kernels = []
    for kname in replaces:
        r = rows[kname]
        if "ms" not in r:
            continue  # a kernel phase a --phases run left out
        kernels.append({
            "name": kname, "route": "cuda",
            "source": sources.get(kname, csrc + "attention.cu"),
            **({} if kname in no_routine else {"routine": csrc + "attention_sm90.cuh"}),
            "replaces": replaces[kname], "launches": launches.get(kname),
            "max_abs_err": r["max_abs_err"],
            "tolerance": f"distance rel {KNN_RTOL}" if kname == "knn_topk" else
            f"rel rms {ATTN_RMS_TOL}, max abs {ATTN_MAX_TOL} x max|plain|",
            **({"rel_rms": r["rel_rms"]} if "rel_rms" in r else {}),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], **({"bf16_kernel_ms": r["bf16_kernel_ms"]} if "bf16_kernel_ms" in r else {}),
            **{k: r[k] for k in ("long_prompt", "bge_m3", "design", "design_ms", "host_us", "queries_8",
                                 "queries_9", "prefix_shapes", "continuous_shapes", "lookahead_shapes",
                                 "shadow_shapes") if k in r},
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
