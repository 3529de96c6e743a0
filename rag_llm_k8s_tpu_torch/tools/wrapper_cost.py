"""Host and device cost of the paged decode and kNN wrappers, for two trees.

Each tree (a checkout of the repo, e.g. the working tree and an unpacked
``git archive`` of its parent) is imported in a process of its own, in the
order given, so two versions of ``rag_llm_k8s_tpu_torch`` never share an
interpreter. Each process builds its tree's kernels and, at the main-path
shapes of ``chip_smoke.py`` (paged decode: B = 8, H = 32, K = 8, hd = 128,
bs = 16, MB = 272, 9,885 live keys; kNN: one query over 65,536 x 1024
fp32), reads in ``ROUNDS`` alternating rounds:

- ``host_us``: host microseconds to issue one wrapper call (the mean of
  ``CALLS_PER_ROUND`` calls, the card not waited for; the card runs a spin
  kernel meanwhile, so the calls never wait on a full launch queue);
- ``ms``: device milliseconds per call (calls queued behind a spin kernel,
  timed between two events).

Run on the card from the repo root, e.g. parent, change, change, parent:

    python3 rag_llm_k8s_tpu_torch/tools/wrapper_cost.py \\
        --tree _archive/parent --tree . --tree . --tree _archive/parent

It prints one JSON line per process and a median per tree.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROUNDS = 7
CALLS_PER_ROUND = 256
SPIN_CYCLES_PER_MS = 2.0e6  # at least the H100's boost clock, as in chip_smoke.py


def _device_ms(torch, fn, iters: int = 64) -> float:
    fn(0)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * 20))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _host_us(torch, fn) -> float:
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * 50))
    t0 = time.perf_counter()
    for i in range(CALLS_PER_ROUND):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / CALLS_PER_ROUND * 1e6


def worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from rag_llm_k8s_tpu_torch.ops import _build
    from rag_llm_k8s_tpu_torch.ops import attention as A
    from rag_llm_k8s_tpu_torch.ops import knn

    assert A.__file__.startswith(os.path.abspath(tree)), A.__file__
    _build.build(["knn", "paged_attention"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    L, B, H, K, hd, bs, MB = 2, 8, 32, 8, 128, 16, 272
    kv_l = [4351, 3100, 1800, 600, 17, 16, 1, 0]
    N = B * MB + 1
    ka = torch.randn((L, N, K, bs, hd), device=dev, generator=g).to(torch.bfloat16)
    va = torch.randn((L, N, K, bs, hd), device=dev, generator=g).to(torch.bfloat16)
    tables = (torch.randperm(N - 1, device=dev, generator=g)[:B * MB] + 1).to(torch.int32).reshape(B, MB)
    kv_len = torch.tensor(kv_l, dtype=torch.int32, device=dev)
    q = torch.randn((B, 1, H, hd), device=dev, generator=g).to(torch.bfloat16)
    emb = torch.randn((65536, 1024), device=dev, generator=g)
    norms = (emb * emb).sum(1)[None].contiguous()
    qk = torch.randn((1, 1024), device=dev, generator=g)
    calls = {
        "paged_decode_attention": lambda i: A.paged_decode_attention(q, ka, va, tables, kv_len, i % L),
        "knn_topk": lambda i: knn.knn_topk(qk, emb, norms, k=5),
    }
    out = {name: {"host_us": [], "ms": []} for name in calls}
    for fn in calls.values():  # first calls: library load, allocator
        for i in range(8):
            fn(i)
    for _ in range(ROUNDS):
        for name, fn in calls.items():
            out[name]["host_us"].append(_host_us(torch, fn))
            out[name]["ms"].append(_device_ms(torch, fn))
    return dict(tree=tree, launches={n: _build.LAUNCHES[n] for n in calls}, **out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="a checkout to import (repeat, in order)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.tree[0])), flush=True)
        return 0
    runs = []
    for tree in args.tree:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", "--tree", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    for tree in dict.fromkeys(args.tree):
        mine = [r for r in runs if r["tree"] == tree]
        summary = {name: {key: statistics.median(v for r in mine for v in r[name][key]) for key in ("host_us", "ms")}
                   for name in ("paged_decode_attention", "knn_topk")}
        print(f"median tree={tree} processes={len(mine)} {json.dumps(summary)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
