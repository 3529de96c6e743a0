"""The mesh's state digest on the heartbeat (``parallel/commands.py``).

Every heartbeat gathers each rank's ``state_digest()`` of its live targets
(here the one-shot engine's prefix cache: its entries and their tiers), and
a difference ends the world as ``MeshDivergence`` does. Four tp = 2 worlds
of one process per rank on the CPU (gloo), side by side: in the planted
ones, rank 1's ``pin`` also marks its entries warm without moving them, a
silent difference the next heartbeat must catch; the unplanted ones beat
clean through the same calls. Two worlds beat by hand between calls; the
other two start the heartbeat and keep the stream busy with back-to-back
generates, so the beats come between commands. The rank functions import
nothing of JAX.
"""

import dataclasses
import re
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from rag_llm_k8s_tpu_torch.core.config import (
    DTypePolicy,
    EngineConfig,
    LlamaConfig,
    MeshConfig,
    PrefixCacheConfig,
    SamplingConfig,
)
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.parallel.commands import MeshDivergence, serve_commands, stream_for
from rag_llm_k8s_tpu_torch.parallel.launch import spawn_world

FP32 = DTypePolicy.fp32()
VOCAB = 64
# 8 query heads over 4 kv heads tile tp = 2
CFG = dataclasses.replace(LlamaConfig.tiny(VOCAB), num_heads=8, num_kv_heads=4, head_dim=8,
                          eos_token_ids=(VOCAB,))
EC = EngineConfig(prompt_buckets=(16,), max_batch_size=1, max_seq_len=64, speculative="off",
                  prefix_cache=PrefixCacheConfig(enabled=True, max_prefix_tokens=32, segment_buckets=(16,),
                                                 suffix_buckets=(16,)))


BEAT_S = 0.25  # the busy worlds' heartbeat interval
BUSY_S = 2.0  # how long an unplanted busy world serves


def _busy_leader(stream, eng, pc):
    """Rank 0 of a busy world: the heartbeat started, rank 1's pin planted
    (where it is), then generates back to back, no beat by hand. Returns
    ``(clean beats after the pin, generates)``; a divergence raises."""
    beats, real = [], stream.heartbeat

    def heartbeat():
        out = real()
        beats.append(time.monotonic())  # a beat that found no difference
        return out

    stream.heartbeat = heartbeat
    stream.start_heartbeat(BEAT_S)
    pc.prefix_for([("head", list(range(3, 15)))])
    pc.pin("head")
    t0, n = time.monotonic(), 0
    try:
        while time.monotonic() - t0 < BUSY_S:
            eng.generate([[20, 21, 22 + n % 5]])
            n += 1
    except Exception as e:
        after = sum(b >= t0 for b in beats)
        raise RuntimeError(f"busy: divergence after {n} generates, {after} clean beat(s) after the pin, "
                           f"{time.monotonic() - t0:.2f} s: {e}") from e
    return sum(b >= t0 for b in beats), n


def _digest_rank(ctx, plant, busy=False):
    model = convert.init_random_sharded(CFG, FP32, ctx, torch.Generator().manual_seed(0))
    eng = InferenceEngine(CFG, model, SamplingConfig(do_sample=False, max_new_tokens=4), EC, FP32, "cpu",
                          mesh=ctx)
    pc = eng.prefix_cache
    planted = []
    if plant and ctx.rank == 1:
        real_pin = pc.pin

        def pin(seg_key):
            # rank 1 alone: the entries read warm, nothing moved, nothing raised
            real_pin(seg_key)
            for e in pc._entries.values():
                e.tier = "warm"
            planted.append(seg_key)

        pc.pin = pin
    if not ctx.leader:
        try:
            serve_commands(ctx)
        except MeshDivergence as e:
            raise MeshDivergence(f"{e} (planted: {planted})") from e
        return None
    stream, clean = stream_for(ctx), 0
    if busy:
        try:
            return _busy_leader(stream, eng, pc)
        finally:
            stream.stop()
    try:
        stream.heartbeat()
        clean += 1
        pc.prefix_for([("head", list(range(3, 15)))])
        stream.heartbeat()
        clean += 1
        pc.pin("head")
        stream.heartbeat()
        clean += 1
        out = eng.generate_prefixed([20, 21, 22], pc.prefix_for([("head", list(range(3, 15)))]))
        stream.heartbeat()
        clean += 1
    except MeshDivergence as e:
        raise RuntimeError(f"divergence detected after {clean} clean heartbeat(s): {e}") from e
    finally:
        stream.stop()
    return clean, len(out), stream.ready()


@pytest.fixture(scope="module")
def worlds():
    def run(plant, busy):
        t = time.monotonic()
        try:
            return ("ok", spawn_world(_digest_rank, MeshConfig(tp=2), device="cpu", timeout_s=60,
                                      args=(plant, busy), join_timeout_s=120.0), time.monotonic() - t)
        except Exception as e:  # noqa: BLE001 — the planted world returns its failure
            return ("error", e, time.monotonic() - t)

    cases = [(plant, busy) for plant in (False, True) for busy in (False, True)]
    with ThreadPoolExecutor(max_workers=len(cases)) as pool:
        futs = {case: pool.submit(run, *case) for case in cases}
        return {case: f.result() for case, f in futs.items()}


def test_a_silent_difference_on_one_rank_ends_the_world_at_the_next_heartbeat(worlds):
    kind, err, seconds = worlds[True, False]
    assert kind == "error", err
    msg = str(err)
    assert "MeshDivergence" in msg and "state digests differ" in msg and "'prefix" in msg
    # the heartbeats before the plant took effect were clean: whichever rank
    # reports first, the divergence came after rank 1's pin
    assert "after 2 clean heartbeat(s)" in msg or "(planted: ['head'])" in msg
    assert seconds < 120


def test_an_unplanted_world_beats_clean_through_the_same_calls(worlds):
    kind, res, _ = worlds[False, False]
    assert kind == "ok", res
    assert res[0] == (4, 4, False) and res[1] is None  # stopped: not ready any more


def test_a_busy_stream_beats_between_commands_and_ends_a_diverged_world(worlds):
    kind, err, seconds = worlds[True, True]
    assert kind == "error", err
    msg = str(err)
    assert "state digests differ" in msg and "'prefix" in msg
    leader = re.search(r"busy: divergence after \d+ generates, (\d+) clean beat\(s\) after the pin", msg)
    if leader:
        # rank 0 saw it: the first beat after the pin (the beat thread's or
        # one a generate ran first) found it while serving, and the stream
        # broke
        assert int(leader.group(1)) == 0, msg
        assert "MeshDivergence" in msg or "command stream is broken: heartbeat" in msg, msg
    else:
        # a follower reported first: it left its loop on rank 0's diverged
        assert "MeshDivergence" in msg and "rank 0's heartbeat found" in msg, msg
    assert seconds < 120


def test_a_busy_unplanted_world_beats_clean_while_serving(worlds):
    kind, res, _ = worlds[False, True]
    assert kind == "ok", res
    beats, generates = res[0]
    # no beat by hand: the interval's beats came between commands (about
    # BUSY_S / BEAT_S of them; at least two, however slow the host)
    assert beats >= 2 and generates >= 2 and res[1] is None
