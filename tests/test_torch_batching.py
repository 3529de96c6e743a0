"""The port's coalesced batching (``engine/batching.py``): the cases of
``tests/test_batching.py`` on the port's classes, and a coalesced burst on a
tiny CPU engine against each request served alone and against the JAX
``BatchScheduler`` over the same weights (greedy)."""

import threading
import time

import jax
import pytest
import torch

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine.batching import BatchScheduler as JBatchScheduler
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EngineConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler, Coalescer
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama

FP32 = DTypePolicy.fp32()
ENGINE = dict(prompt_buckets=(16,), max_batch_size=4)
PROMPTS = [[3, 1, 4], [1, 5, 9, 2], [6, 5], [3, 5, 8, 9, 7], [9, 3, 2], [3, 8]]


@pytest.fixture(scope="module")
def params():
    return init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(), JDTypes.fp32())


@pytest.fixture(scope="module")
def engine(params):
    cfg = LlamaConfig.tiny()
    model = convert.load_llama(build_llama(cfg, FP32, torch.device("cpu")), convert.flatten_tree(params))
    return InferenceEngine(cfg, model, SamplingConfig(do_sample=False, max_new_tokens=6),
                           EngineConfig(**ENGINE), FP32, device="cpu")


class _Counted:
    """Counts ``engine.generate`` calls and their batch sizes."""

    def __init__(self, engine):
        self.engine, self.sizes = engine, []
        self.real = engine.generate
        engine.generate = self

    def __call__(self, prompts, *a, **kw):
        self.sizes.append(len(prompts))
        return self.real(prompts, *a, **kw)

    def restore(self):
        self.engine.generate = self.real


def _burst(submit, prompts):
    results = [None] * len(prompts)

    def worker(i):
        results[i] = submit(prompts[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return results


class TestBatchScheduler:
    def test_concurrent_submits_match_solo_and_the_jax_scheduler(self, engine, params):
        want = [engine.generate([p])[0] for p in PROMPTS]
        counted = _Counted(engine)
        sched = BatchScheduler(engine, max_wait_ms=20.0)
        try:
            got = _burst(lambda p: sched.submit(p, timeout=120), PROMPTS)
        finally:
            sched.shutdown()
            counted.restore()
        assert got == want
        # 6 concurrent requests with cap 4 coalesce into fewer calls, none past the cap
        assert len(counted.sizes) < len(PROMPTS) and max(counted.sizes) <= ENGINE["max_batch_size"]
        assert max(counted.sizes) > 1

        jengine = JEngine(JLlamaConfig.tiny(), params, sampling=JSampling(do_sample=False, max_new_tokens=6),
                          engine_config=JEngineConfig(**ENGINE), dtypes=JDTypes.fp32())
        jsched = JBatchScheduler(jengine, max_wait_ms=20.0)
        try:
            jgot = _burst(lambda p: jsched.submit(p, timeout=120), PROMPTS)
        finally:
            jsched.shutdown()
        assert got == jgot

    def test_generate_sub_batches_past_the_cap(self, engine):
        assert engine.generate(PROMPTS) == [engine.generate([p])[0] for p in PROMPTS]

    def test_grouping_by_max_new_and_seed(self, engine):
        counted = _Counted(engine)
        sched = BatchScheduler(engine, max_wait_ms=300.0)
        try:
            keys = [(2, None), (2, None), (5, None), (2, 7), (2, None)]
            results = [None] * len(keys)

            def run(i):
                results[i] = sched.submit([3, 1, 4 + i], max_new_tokens=keys[i][0], seed=keys[i][1], timeout=120)

            threads = []
            for i in range(len(keys)):
                threads.append(threading.Thread(target=run, args=(i,)))
                threads[-1].start()
                time.sleep(0.02)
            for t in threads:
                t.join(120)
        finally:
            sched.shutdown()
            counted.restore()
        assert all(len(r) <= keys[i][0] for i, r in enumerate(results))
        # the batch that led with (2, None) carried (5, None) to the next
        # round: no batch mixed keys, and every request was answered
        assert sum(counted.sizes) == len(keys) and counted.sizes[0] == 2

    def test_shutdown_rejects(self, engine):
        sched = BatchScheduler(engine)
        sched.shutdown()
        with pytest.raises(RuntimeError):
            sched.submit([1, 2, 3])

    def test_shutdown_drains_queued_and_carried(self, engine):
        """Items still queued or held as the mismatch carry at shutdown are
        failed, not abandoned."""
        sched = BatchScheduler(engine, max_wait_ms=700.0)
        release = threading.Event()
        orig_generate = sched.engine.generate

        def slow_generate(*a, **kw):
            release.wait(timeout=30)
            return orig_generate(*a, **kw)

        sched.engine.generate = slow_generate
        try:
            results = {}

            def run(name, max_new):
                try:
                    results[name] = ("ok", sched.submit([3, 17], max_new_tokens=max_new, timeout=60))
                except BaseException as e:  # noqa: BLE001
                    results[name] = ("err", type(e).__name__)

            threads = [threading.Thread(target=run, args=(n, m)) for n, m in (("t1", 2), ("t2", 3), ("t3", 4))]
            threads[0].start()
            time.sleep(0.2)  # the worker picked t1 and waits in its window
            threads[1].start()
            time.sleep(0.2)  # t2 carried; the worker is inside the blocked generate
            threads[2].start()
            time.sleep(0.2)  # t3 queued
            sched._stop.set()
            release.set()
            sched._queue.put(None)
            sched._worker.join(timeout=30)
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive(), "submitter hung after shutdown"
            assert results["t1"][0] == "ok"
            assert results["t2"] == ("err", "RuntimeError")
            assert results["t3"] == ("err", "RuntimeError")
        finally:
            sched.engine.generate = orig_generate
            sched.shutdown()

    def test_worker_never_requeues_drained_items(self, engine):
        sched = BatchScheduler(engine, max_wait_ms=100.0)
        try:
            worker_puts = []
            orig_put = sched._queue.put

            def spy_put(item, *a, **kw):
                if threading.current_thread() is sched._worker:
                    worker_puts.append(item)
                return orig_put(item, *a, **kw)

            sched._queue.put = spy_put
            outs = {}

            def run(name, max_new):
                outs[name] = sched.submit([3, 17], max_new_tokens=max_new, timeout=120)

            ta = threading.Thread(target=run, args=("a", 4))
            ta.start()
            time.sleep(0.02)
            tb = threading.Thread(target=run, args=("b", 5))
            tb.start()
            ta.join(timeout=120)
            tb.join(timeout=120)
            assert set(outs) == {"a", "b"} and all(outs.values())
            assert worker_puts == []
        finally:
            sched.shutdown()

    def test_errors_reach_every_waiter_of_the_batch(self, engine):
        sched = BatchScheduler(engine, max_wait_ms=200.0)
        orig = sched.engine.generate
        sched.engine.generate = lambda *a, **kw: (_ for _ in ()).throw(ValueError("boom"))
        try:
            errors = _burst(lambda p: _catch(lambda: sched.submit(p, timeout=60)), PROMPTS[:3])
        finally:
            sched.engine.generate = orig
            sched.shutdown()
        assert errors == ["ValueError: boom"] * 3

    def test_scheduler_solo_skips_window(self, engine):
        sched = BatchScheduler(engine, max_wait_ms=2000.0, pending_hint=lambda: 1)
        try:
            t0 = time.monotonic()
            out = sched.submit([3, 1, 4], timeout=120)
            assert time.monotonic() - t0 < 1.0  # not the 2 s window
            assert out == engine.generate([[3, 1, 4]])[0]
        finally:
            sched.shutdown()


def _catch(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001
        return f"{type(e).__name__}: {e}"


class TestCoalescer:
    def test_concurrent_submits_batch_and_return_in_order(self):
        calls, lock = [], threading.Lock()

        def batch_fn(items):
            with lock:
                calls.append(list(items))
            time.sleep(0.05)
            return [x * 10 for x in items]

        co = Coalescer(batch_fn, max_batch=4, max_wait_ms=1.0)
        try:
            results = _burst(lambda i: co.submit(i, timeout=30), list(range(8)))
            assert results == [i * 10 for i in range(8)]
            assert len(calls) < 8 and max(len(c) for c in calls) > 1
            assert max(len(c) for c in calls) <= 4
        finally:
            co.shutdown()

    def test_error_delivered_to_every_waiter(self):
        gate = threading.Event()

        def batch_fn(items):
            gate.wait(5)
            raise ValueError("boom")

        co = Coalescer(batch_fn, max_batch=4, max_wait_ms=200.0)
        try:
            threads_out = []
            ts = [threading.Thread(target=lambda: threads_out.append(_catch(lambda: co.submit(1, timeout=30))))
                  for _ in range(3)]
            for t in ts:
                t.start()
            time.sleep(0.1)
            gate.set()
            for t in ts:
                t.join(30)
            assert threads_out == ["ValueError: boom"] * 3
        finally:
            co.shutdown()

    def test_wrong_result_count_is_an_error_not_a_hang(self):
        co = Coalescer(lambda items: [], max_batch=4, max_wait_ms=1.0)
        try:
            with pytest.raises(RuntimeError, match="results"):
                co.submit(1, timeout=30)
        finally:
            co.shutdown()

    def test_shutdown_rejects_new_submits_and_fails_queued_ones(self):
        co = Coalescer(lambda items: items, max_batch=2, max_wait_ms=1.0)
        co.shutdown()
        with pytest.raises(RuntimeError, match="shut down"):
            co.submit(1, timeout=5)
        gate = threading.Event()
        co2 = Coalescer(lambda items: gate.wait(5) and items, max_batch=1, max_wait_ms=0.0)
        out = []
        ts = [threading.Thread(target=lambda: out.append(_catch(lambda: co2.submit(1, timeout=30))))
              for _ in range(3)]
        for t in ts:
            t.start()
        time.sleep(0.1)  # one in flight, two queued
        co2._stop.set()
        gate.set()
        co2._queue.put(None)
        co2._worker.join(10)
        for t in ts:
            t.join(10)
        assert sorted(out, key=str) == sorted([None, "RuntimeError: coalescer is shut down",
                                               "RuntimeError: coalescer is shut down"], key=str)

    def test_zero_window_still_drains_queued_items(self):
        calls, lock, gate = [], threading.Lock(), threading.Event()

        def batch_fn(items):
            with lock:
                calls.append(list(items))
            if len(calls) == 1:
                gate.wait(10)
            return [x * 10 for x in items]

        co = Coalescer(batch_fn, max_batch=8, max_wait_ms=0.0)
        try:
            results = [None] * 5

            def run(i):
                results[i] = co.submit(i, timeout=30)

            t0 = threading.Thread(target=run, args=(0,))
            t0.start()
            while not calls:
                time.sleep(0.001)
            rest = [threading.Thread(target=run, args=(i,)) for i in range(1, 5)]
            for t in rest:
                t.start()
            time.sleep(0.05)
            gate.set()
            t0.join(30)
            for t in rest:
                t.join(30)
            assert results == [i * 10 for i in range(5)]
            assert len(calls) == 2 and sorted(calls[1]) == [1, 2, 3, 4]
        finally:
            co.shutdown()

    def test_pending_hint_lets_a_solo_item_skip_the_window(self):
        co = Coalescer(lambda items: [x * 10 for x in items], max_batch=8, max_wait_ms=2000.0,
                       pending_hint=lambda: 1)
        try:
            t0 = time.monotonic()
            assert co.submit(3, timeout=30) == 30
            assert time.monotonic() - t0 < 0.5
        finally:
            co.shutdown()

    def test_hinted_burst_still_coalesces(self):
        calls, lock, inflight = [], threading.Lock(), [4]

        def batch_fn(items):
            with lock:
                calls.append(list(items))
            return [x * 10 for x in items]

        co = Coalescer(batch_fn, max_batch=8, max_wait_ms=5000.0, pending_hint=lambda: inflight[0])
        try:
            results = [None] * 4

            def run(i):
                time.sleep(0.01 * i)
                results[i] = co.submit(i, timeout=30)

            threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
            t0 = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert results == [i * 10 for i in range(4)]
            assert len(calls) == 1 and sorted(calls[0]) == [0, 1, 2, 3]
            assert time.monotonic() - t0 < 2.0
        finally:
            co.shutdown()
