"""Production entry point: assemble the service from a staged directory and
serve it, the counterpart of ``rag_llm_k8s_tpu/server/main.py``.

Boot sequence (``build_service``, the JAX one's steps on one card):

1. ``config.json`` under ``MODEL_PATH`` sets the Llama config when present;
2. the Llama-3.1 safetensors shards stream onto the card
   (``models.loader.load_safetensors_params``; ``TPU_RAG_WEIGHT_QUANT=int8``
   quantizes on the host as they stream), through the converted-parameter
   cache (``models.checkpoint.load_params_cached``, one directory per quant
   mode);
3. both tokenizers (``MODEL_PATH/tokenizer.json`` and
   ``MODEL_PATH/bge-m3/tokenizer.json``);
4. the bge-m3 encoder from ``MODEL_PATH/bge-m3``;
5. a probe embedding's fingerprint, then ``VectorStore.open_or_create`` at
   the index path (a snapshot from other encoder weights is rebuilt);
6. a ``BatchScheduler`` under ``batching="coalesce"`` (the default), or the
   continuous scheduler under ``"continuous"``.

``main()`` then ingests the PDF directory, warms up in a background thread
(``/healthz`` answers 503 until it is done), arms the fault sites listed in
``TPU_RAG_FAULTS`` (after the ingest, so the budget tests the serving path)
and serves on a threading WSGI server (``server.app.make_server``), one
thread per request, so concurrent requests coalesce. SIGTERM starts the
graceful drain (``resilience/lifecycle.py``): new and queued requests get
503 ``draining``, the ones in flight finish within ``drain_deadline_s``,
then the process exits with 0. ``TPU_RAG_JSON_LOGS=1`` makes every log line
one JSON object carrying the request's trace and span ids
(``obs/logging.py``), installed before anything logs.

Run: ``python -m rag_llm_k8s_tpu_torch.server.main`` (environment keys:
``core.config.AppConfig.from_env``).

Not ported yet (``ROADMAP.md`` Queue 1): the WAL restore of the JAX entry
point (item 8) and the device mesh (item 10: the port serves one card).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)


def configure_logging(env: Optional[dict] = None) -> None:
    """The process's log format: trace-correlated JSON lines under
    ``TPU_RAG_JSON_LOGS`` (``1``, ``true`` or ``yes``), else the plain
    format; ``TPU_RAG_LOG_LEVEL`` sets the level either way."""
    env = os.environ if env is None else env
    level = env.get("TPU_RAG_LOG_LEVEL", "INFO")
    if env.get("TPU_RAG_JSON_LOGS", "").lower() in ("1", "true", "yes"):
        from rag_llm_k8s_tpu_torch.obs.logging import configure_json_logging

        configure_json_logging(level)
    else:
        logging.basicConfig(level=level)


def build_service(config=None, device=None, info: Optional[dict] = None):
    """The ``RagService`` for ``config`` (default ``AppConfig.from_env()``)
    on ``device`` (default: the card; with none it raises). ``info``
    receives what the boot did: ``params_source`` (``"cache"`` or
    ``"converted"``) and ``index_loaded_vectors`` (rows read from a
    persisted snapshot)."""
    import torch

    from rag_llm_k8s_tpu_torch.core.config import AppConfig
    from rag_llm_k8s_tpu_torch.core.device import resolve_device
    from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
    from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
    from rag_llm_k8s_tpu_torch.index.store import VectorStore
    from rag_llm_k8s_tpu_torch.models.checkpoint import CACHE_SUBDIR, load_params_cached
    from rag_llm_k8s_tpu_torch.models.llama import build_llama
    from rag_llm_k8s_tpu_torch.models.loader import (
        config_from_hf_json,
        load_encoder_safetensors,
        load_safetensors_params,
    )
    from rag_llm_k8s_tpu_torch.server.app import RagService, build_scheduler
    from rag_llm_k8s_tpu_torch.tokenizer import load_tokenizer

    config = AppConfig.from_env() if config is None else config
    info = {} if info is None else info
    dev = resolve_device(device)
    model_dir = config.server.model_path
    model_cfg = config.model
    if os.path.exists(os.path.join(model_dir, "config.json")):
        model_cfg = config_from_hf_json(model_dir)
        config = dataclasses.replace(config, model=model_cfg)
    logger.info("loading Llama weights from %s", model_dir)
    quant = config.engine.weight_quant
    # the cache holds whichever layout was converted: one directory per quant
    # mode, so toggling TPU_RAG_WEIGHT_QUANT swaps caches
    cache_dir = os.path.join(model_dir, CACHE_SUBDIR if quant == "bf16" else f"{CACHE_SUBDIR}_{quant}")
    model = load_params_cached(
        model_dir,
        lambda: load_safetensors_params(model_dir, model_cfg, config.dtypes, dev, quant=quant),
        abstract_params_fn=lambda: build_llama(model_cfg, config.dtypes, dev, quantized=quant == "int8"),
        cache_dir=cache_dir,
        info=info,
    )
    llm_tokenizer = load_tokenizer(model_dir)

    logger.info("loading bge-m3 from %s", config.server.embedder_path)
    enc_model = load_encoder_safetensors(config.server.embedder_path, config.encoder, config.dtypes, dev)
    enc_tokenizer = load_tokenizer(config.server.embedder_path)

    engine = InferenceEngine(model_cfg, model, config.sampling, config.engine, config.dtypes, dev)
    encoder = EncoderRunner(config.encoder, enc_model, dev, eos_id=getattr(enc_tokenizer, "eos_id", None))

    # fingerprint the embedder with a probe embedding, so that a persisted
    # index built by other encoder weights is detected and rebuilt
    probe = encoder.encode([enc_tokenizer.encode("__embedder_fingerprint__")])[0]
    fingerprint = hashlib.sha256(probe.tobytes()).hexdigest()[:16]
    store = VectorStore.open_or_create(
        config.server.index_path, dim=config.retrieval.embed_dim, fingerprint=fingerprint, device=dev
    )
    info["index_loaded_vectors"] = store.ntotal

    if config.engine.batching == "continuous":
        if config.engine.speculative == "prompt_lookup":
            logger.warning(
                "TPU_RAG_SPECULATIVE='prompt_lookup' is configured but "
                "TPU_RAG_BATCHING='continuous' routes requests through the "
                "continuous engine, which that knob does not govern; "
                "batching='coalesce' (the default) serves the one-shot "
                "speculative path"
            )
        scheduler = build_scheduler(engine, config.engine, config.resilience)
    else:
        # 30 ms: long enough to catch a cold burst fanning out of one
        # coalesced retrieval, short next to a full-context generate
        scheduler = BatchScheduler(engine, max_wait_ms=30.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return RagService(config, engine, llm_tokenizer, encoder, enc_tokenizer, store, scheduler=scheduler)


def arm_faults(env: Optional[dict] = None) -> dict:
    """Arm the fault sites ``TPU_RAG_FAULTS`` lists (``site[:count],...``;
    ``1`` only enables ``/debug/faults``); returns what is armed."""
    from rag_llm_k8s_tpu_torch.resilience import faults

    armed = faults.arm_from_env(env)
    if armed:
        logger.warning("fault injection armed from TPU_RAG_FAULTS: %s", armed)
    return armed


def main() -> None:
    import signal

    from rag_llm_k8s_tpu_torch.server.app import make_server

    configure_logging()
    service = build_service()
    service.ingest_directory()
    if service.store.ntotal == 0:
        logger.warning("No PDF files were processed. The index might be empty.")

    def _warm():
        try:
            service.warmup()
            logger.info("warmup done: ready")
        except Exception:  # noqa: BLE001 — logged; /healthz stays 503
            logger.exception("warmup failed; the service stays unready")

    threading.Thread(target=_warm, daemon=True, name="warmup").start()
    arm_faults()
    cfg = service.config.server
    server = make_server(service, cfg.host, cfg.port)

    def _exit_after_drain(grace_s: float = 2.0):
        # the admission slot frees before the handler writes its response:
        # give the last responses a moment to reach their sockets, then exit
        # (os._exit: serve_forever is blocked in the main thread, and there
        # is nothing left to flush)
        t_end = time.monotonic() + grace_s
        while server.requests_in_flight() and time.monotonic() < t_end:
            time.sleep(0.01)
        logger.info("drained: exiting")
        os._exit(0)

    # SIGTERM (every roll, reschedule and node drain) begins the graceful
    # drain; the coordinator's watcher calls exit_fn once the requests in
    # flight have finished or the drain deadline has passed
    service.lifecycle.exit_fn = _exit_after_drain
    signal.signal(signal.SIGTERM, lambda *_: service.lifecycle.begin_drain("sigterm"))
    logger.info("serving on %s:%d", cfg.host, server.server_port)
    res = service.config.resilience
    logger.info(
        "resilience: admission %d concurrent + %d queued (429 beyond), default deadline %d ms, "
        "breaker %d resets / %.0f s, %d in-flight retries, drain deadline %.1f s",
        res.admission_max_concurrency, res.admission_max_queue, res.deadline_ms,
        res.breaker_reset_threshold, res.breaker_window_s, res.inflight_retries, res.drain_deadline_s,
    )
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.shutdown()


if __name__ == "__main__":
    main()
