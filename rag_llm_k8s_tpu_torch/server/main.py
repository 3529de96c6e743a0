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
(``/healthz`` answers 503 until it is done) and then, with the flight WAL
on (``TPU_RAG_FLIGHT_WAL=1``), runs the warm restart on the same thread
(``RagService.restore_from_wal``: the warmth manifest's chunks re-staged,
the previous incarnation's in-flight requests resumed), arms the fault sites listed in
``TPU_RAG_FAULTS`` (after the ingest, so the budget tests the serving path)
and serves on a threading WSGI server (``server.app.make_server``), one
thread per request, so concurrent requests coalesce. SIGTERM starts the
graceful drain (``resilience/lifecycle.py``): new and queued requests get
503 ``draining``, the ones in flight finish within ``drain_deadline_s``,
the persist step fsyncs the WAL and writes the warmth manifest, then the
process exits with 0. ``TPU_RAG_JSON_LOGS=1`` makes every log line
one JSON object carrying the request's trace and span ids
(``obs/logging.py``), installed before anything logs.

Run: ``python -m rag_llm_k8s_tpu_torch.server.main`` (environment keys:
``core.config.AppConfig.from_env``). Routes: ``/upload_pdf``, ``/generate``
(``/query``), ``/index_info``, ``/healthz``, ``/drain``, ``/metrics``,
``/slo``, ``/profile``, and, 403 unless ``TPU_RAG_DEBUG=1`` or
``TPU_RAG_FAULTS`` is set, ``/debug/traces``, ``/debug/timeline/<rid>``,
``/debug/incidents``, ``/debug/goodput``, ``/debug/quality``,
``/debug/tenants`` and ``/debug/faults`` (the last only under
``TPU_RAG_FAULTS``). The shadow auditor runs by default
(``TPU_RAG_SHADOW*``). Incident bundles
spool to ``TPU_RAG_FLIGHT_SPOOL`` (default ``/tmp/tpu_rag_incidents``; at
most ``TPU_RAG_FLIGHT_SPOOL_MAX``, one per trigger per
``TPU_RAG_FLIGHT_COOLDOWN_S``).

Mesh (``TPU_RAG_MESH``, default ``tp=-1``: every visible card): with more
than one rank, ``main()`` starts ranks 1..world-1 itself (``spawn``
processes, ``parallel/launch.py``), each on ``cuda:(r % device_count)``
over nccl when every rank has a card of its own and gloo otherwise. Every
rank loads only its shard through the streaming put, into a per-rank
parameter cache keyed by the mesh's shape; rank 0 builds the service as
above and drives the followers through the command stream
(``parallel/commands.py``), whose heartbeat keeps them answering while the
service is idle. ``/healthz`` is not ready while a follower is missing; a
follower that exits makes rank 0 exit non-zero, and SIGTERM's drain ends
the followers (``stop``) before rank 0 exits. A mesh serves every engine
feature: the followers build the same engines from the same config (the
one-shot engine with its prefix cache, and under
``TPU_RAG_BATCHING=continuous`` the continuous engine, paged or dense,
int8 KV, any pool role) and run the commands addressed to each, so the
prefill-tier and decode-tier deployments of ``deploy/llm/deploy.yaml``
boot under ``TPU_RAG_MESH`` as the main one does.
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


# a follower's load may take longer than the groups' collective timeout:
# the ranks meet after loading at a barrier with a timeout of its own
LOAD_TIMEOUT_S = 1800.0
# the command stream's heartbeat, idle or serving: well inside the groups'
# timeout, and the longest a diverged world serves before it ends
HEARTBEAT_S = 20.0


def load_model(config, device, mesh=None, info: Optional[dict] = None):
    """``(config, model)``: the Llama config (``config.json`` under
    ``MODEL_PATH`` when present) and the model, or this rank's shard of it
    on ``mesh``, through the converted-parameter cache
    (``models.checkpoint.cache_location``: one directory per quant mode, so
    toggling ``TPU_RAG_WEIGHT_QUANT`` swaps caches, and per mesh shape, one
    file per rank)."""
    from rag_llm_k8s_tpu_torch.models.checkpoint import cache_location, load_params_cached
    from rag_llm_k8s_tpu_torch.models.llama import build_llama
    from rag_llm_k8s_tpu_torch.models.loader import config_from_hf_json, load_safetensors_params

    model_dir = config.server.model_path
    model_cfg = config.model
    if os.path.exists(os.path.join(model_dir, "config.json")):
        model_cfg = config_from_hf_json(model_dir)
        config = dataclasses.replace(config, model=model_cfg)
    logger.info("loading Llama weights from %s", model_dir)
    quant = config.engine.weight_quant
    cache_dir, filename = cache_location(model_dir, quant, mesh)
    model = load_params_cached(
        model_dir,
        lambda: load_safetensors_params(model_dir, model_cfg, config.dtypes, device, quant=quant, mesh=mesh),
        abstract_params_fn=lambda: build_llama(model_cfg, config.dtypes, device, quantized=quant == "int8",
                                               mesh=mesh),
        cache_dir=cache_dir,
        info=info,
        filename=filename,
    )
    return config, model


def build_service(config=None, device=None, info: Optional[dict] = None, mesh=None):
    """The ``RagService`` for ``config`` (default ``AppConfig.from_env()``)
    on ``device`` (default: the card; with none it raises), or rank 0's
    service over ``mesh`` (its device). ``info`` receives what the boot
    did: ``params_source`` (``"cache"`` or ``"converted"``) and
    ``index_loaded_vectors`` (rows read from a persisted snapshot)."""
    import torch

    from rag_llm_k8s_tpu_torch.core.config import AppConfig
    from rag_llm_k8s_tpu_torch.core.device import resolve_device
    from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
    from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
    from rag_llm_k8s_tpu_torch.index.store import VectorStore
    from rag_llm_k8s_tpu_torch.models.loader import load_encoder_safetensors
    from rag_llm_k8s_tpu_torch.server.app import RagService, build_scheduler
    from rag_llm_k8s_tpu_torch.tokenizer import load_tokenizer

    config = AppConfig.from_env() if config is None else config
    info = {} if info is None else info
    dev = mesh.device if mesh is not None else resolve_device(device)
    model_dir = config.server.model_path
    config, model = load_model(config, dev, mesh, info)
    model_cfg = config.model
    llm_tokenizer = load_tokenizer(model_dir)

    logger.info("loading bge-m3 from %s", config.server.embedder_path)
    enc_model = load_encoder_safetensors(config.server.embedder_path, config.encoder, config.dtypes, dev)
    enc_tokenizer = load_tokenizer(config.server.embedder_path)

    engine = InferenceEngine(model_cfg, model, config.sampling, config.engine, config.dtypes, dev, mesh=mesh)
    encoder = EncoderRunner(config.encoder, enc_model, dev, eos_id=getattr(enc_tokenizer, "eos_id", None),
                            mesh=mesh)

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


def build_follower(config, mesh):
    """A follower rank's engines: its shard of the Llama weights, the
    one-shot engine over ``mesh`` and, under ``batching="continuous"``, the
    continuous engine over the same model, built in rank 0's order
    (``build_service``), so the command stream names them alike; no
    tokenizer, encoder, store or scheduler (rank 0 serves and schedules)."""
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine

    config, model = load_model(config, mesh.device, mesh)
    engine = InferenceEngine(config.model, model, config.sampling, config.engine, config.dtypes, mesh.device,
                             mesh=mesh)
    cont = None
    if config.engine.batching == "continuous":
        cont = ContinuousEngine(engine.config, engine.model, engine.sampling, config.engine, engine.dtypes,
                                engine.device, engine.pad_id, mesh=mesh)
    return engine, cont


def _follower_main(mesh, config) -> int:
    """A follower rank of ``server.main``: load, meet rank 0 at the barrier,
    then run its commands until ``stop``. SIGTERM is left to rank 0's
    drain, which sends ``stop``."""
    import signal

    configure_logging()
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    # held until the loop ends: the stream names its targets weakly
    engines = build_follower(config, mesh)
    mesh.barrier(LOAD_TIMEOUT_S)
    from rag_llm_k8s_tpu_torch.parallel.commands import serve_commands

    n = serve_commands(mesh)
    logger.info("rank %d: stopped after %d commands", mesh.rank, n)
    del engines
    return n


def mesh_world(config, device=None) -> int:
    """The ranks ``config.mesh`` asks for on this host's cards (``tp=-1``
    takes every visible card; one on the CPU)."""
    import torch

    n = torch.cuda.device_count() if device is None and torch.cuda.is_available() else 1
    return config.mesh.world(max(n, 1))


def start_mesh(config, device=None):
    """Rank 0 of a mesh: start the followers, join the world, and return
    ``(mesh, followers)``. Every rank runs on ``device`` when given (the
    CPU tests), else on its card."""
    from rag_llm_k8s_tpu_torch.parallel.launch import free_port, join_mesh, pick_backend, start_ranks

    world = mesh_world(config, device)
    backend, port = pick_backend(world, device), free_port()
    logger.info("starting a %d-rank mesh %s over %s", world, config.mesh, backend)
    followers = start_ranks(_follower_main, range(1, world), world, port, backend, config.mesh, device=device,
                            args=(config,))
    mesh = join_mesh(0, world, port, backend, config.mesh, device)
    return mesh, followers


def _watch_followers(followers, on_exit) -> None:
    """Call ``on_exit(process)`` once a follower has exited (a thread)."""

    def watch():
        while True:
            for p in followers:
                if p.exitcode is not None:
                    on_exit(p)
                    return
            time.sleep(0.5)

    threading.Thread(target=watch, daemon=True, name="mesh-followers").start()


def arm_faults(env: Optional[dict] = None) -> dict:
    """Arm the fault sites ``TPU_RAG_FAULTS`` lists (``site[:count],...``;
    ``1`` only enables ``/debug/faults``); returns what is armed."""
    from rag_llm_k8s_tpu_torch.resilience import faults

    armed = faults.arm_from_env(env)
    if armed:
        logger.warning("fault injection armed from TPU_RAG_FAULTS: %s", armed)
    return armed


def main(config=None, device=None) -> None:
    """Boot and serve: ``config`` defaults to ``AppConfig.from_env()`` and
    ``device`` to the card (``"cpu"``: every rank on the CPU, as the tests
    run it)."""
    import signal

    from rag_llm_k8s_tpu_torch.core.config import AppConfig
    from rag_llm_k8s_tpu_torch.server.app import make_server

    configure_logging()
    cfg = AppConfig.from_env() if config is None else config
    followers, mesh, stopping = [], None, threading.Event()
    if mesh_world(cfg, device) > 1:
        from rag_llm_k8s_tpu_torch.parallel.launch import stop_ranks

        mesh, followers = start_mesh(cfg, device)

        def _follower_gone(p):
            if stopping.is_set():
                return
            logger.error("mesh follower %s exited with %s: exiting", p.name, p.exitcode)
            stop_ranks(followers)
            os._exit(3)

        _watch_followers(followers, _follower_gone)
    if mesh is not None:
        service = build_service(cfg, mesh=mesh)
        mesh.barrier(LOAD_TIMEOUT_S)  # every follower has loaded its shard
        service.engine.commands.start_heartbeat(HEARTBEAT_S)
        service.peers_ready = lambda: service.engine.commands.ready() and all(p.is_alive() for p in followers)
    else:
        service = build_service() if config is None and device is None else build_service(cfg, device=device)
    service.ingest_directory()
    if service.store.ntotal == 0:
        logger.warning("No PDF files were processed. The index might be empty.")

    def _warm_then_restore():
        # the restore runs after warmup, so the resumed requests run on a
        # built service (and this incarnation appends to its own epoch only)
        try:
            service.warmup()
            logger.info("warmup done: ready")
        except Exception:  # noqa: BLE001 — logged; /healthz stays 503
            logger.exception("warmup failed; the service stays unready")
            return
        try:
            summary = service.restore_from_wal()
            if summary["resumed"] or summary["skipped"] or summary["rehydrated"]:
                logger.info("WAL restore: resumed=%d skipped=%d rehydrated=%d", summary["resumed"],
                            summary["skipped"], summary["rehydrated"])
        except Exception:  # noqa: BLE001 — a failed restore must not kill the boot
            logger.exception("WAL restore failed; serving cold")

    threading.Thread(target=_warm_then_restore, daemon=True, name="warmup").start()
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
        if followers:
            # the followers leave their command loops, then exit
            stopping.set()
            try:
                service.engine.commands.stop()
            except Exception:  # noqa: BLE001 — a broken stream: the followers are stopped below
                logger.exception("mesh stop command failed")
            for p in followers:
                p.join(timeout=30.0)
            stop_ranks(followers)
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
