"""One run of one cell: build the deployment from the cell's configuration,
drive its mix through ``POST /generate`` for the window, then judge what
was served and compute the cell's metrics.

The service is built as ``server/main.py`` builds a one-card deployment
(``AppConfig.from_env`` over the configuration's environment, the one-shot
engine, the coalescing scheduler, ``RagService``, its own ``warmup``), except that the weights, the index and its texts come from the
seed (``weights.py``, ``traffic.py``) instead of files. The window drives
``create_app(service).test_client()``: the WSGI app's ``ep_generate``, the
admission gate, ``RagService.answer``.

The harness puts one wrapper on the engine instance: around
``_device_run``, the device program of every generate call. It records the
call's host interval, its prompt rows (left on the card until the window
closes), its output, the loop steps the engine counted and the seed of its
sampler, and changes nothing of what the call does. A traced run also
records the model's dense-cache attention calls (``attn_calls.Recorder``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark import check, traffic, weights
from benchmark.reference import tokenize as ref_tok

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RUN_DIR = os.path.join(HERE, "_run")
FORBIDDEN = ("jax", "jaxlib", "flax", "rag_llm_k8s_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    Flax's or the JAX package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    config: Dict
    mix: traffic.Mix
    mix_raw: Dict
    entry: Dict
    metrics_e2e: List[str]
    metrics_layer: List[str]
    units: Dict[str, str]
    limits: Dict[str, float]
    samples: tuple


def load_cell(name: str, bench_path: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration and mix
    files, and the metrics it reports (an entry without ``workloads`` is
    reported everywhere)."""
    with open(bench_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "mixes", f"{entry['traffic']}.json")) as f:
        mix_raw = json.load(f)

    def mine(ms):
        return [m["name"] for m in ms if name in m.get("workloads", [name])]

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    limits, samples = check.load_limits(name)
    return Cell(name, config, traffic.Mix.from_dict(mix_raw), mix_raw, entry, mine(bench["end_to_end"]),
                mine(bench["per_layer"]), units, limits, samples)


def app_config(config: Dict, seed: int):
    """The deployment's ``AppConfig`` with the configuration's widths."""
    from rag_llm_k8s_tpu_torch.core.config import AppConfig, EncoderConfig, LlamaConfig

    env = dict(config["deployment"]["env"])
    env["TPU_RAG_FLIGHT_SPOOL"] = os.path.join(RUN_DIR, "incidents")
    app = AppConfig.from_env(env)
    m, e = config["model"], config["encoder"]
    model = LlamaConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"], intermediate_size=m["intermediate_size"],
        num_layers=m["num_hidden_layers"], num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], head_dim=m.get("head_dim") or m["hidden_size"] // m["num_attention_heads"],
        rms_norm_eps=m["rms_norm_eps"], rope_theta=float(m["rope_theta"]), rope_scaling=None,
        max_seq_len=m["max_position_embeddings"], tie_word_embeddings=m["tie_word_embeddings"],
        bos_token_id=m["bos_token_id"], eos_token_ids=(m["eos_token_id"],),
    )
    encoder = EncoderConfig(
        vocab_size=e["vocab_size"], hidden_size=e["hidden_size"], intermediate_size=e["intermediate_size"],
        num_layers=e["num_hidden_layers"], num_heads=e["num_attention_heads"],
        max_position_embeddings=e["max_position_embeddings"], type_vocab_size=e["type_vocab_size"],
        layer_norm_eps=e["layer_norm_eps"], pad_token_id=e["pad_token_id"], position_offset=e["pad_token_id"] + 1,
        embed_dim=e["hidden_size"], max_encode_len=e["max_encode_len"],
    )
    sampling = dataclasses.replace(app.sampling, seed=weights.tensor_seed(seed, "sampling") % (1 << 31))
    retrieval = dataclasses.replace(app.retrieval, embed_dim=e["hidden_size"])
    return dataclasses.replace(app, model=model, encoder=encoder, sampling=sampling, retrieval=retrieval)


class Capture:
    """The wrapper on ``engine._device_run`` (see the module docstring)."""

    def __init__(self, engine):
        self.engine = engine
        self.calls: List[check.Call] = []
        self.on = False
        self.started = 0  # device runs begun (the attention recorder's call number)
        self.inner = engine._device_run  # the tests break the timed path here, under the record

        def device_run(tokens, pad_mask, S, max_new, chunk, spec, gen):
            self.started += 1
            seed = gen.initial_seed()
            t0 = time.perf_counter()
            out, iters = self.inner(tokens, pad_mask, S, max_new, chunk, spec, gen)
            t1 = time.perf_counter()
            if self.on:
                last = engine.loop_counts.last or {}
                self.calls.append(check.Call(t0, t1, tokens, pad_mask, int(S), int(max_new), chunk, bool(spec),
                                             int(seed), out, int(last.get("steps", 0))))
            return out, iters

        engine._device_run = device_run


@dataclass
class Built:
    service: object
    client: object
    engine: object
    app: object
    metas: List[Dict]
    capture: Capture
    recorder: Optional[object] = None


def build(cell: Cell, seed: int, device, record_attention: bool = False) -> Built:
    import torch

    from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
    from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
    from rag_llm_k8s_tpu_torch.index.store import VectorStore
    from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
    from rag_llm_k8s_tpu_torch.models.llama import build_llama
    from rag_llm_k8s_tpu_torch.server.app import RagService, create_app
    from rag_llm_k8s_tpu_torch.tokenizer import load_tokenizer

    app = app_config(cell.config, seed)
    dev = torch.device(device)
    t = time.perf_counter()
    stages = {}
    if not app.engine.fuse_matmuls or app.engine.batching != "coalesce":
        raise SystemExit("the harness builds the coalescing deployment of the fused layout")
    model = build_llama(app.model, app.dtypes, dev, fused=True)
    weights.fill_model_(model, weights.decoder_shapes(cell.config["model"]), weights.tensor_seed(seed, "decoder"))
    enc = build_encoder(app.encoder, app.dtypes, dev)
    weights.fill_model_(enc, weights.encoder_shapes(cell.config["encoder"]), weights.tensor_seed(seed, "encoder"))
    engine = InferenceEngine(app.model, model, app.sampling, app.engine, app.dtypes, dev)
    stages["weights"], t = time.perf_counter() - t, time.perf_counter()
    llm_tok, enc_tok = load_tokenizer(ref_tok.BPE_FILE), load_tokenizer(ref_tok.UNIGRAM_FILE)
    encoder = EncoderRunner(app.encoder, enc, dev, eos_id=getattr(enc_tok, "eos_id", None))
    store = VectorStore(app.retrieval.embed_dim, dev)
    vecs = weights.index_vectors(weights.tensor_seed(seed, "index"), cell.mix.chunks, app.retrieval.embed_dim, dev)
    metas = traffic.chunk_metadata(cell.mix, seed)
    store.add(list(vecs.cpu().numpy()), metas)
    del vecs
    stages["index"], t = time.perf_counter() - t, time.perf_counter()
    # as server/main.py builds the coalescing deployment (the configurations' batching)
    svc = RagService(app, engine, llm_tok, encoder, enc_tok, store, scheduler=BatchScheduler(engine, max_wait_ms=30.0))
    svc.warmup()
    stages["warmup"] = time.perf_counter() - t
    print("setup stages (s): " + " ".join(f"{k}={v:.2f}" for k, v in stages.items()), file=sys.stderr, flush=True)
    if not svc.ready:
        raise RuntimeError("the service did not come up ready from its warmup")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    capture = Capture(engine)
    recorder = None
    if record_attention:
        from benchmark.attn_calls import Recorder

        recorder = Recorder(capture)
    return Built(svc, create_app(svc).test_client(), engine, app, metas, capture, recorder)


@dataclass
class Window:
    t_open: float
    t_stop: float
    t_close: float = 0.0
    t_slice: float = 0.0
    slice_end_ns: int = 0
    records: List[Dict] = field(default_factory=list)


def drive(built: Built, qs: List[List[str]], seconds: float, think_ms: float, on_open=None,
          slice_s: float = 0.0, first_call_s: float = 600.0):
    """Each client sends its questions one after another (a closed loop).
    The clients start together; the window opens when the first generate
    call ends, so that it measures the loaded service and not the start's
    burst (set-up counts up to there), calls ``on_open()``, and runs
    ``seconds``. Returns the window and the client threads once ``slice_s``
    seconds of it have passed (the traced slice: its end is ``t_slice``,
    and ``slice_end_ns`` on the epoch clock); ``wait_close`` waits out the
    rest."""
    from rag_llm_k8s_tpu_torch.ops import _build

    lock = threading.Lock()
    _build.reset_launches()
    built.capture.on = True
    w = Window(0.0, float("inf"))

    def client(c: int) -> None:
        for i, q in enumerate(qs[c]):
            if time.perf_counter() >= w.t_stop:
                return
            ts = time.perf_counter()
            try:
                r = built.client.post("/generate", json_body={"prompt": q})
                status, body = r.status_code, r.get_json()
            except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
                status, body = -1, {"error": repr(e)}
            te = time.perf_counter()
            with lock:
                w.records.append({"client": c, "i": i, "q": q, "send": ts, "recv": te, "status": status,
                                  "body": body})
            if think_ms:
                time.sleep(think_ms / 1e3)

    threads = [threading.Thread(target=client, args=(c,), daemon=True, name=f"client-{c}") for c in range(len(qs))]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    while not built.capture.calls:
        if time.perf_counter() - t_start > first_call_s:
            raise RuntimeError("no generate call ended before the window could open")
        time.sleep(0.002)
    w.t_open = time.perf_counter()
    w.t_stop = w.t_open + seconds
    if on_open is not None:
        on_open()
    time.sleep(max(0.0, w.t_open + slice_s - time.perf_counter()))
    w.t_slice, w.slice_end_ns = time.perf_counter(), time.time_ns()
    return w, threads


def wait_close(w: Window) -> None:
    time.sleep(max(0.0, w.t_stop - time.perf_counter()))
    w.t_close = time.perf_counter()


def close(built: Built, threads, drain_s: float = 240.0) -> None:
    """Stop the service after the window: the scheduler first (a batch in
    flight finishes, queued requests are refused), then wait for the
    clients, then the rest."""
    sched = built.service.scheduler
    if sched is not None:
        sched.shutdown()
    deadline = time.perf_counter() + drain_s
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    built.capture.on = False
    built.service.shutdown()


def free(built: Built) -> None:
    """Move the captured calls to the host and let the program go."""
    import torch

    for c in built.capture.calls:
        c.fetch()
    if built.recorder is not None:
        built.recorder.uninstall()
        built.recorder.fetch()
    built.service = built.client = built.engine = built.capture.engine = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
