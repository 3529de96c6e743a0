"""HTTP serving app: a lean counterpart of ``rag_llm_k8s_tpu/server/app.py``.

Routes (same JSON as the JAX service): ``POST /upload_pdf``, ``POST
/generate`` (alias ``POST /query``), ``GET /index_info``, ``GET /healthz``.
The WSGI plumbing is the standard library's, so the port needs no web
framework: ``WsgiApp.test_client()`` drives it in-process, and
``make_server`` serves it over HTTP on a threading ``wsgiref`` server (one
thread per request, so concurrent requests can coalesce).

Retrieval (query embedding + kNN) goes through a ``Coalescer``, as in the
JAX service (which has one whenever it has an encoder): concurrent queries
form one batch of up to 8, padded to 8 rows, run as one encoder forward and
one ``knn_topk`` call with 8 queries (``_retrieve_many``). The service counts
the requests in flight toward retrieval and toward generation and hands the
counts to the coalescer and the scheduler as ``pending_hint``, so a solo
query does not wait out their windows.

Under a ``BatchScheduler`` (``batching="coalesce"``, the default; built by
``server/main.py``) a solo query takes the single-fetch path (``_fused_ok``,
exactly the JAX rule): the retrieve coalescer returns a singleton batch's
packed ``[1, 2k]`` top-k unfetched, and the prompt is assembled on the
device from it and the store's chunk-token sidecar
(``InferenceEngine.generate_rag``). A burst, a long question whose tail
overflows the fused tail bucket, or a store past ``rag_fused_max_vectors``
takes the host path: the hits are fetched, the prompt is assembled on the
host (piecewise, or budgeted) and submitted to the scheduler, which batches
concurrent prompts into one ``engine.generate``.

With a ``ContinuousScheduler`` (``batching="continuous"``, built by
``build_scheduler`` over the one-shot engine's model, one copy of the
weights) every query takes the host path and its prompt joins the running
batch; a prompt longer than the scheduler's largest bucket goes to the
one-shot engine's chunked prefill. Without a scheduler every query takes
the host path through the one-shot engine.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import socketserver
import threading
import time
from typing import Dict, List, Optional
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server as _wsgiref_make_server

import numpy as np
import torch

from rag_llm_k8s_tpu_torch.core.config import AppConfig, EngineConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler, Coalescer
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.index.store import SearchResult, VectorStore
from rag_llm_k8s_tpu_torch.ops.knn import knn_topk
from rag_llm_k8s_tpu_torch.rag.chunking import split_text
from rag_llm_k8s_tpu_torch.rag.pdf import extract_text
from rag_llm_k8s_tpu_torch.rag.prompt import assemble_context, assemble_prompt, extract_answer
from rag_llm_k8s_tpu_torch.utils.tokens import truncate_keep_eos

logger = logging.getLogger(__name__)

NO_RESULTS = "No relevant information found in the index."


def make_segment_source(llm_tokenizer, max_bucket: int):
    """The chunk → prompt-segment token source handed to the store's
    sidecar: a closure over the tokenizer only (never a bound method, so the
    store does not keep a service alive). ``cache_key`` lets the store keep
    its rows across re-attaches with the same tokenizer."""

    def segment_ids(metadata: Dict) -> List[int]:
        seg = (
            f"Document '{metadata.get('filename')}' "
            f"(chunk {metadata.get('chunk_id')}): {metadata.get('text')}\n\n"
        )
        return llm_tokenizer.encode(seg)[:max_bucket]

    segment_ids.cache_key = ("segment_ids_v1", id(llm_tokenizer), max_bucket)
    return segment_ids


def build_scheduler(
    engine: InferenceEngine, engine_config: Optional[EngineConfig] = None
) -> Optional[ContinuousScheduler]:
    """The continuous scheduler ``engine_config`` (default: the engine's own)
    asks for: a ``ContinuousScheduler`` over a ``ContinuousEngine`` that
    SHARES the one-shot engine's model (one copy of the weights) when
    ``batching == "continuous"``, else None (``server/main.py`` builds the
    ``BatchScheduler`` of ``batching="coalesce"``)."""
    ec = engine_config or engine.engine_config
    if ec.batching != "continuous":
        return None
    cont = ContinuousEngine(
        engine.config, engine.model, engine.sampling, ec, engine.dtypes, engine.device, engine.pad_id
    )
    return ContinuousScheduler(cont)


def engine_mode(scheduler) -> str:
    """The serving mode ``/healthz`` reports (the JAX service's names)."""
    if scheduler is None:
        return "one-shot"
    if isinstance(scheduler, ContinuousScheduler):
        return "continuous-interleaved" if scheduler.engine.interleave_on else "continuous"
    if isinstance(scheduler, BatchScheduler):
        return "coalesce"
    return type(scheduler).__name__


class RagService:
    """The retrieve-then-generate pipeline behind the routes. ``scheduler``
    is a ``BatchScheduler``, a ``ContinuousScheduler`` or None."""

    def __init__(
        self,
        config: AppConfig,
        engine: InferenceEngine,
        llm_tokenizer,
        encoder: EncoderRunner,
        encoder_tokenizer,
        store: VectorStore,
        scheduler=None,
    ):
        self.config = config
        self.engine = engine
        self.scheduler = scheduler
        self.llm_tokenizer = llm_tokenizer
        self.encoder = encoder
        self.encoder_tokenizer = encoder_tokenizer
        self.store = store
        self.ready = False
        if encoder.eos_id is None:
            encoder.eos_id = getattr(encoder_tokenizer, "eos_id", None)
        self._a_ids_cache: Optional[List[int]] = None
        self._segment_source = make_segment_source(
            llm_tokenizer, max(engine.engine_config.prompt_buckets)
        )
        if engine.engine_config.rag_fused:
            store.attach_token_source(self._segment_source)
        # requests in flight toward each batching stage, fed to the
        # coalescer and the scheduler as pending_hint: a stage stops waiting
        # out its window once every request in flight toward it has joined
        self._inflight_lock = threading.Lock()
        self._inflight_retrieve = 0
        self._inflight_generate = 0
        # query batches > 1 pad to this many rows: one more shape, not a ladder
        self._retrieve_cap = 8
        # 25 ms: a cold burst's requests arrive within ms of each other; a
        # solo query leaves after the hint's grace, not the window
        self.retrieve_coalescer = Coalescer(
            lambda items: self._retrieve_many(items, allow_device=True),
            max_batch=self._retrieve_cap, max_wait_ms=25.0,
            pending_hint=lambda: self._inflight_retrieve,
        )
        if scheduler is not None and getattr(scheduler, "pending_hint", False) is None:
            scheduler.pending_hint = lambda: self._inflight_generate

    # -- ingest ---------------------------------------------------------
    def embed_texts(self, texts: List[str]) -> np.ndarray:
        limit = self.config.encoder.max_encode_len
        eos = getattr(self.encoder_tokenizer, "eos_id", None)
        return self.encoder.encode(
            [truncate_keep_eos(self.encoder_tokenizer.encode(t), limit, eos) for t in texts]
        )

    def ingest_pdf_bytes(self, data: bytes, filename: str) -> int:
        """Extract → chunk → batch-embed → index (and save the snapshot when
        the store has a path). Returns the chunk count."""
        text = extract_text(data)
        r = self.config.retrieval
        chunks = split_text(text, r.chunk_size, r.chunk_overlap)
        if not chunks:
            return 0
        vectors = self.embed_texts(chunks)
        metadata = [{"filename": filename, "chunk_id": i, "text": c} for i, c in enumerate(chunks)]
        added = self.store.add(list(vectors), metadata)
        if added and self.store.path:
            self.store.save()
        logger.info("ingested %s: %d chunks (%d new)", filename, len(chunks), added)
        return len(chunks)

    def ingest_directory(self, pdf_dir: Optional[str] = None) -> int:
        """Boot-time ingest of every ``*.pdf`` in ``pdf_dir`` (default: the
        config's), idempotent through the store's content-hash dedup; one
        bad PDF is logged and skipped. Returns the number of PDF files."""
        pdf_dir = pdf_dir or self.config.server.pdf_dir
        if not os.path.isdir(pdf_dir):
            logger.warning("No PDF directory at %s", pdf_dir)
            return 0
        files = [f for f in sorted(os.listdir(pdf_dir)) if f.endswith(".pdf")]
        for fname in files:
            try:
                with open(os.path.join(pdf_dir, fname), "rb") as f:
                    self.ingest_pdf_bytes(f.read(), fname)
            except Exception:  # noqa: BLE001 — one bad PDF must not stop the boot
                logger.exception("failed to ingest %s; skipping", fname)
        if not files:
            logger.warning("No PDF files found in %s", pdf_dir)
        return len(files)

    # -- prompt pieces --------------------------------------------------
    def _a_ids(self) -> List[int]:
        """BOS + "{system}\\n\\nContext: " — the fixed prompt head."""
        if self._a_ids_cache is None:
            ids = self.llm_tokenizer.encode(f"{self.config.system_message}\n\nContext: ")
            bos = self.config.model.bos_token_id
            if not ids or ids[0] != bos:
                ids = [bos] + ids
            self._a_ids_cache = ids
        return self._a_ids_cache

    def _b_ids(self, user_prompt: str) -> List[int]:
        """"\\n\\nUser: {q}\\n\\nChatbot:" — the per-query prompt tail."""
        return self.llm_tokenizer.encode(f"\n\nUser: {user_prompt}\n\nChatbot:")

    def _fused_ok(self) -> bool:
        """Single-fetch path applicability: the JAX rule (no prefix cache
        here), so only under a ``BatchScheduler``."""
        ec = self.engine.engine_config
        return (
            ec.rag_fused
            and isinstance(self.scheduler, BatchScheduler)
            and 0 < self.store.ntotal <= ec.rag_fused_max_vectors
        )

    def _scheduler_prompt_cap(self) -> int:
        """Longest prompt the scheduler takes without truncating: the
        continuous engine's largest bucket; the coalescing scheduler hands
        prompts to the chunk-capable one-shot engine, so it has no cap."""
        if isinstance(self.scheduler, ContinuousScheduler):
            return max(self.scheduler.engine.buckets)
        return 1 << 62

    def warmup(self) -> None:
        """Build what the first request would otherwise build, then mark the
        service ready: on the card the CUDA kernels (``ops._build``), the
        C++ libraries (the tokenizer's merge loop is built when it loads; the
        index codec here), then one request-shaped pass: an embedding, a
        retrieve alone and a padded burst of them, the chunk-token sidecar,
        and a short generate of a head + tail prompt."""
        if self.engine.device.type == "cuda":
            from rag_llm_k8s_tpu_torch.ops import _build

            _build.build()
        if self.store.path:
            from rag_llm_k8s_tpu_torch.native.build import load_library

            load_library("indexio")
        self.embed_texts(["warmup"])
        self._retrieve("warmup")
        if self.store.ntotal:
            self._retrieve_many(["warmup"] * self._retrieve_cap)
            if self.engine.engine_config.rag_fused:
                self.store.token_snapshot()
        self.engine.generate([self._a_ids() + self._b_ids("warmup")], max_new_tokens=2)
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        self.ready = True

    def shutdown(self) -> None:
        self.retrieve_coalescer.shutdown()
        if self.scheduler is not None:
            self.scheduler.shutdown()

    @staticmethod
    def _kept_chunks(seg_lens, avail: int):
        """THE context-budget rule, identical to the device assembly: keep the
        longest chunk prefix that fits; token-truncate the first chunk if it
        alone overflows. Returns ``(n_kept, used_tokens, trunc_or_None)``."""
        used = n_kept = 0
        trunc = None
        for j, L in enumerate(seg_lens):
            if used + L <= avail:
                used += L
                n_kept += 1
            else:
                if j == 0:
                    trunc = max(avail, 0)
                    used = trunc
                    n_kept = 1
                break
        return n_kept, used, trunc

    def _piecewise_prompt(self, user_prompt: str, results):
        """Host mirror of the device assembly: head ‖ kept chunk segments ‖
        tail under the same budget rule. None when head + tail leave fewer
        than 16 tokens of context room."""
        a_ids = self._a_ids()
        b_ids = self._b_ids(user_prompt)
        avail = max(self.engine.engine_config.prompt_buckets) - len(a_ids) - len(b_ids)
        if avail < 16:
            return None
        segs = []
        for r in results[: self.config.retrieval.context_top_n]:
            cached = self.store.cached_token_row(r.row)
            segs.append(list(cached) if cached is not None else self._segment_source(r.metadata))
        n_kept, _, trunc = self._kept_chunks([len(s) for s in segs], avail)
        kept = segs[:n_kept]
        if trunc is not None:
            kept[0] = kept[0][:trunc]
        ids = list(a_ids)
        for s in kept:
            ids.extend(s)
        ids.extend(b_ids)
        return assemble_context(results, n_kept), ids

    def _budgeted_prompt(self, user_prompt: str, results):
        """Whole-string prompt, shrinking the context (drop trailing chunks,
        then trim the last chunk's words) until it fits the largest bucket;
        an irreducible question goes through whole, to chunked prefill."""
        budget = max(self.engine.engine_config.prompt_buckets)
        bos = self.config.model.bos_token_id
        used = [
            SearchResult(metadata=dict(r.metadata), distance=r.distance)
            for r in results[: self.config.retrieval.context_top_n]
        ]
        while True:
            context = assemble_context(used, len(used))
            ids = self.llm_tokenizer.encode(
                assemble_prompt(user_prompt, context, self.config.system_message)
            )
            if not ids or ids[0] != bos:
                ids = [bos] + ids
            if len(ids) <= budget:
                return context, ids
            if len(used) > 1:
                used.pop()
                continue
            words = used[0].metadata.get("text", "").split()
            target = min(len(words) - 1, int(len(words) * budget / len(ids) * 0.9))
            if target < 10:
                return context, ids
            used[0].metadata["text"] = " ".join(words[:target])

    # -- retrieve -------------------------------------------------------
    def _retrieve(self, text: str, allow_device: bool = False):
        """One query through :meth:`_retrieve_many`."""
        return self._retrieve_many([text], allow_device)[0]

    def _retrieve_many(self, texts: List[str], allow_device: bool = False):
        """Embed the queries and rank them against the index on the device:
        one encoder forward and one ``knn_topk`` call per length bucket (in
        practice one). A batch of more than one pads to ``_retrieve_cap``
        rows (the padding rows repeat the first query), so bursts add one
        shape, not a ladder. Returns ``[(results, tokenize_ms)]`` in input
        order.

        With ``allow_device``, a singleton batch on the single-fetch path
        returns the packed ``[1, 2k]`` device tensor unfetched:
        ``[("__device__", packed, k_eff, tokenize_ms)]``."""
        n = self.store.ntotal
        if n == 0:
            return [([], 0.0)] * len(texts)
        # never more neighbours than real rows: the kernel's fill entries
        # past ntotal are never asked for
        k_eff = min(self.config.retrieval.k, n)
        emb, norms = self.store.device_snapshot()
        prepped = []
        for text in texts:
            t0 = time.monotonic()
            tokens, mask = self.encoder.prepare_batch(self.encoder_tokenizer.encode(text))
            prepped.append((tokens, mask, (time.monotonic() - t0) * 1e3))

        def rank(tokens: np.ndarray, mask: np.ndarray) -> torch.Tensor:
            with torch.inference_mode():
                vec = self.encoder.embed(tokens, mask)
                d, i = knn_topk(vec.float().contiguous(), emb, norms, k=k_eff)
                # one [B, 2k] tensor: fp32 carries row ids exactly up to 2^24
                return torch.cat([d, i.float()], dim=1)

        if allow_device and len(texts) == 1 and self._fused_ok():
            tokens, mask, tok_ms = prepped[0]
            return [("__device__", rank(tokens, mask), k_eff, tok_ms)]

        out: List = [None] * len(texts)
        by_bucket: Dict[int, List[int]] = {}
        for i, (tokens, _, _) in enumerate(prepped):
            by_bucket.setdefault(tokens.shape[1], []).append(i)
        for S, idxs in by_bucket.items():
            for start in range(0, len(idxs), self._retrieve_cap):
                group = idxs[start : start + self._retrieve_cap]
                B_pad = 1 if len(group) == 1 else self._retrieve_cap
                rows = group + [group[0]] * (B_pad - len(group))
                tokens = np.concatenate([prepped[i][0] for i in rows])
                mask = np.concatenate([prepped[i][1] for i in rows])
                packed = rank(tokens, mask).cpu().numpy()  # one fetch
                dists, idx = packed[:, :k_eff], packed[:, k_eff:].astype(np.int64)
                for row, i in enumerate(group):
                    out[i] = (self.store.results_at(idx[row], dists[row]), prepped[i][2])
        return out

    # -- answer ---------------------------------------------------------
    def _release(self, retrieve: bool = False, generate: bool = False) -> None:
        with self._inflight_lock:
            self._inflight_retrieve -= int(retrieve)
            self._inflight_generate -= int(generate)

    def answer(self, user_prompt: str, sampling: Optional[SamplingConfig] = None) -> Dict:
        """Retrieve, assemble, generate. ``sampling`` overrides the engine's
        settings for this request; only the continuous scheduler takes it."""
        if sampling is not None and not isinstance(self.scheduler, ContinuousScheduler):
            raise ValueError("per-request sampling needs batching='continuous'")
        timings: Dict[str, float] = {}
        t_all = time.monotonic()
        with self._inflight_lock:
            self._inflight_retrieve += 1
            self._inflight_generate += 1
        in_retrieve = in_generate = True
        try:
            r = self.retrieve_coalescer.submit(user_prompt)
            self._release(retrieve=True)
            in_retrieve = False
            if r[0] == "__device__":
                timings["tokenize_ms"] = r[3]
                timings["embed_retrieve_ms"] = (time.monotonic() - t_all) * 1e3 - r[3]
                # a fused request never reaches the scheduler: release its
                # generate claim now, or the scheduler's hint would wait for it
                self._release(generate=True)
                in_generate = False
                resp = self._answer_fused(user_prompt, r, timings, t_all)
                if resp is not None:
                    return resp
                with self._inflight_lock:
                    self._inflight_generate += 1
                in_generate = True
                # head + tail did not fit the bucket: fetch the hits, host path
                k_eff = r[2]
                packed = r[1].cpu().numpy()
                results = self.store.results_at(packed[0, k_eff:].astype(np.int64), packed[0, :k_eff])
            else:
                results, tok_ms = r
                timings["tokenize_ms"] = tok_ms
                timings["embed_retrieve_ms"] = (time.monotonic() - t_all) * 1e3 - tok_ms
            if not results:
                return {"generated_text": NO_RESULTS}
            pw = self._piecewise_prompt(user_prompt, results) if self.engine.engine_config.rag_fused else None
            context, prompt_ids = pw if pw is not None else self._budgeted_prompt(user_prompt, results)
            t0 = time.monotonic()
            if self.scheduler is not None and len(prompt_ids) <= self._scheduler_prompt_cap():
                if isinstance(self.scheduler, ContinuousScheduler):
                    out_ids = self.scheduler.submit(prompt_ids, sampling=sampling)
                else:
                    out_ids = self.scheduler.submit(prompt_ids)
            else:
                # no scheduler, or past the continuous scheduler's largest
                # bucket: the one-shot engine (chunked prefill) serves it whole
                self._release(generate=True)
                in_generate = False
                out_ids = self.engine.generate([prompt_ids])[0]
            if in_generate:
                self._release(generate=True)
                in_generate = False
            completion = self.llm_tokenizer.decode(out_ids)
            timings["generate_ms"] = (time.monotonic() - t0) * 1e3
            timings["total_ms"] = (time.monotonic() - t_all) * 1e3
        finally:
            # error paths and the no-results return release their claims too
            self._release(retrieve=in_retrieve, generate=in_generate)
        return {
            "generated_text": extract_answer(completion),
            "context": context,
            "timings": {k: round(v, 2) for k, v in timings.items()},
        }

    def _answer_fused(self, user_prompt: str, fused_r, timings, t_all):
        """Device-side prompt assembly + generate from the unfetched
        retrieve output. None when head + tail leave fewer than 16 tokens of
        room or the tail overflows the fused bucket (the host path serves)."""
        _, packed_dev, k_eff, tokenize_ms = fused_r
        t_b = time.monotonic()
        a_ids, b_ids = self._a_ids(), self._b_ids(user_prompt)
        S = max(self.engine.engine_config.prompt_buckets)
        if len(a_ids) + len(b_ids) + 16 > S or len(b_ids) > self.engine.RAG_TAIL_BUCKET:
            return None
        snap = self.store.token_snapshot(blocking=False)
        if snap is None:
            return None
        toks_dev, lens_dev = snap
        timings["tokenize_ms"] = tokenize_ms + (time.monotonic() - t_b) * 1e3
        n_ctx = min(self.config.retrieval.context_top_n, k_eff)
        t0 = time.monotonic()
        out_ids = self.engine.generate_rag(a_ids, b_ids, packed_dev, toks_dev, lens_dev, n_chunks=n_ctx)
        completion = self.llm_tokenizer.decode(out_ids)
        timings["generate_ms"] = (time.monotonic() - t0) * 1e3
        # the ids for the response's context text: generation has synced
        # the stream many times already, so this read adds no wait
        packed = packed_dev.cpu().numpy()
        results = self.store.results_at(packed[0, k_eff:].astype(np.int64), packed[0, :k_eff])
        n_kept, _, _ = self._kept_chunks(
            self.store.token_lengths(packed[0, k_eff : k_eff + n_ctx].astype(np.int64)),
            S - len(a_ids) - len(b_ids),
        )
        timings["total_ms"] = (time.monotonic() - t_all) * 1e3
        return {
            "generated_text": extract_answer(completion),
            "context": assemble_context(results, n_kept),
            "timings": {k: round(v, 2) for k, v in timings.items()},
        }


# ---------------------------------------------------------------------------
# WSGI
# ---------------------------------------------------------------------------

_REASONS = {200: "OK", 400: "BAD REQUEST", 404: "NOT FOUND", 405: "METHOD NOT ALLOWED",
            500: "INTERNAL SERVER ERROR", 503: "SERVICE UNAVAILABLE"}


def _parse_multipart(body: bytes, content_type: str) -> Dict[str, tuple]:
    """``multipart/form-data`` → ``{field: (filename or None, bytes)}``."""
    boundary = None
    for param in content_type.split(";")[1:]:
        key, _, val = param.strip().partition("=")
        if key.lower() == "boundary":
            boundary = val.strip('"')
    if not boundary:
        return {}
    fields: Dict[str, tuple] = {}
    for part in body.split(b"--" + boundary.encode())[1:]:
        if part.startswith(b"--"):
            break
        head, _, data = part.partition(b"\r\n\r\n")
        if data.endswith(b"\r\n"):
            data = data[:-2]
        name = filename = None
        for line in head.decode("utf-8", "replace").split("\r\n"):
            if line.lower().startswith("content-disposition:"):
                for item in line.split(";")[1:]:
                    key, _, val = item.strip().partition("=")
                    if key == "name":
                        name = val.strip('"')
                    elif key == "filename":
                        filename = val.strip('"')
        if name is not None:
            fields[name] = (filename, data)
    return fields


class Response:
    def __init__(self, status: int, body: bytes):
        self.status_code = status
        self.data = body

    def get_json(self):
        return json.loads(self.data)


class TestClient:
    """In-process client: builds a WSGI environ, calls the app."""

    __test__ = False  # not a pytest test class

    def __init__(self, app):
        self.app = app

    def open(self, method: str, path: str, body: bytes = b"", content_type: str = "") -> Response:
        environ = {
            "REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": "",
            "CONTENT_TYPE": content_type, "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body), "SERVER_NAME": "localhost",
            "SERVER_PORT": "80", "wsgi.url_scheme": "http",
        }
        status = []
        chunks = self.app(environ, lambda s, headers: status.append(s))
        return Response(int(status[0].split()[0]), b"".join(chunks))

    def get(self, path: str) -> Response:
        return self.open("GET", path)

    def post(self, path: str, json_body=None, files: Optional[Dict[str, tuple]] = None) -> Response:
        """``json_body`` as a JSON request, or ``files={"file": (name, bytes)}``
        as ``multipart/form-data``."""
        if files is None:
            return self.open("POST", path, json.dumps(json_body or {}).encode(), "application/json")
        boundary = "----port-test-boundary"
        parts = []
        for field, (fname, data) in files.items():
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; name="{field}"; '
                f'filename="{fname}"\r\nContent-Type: application/octet-stream\r\n\r\n'.encode()
                + data + b"\r\n"
            )
        body = b"".join(parts) + f"--{boundary}--\r\n".encode()
        return self.open("POST", path, body, f"multipart/form-data; boundary={boundary}")


class WsgiApp:
    ROUTES = {
        "/upload_pdf": ("POST", "upload_pdf"),
        "/generate": ("POST", "generate"),
        "/query": ("POST", "generate"),
        "/index_info": ("GET", "index_info"),
        "/healthz": ("GET", "healthz"),
    }

    def __init__(self, service: RagService):
        self.service = service

    def __call__(self, environ, start_response):
        path, method = environ.get("PATH_INFO", "/"), environ.get("REQUEST_METHOD", "GET")
        route = self.ROUTES.get(path)
        if route is None:
            status, payload = 404, {"error": "not found"}
        elif route[0] != method:
            status, payload = 405, {"error": "method not allowed"}
        else:
            length = int(environ.get("CONTENT_LENGTH") or 0)
            body = environ["wsgi.input"].read(length) if length else b""
            status, payload = getattr(self, f"ep_{route[1]}")(body, environ.get("CONTENT_TYPE", ""))
        data = json.dumps(payload).encode()
        start_response(
            f"{status} {_REASONS.get(status, '')}",
            [("Content-Type", "application/json"), ("Content-Length", str(len(data)))],
        )
        return [data]

    def ep_upload_pdf(self, body: bytes, content_type: str):
        files = _parse_multipart(body, content_type) if content_type.startswith("multipart/") else {}
        if "file" not in files:
            return 400, {"error": "No file part"}
        filename, data = files["file"]
        if not filename:
            return 400, {"error": "No selected file"}
        if not filename.endswith(".pdf"):
            return 400, {"error": "Invalid file format"}
        try:
            n = self.service.ingest_pdf_bytes(data, filename)
        except Exception as e:  # noqa: BLE001 — any failure → JSON error
            logger.exception("upload_pdf failed")
            return 500, {"error": str(e)}
        return 200, {"message": f"PDF processed and indexed successfully. {n} chunks created."}

    def ep_generate(self, body: bytes, content_type: str):
        try:
            data = json.loads(body or b"{}")
        except ValueError:
            data = {}
        if not isinstance(data, dict):
            data = {}
        prompt = data.get("prompt", "")
        sampling = None
        if "sampling" in data:
            # optional per-request override, e.g. {"do_sample": false}
            raw = data["sampling"]
            types = {"do_sample": (bool,), "temperature": (int, float), "top_p": (int, float)}
            if not isinstance(raw, dict) or not all(
                k in types and isinstance(v, types[k]) and (k == "do_sample" or not isinstance(v, bool))
                for k, v in raw.items()
            ):
                return 400, {"error": "sampling must be an object of do_sample (bool), "
                                      "temperature and top_p (numbers)"}
            if not isinstance(self.service.scheduler, ContinuousScheduler):
                return 400, {"error": "per-request sampling needs batching='continuous'"}
            sampling = dataclasses.replace(self.service.config.sampling, **raw)
        try:
            return 200, self.service.answer(prompt, sampling)
        except Exception as e:  # noqa: BLE001 — any failure → JSON error
            logger.exception("generate failed")
            return 500, {"error": str(e)}

    def ep_index_info(self, body: bytes, content_type: str):
        return 200, self.service.store.info()

    def ep_healthz(self, body: bytes, content_type: str):
        svc = self.service
        dev = svc.engine.device
        payload = {
            "status": "ok" if svc.ready else "warming",
            "engine_mode": engine_mode(svc.scheduler),
            "device_platform": dev.type,
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        }
        return (200 if svc.ready else 503), payload

    def test_client(self) -> TestClient:
        return TestClient(self)


def create_app(service: RagService) -> WsgiApp:
    return WsgiApp(service)


class ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
    """``wsgiref``'s server with one thread per request (it serves one at a
    time otherwise, and then nothing ever coalesces)."""

    daemon_threads = True


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 — the base class's name
        logger.debug("%s - %s", self.address_string(), format % args)


def make_server(service: RagService, host: str, port: int) -> ThreadingWSGIServer:
    """An HTTP server for ``service`` on ``host:port`` (port 0: any free
    port, read it from ``server.server_port``); run ``serve_forever()``."""
    return _wsgiref_make_server(host, port, create_app(service), server_class=ThreadingWSGIServer,
                                handler_class=_QuietHandler)

