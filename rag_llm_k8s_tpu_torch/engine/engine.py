"""The one-shot inference engine, counterpart of
``rag_llm_k8s_tpu/engine/engine.py``'s ``InferenceEngine``.

- Prompts pad LEFT to the next bucket (``EngineConfig.prompt_buckets``), so
  every row writes the cache at the same index; prompts past the largest
  bucket prefill through the cache in bucket-sized chunks.
- Decode is the vanilla KV-cached loop, or for a batch-1 single-shot prompt
  the prompt-lookup speculative loop: each iteration feeds the pending
  token plus the ``k`` tokens that followed the latest earlier occurrence of
  the trailing n-gram through ONE chunk-mode forward, then keeps the
  longest accepted prefix plus one correction (greedy: token-identical to
  the vanilla loop; sampled: rejection sampling, distribution-identical).
  Under ``speculative="auto"`` an EMA of tokens per verify turns it off
  while it does not pay, re-probing periodically.
- ``generate_rag`` assembles the RAG prompt on the device from the fused
  retrieve's packed top-k and the store's chunk-token sidecar.
- With ``EngineConfig.prefix_cache.enabled`` the engine owns a
  ``PrefixCache`` (``engine/prefix_cache.py``) and gives it the segment
  builder (``build_segment_kv``), the splice (``splice_prefix``), the RoPE
  re-rotation (``rerotate_segment_kv``) and ``generate_prefixed``, which
  splices a cached prefix into a fresh left-aligned batch-1 cache and
  prefills only the right-padded per-query suffix at the prefix frontier,
  then decodes with the vanilla loop (never speculative, as in JAX).

``EngineConfig.weight_quant="int8"`` serves a ``quantize_llama`` copy of the
model (an already-quantized model passes through) and ``kv_quant="int8"``
an int8 cache, whose decode and chunk forwards run the q8 kernels.

Cache lengths follow the JAX engine exactly: ``T = ceil((S + max_new) / 128)
* 128`` on the vanilla path, with ``k`` more slots of slack on the
  speculative path so the last verify's ``k + 1`` writes stay inside.

The JAX engine runs each generate as one compiled program with an on-device
while loop. Here PyTorch runs eagerly and the host drives the loop: each
decode step or verify reads one small value back (the all-done flag, or the
``k + 1`` verify tokens), one host sync per iteration. The speculative loop
also keeps its token history on the host, so it fetches the assembled
prompt once. CUDA graphs are the tool to remove these syncs later. Each
decode step and each verify runs inside a ``record_function`` range
(``decode_forward``, ``verify_forward``), so a ``torch.profiler`` trace
shows one forward's host issue time and the kernels it launched.

Metrics (``bind_metrics``, as the JAX engine's): ``rag_generate_duration_seconds``
per call, ``rag_decode_inter_token_seconds{mode="oneshot_est"}`` (call
duration over decode steps, prefill included: an estimate, as in JAX), and
the compile counters, which here read the process's kernel-library builds
and loads (``ops._build.COMPILES``).

``score_exact`` is the shadow auditor's exact path (``obs/shadow.py``):
one teacher-forced chunked forward over a delivered request's prompt and
stream through ``chunk_prefill_attention`` (``_q8`` under int8 KV), each
chunk's logits reduced on the device to argmax, max and the delivered
token's logit.

The goodput ledger (``self.ledger``, ``obs/goodput.py``): each ``generate``,
``generate_rag`` and ``generate_prefixed`` call is one ``oneshot`` window
whose duration is the host clock around the call, ending in its own final
fetch; the roofline splits it into prefill and decode shares. Each call
journals a ``goodput_window`` event, and an ``info`` out-param receives the
request's share (``chip_ms``, ``goodput_frac``, ``cost_usd`` when priced).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from rag_llm_k8s_tpu_torch.core.config import (
    DTypePolicy,
    EngineConfig,
    LlamaConfig,
    SamplingConfig,
)
from rag_llm_k8s_tpu_torch.core.device import DeviceLike, resolve_device
from rag_llm_k8s_tpu_torch.obs import flight, goodput, metrics
from rag_llm_k8s_tpu_torch.ops import _build
from rag_llm_k8s_tpu_torch.resilience import faults
from rag_llm_k8s_tpu_torch.engine.sampling import (
    NEG_INF,
    categorical,
    prepared_logits,
    sample_token,
)
from rag_llm_k8s_tpu_torch.models.llama import (
    LlamaModel,
    fuse_projections_,
    make_kv_cache,
    mask_window,
    quantize_llama,
    rerotate_prefix_planes,
)
from rag_llm_k8s_tpu_torch.utils.buckets import bucket_len, next_pow2

logger = logging.getLogger(__name__)


@dataclass
class EngineStats:
    # prompt tokens prefilled (batch padding rows count their one BOS, as
    # in JAX; a fused request counts head + tail here and its chunks when
    # the service knows them, ``record_prefill``)
    prefill_tokens: int = 0
    decode_tokens: int = 0
    generate_calls: int = 0
    # speculative verify forwards and the tokens they emitted
    spec_verify_steps: int = 0
    spec_emitted_tokens: int = 0
    # prompt tokens whose prefill was skipped because their KV was spliced
    # from the prefix cache (prefill_tokens counts only computed tokens)
    prefill_tokens_skipped: int = 0


def bind_compile_metrics(registry) -> None:
    """The compile counters of the JAX engines, read from the process's
    kernel-library builds and loads (both engines register the same two)."""
    registry.counter("rag_compile_events_total", "AOT lowering/compile events",
                     fn=lambda: _build.COMPILES["events"])
    registry.counter("rag_compile_seconds_total", "seconds spent in AOT lowering/compile",
                     fn=lambda: _build.COMPILES["seconds"])


def serving_model(model: LlamaModel, engine_config: EngineConfig) -> LlamaModel:
    """The model an engine serves under ``engine_config`` (JAX
    ``maybe_fuse_params`` then ``maybe_quantize_params``): projections fused
    in place when ``fuse_matmuls``, then an int8 copy when ``weight_quant ==
    "int8"`` (a quantized model passes through; the caller's bf16 model is
    left as it is)."""
    engine_config.validate_quant()
    if engine_config.fuse_matmuls:
        fuse_projections_(model)
    return quantize_llama(model) if engine_config.weight_quant == "int8" else model


def stamp_spec(info: Optional[Dict], ran: bool) -> None:
    """The approximation fingerprint (``obs/shadow.py``): when speculation
    served the request, ``info["approx"]`` names ``spec_verify``, so its
    audit is attributed to it."""
    if info is not None and ran:
        ap = info.setdefault("approx", [])
        if "spec_verify" not in ap:
            ap.append("spec_verify")


def _cache_len(n: int) -> int:
    return -(-n // 128) * 128


def assemble_rag_tokens(
    a_ids: torch.Tensor,  # [LA] head
    b_pad: torch.Tensor,  # [LB] tail, padded
    b_len: int,
    packed: torch.Tensor,  # [1, 2kk] fp32: dists ‖ ids
    store_toks: torch.Tensor,  # [cap, Lc]
    store_lens: torch.Tensor,  # [cap]
    S: int,
    n: int,
    pad_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side RAG prompt: head ‖ the longest prefix of the top-``n``
    chunk segments that fits ``S - LA - b_len`` (chunk 0 token-truncated if
    it alone overflows) ‖ tail, packed against the right edge. Returns
    ``(tokens [1, S], pad_mask [1, S])``; nothing is read back to the host."""
    dev = store_toks.device
    i64 = torch.int64
    cap, Lc = store_toks.shape
    LA, LB = a_ids.shape[0], b_pad.shape[0]
    kk = packed.shape[1] // 2
    idx = packed[0, kk : kk + n].to(i64)
    safe = idx.clamp(0, cap - 1)
    rows = store_toks[safe].to(i64)  # [n, Lc]
    lens = store_lens[safe].to(i64)  # [n]
    avail = max(S - LA - b_len, 0)
    keep = torch.cumsum(lens, 0) <= avail
    eff = torch.where(keep, lens, torch.zeros_like(lens))
    # never drop ALL context: chunk 0 truncates to the budget instead
    eff0 = torch.where(keep[0], lens[0], lens[0].clamp(max=avail))
    eff = torch.cat([eff0[None], eff[1:]])
    start = S - (LA + eff.sum() + b_len)
    # one slack slot at S + Lc - 1 absorbs every masked-out lane
    junk = S + Lc - 1
    buf = torch.full((S + Lc,), pad_id, dtype=i64, device=dev)
    buf[start + torch.arange(LA, device=dev)] = a_ids.to(i64)
    off = start + LA + torch.cat([torch.zeros(1, dtype=i64, device=dev), torch.cumsum(eff, 0)[:-1]])
    lane = torch.arange(Lc, device=dev)
    for i in range(n):
        valid = lane < eff[i]
        tgt = torch.where(valid, off[i] + lane, torch.full_like(lane, junk))
        buf[tgt] = torch.where(valid, rows[i], buf[tgt])
    laneb = torch.arange(LB, device=dev)
    validb = laneb < b_len
    tgtb = torch.where(validb, S - b_len + laneb, torch.full_like(laneb, junk))
    buf[tgtb] = torch.where(validb, b_pad.to(i64), buf[tgtb])
    tokens = buf[:S][None, :]
    pad_mask = (torch.arange(S, device=dev) >= start).to(i64)[None, :]
    return tokens, pad_mask


class InferenceEngine:
    """Owns the model; ``generate`` and ``generate_rag`` are thread-safe
    (calls serialize on one lock: one program runs on the card at a time)."""

    _SPEC_EMA_DECAY = 0.7
    _SPEC_REPROBE = 32
    # single-fetch RAG prompt-tail bucket ("\n\nUser: {q}\n\nChatbot:")
    RAG_TAIL_BUCKET = 128

    def __init__(
        self,
        config: LlamaConfig,
        model: LlamaModel,
        sampling: SamplingConfig = SamplingConfig(),
        engine_config: EngineConfig = EngineConfig(),
        dtypes: DTypePolicy = DTypePolicy(),
        device: DeviceLike = None,
        pad_id: int = 0,
    ):
        if engine_config.speculative not in ("off", "prompt_lookup", "auto"):
            raise ValueError(
                f"speculative={engine_config.speculative!r}: expected "
                "'off', 'prompt_lookup' or 'auto'"
            )
        self.device = resolve_device(device)
        self.config = config
        self.sampling = sampling
        self.engine_config = engine_config
        self.dtypes = dtypes
        self.pad_id = pad_id
        self.model = serving_model(model, engine_config)
        self._spec_ema: Optional[float] = None
        self._spec_skips = 0
        self._lock = threading.Lock()
        self._run_lock = threading.Lock()
        self._rng_counter = 0
        self._eos = torch.tensor(config.eos_token_ids, device=self.device)
        self.stats = EngineStats()
        # the goodput ledger: a generate call is one window whose measured
        # host duration the roofline splits into prefill and decode shares
        # ("oneshot" windows; the continuous engine measures each window)
        self.ledger = goodput.ledger_for(config, engine_config)
        # the handles write into a registry of the engine's own until a
        # service binds them to its registry (JAX binds the process default
        # registry, which nothing in the port serves)
        self.bind_metrics(metrics.MetricsRegistry())
        # the cross-request KV prefix cache; this engine builds, splices and
        # generates for it
        self.prefix_cache = None
        self._prefix_zero: Optional[Tuple[torch.Tensor, ...]] = None
        if engine_config.prefix_cache.enabled:
            from rag_llm_k8s_tpu_torch.engine.prefix_cache import PrefixCache

            self.prefix_cache = PrefixCache(engine_config.prefix_cache, self)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def bind_metrics(self, registry) -> None:
        """Point this engine's metric handles at ``registry`` (JAX
        ``InferenceEngine.bind_metrics``)."""
        bind_compile_metrics(registry)
        self._m_generate = registry.histogram(
            "rag_generate_duration_seconds",
            "one generate call: prefill + decode + output fetch",
            buckets=metrics.REQUEST_BUCKETS,
        )
        self._m_itl = registry.labeled_histogram(
            "rag_decode_inter_token_seconds",
            "per-decoded-token latency (mode label: oneshot_est is call "
            "duration over decode steps; continuous is exact per window)",
            buckets=metrics.TOKEN_LATENCY_BUCKETS,
        ).labels(mode="oneshot_est")

    def _observe_generate(self, seconds: float, decode_steps: int) -> None:
        self._m_generate.observe(seconds)
        self._m_itl.observe(seconds / max(decode_steps, 1))

    def _record_oneshot(
        self, call_s: float, bucket: int, batch: int, computed: int, decode_tokens: int,
        decode_steps: int, skipped: int = 0, info: Optional[Dict] = None,
    ) -> None:
        """Fold one generate call into the goodput ledger, journal its
        ``goodput_window`` event and, given an ``info`` out-param, leave the
        per-request share there (``info["goodput"]``). A chunked
        ``generate`` records once per sub-batch into one ``info``: the
        shares accumulate."""
        w = self.ledger.record_oneshot(
            call_s, bucket=bucket, batch=batch, computed_tokens=computed,
            decode_tokens=decode_tokens, decode_steps=decode_steps, skipped=skipped,
        )
        if w is None:
            return
        per_row = w.pop("chip_ms_per_row")
        frac = w.pop("goodput_frac")
        flight.emit("goodput_window", **w)
        if info is None:
            return
        gp = {"chip_ms": per_row, "goodput_frac": frac}
        if self.ledger.chip_hour_usd > 0:
            gp["cost_usd"] = per_row / 1e3 / 3600.0 * self.ledger.chip_hour_usd
        prev = info.get("goodput")
        if prev and prev.get("chip_ms"):
            chip = prev["chip_ms"] + gp["chip_ms"]
            gp["goodput_frac"] = round((prev["chip_ms"] * prev.get("goodput_frac", 0.0) + gp["chip_ms"] * frac) / chip, 6)
            gp["chip_ms"] = round(chip, 4)
            if "cost_usd" in gp or "cost_usd" in prev:
                gp["cost_usd"] = prev.get("cost_usd", 0.0) + gp.get("cost_usd", 0.0)
        info["goodput"] = gp

    def record_prefill(self, n_tokens: int) -> None:
        """Prefill tokens of a device-assembled prompt that only the caller
        knows (its chunk share, once the retrieved ids are fetched)."""
        with self._lock:
            self.stats.prefill_tokens += int(n_tokens)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _clamp_max_new(self, S: int, max_new: int) -> int:
        """Keep S + max_new within the engine's cache budget."""
        budget = self.engine_config.max_seq_len - S
        return max(1, min(max_new, budget))

    def _next_rng(self, seed: Optional[int]) -> torch.Generator:
        """Fresh randomness per call unless the caller pins a seed."""
        if seed is None:
            with self._lock:
                self._rng_counter += 1
                seed = (self.sampling.seed * 1_000_003 + self._rng_counter) % (1 << 62)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def _spec_applicable(self, n_prompts: int, chunk) -> bool:
        """Speculation serves batch-1 single-shot prompts; "auto" skips it
        while the measured acceptance stays below ``spec_min_accept``,
        re-probing every ``_SPEC_REPROBE``-th eligible call."""
        mode = self.engine_config.speculative
        if mode not in ("prompt_lookup", "auto") or n_prompts != 1 or chunk is not None:
            return False
        if mode == "auto":
            with self._lock:
                ema, skips = self._spec_ema, self._spec_skips
                low = ema is not None and ema < self.engine_config.spec_min_accept
                if low:
                    self._spec_skips += 1
            if low and (skips + 1) % self._SPEC_REPROBE != 0:
                return False
        return True

    def _spec_record(self, emitted: int, iters: int) -> None:
        acc = emitted / max(iters, 1)
        with self._lock:
            self.stats.spec_verify_steps += iters
            self.stats.spec_emitted_tokens += emitted
            d = self._SPEC_EMA_DECAY
            self._spec_ema = acc if self._spec_ema is None else d * self._spec_ema + (1 - d) * acc

    def _isin_eos(self, tok: torch.Tensor) -> torch.Tensor:
        return torch.isin(tok, self._eos)

    def _prefill_inputs(self, pad_mask: torch.Tensor):
        kv_start, _ = mask_window(pad_mask)
        real_len = pad_mask.sum(dim=-1)
        positions = (torch.cumsum(pad_mask, dim=-1) - 1).clamp_min(0)
        return kv_start, real_len, positions

    # ------------------------------------------------------------------
    # the two decode loops
    # ------------------------------------------------------------------
    def _run_vanilla(
        self, tokens: torch.Tensor, pad_mask: torch.Tensor, S: int, max_new: int,
        chunk: Optional[int], gen: torch.Generator,
    ) -> np.ndarray:
        """Prefill (single-shot or chunked) then the KV-cached decode loop;
        returns ``[B, max_new]`` token ids (EOS-padded after a row ends)."""
        cfg, model, dev = self.config, self.model, self.device
        B = tokens.shape[0]
        T = _cache_len(S + max_new)
        cache = make_kv_cache(cfg, B, T, self.dtypes.compute_dtype, dev, self.engine_config.kv_quant)
        kv_start, real_len, positions = self._prefill_inputs(pad_mask)

        def full(n: int) -> torch.Tensor:
            return torch.full((B,), n, dtype=torch.int64, device=dev)

        if chunk is None:
            logits = model(tokens, positions, cache, kv_start, full(S), 0, last_logit_only=True)
        else:
            for wi in range(0, S - chunk, chunk):
                model(
                    tokens[:, wi : wi + chunk], positions[:, wi : wi + chunk], cache,
                    kv_start, full(wi + chunk), wi, chunked=True, last_logit_only=True,
                )
            wi = S - chunk
            logits = model(
                tokens[:, wi:], positions[:, wi:], cache, kv_start, full(S), wi,
                chunked=True, last_logit_only=True,
            )
        return self._decode_loop(cache, logits, kv_start, S, real_len, max_new, gen)

    def _decode_loop(
        self, cache, logits: torch.Tensor, kv_start: torch.Tensor, slot0: int, pos0, max_new: int,
        gen: torch.Generator,
    ) -> np.ndarray:
        """Sample the prefill's first token from ``logits [B, 1, V]``, then
        the KV-cached decode loop: step ``i`` feeds the last token at slot
        ``slot0 + i - 1`` and position ``pos0 + i - 1``. Returns ``[B,
        max_new]`` token ids (EOS-padded after a row ends)."""
        B, dev = logits.shape[0], self.device
        tok = sample_token(logits[:, -1], self.sampling, gen)
        done = self._isin_eos(tok)
        out = torch.full((B, max_new), self.pad_id, dtype=torch.int64, device=dev)
        out[:, 0] = tok
        eos0 = self.config.eos_token_ids[0]
        step = 1
        # one host sync per step: the loop ends when every row has ended
        while step < max_new and not bool(done.all()):
            wi = slot0 + step - 1
            with record_function("decode_forward"):
                logits = self.model(
                    tok[:, None], (pos0 + step - 1)[:, None], cache, kv_start,
                    torch.full((B,), wi + 1, dtype=torch.int64, device=dev), wi,
                )
                nxt = sample_token(logits[:, 0], self.sampling, gen)
                tok = torch.where(done, torch.full_like(nxt, eos0), nxt)
                done = done | self._isin_eos(tok)
                out[:, step] = tok
            step += 1
        return out.cpu().numpy()

    def _run_spec(
        self, tokens: torch.Tensor, pad_mask: torch.Tensor, S: int, max_new: int,
        gen: torch.Generator,
    ) -> Tuple[np.ndarray, int]:
        """Batch-1 prompt-lookup speculative generate; returns ``([1, max_new]
        token ids, verify forwards run)``."""
        cfg, model, dev = self.config, self.model, self.device
        sampling = self.sampling
        sampled = sampling.do_sample and sampling.temperature > 0.0
        n = max(1, self.engine_config.spec_ngram)
        k = max(1, self.engine_config.spec_tokens)
        # k extra slots: the LAST verify can start at slot S + max_new - 2
        # and still writes k + 1 slots
        T = _cache_len(S + max_new + k)
        cache = make_kv_cache(cfg, 1, T, self.dtypes.compute_dtype, dev, self.engine_config.kv_quant)
        kv_start, real_len, positions = self._prefill_inputs(pad_mask)
        logits = model(
            tokens, positions, cache, kv_start, torch.full((1,), S, device=dev), 0,
            last_logit_only=True,
        )
        tok0 = sample_token(logits[:, -1], sampling, gen)
        # the ONE fetch of the assembled prompt: the history lives on the host
        host = torch.cat([tokens[0], kv_start, real_len, tok0]).cpu().numpy()
        ks, rl, t0 = int(host[S]), int(host[S + 1]), int(host[S + 2])
        eos = np.asarray(cfg.eos_token_ids)
        done = t0 in cfg.eos_token_ids
        # out and hist carry k + 1 slack slots; hist mirrors cache slots:
        # prompt at [0, S), emitted token j at S + j
        out = np.full(max_new + k + 1, self.pad_id, np.int64)
        out[0] = t0
        hist = np.full(T + k + 1, self.pad_id, np.int64)
        hist[:S] = host[:S]
        hist[S] = t0
        idx = np.arange(T + k + 1)
        j_idx = np.arange(k + 1)
        e, iters = 1, 0
        while e < max_new and not done:
            wi = S + e - 1  # slot of the pending token
            # propose: the latest earlier occurrence of the trailing n-gram
            # whose k-token continuation is already written
            match = np.ones(T + k + 1, bool)
            for j in range(n):
                match &= np.roll(hist, j) == hist[wi - j]
            match &= (idx >= ks + n - 1) & (idx + k <= wi)
            hits = np.nonzero(match)[0]
            src = int(hits[-1]) + 1 if hits.size else 0
            props = hist[src : src + k]
            with record_function("verify_forward"):
                fed = torch.from_numpy(np.concatenate([hist[wi : wi + 1], props])[None]).to(dev)
                pos = torch.arange(rl - 1 + e, rl + e + k, device=dev)[None]
                logits = model(
                    fed, pos, cache, kv_start, torch.full((1,), wi + k + 1, device=dev), wi,
                    chunked=True,
                )[0]  # [k + 1, V]
            if not sampled:
                g = torch.argmax(logits, dim=-1).cpu().numpy()
                m = int(np.cumprod(props == g[:k]).sum())
            else:
                # rejection sampling against the point-mass draft: accept x_j
                # w.p. p_j(x_j); on rejection draw from p_j with x_j masked;
                # on full acceptance draw the bonus from p_k
                prepared = prepared_logits(logits, sampling)
                probs = torch.softmax(prepared, dim=-1)
                props_t = fed[0, 1:]
                p_prop = probs[:k].gather(1, props_t[:, None])[:, 0]
                u = torch.rand(k, generator=gen, device=dev)
                res = prepared[:k].scatter(1, props_t[:, None], NEG_INF)
                r = categorical(res, gen)
                bonus = categorical(prepared[k], gen)
                got = torch.cat([(u < p_prop).long(), r, bonus[None]]).cpu().numpy()
                m = int(np.cumprod(got[:k]).sum())
                corr = got[k + min(m, k - 1)] if m < k else got[2 * k]
                g = np.concatenate([props, got[2 * k :]])
                g[m] = corr
            is_eos = np.isin(g, eos)
            eos_pos = int(np.min(np.where(is_eos & (j_idx <= m), j_idx, k + 1)))
            m_eff = min(m, eos_pos, max_new - e - 1)
            out[e : e + m_eff + 1] = g[: m_eff + 1]
            hist[wi + 1 : wi + m_eff + 2] = g[: m_eff + 1]
            done = eos_pos <= m_eff
            e += m_eff + 1
            iters += 1
        return out[None, :max_new], iters

    # ------------------------------------------------------------------
    # host-side API
    # ------------------------------------------------------------------
    def _trim(self, row) -> List[int]:
        eos = set(self.config.eos_token_ids)
        outl: List[int] = []
        for t in row:
            if int(t) in eos:
                break
            outl.append(int(t))
        return outl

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: Optional[int] = None,
        seed: Optional[int] = None,
        info: Optional[Dict] = None,
    ) -> List[List[int]]:
        """Continuations for a batch of token-id prompts, one list per
        prompt, cut at (and excluding) EOS. Batches beyond
        ``max_batch_size`` run as sequential sub-batches. The ``generate``
        fault site comes first; nothing inside the decode loop checks a
        deadline (the JAX generate is one device call). ``info`` (an
        out-param) receives the call's goodput share."""
        if not prompts:
            return []
        faults.maybe_fail("generate")
        max_new = self.sampling.max_new_tokens if max_new_tokens is None else max_new_tokens
        if max_new <= 0:
            return [[] for _ in prompts]
        cap = self.engine_config.max_batch_size
        gen = self._next_rng(seed)
        out: List[List[int]] = []
        for i in range(0, len(prompts), cap):
            out.extend(self._generate_batch(prompts[i : i + cap], max_new, gen, info))
        return out

    def _generate_batch(
        self, prompts: Sequence[Sequence[int]], max_new: int, gen: torch.Generator, info: Optional[Dict] = None,
    ) -> List[List[int]]:
        maxlen = max(len(p) for p in prompts)
        largest = max(self.engine_config.prompt_buckets)
        cap = self.engine_config.max_chunked_prompt
        if maxlen > cap:
            logger.warning(
                "prompt of %d tokens exceeds max_chunked_prompt=%d; "
                "left-truncating to the most recent %d tokens", maxlen, cap, cap,
            )
            maxlen = cap
        if maxlen <= largest:
            S = bucket_len(maxlen, self.engine_config.prompt_buckets)
            chunk = None
            max_new = self._clamp_max_new(S, max_new)
        else:
            # chunked prefill; decode keeps the room the largest bucket gets
            chunk = largest
            S = -(-maxlen // chunk) * chunk
            budget = max(1, self.engine_config.max_seq_len - largest)
            max_new = max(1, min(max_new, budget))
        B = next_pow2(len(prompts))
        tokens = np.full((B, S), self.pad_id, np.int64)
        pad_mask = np.zeros((B, S), np.int64)
        for i, p in enumerate(prompts):
            p = list(p)[-maxlen:]
            tokens[i, S - len(p):] = p
            pad_mask[i, S - len(p):] = 1
        # empty rows (batch padding) get one BOS so real_len >= 1
        for i in range(len(prompts), B):
            tokens[i, -1] = self.config.bos_token_id
            pad_mask[i, -1] = 1
        tok_t = torch.from_numpy(tokens).to(self.device)
        mask_t = torch.from_numpy(pad_mask).to(self.device)
        with self._run_lock:
            spec = self._spec_applicable(len(prompts), chunk)
            iters = 0
            t_call = time.perf_counter()
            if spec:
                out, iters = self._run_spec(tok_t, mask_t, S, max_new, gen)
            else:
                out = self._run_vanilla(tok_t, mask_t, S, max_new, chunk, gen)
            call_s = time.perf_counter() - t_call
        results = [self._trim(out[i]) for i in range(len(prompts))]
        spec_accept = None
        if spec and iters > 0:
            # tokens the verify forwards emitted: the answer plus its EOS,
            # minus the prefill's token
            emitted = len(results[0]) + (1 if len(results[0]) < max_new else 0) - 1
            self._spec_record(max(emitted, 0), iters)
            spec_accept = round(max(emitted, 0) / iters, 4)
        steps = max((len(r) for r in results), default=1)
        self._observe_generate(call_s, steps)
        n_decode = sum(len(r) for r in results)
        with self._lock:
            self.stats.generate_calls += 1
            self.stats.prefill_tokens += int(pad_mask.sum())
            self.stats.decode_tokens += n_decode
        self._record_oneshot(call_s, bucket=S, batch=B, computed=int(pad_mask.sum()), decode_tokens=n_decode,
                             decode_steps=steps, info=info)
        if info is not None and spec_accept is not None and self.ledger.enabled:
            # the per-call acceptance mean, gated on the ledger like every
            # goodput key (TPU_RAG_GOODPUT=0: no goodput block at all)
            info.setdefault("goodput", {})["spec_accept_len_mean"] = spec_accept
        stamp_spec(info, spec and iters > 0)
        return results

    @torch.inference_mode()
    def generate_rag(
        self,
        a_ids: Sequence[int],
        b_ids: Sequence[int],
        packed: torch.Tensor,
        store_toks: torch.Tensor,
        store_lens: torch.Tensor,
        n_chunks: int,
        max_new_tokens: Optional[int] = None,
        seed: Optional[int] = None,
        info: Optional[Dict] = None,
    ) -> List[int]:
        """Single-fetch RAG generate: the packed retrieve output and the
        chunk-token sidecar are device tensors, and the prompt is assembled
        on the device (``assemble_rag_tokens``). Always serves at the
        largest prompt bucket; the caller guards that head + tail fit it.
        ``info`` (an out-param) receives the call's goodput share."""
        S = max(self.engine_config.prompt_buckets)
        max_new = self.sampling.max_new_tokens if max_new_tokens is None else max_new_tokens
        max_new = self._clamp_max_new(S, max_new)
        b = np.asarray(b_ids, np.int64)
        LB = self.RAG_TAIL_BUCKET
        if b.shape[0] > LB:
            raise ValueError(
                f"prompt tail of {b.shape[0]} tokens exceeds the fused bucket "
                f"({LB}) — route this query through the host path"
            )
        b_pad = np.full((LB,), self.pad_id, np.int64)
        b_pad[: b.shape[0]] = b
        kk = int(packed.shape[1]) // 2
        n = min(n_chunks, kk)
        gen = self._next_rng(seed)
        dev = self.device
        tokens, pad_mask = assemble_rag_tokens(
            torch.as_tensor(np.asarray(a_ids, np.int64), device=dev),
            torch.from_numpy(b_pad).to(dev), int(b.shape[0]), packed, store_toks,
            store_lens, S, n, self.pad_id,
        )
        with self._run_lock:
            spec = self._spec_applicable(1, None)
            iters = 0
            t_call = time.perf_counter()
            if spec:
                out, iters = self._run_spec(tokens, pad_mask, S, max_new, gen)
            else:
                out = self._run_vanilla(tokens, pad_mask, S, max_new, None, gen)
            call_s = time.perf_counter() - t_call
        row = self._trim(out[0])
        spec_accept = None
        if spec and iters > 0:
            emitted = len(row) + (1 if len(row) < max_new else 0) - 1
            self._spec_record(max(emitted, 0), iters)
            spec_accept = round(max(emitted, 0) / iters, 4)
        self._observe_generate(call_s, len(row))
        with self._lock:
            self.stats.generate_calls += 1
            self.stats.decode_tokens += len(row)
            # the prompt is assembled on the device: head + tail are the
            # host-known share (the service adds the chunks, record_prefill)
            self.stats.prefill_tokens += len(a_ids) + int(b.shape[0])
        # the assembled length is decided on the card (fetching it would
        # add a round trip): head + tail plus n chunks at the sidecar's
        # row width, clamped to the bucket — an estimate, as in JAX
        self._record_oneshot(call_s, bucket=S, batch=1,
                             computed=min(len(a_ids) + int(b.shape[0]) + n * int(store_toks.shape[1]), S),
                             decode_tokens=len(row), decode_steps=max(len(row), 1), info=info)
        if info is not None and spec_accept is not None and self.ledger.enabled:
            info.setdefault("goodput", {})["spec_accept_len_mean"] = spec_accept
        stamp_spec(info, spec and iters > 0)
        return row

    # ------------------------------------------------------------------
    # exact-path shadow scoring (obs/shadow.py drives this)
    # ------------------------------------------------------------------
    # the scorer's chunk width: it bounds the [1, C, V] logit plane (the
    # scorer needs every position's logits, unlike a serving prefill);
    # 256 x a 128k vocabulary is ~130 MB of fp32
    _SCORE_CHUNK = 256

    @torch.inference_mode()
    def score_exact(self, prompt_ids: Sequence[int], emitted_ids: Sequence[int]) -> Dict[str, np.ndarray]:
        """Teacher-forced exact-path scoring for the shadow auditor (JAX
        ``score_exact``): one chunked forward over ``prompt + emitted``,
        left-padded to a multiple of the chunk, into a fresh dense cache in
        the engine's own KV dtype; no prefix reuse, no speculation. Each
        chunk's ``[1, C, V]`` logits are reduced on the device to (argmax,
        max logit, logit of the next delivered token) in one ``[S, 3]``
        buffer, which the host fetches once at the end.

        Returns arrays over the emitted positions: ``argmax`` (int64, the
        exact path's greedy choice given the delivered prefix),
        ``max_logit`` and ``chosen_logit`` (float64: the logit of that choice
        and of the delivered token). Raises ValueError without a prompt or
        an emitted token, or past ``max_chunked_prompt`` (the auditor counts
        that as an ``oversize`` skip).

        Safe beside a serving call on another thread: the scorer owns its
        cache and its buffers, takes no engine lock, and records no stats
        and no goodput window (JAX records none either)."""
        x = [int(t) for t in prompt_ids] + [int(t) for t in emitted_ids]
        W = len(emitted_ids)
        if W == 0 or len(x) < 2:
            raise ValueError("score_exact needs a prompt and >= 1 emitted token")
        cap = self.engine_config.max_chunked_prompt
        if len(x) > cap:
            raise ValueError(f"score_exact sequence of {len(x)} tokens exceeds max_chunked_prompt={cap}")
        chunk = min(self._SCORE_CHUNK, max(self.engine_config.prompt_buckets))
        S = -(-len(x) // chunk) * chunk
        off = S - len(x)
        tokens = np.full((1, S), self.pad_id, np.int64)
        tokens[0, off:] = x
        mask = np.zeros((1, S), np.int64)
        mask[0, off:] = 1
        nxt = np.zeros((1, S), np.int64)
        nxt[0, : S - 1] = tokens[0, 1:]
        dev = self.device
        tokens_t, mask_t, nxt_t = (torch.from_numpy(a).to(dev) for a in (tokens, mask, nxt))
        cache = self._new_cache(_cache_len(S))
        kv_start, _, positions = self._prefill_inputs(mask_t)
        stats = torch.zeros((S, 3), dtype=torch.float32, device=dev)
        for wi in range(0, S, chunk):
            logits = self.model(
                tokens_t[:, wi : wi + chunk], positions[:, wi : wi + chunk], cache, kv_start,
                torch.full((1,), wi + chunk, dtype=torch.int64, device=dev), wi, chunked=True,
            )
            row = logits[0].float()  # [chunk, V]
            chosen = row.gather(-1, nxt_t[0, wi : wi + chunk, None])[:, 0]
            stats[wi : wi + chunk] = torch.stack([row.argmax(dim=-1).float(), row.amax(dim=-1), chosen], dim=-1)
        host = stats.cpu().numpy()
        lo = off + len(x) - W - 1  # the slot whose logits predict emitted[0]
        sl = slice(lo, lo + W)
        return {
            "argmax": host[sl, 0].astype(np.int64),
            "max_logit": host[sl, 1].astype(np.float64),
            "chosen_logit": host[sl, 2].astype(np.float64),
        }

    # ------------------------------------------------------------------
    # KV prefix cache (engine/prefix_cache.py drives these)
    # ------------------------------------------------------------------
    def _prefix_capacity(self) -> int:
        return self.engine_config.prefix_cache.max_prefix_tokens

    def _prefix_planes(self, cache) -> Tuple[torch.Tensor, ...]:
        """A cache's planes in the prefix layout: ``(k, v)``, or ``(k, v,
        k_scale, v_scale)`` under int8 KV."""
        return (cache.k, cache.v) + ((cache.k_scale, cache.v_scale) if cache.quantized else ())

    def _new_cache(self, T: int):
        return make_kv_cache(
            self.config, 1, T, self.dtypes.compute_dtype, self.device, self.engine_config.kv_quant
        )

    def prefix_buffer_zero(self) -> Tuple[torch.Tensor, ...]:
        """The shared all-zeros ``[L, 1, K, P, hd]`` splice buffer (scales
        ``[L, 1, K, P]`` under int8 KV) every prefix assembly starts from.
        Never written: splices return new buffers. Built outside the lock;
        two racing first builders waste one allocation, the first install
        wins."""
        with self._lock:
            cached = self._prefix_zero
        if cached is not None:
            return cached
        planes = self._prefix_planes(self._new_cache(self._prefix_capacity()))
        with self._lock:
            if self._prefix_zero is None:
                self._prefix_zero = planes
            return self._prefix_zero

    @staticmethod
    def splice_prefix(buf: Tuple, block: Tuple, offset: int) -> Tuple:
        """A new buffer: ``buf`` with the segment block written at slot
        ``offset`` (the slot axis is 3 in payloads and scales). As the JAX
        package's ``dynamic_update_slice``, a block that would run past the
        buffer's end is written ending at the end."""
        out = []
        for c, b in zip(buf, block):
            start = max(0, min(int(offset), c.shape[3] - b.shape[3]))
            n = c.clone()
            n[:, :, :, start : start + b.shape[3]] = b.to(c.dtype)
            out.append(n)
        return tuple(out)

    def rerotate_segment_kv(self, planes: Tuple, delta: int) -> Tuple:
        """Position-shift a cached segment block by ``delta`` tokens (chunk
        reuse): K re-rotated by the RoPE delta, V as it is; bf16 pairs and
        the int8 4-tuple alike."""
        return rerotate_prefix_planes(self.config, planes, delta)

    @staticmethod
    def slice_prefix_block(block: Tuple, width: int) -> Tuple:
        """The first ``width`` slots of a segment block: the boundary
        correction overwrites only its window, not the re-rotated tail."""
        return tuple(p[:, :, :, :width] for p in block)

    @torch.inference_mode()
    def build_segment_kv(self, ids: Sequence[int], ctx_planes: Tuple, ctx_len: int) -> Tuple:
        """Prefill one prompt segment with ``ctx_planes[:ctx_len]`` as its
        left context (a chunked forward at offset ``ctx_len``) and return its
        KV block padded to the segment bucket: the prefix cache's miss path.
        The tokens count as prefilled."""
        pc = self.engine_config.prefix_cache
        n = len(ids)
        Sb = bucket_len(max(n, 1), pc.segment_buckets)
        T = _cache_len(self._prefix_capacity() + Sb)
        dev = self.device
        toks = np.full((1, Sb), self.pad_id, np.int64)
        toks[0, :n] = list(ids)
        with self._run_lock:
            cache = self._new_cache(T)
            for c, b in zip(self._prefix_planes(cache), ctx_planes):
                c[:, :, :, : b.shape[3]] = b.to(c.dtype)  # its tail past ctx_len is overwritten below
            positions = ctx_len + torch.arange(Sb, device=dev)[None, :]
            self.model(
                torch.from_numpy(toks).to(dev), positions, cache, torch.zeros(1, dtype=torch.int64, device=dev),
                torch.full((1,), ctx_len + n, dtype=torch.int64, device=dev), int(ctx_len),
                chunked=True, last_logit_only=True,
            )
            block = tuple(c[:, :, :, ctx_len : ctx_len + Sb].clone() for c in self._prefix_planes(cache))
        with self._lock:
            self.stats.prefill_tokens += n
        return block

    def _prefixed_max_new(self, max_new_tokens: Optional[int]) -> int:
        max_new = self.sampling.max_new_tokens if max_new_tokens is None else max_new_tokens
        return max(1, min(max_new, self.engine_config.max_seq_len - max(self.engine_config.prompt_buckets)))

    def prefill_prefixed(self, suffix_ids: Sequence[int], prefix, max_new: int):
        """The prefixed prefill: ``prefix.planes`` spliced into a fresh
        left-aligned batch-1 cache (slot == position) sized for ``max_new``
        more tokens, and the suffix, right-padded to its bucket, prefilled
        at positions ``plen + arange(S_suf)``. Returns ``(logits [1, 1, V]``
        of the last real suffix token (``logit_index``), ``cache, total)``
        with ``total = plen + len(suffix_ids)``. The caller holds the run
        lock (or owns the card)."""
        n_suf = len(suffix_ids)
        S_suf = bucket_len(n_suf, self.engine_config.prefix_cache.suffix_buckets)
        dev = self.device
        plen = int(prefix.length)
        total = plen + n_suf
        cache = self._new_cache(_cache_len(self._prefix_capacity() + S_suf + max_new))
        for c, b in zip(self._prefix_planes(cache), prefix.planes):
            c[:, :, :, : b.shape[3]] = b.to(c.dtype)
        toks = np.full((1, S_suf), self.pad_id, np.int64)
        toks[0, :n_suf] = list(suffix_ids)
        # the pad tokens' K/V land in [total, plen + S_suf), outside every
        # window until the decode overwrites them in order
        logits = self.model(
            torch.from_numpy(toks).to(dev), plen + torch.arange(S_suf, device=dev)[None, :], cache,
            torch.zeros(1, dtype=torch.int64, device=dev), torch.full((1,), total, dtype=torch.int64, device=dev),
            plen, chunked=True, logit_index=torch.full((1,), n_suf - 1, dtype=torch.int64, device=dev),
        )
        return logits, cache, total

    @torch.inference_mode()
    def generate_prefixed(
        self,
        suffix_ids: Sequence[int],
        prefix,  # CachedPrefix
        max_new_tokens: Optional[int] = None,
        seed: Optional[int] = None,
        info: Optional[Dict] = None,
    ) -> List[int]:
        """Generate with a cached prefix (JAX ``generate_prefixed``):
        ``prefill_prefixed``, its first token sampled from the last real
        suffix token's logits, then the vanilla decode loop (never
        speculative). Raises ValueError on an empty suffix or one past the
        suffix ladder (the caller serves the cold path)."""
        pc = self.engine_config.prefix_cache
        if not suffix_ids:
            # an empty suffix would sample tok0 from a PAD token's logits
            raise ValueError("generate_prefixed needs a non-empty suffix")
        n_suf = len(suffix_ids)
        if n_suf > max(pc.suffix_buckets):
            raise ValueError(
                f"prefixed suffix of {n_suf} tokens exceeds the largest "
                f"suffix bucket ({max(pc.suffix_buckets)})"
            )
        max_new = self._prefixed_max_new(max_new_tokens)
        gen = self._next_rng(seed)
        with self._run_lock:
            t_call = time.perf_counter()
            logits, cache, total = self.prefill_prefixed(suffix_ids, prefix, max_new)
            pos0 = torch.full((1,), total, dtype=torch.int64, device=self.device)
            kv_start = torch.zeros(1, dtype=torch.int64, device=self.device)
            out = self._decode_loop(cache, logits, kv_start, total, pos0, max_new, gen)
            call_s = time.perf_counter() - t_call
        row = self._trim(out[0])
        self._observe_generate(call_s, len(row))
        with self._lock:
            self.stats.generate_calls += 1
            self.stats.prefill_tokens += n_suf
            self.stats.prefill_tokens_skipped += int(prefix.reused_tokens)
            self.stats.decode_tokens += len(row)
        S_suf = bucket_len(n_suf, pc.suffix_buckets)
        self._record_oneshot(call_s, bucket=S_suf, batch=1, computed=n_suf, decode_tokens=len(row),
                             decode_steps=max(len(row), 1), skipped=int(prefix.reused_tokens), info=info)
        return row

    def warm_prefixed(self, suffix_lens: Sequence[int] = (), max_new_tokens: Optional[int] = None) -> List[int]:
        """The suffix buckets the prefixed generate serves at (JAX: the
        executables it compiles ahead of traffic). Eager PyTorch compiles
        nothing per shape, and the kernels this path launches are built by
        ``ops._build.build`` at service warmup, so this only names them."""
        if self.prefix_cache is None:
            return []
        pc = self.engine_config.prefix_cache
        top = max(pc.suffix_buckets)
        return sorted({
            bucket_len(min(max(n, 1), top), pc.suffix_buckets)
            for n in (suffix_lens or (self.RAG_TAIL_BUCKET,))
        })
