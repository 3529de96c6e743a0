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
``lax.while_loop`` and one host fetch. Here PyTorch runs eagerly and the
host issues the loop's steps, but the loop's state lives on the card as
JAX's carry does: the vanilla loop's token, done flags, output and the
step's slot and positions; the speculative loop's token history, output,
emitted count, done flag and verify count, with the n-gram proposal, the
acceptance (greedy, or the rejection draw) and the ``out``/``hist``
scatters all on the card. The dense cache is written, and kernels 4 and 6
read, at a device slot (``models/llama.py`` ``DeviceSlot``). The host never
waits on the step it just issued: before issuing a step it reads the
all-done flag of the step ``DONE_LAG`` behind the newest one, which a
non-blocking copy into pinned memory carried back behind an event
(``_DoneReader``), and stops once it says every row has ended (a finished
state is a no-op: ``out`` and the speculative state stay as they are). So
at most ``DONE_LAG`` steps run past the end, and the one fetch of ``out``
(and the verify count) ends the call. The lag is fixed, not "whatever has
finished", so every rank of a mesh stops at the same step. Sampled steps
past the end draw from the generator; it is set back to where the last real
step left it. ``loop_counts`` counts the host's waits per call (the lagged
reads and the final fetch; none on the newest step) and the steps past the
end. CUDA graphs are the tool to remove the remaining launch cost later.
Each decode step and each verify runs inside a ``record_function`` range
(``decode_forward``, ``verify_forward``), so a ``torch.profiler`` trace
shows one forward's host issue time and the kernels it launched.

Metrics (``bind_metrics``, as the JAX engine's): ``rag_generate_duration_seconds``
per call, ``rag_decode_inter_token_seconds{mode="oneshot_est"}`` (call
duration over decode steps, prefill included: an estimate, as in JAX), and
the compile counters, which here read the process's kernel-library builds
and loads (``ops._build.COMPILES``).

On a mesh (``mesh``, a ``core.mesh.MeshContext`` of more than one rank;
the JAX engine's ``mesh=``) the model is this rank's shard
(``parallel.sharding``) and every rank runs the same device program: rank
0 sends each one as a mesh command (``parallel/commands.py``,
``_device_run``, ``_score_device``, ``_prefixed_device``) before running
it, under one lock. A command carries the prompt the program runs on (the
assembled one for ``generate_rag``, fetched once), the token budget, the
speculation switch and the sampler's generator state, so every rank draws
the same token from the same gathered logits, and the per-step ``done``
check reads the same values everywhere.
The rest of a call (trimming, stats, the goodput window) is rank 0's. A
tp-sharded model keeps the unfused layout (JAX ``maybe_fuse_params``).

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

import contextlib
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
from rag_llm_k8s_tpu_torch.parallel.commands import CommandStream, mesh_command, register_target, stream_for
from rag_llm_k8s_tpu_torch.resilience import faults
from rag_llm_k8s_tpu_torch.engine.sampling import (
    NEG_INF,
    categorical,
    prepared_logits,
    sample_token,
)
from rag_llm_k8s_tpu_torch.models.llama import (
    DeviceSlot,
    LlamaModel,
    fuse_projections_,
    make_kv_cache,
    mask_window,
    quantize_llama,
    rerotate_prefix_planes,
)
from rag_llm_k8s_tpu_torch.utils.buckets import bucket_len, next_pow2

logger = logging.getLogger(__name__)

# the host reads the all-done flag of the step DONE_LAG behind the newest
# step it has issued: at most DONE_LAG steps run past the end, and none of
# the host's waits falls on the step it just issued (0 reads the newest)
DONE_LAG = 2


class _DoneReader:
    """The decode loops' lagged read of the all-done flag. ``record(j,
    fin)`` after issuing step ``j``: on the card a non-blocking copy of the
    device flag ``fin`` into pinned memory and an event behind it (a ring
    of ``lag + 1`` events: step ``j``'s reuses the one of step ``j - lag -
    1``, already waited on). ``ended()`` before issuing the next step:
    waits on the event of step ``newest - lag`` (none while fewer steps are
    issued) and returns its flag. On the CPU the flag is read as it is
    (nothing is in flight). ``waits`` counts the reads, ``newest`` those of
    the newest step, ``wait_s`` the host seconds spent in them."""

    def __init__(self, device: torch.device, n: int, lag: int):
        self.lag = max(int(lag), 0)
        self.cuda = device.type == "cuda"
        self.flags = torch.zeros(n, dtype=torch.bool, pin_memory=self.cuda)
        self.events = [torch.cuda.Event() for _ in range(self.lag + 1)] if self.cuda else []
        self.issued = -1
        self.waits = 0
        self.newest = 0
        self.wait_s = 0.0

    def record(self, j: int, fin: torch.Tensor) -> None:
        if self.cuda:
            self.flags[j : j + 1].copy_(fin.reshape(1), non_blocking=True)
            self.events[j % (self.lag + 1)].record()
        else:
            self.flags[j : j + 1].copy_(fin.reshape(1))
        self.issued = j

    def ended(self) -> bool:
        j = self.issued - self.lag
        if j < 0:
            return False
        t = time.perf_counter()
        if self.cuda:
            self.events[j % (self.lag + 1)].synchronize()
        self.wait_s += time.perf_counter() - t
        self.waits += 1
        self.newest += j == self.issued
        return bool(self.flags[j])


@dataclass
class LoopCounts:
    """The decode loops' host waits on the card and steps past the end, in
    total and for the last call (``last``): ``waits`` the lagged done reads
    plus the final fetch, ``newest`` the reads of the step just issued (0 at
    ``DONE_LAG`` > 0), ``overrun`` the steps issued after every row had
    ended; ``wait_s`` and ``fetch_s`` the host seconds spent in the lagged
    reads and in the final fetch (in total only)."""

    calls: int = 0
    waits: int = 0
    newest: int = 0
    overrun: int = 0
    wait_s: float = 0.0
    fetch_s: float = 0.0
    last: Optional[Dict[str, int]] = None


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
    left as it is). A tp-sharded model stays unfused, and a fused one is
    refused: its shards would not be the fused weight's."""
    engine_config.validate_quant()
    if getattr(model, "layout", None) is not None:
        if model.fused:
            raise ValueError("a fused q|k|v / gate|up model cannot serve over tp: load the unfused layout")
    elif engine_config.fuse_matmuls:
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


def _vanilla_steps(out: np.ndarray, eos_ids) -> int:
    """The decode steps JAX's loop runs for the fetched ``out [B, max_new]``:
    through the step whose token ended the last row, or all ``max_new - 1``
    when a row never ends."""
    hit = np.isin(out, np.asarray(eos_ids))
    first = np.where(hit.any(axis=1), hit.argmax(axis=1), out.shape[1] - 1)
    return int(first.max())


class _SyncDebug:
    """On the card, ``torch.cuda.set_sync_debug_mode("error")`` for the
    block: any host sync inside raises. Nothing on the CPU."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"

    def __enter__(self):
        if self.on:
            self.prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode(self.prev)
        return False


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
        mesh=None,
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
        model_mesh = getattr(model, "mesh", None)
        if mesh is not None and model_mesh is not mesh and mesh.world > 1:
            raise ValueError("InferenceEngine(mesh=...): the model must be this rank's shard on that mesh")
        self.mesh = model_mesh if mesh is None else mesh
        self.model = serving_model(model, engine_config)
        self._spec_ema: Optional[float] = None
        self._spec_skips = 0
        self._lock = threading.Lock()
        # rank 0 of a mesh sends each device program as a command before it
        # runs it, both under the stream's lock (parallel/commands.py); the
        # stream is the mesh's one, shared with its other engines
        self.commands: Optional[CommandStream] = stream_for(self.mesh)
        self._commands, self._mesh_name = self.commands, register_target(self.mesh, self, "oneshot")
        self._run_lock = self.commands.lock if self.commands is not None else threading.RLock()
        self._rng_counter = 0
        self._eos = torch.tensor(config.eos_token_ids, device=self.device)
        self.stats = EngineStats()
        self.loop_counts = LoopCounts()
        # set on the card to make any host sync inside a loop step raise
        # (torch.cuda.set_sync_debug_mode): the check that a step never
        # waits on the card
        self.strict_sync = False
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
        model, dev = self.model, self.device
        B = tokens.shape[0]
        T = _cache_len(S + max_new)
        cache = self._new_cache(T, B)
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

    def _strict(self):
        """The sync check around one step's issue (``strict_sync``), else
        nothing."""
        return _SyncDebug(self.device) if self.strict_sync else contextlib.nullcontext()

    def _close_loop(self, reader: _DoneReader, issued: int, real: int, states: Dict[int, torch.Tensor],
                    gen: torch.Generator, fetch_s: float) -> None:
        """After the final fetch: count the call's waits (the lagged reads
        and the fetch) and its steps past the end, and set a sampled loop's
        generator back to where its last real step left it."""
        if real + 1 in states:
            gen.set_state(states[real + 1])
        last = {"waits": reader.waits + 1, "newest": reader.newest, "overrun": issued - real, "steps": issued}
        with self._lock:
            lc = self.loop_counts
            lc.calls += 1
            lc.waits += last["waits"]
            lc.newest += last["newest"]
            lc.overrun += last["overrun"]
            lc.wait_s += reader.wait_s
            lc.fetch_s += fetch_s
            lc.last = last

    def _decode_loop(
        self, cache, logits: torch.Tensor, kv_start: torch.Tensor, slot0: int, pos0, max_new: int,
        gen: torch.Generator,
    ) -> np.ndarray:
        """Sample the prefill's first token from ``logits [B, 1, V]``, then
        the KV-cached decode loop (JAX ``_make_gen``'s ``while_loop``): step
        ``i`` feeds the last token at slot ``slot0 + i - 1`` and position
        ``pos0 + i - 1``, both kept on the card and advanced there. Returns
        ``[B, max_new]`` token ids (EOS-padded after a row ends, pad after
        every row has)."""
        B, dev = logits.shape[0], self.device
        sampled = self.sampling.do_sample and self.sampling.temperature > 0.0
        tok = sample_token(logits[:, -1], self.sampling, gen)
        done = self._isin_eos(tok)
        out = torch.full((B, max_new), self.pad_id, dtype=torch.int64, device=dev)
        out[:, 0] = tok
        eos0 = torch.full_like(tok, self.config.eos_token_ids[0])
        # the step's slot, its kv_len and the rows' positions, advanced by
        # one add: [slot, kv_len x B, pos x B]; the cache write's int64 slot
        # by another
        at = torch.cat([torch.full((1 + B,), slot0, dtype=torch.int32, device=dev),
                        torch.as_tensor(pos0, device=dev).to(torch.int32).reshape(B)])
        at[1 : 1 + B] += 1
        kv_len, pos = at[1 : 1 + B], at[1 + B :]
        slot = DeviceSlot(at[:1], torch.full((1,), slot0, dtype=torch.int64, device=dev))
        reader = _DoneReader(dev, max_new, DONE_LAG)
        fin = done.all()
        reader.record(0, fin)
        states: Dict[int, torch.Tensor] = {}
        step = 1
        while step < max_new and not reader.ended():
            if sampled:
                states[step] = gen.get_state()
            with self._strict(), record_function("decode_forward"):
                logits = self.model(tok[:, None], pos[:, None], cache, kv_start, kv_len, slot)
                nxt = sample_token(logits[:, 0], self.sampling, gen)
                tok = torch.where(done, eos0, nxt)
                done = done | self._isin_eos(tok)
                # a step issued after every row ended writes nothing (JAX's
                # loop would not have run it)
                out[:, step] = torch.where(fin, self.pad_id, tok)
                at += 1
                slot.slots.add_(1)
                fin = done.all()
                reader.record(step, fin)
            step += 1
        t = time.perf_counter()
        host = out.cpu().numpy()  # the one fetch
        fetch_s = time.perf_counter() - t
        self._close_loop(reader, step - 1, _vanilla_steps(host, self.config.eos_token_ids), states, gen, fetch_s)
        return host

    def _run_spec(
        self, tokens: torch.Tensor, pad_mask: torch.Tensor, S: int, max_new: int,
        gen: torch.Generator,
    ) -> Tuple[np.ndarray, int]:
        """Batch-1 prompt-lookup speculative generate (JAX
        ``_make_gen_spec``'s ``while_loop``, its carry on the card); returns
        ``([1, max_new] token ids, verify forwards run)``."""
        model, dev = self.model, self.device
        sampling = self.sampling
        sampled = sampling.do_sample and sampling.temperature > 0.0
        n = max(1, self.engine_config.spec_ngram)
        k = max(1, self.engine_config.spec_tokens)
        i64 = torch.int64
        # k extra slots: the LAST verify can start at slot S + max_new - 2
        # and still writes k + 1 slots
        T = _cache_len(S + max_new + k)
        cache = self._new_cache(T)
        kv_start, real_len, positions = self._prefill_inputs(pad_mask)
        logits = model(
            tokens, positions, cache, kv_start, torch.full((1,), S, device=dev), 0,
            last_logit_only=True,
        )
        tok0 = sample_token(logits[:, -1], sampling, gen)  # [1]
        done = self._isin_eos(tok0)  # [1]
        # out and hist carry k + 1 slack slots, so every scatter below has
        # unique lanes; hist mirrors cache slots: prompt at [0, S), emitted
        # token j at S + j
        out = torch.full((max_new + k + 1,), self.pad_id, dtype=i64, device=dev)
        out[:1] = tok0
        hist = torch.full((T + k + 1,), self.pad_id, dtype=i64, device=dev)
        hist[:S] = tokens[0].to(i64)
        hist[S : S + 1] = tok0
        idx = torch.arange(T + k + 1, device=dev)
        j_idx = torch.arange(k + 1, device=dev)
        lanes = j_idx[:k]
        lo = kv_start.to(i64) + (n - 1)  # [1]: the earliest candidate n-gram end
        e = torch.ones(1, dtype=i64, device=dev)  # tokens emitted
        iters = torch.zeros(1, dtype=i64, device=dev)
        fin = done | (e >= max_new)
        reader = _DoneReader(dev, max_new, DONE_LAG)
        reader.record(0, fin)
        states: Dict[int, torch.Tensor] = {}
        it = 0
        while it + 1 < max_new and not reader.ended():
            it += 1
            if sampled:
                states[it] = gen.get_state()
            with self._strict(), record_function("verify_forward"):
                live = ~fin
                wi = S + e - 1  # [1]: slot of the pending token
                # propose: the latest earlier occurrence of the trailing
                # n-gram whose k-token continuation is already written
                match = (idx >= lo) & (idx + k <= wi)
                for j in range(n):
                    match &= torch.roll(hist, j) == hist.index_select(0, wi - j)
                c_star = torch.where(match, idx, -1).amax(dim=0, keepdim=True)
                src = torch.where(c_star >= 0, c_star + 1, 0)
                props = hist.index_select(0, src + lanes)  # [k]
                fed = torch.cat([hist.index_select(0, wi), props])[None]  # [1, k + 1]
                # the k-slack keeps wi + k + 1 inside the cache
                slot = DeviceSlot(wi.to(torch.int32), wi + j_idx)
                logits = model(
                    fed, (real_len - 1 + e + j_idx)[None], cache, kv_start, wi + k + 1, slot, chunked=True,
                )[0]  # [k + 1, V]
                if not sampled:
                    g = torch.argmax(logits, dim=-1)
                    m = torch.cumprod((props == g[:k]).to(i64), 0).sum(0, keepdim=True)
                else:
                    # rejection sampling against the point-mass draft: accept
                    # x_j w.p. p_j(x_j); on rejection draw from p_j with x_j
                    # masked; on full acceptance draw the bonus from p_k
                    prepared = prepared_logits(logits, sampling)
                    probs = torch.softmax(prepared, dim=-1)
                    p_prop = probs[:k].gather(1, props[:, None])[:, 0]
                    u = torch.rand(k, generator=gen, device=dev)
                    res = prepared[:k].scatter(1, props[:, None], NEG_INF)
                    r = categorical(res, gen)
                    bonus = categorical(prepared[k], gen)
                    m = torch.cumprod((u < p_prop).to(i64), 0).sum(0, keepdim=True)
                    corr = torch.where(m < k, r.index_select(0, m.clamp(max=k - 1)), bonus)
                    g = torch.where(j_idx == m, corr, torch.cat([props, bonus[None]]))
                is_eos = self._isin_eos(g)
                eos_pos = torch.where(is_eos & (j_idx <= m), j_idx, k + 1).amin(dim=0, keepdim=True)
                m_eff = torch.minimum(torch.minimum(m, eos_pos), max_new - e - 1)
                emit = (j_idx <= m_eff) & live
                o_idx, h_idx = e + j_idx, wi + 1 + j_idx
                out[o_idx] = torch.where(emit, g, out[o_idx])
                hist[h_idx] = torch.where(emit, g, hist[h_idx])
                done = done | (live & (eos_pos <= m_eff))
                e = e + torch.where(live, m_eff + 1, 0)
                iters = iters + live.to(i64)
                fin = done | (e >= max_new)
                reader.record(it, fin)
        t = time.perf_counter()
        host = torch.cat([out[:max_new], iters]).cpu().numpy()  # the one fetch
        fetch_s = time.perf_counter() - t
        n_iters = int(host[max_new])
        self._close_loop(reader, it, n_iters, states, gen, fetch_s)
        return host[None, :max_new], n_iters

    @mesh_command
    @torch.inference_mode()
    def _device_run(
        self, tokens: torch.Tensor, pad_mask: torch.Tensor, S: int, max_new: int, chunk: Optional[int],
        spec: bool, gen: torch.Generator,
    ) -> Tuple[np.ndarray, int]:
        """One generate's device program: ``(token ids [B, max_new], verify
        forwards)``. The caller holds the run lock; on a mesh every rank runs
        it, from rank 0's prompt and generator state."""
        if spec:
            return self._run_spec(tokens, pad_mask, S, max_new, gen)
        return self._run_vanilla(tokens, pad_mask, S, max_new, chunk, gen), 0

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
            t_call = time.perf_counter()
            out, iters = self._device_run(tok_t, mask_t, S, max_new, chunk, spec, gen)
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
            t_call = time.perf_counter()
            out, iters = self._device_run(tokens, pad_mask, S, max_new, None, spec, gen)
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
        and no goodput window (JAX records none either). On a mesh it is a
        command like any generate, and takes the run lock: the auditor's
        thread never issues collectives beside a request's."""
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
        host = self._score_device(tokens, mask, nxt, chunk)
        lo = off + len(x) - W - 1  # the slot whose logits predict emitted[0]
        sl = slice(lo, lo + W)
        return {
            "argmax": host[sl, 0].astype(np.int64),
            "max_logit": host[sl, 1].astype(np.float64),
            "chosen_logit": host[sl, 2].astype(np.float64),
        }

    @mesh_command
    @torch.inference_mode()
    def _score_device(self, tokens: np.ndarray, mask: np.ndarray, nxt: np.ndarray, chunk: int) -> np.ndarray:
        """``score_exact``'s device program: ``[S, 3]`` (argmax, max logit,
        next token's logit) at every position; on a mesh every rank runs it
        under the stream's lock."""
        dev = self.device
        S = tokens.shape[1]
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
        return stats.cpu().numpy()

    # ------------------------------------------------------------------
    # KV prefix cache (engine/prefix_cache.py drives these)
    # ------------------------------------------------------------------
    def _prefix_capacity(self) -> int:
        return self.engine_config.prefix_cache.max_prefix_tokens

    def _prefix_planes(self, cache) -> Tuple[torch.Tensor, ...]:
        """A cache's planes in the prefix layout: ``(k, v)``, or ``(k, v,
        k_scale, v_scale)`` under int8 KV."""
        return (cache.k, cache.v) + ((cache.k_scale, cache.v_scale) if cache.quantized else ())

    def _new_cache(self, T: int, B: int = 1):
        """A fresh ``[L, B, K, T, hd]`` cache at this rank's kv heads."""
        return make_kv_cache(
            getattr(self.model, "local", self.config), B, T, self.dtypes.compute_dtype, self.device, self.engine_config.kv_quant
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
        t_call = time.perf_counter()
        out = self._prefixed_device(list(suffix_ids), prefix, max_new, gen)
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

    @mesh_command
    @torch.inference_mode()
    def _prefixed_device(self, suffix_ids: List[int], prefix, max_new: int, gen: torch.Generator) -> np.ndarray:
        """``generate_prefixed``'s device program (every rank of a mesh runs
        it, from rank 0's generator state): the prefixed prefill and the
        vanilla decode loop; the token ids ``[1, max_new]``."""
        with self._run_lock:
            logits, cache, total = self.prefill_prefixed(suffix_ids, prefix, max_new)
            pos0 = torch.full((1,), total, dtype=torch.int64, device=self.device)
            kv_start = torch.zeros(1, dtype=torch.int64, device=self.device)
            return self._decode_loop(cache, logits, kv_start, total, pos0, max_new, gen)

    # ------------------------------------------------------------------
    # the boot's warm set (JAX ``warmup``: the executables it compiles)
    # ------------------------------------------------------------------
    _WARM_TOKENS = 2

    def warmup(
        self,
        batch_sizes: Sequence[int] = (1,),
        buckets: Optional[Sequence[int]] = None,
    ) -> List[Tuple[int, int, object]]:
        """Run once each shape JAX's ``warmup`` compiles for these batch
        sizes and buckets, chosen from the static config, never from the
        acceptance EMA: batch 1 takes the speculative loop under
        ``prompt_lookup`` and ``auto``, and the vanilla one too under
        ``auto`` (it can fall back); a padded batch the vanilla loop. Eager
        PyTorch compiles nothing per shape; the first run of a shape is
        what warming buys here (the allocator's blocks, the kernels'
        first launches). Each runs ``_WARM_TOKENS`` tokens. Returns the
        ``(batch, bucket, variant)`` shapes run, ``variant`` None (vanilla)
        or ``"spec"``, as JAX keys its executables."""
        buckets = buckets or self.engine_config.prompt_buckets
        spec_mode = self.engine_config.speculative
        shapes: List[Tuple[int, int, object]] = []
        for b in batch_sizes:
            for s in buckets:
                mb = next_pow2(b)
                if mb == 1 and spec_mode in ("prompt_lookup", "auto"):
                    shapes.append((1, s, "spec"))
                    if spec_mode == "auto":
                        shapes.append((1, s, None))
                else:
                    shapes.append((mb, s, None))
        for shape in shapes:
            self.warm_shape(*shape)
        return shapes

    def warm_shape(self, B: int, S: int, variant=None) -> None:
        """One run of the device program at batch ``B`` and bucket ``S``
        (``variant``: None vanilla, ``"spec"`` speculative, or an int chunk
        width: a chunked prefill of ``S`` tokens), on a prompt of ``S`` BOS
        tokens, from a generator of its own: no stats, no EMA, no ledger
        and no draw from the engine's seed counter change."""
        spec, chunk = variant == "spec", variant if isinstance(variant, int) else None
        if chunk is not None:
            max_new = max(1, min(self._WARM_TOKENS, self.engine_config.max_seq_len - chunk))
        else:
            max_new = self._clamp_max_new(S, self._WARM_TOKENS)
        tokens = torch.full((B, S), self.config.bos_token_id, dtype=torch.int64, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        with self._run_lock:
            self._device_run(tokens, torch.ones_like(tokens), S, max_new, chunk, spec, gen)

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
