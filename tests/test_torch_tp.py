"""Tensor parallelism on ``torch.distributed`` (one process per rank, gloo on
the CPU) against the JAX package's tp mesh on its 8 virtual CPU devices and
against the port's own tp=1 engine, on the same tiny fp32 weights.

Each world is spawned once for the module (``parallel.launch.spawn_world``,
with a join timeout, so a deadlock fails instead of hanging) and runs every
case inside it; the test functions assert the cases one by one. Tolerance:
greedy tokens equal; logits within 1e-5 relative (RMS of the difference
over the RMS of the reference) in fp32.

Mirrors ``tests/test_engine.py`` ``TestShardedEngine`` and
``test_tp_mesh_keeps_unfused_layout``, ``tests/test_quant.py``
``TestQuantTP``, ``tests/test_fused_rag.py``
``test_single_fetch_serves_over_tp2_mesh`` and ``tests/test_checkpoint.py``
``test_sharded_restore``. The rank functions import nothing of JAX: the
spawned ranks import this module.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu_torch.core.config import (
    AppConfig,
    DTypePolicy,
    EncoderConfig,
    EngineConfig,
    LlamaConfig,
    MeshConfig,
    SamplingConfig,
    ShadowConfig,
)
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama, mask_window
from rag_llm_k8s_tpu_torch.parallel.commands import serve_commands
from rag_llm_k8s_tpu_torch.parallel.launch import spawn_world
from rag_llm_k8s_tpu_torch.parallel.sharding import llama_param_specs, shard_llama_params, shard_params

FP32 = DTypePolicy.fp32()
VOCAB = 300
REL = 1e-5  # fp32 logits: relative RMS error against the reference
# 8 query heads over 4 kv heads tile tp = 2 and 4; the EOS id is out of
# range, so every run goes to its token budget
TP_CFG = dataclasses.replace(LlamaConfig.tiny(VOCAB), num_heads=8, num_kv_heads=4, head_dim=8,
                             eos_token_ids=(VOCAB,))
# 4 over 2 do not tile tp = 4: attention stays replicated there
ODD_CFG = dataclasses.replace(LlamaConfig.tiny(VOCAB), eos_token_ids=(VOCAB,))
ENGINE = dict(prompt_buckets=(16, 32), max_batch_size=2)
MAX_NEW = 8
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [5, 3, 5]]
REPEAT = ([7, 21, 99, 4, 150, 33] * 4)[:22]  # prompt lookup has something to propose
LONG = [int(x) for x in np.random.default_rng(3).integers(3, VOCAB, 70)]  # past the 32 bucket: chunked
SCORE = ([3, 1, 4, 1, 5], [9, 2, 6, 5])
SEED = 11
TEXTS = ["alpha beta gamma", "delta epsilon", "zeta eta theta"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _engine(cfg, model, mesh=None, sampled=False, **kw):
    return InferenceEngine(
        cfg, model, SamplingConfig(max_new_tokens=MAX_NEW, do_sample=sampled, temperature=0.8, top_p=0.9),
        EngineConfig(**{**ENGINE, **kw}), FP32, "cpu", mesh=mesh,
    )


def _logits(model, tokens):
    """Prefill logits ``[B, S, V]`` of left-padded ``tokens`` (0 = pad)."""
    toks = torch.as_tensor(tokens)
    mask = (toks != 0).long()
    ks, _ = mask_window(mask)
    pos = (torch.cumsum(mask, -1) - 1).clamp_min(0)
    B, S = toks.shape
    from rag_llm_k8s_tpu_torch.models.llama import make_kv_cache

    cache = make_kv_cache(model.local, B, S, torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        return model(toks, pos, cache, ks, torch.full((B,), S), 0).numpy()


LOGIT_TOKENS = np.array([[0, 0, 3, 1, 4, 1, 5, 9], [7, 8, 9, 10, 11, 12, 13, 14]])


def _drive(ctx, engine, lead):
    """Rank 0 runs ``lead(engine)`` and stops the stream; every other rank
    follows, recording what each device program returned."""
    if ctx.leader:
        try:
            return lead(engine)
        finally:
            engine.commands.stop()
    runs = []
    real = engine._device_run
    engine._device_run = lambda *a: runs.append(real(*a)) or runs[-1]
    serve_commands(ctx)
    return [r[0].tolist() for r in runs]


def _one_shot(engine):
    out = {"greedy": engine.generate(PROMPTS), "long": engine.generate([LONG])}
    sc = engine.score_exact(*SCORE)
    out["score"] = {k: v.tolist() for k, v in sc.items()}
    return out


def _tp_rank(ctx, flat, qflat, oddflat, hf_dir, workdir):
    """Every case of a tp world, on every rank; rank 0's results plus each
    rank's view of the device programs it ran."""
    res = {}
    model = shard_llama_params(flat, ctx, TP_CFG, FP32, "cpu")
    res["logits"] = _logits(model, LOGIT_TOKENS)
    res["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    eng = _engine(TP_CFG, model, ctx)
    res["fused"] = eng.model.fused
    res["one_shot"] = _drive(ctx, eng, _one_shot)
    spec = _engine(TP_CFG, model, ctx, speculative="prompt_lookup")
    res["spec"] = _drive(ctx, spec, lambda e: (e.generate([REPEAT]), e.stats.spec_verify_steps))
    samp = _engine(TP_CFG, model, ctx, sampled=True)
    res["sampled"] = _drive(ctx, samp, lambda e: e.generate(PROMPTS, seed=SEED))
    try:
        _engine(TP_CFG, build_llama(TP_CFG, FP32, "cpu", fused=True, mesh=ctx), ctx)
        res["fused_refused"] = False
    except ValueError:
        res["fused_refused"] = True
    # int8: a quantized JAX tree sharded, and the engine quantizing a
    # sharded bf16 model (row-parallel scales completed over tp)
    qmodel = shard_llama_params(qflat, ctx, TP_CFG, FP32, "cpu")
    res["q8_logits"] = _logits(qmodel, LOGIT_TOKENS)
    res["q8_tree"] = _drive(ctx, _engine(TP_CFG, qmodel, ctx, weight_quant="int8"), lambda e: e.generate(PROMPTS))
    qeng = _engine(TP_CFG, model, ctx, weight_quant="int8")
    res["q8_scales"] = {n: p.numpy().copy() for n, p in qeng.model.named_parameters() if n.endswith(".scale")}
    res["q8_engine"] = _drive(ctx, qeng, lambda e: e.generate(PROMPTS))
    if ctx.tp == 4:
        odd = shard_llama_params(oddflat, ctx, ODD_CFG, FP32, "cpu")
        res["odd_logits"] = _logits(odd, LOGIT_TOKENS)
        res["odd_shapes"] = {n: tuple(p.shape) for n, p in odd.named_parameters()}
        res["odd"] = _drive(ctx, _engine(ODD_CFG, odd, ctx), lambda e: e.generate(PROMPTS))
    # the converted-parameter cache: one file per rank, keyed by the mesh
    from rag_llm_k8s_tpu_torch.models.checkpoint import cache_location, restore_params, save_params

    d, fname = cache_location(workdir, "bf16", ctx)
    save_params(d, model, fname)
    back = restore_params(d, build_llama(TP_CFG, FP32, "cpu", mesh=ctx), fname)
    res["cache"] = dict(dir=os.path.relpath(d, workdir), file=fname, same=all(
        torch.equal(a, b) for a, b in zip(model.parameters(), back.parameters())))
    try:
        restore_params(d, build_llama(TP_CFG, FP32, "cpu"), fname)
        res["cache"]["tp1_template_refused"] = False
    except ValueError:
        res["cache"]["tp1_template_refused"] = True
    # the HF loader through the streaming put, bf16 and int8
    from rag_llm_k8s_tpu_torch.models.loader import load_safetensors_params

    for quant in ("bf16", "int8"):
        m = load_safetensors_params(hf_dir, TP_CFG, FP32, "cpu", quant=quant, mesh=ctx)
        res[f"loaded_{quant}"] = {n: p.numpy().copy() for n, p in m.named_parameters()}
    if ctx.tp == 2:
        res["service"] = _service_case(ctx, model)
    return res


def _service_case(ctx, model):
    """The fused single-fetch service over the tp=2 engine (rank 0), the
    followers running its commands."""
    from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
    from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
    from rag_llm_k8s_tpu_torch.index.store import VectorStore
    from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
    from rag_llm_k8s_tpu_torch.server.app import RagService, create_app

    eng = _engine(TP_CFG, model, ctx, prompt_buckets=(256,))
    if not ctx.leader:
        serve_commands(ctx)
        return None
    svc = _service(eng)
    try:
        out = {"answer": svc.answer("alpha beta")["generated_text"],
               "single_fetch": svc.metrics.snapshot().get("query_single_fetch")}
        client = create_app(svc).test_client()
        out["healthz"] = client.get("/healthz").get_json()
        out["heartbeat"] = eng.commands.heartbeat()
        text = client.get("/metrics").get_data(as_text=True)
        out["hbm_children"] = sorted(line.split(" ")[0] for line in text.splitlines()
                                     if line.startswith("rag_device_hbm_bytes_in_use{"))
    finally:
        svc.shutdown()  # sends stop: the followers return
    out["ready_after_stop"] = eng.commands.ready()
    return out


def _service(engine):
    """A fused-path service over ``engine`` with the three texts ingested
    (the encoder's weights from seed 1, as on the meshless side)."""
    from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
    from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
    from rag_llm_k8s_tpu_torch.index.store import VectorStore
    from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
    from rag_llm_k8s_tpu_torch.server.app import RagService

    ec = EncoderConfig.tiny(VOCAB)
    enc = convert.init_random_(build_encoder(ec, FP32, torch.device("cpu")), torch.Generator().manual_seed(1))
    encoder = EncoderRunner(ec, enc, device="cpu", length_buckets=(32,), max_batch=4)
    store = VectorStore(dim=ec.hidden_size, device="cpu")
    svc = RagService(AppConfig(model=TP_CFG, encoder=ec, system_message="SYS", shadow=ShadowConfig(sample_rate=0.0)),
                     engine, _Bytes(), encoder, _Bytes(), store, scheduler=BatchScheduler(engine, max_wait_ms=20.0))
    svc.ready = True
    vecs = encoder.encode([_Bytes().encode(t) for t in TEXTS])
    store.add(list(vecs), [{"filename": "f", "chunk_id": i, "text": t} for i, t in enumerate(TEXTS)])
    return svc


class _Bytes:
    """Reversible byte-level stub tokenizer (ids = byte + 3)."""

    def encode(self, text):
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        return bytes((i - 3) % 256 for i in ids if i >= 3).decode("utf-8", "replace")


# ---------------------------------------------------------------------------
# the reference side (this process): JAX's tp mesh and the port at tp = 1
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import jax

    from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
    from rag_llm_k8s_tpu.models.llama import init_llama_params, quantize_llama_params

    jfp32 = JDTypes.fp32()
    params = init_llama_params(jax.random.PRNGKey(0), _jcfg(TP_CFG), jfp32)
    odd = init_llama_params(jax.random.PRNGKey(1), _jcfg(ODD_CFG), jfp32)
    flat = convert.flatten_tree(params)
    qflat = convert.flatten_tree(quantize_llama_params(params))
    hf_dir = str(tmp_path_factory.mktemp("hf"))
    _write_hf(flat, hf_dir)
    return dict(params=params, odd=odd, flat=flat, qflat=qflat, oddflat=convert.flatten_tree(odd), hf_dir=hf_dir)


def _jcfg(cfg):
    from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig

    return JLlamaConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _write_hf(flat, d):
    """The TP_CFG weights as an HF safetensors checkpoint ([out, in])."""
    from rag_llm_k8s_tpu_torch.utils.safetensors_io import save_file

    sd = convert.llama_state_dict(flat, TP_CFG.num_layers)
    hf = {"model.embed_tokens.weight": sd["embed.weight"], "model.norm.weight": sd["final_norm.weight"],
          "lm_head.weight": sd["lm_head.weight"]}
    names = {"attn.wq": "self_attn.q_proj", "attn.wk": "self_attn.k_proj", "attn.wv": "self_attn.v_proj",
             "attn.wo": "self_attn.o_proj", "mlp.w_gate": "mlp.gate_proj", "mlp.w_up": "mlp.up_proj",
             "mlp.w_down": "mlp.down_proj", "input_norm": "input_layernorm",
             "post_attn_norm": "post_attention_layernorm"}
    for i in range(TP_CFG.num_layers):
        for port, h in names.items():
            hf[f"model.layers.{i}.{h}.weight"] = sd[f"layers.{i}.{port}.weight"]
    save_file({k: torch.from_numpy(np.array(v)) for k, v in hf.items()},
              os.path.join(d, "model-00001-of-00001.safetensors"))


def _port_model(flat, cfg=TP_CFG):
    model = build_llama(cfg, FP32, torch.device("cpu"), quantized=convert.llama_is_quantized(flat))
    return convert.load_llama(model, flat)


@pytest.fixture(scope="module")
def tp1(ref):
    """The port's meshless results on the same weights."""
    model = _port_model(ref["flat"])
    out = {"logits": _logits(model, LOGIT_TOKENS), "one_shot": _one_shot(_engine(TP_CFG, model))}
    spec = _engine(TP_CFG, model, speculative="prompt_lookup")
    out["spec"] = (spec.generate([REPEAT]), spec.stats.spec_verify_steps)
    out["sampled"] = _engine(TP_CFG, model, sampled=True).generate(PROMPTS, seed=SEED)
    qmodel = _port_model(ref["qflat"])
    out["q8_logits"] = _logits(qmodel, LOGIT_TOKENS)
    out["q8_tree"] = _engine(TP_CFG, qmodel, weight_quant="int8").generate(PROMPTS)
    # unfused, as a tp engine serves it, so the scales line up name by name
    qeng = _engine(TP_CFG, _port_model(ref["flat"]), weight_quant="int8", fuse_matmuls=False)
    out["q8_scales"] = {n: p.numpy().copy() for n, p in qeng.model.named_parameters() if n.endswith(".scale")}
    out["q8_engine"] = qeng.generate(PROMPTS)
    odd = _port_model(ref["oddflat"], ODD_CFG)
    out["odd_logits"] = _logits(odd, LOGIT_TOKENS)
    out["odd"] = _engine(ODD_CFG, odd).generate(PROMPTS)
    svc = _service(_engine(TP_CFG, _port_model(ref["flat"]), prompt_buckets=(256,)))
    try:
        out["answer"] = svc.answer("alpha beta")["generated_text"]
    finally:
        svc.shutdown()
    from rag_llm_k8s_tpu_torch.models.loader import load_safetensors_params

    out["loaded"] = {q: load_safetensors_params(ref["hf_dir"], TP_CFG, FP32, "cpu", quant=q)
                     for q in ("bf16", "int8")}
    return out


@pytest.fixture(scope="module")
def jax_tp(ref, devices8):
    """The JAX engine's greedy tokens on its tp meshes and its logits."""
    import jax.numpy as jnp

    from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
    from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
    from rag_llm_k8s_tpu.core.config import MeshConfig as JMeshConfig
    from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
    from rag_llm_k8s_tpu.core.mesh import make_mesh
    from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
    from rag_llm_k8s_tpu.models.llama import LlamaModel as JLlamaModel
    from rag_llm_k8s_tpu.models.llama import make_kv_cache as jcache
    from rag_llm_k8s_tpu.models.llama import quantize_llama_params
    from rag_llm_k8s_tpu.parallel.sharding import shard_llama_params as jshard

    jfp32 = JDTypes.fp32()
    out = {}
    toks = jnp.asarray(LOGIT_TOKENS, jnp.int32)
    mask = (toks != 0).astype(jnp.int32)
    ks = jnp.argmax(mask, axis=-1).astype(jnp.int32)
    pos = jnp.maximum(jnp.cumsum(mask, -1) - 1, 0)
    B, S = LOGIT_TOKENS.shape
    for name, params, cfg in (("logits", ref["params"], TP_CFG), ("odd_logits", ref["odd"], ODD_CFG)):
        lg, _ = JLlamaModel(_jcfg(cfg), jfp32, attn_impl="xla").apply(
            {"params": params}, toks, pos, jcache(_jcfg(cfg), B, S, jnp.float32), ks, jnp.full((B,), S, jnp.int32),
            jnp.int32(0))
        out[name] = np.asarray(lg)
    for tp in (2, 4):
        ctx = make_mesh(JMeshConfig(dp=1, sp=1, tp=tp), devices=devices8[:tp])
        samp = JSampling(do_sample=False, max_new_tokens=MAX_NEW)
        ec = JEngineConfig(**ENGINE)
        out[("greedy", tp)] = JEngine(_jcfg(TP_CFG), jshard(ref["params"], ctx), sampling=samp, engine_config=ec,
                                      dtypes=jfp32, mesh=ctx).generate(PROMPTS)
        out[("q8", tp)] = JEngine(_jcfg(TP_CFG), jshard(quantize_llama_params(ref["params"]), ctx), sampling=samp,
                                  engine_config=JEngineConfig(**ENGINE, weight_quant="int8"), dtypes=jfp32,
                                  mesh=ctx).generate(PROMPTS)
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """Both worlds, started at once and run beside the reference fixtures
    (``tp1``, ``jax_tp``): ``worlds[tp]`` waits for its world's results."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=2)
    futures, work = {}, {}
    for tp in (2, 4):
        work[tp] = str(tmp_path_factory.mktemp(f"tp{tp}"))
        futures[tp] = pool.submit(spawn_world, _tp_rank, MeshConfig(tp=tp), device="cpu", timeout_s=60,
                                  args=(ref["flat"], ref["qflat"], ref["oddflat"], ref["hf_dir"], work[tp]),
                                  join_timeout_s=300)
    pool.shutdown(wait=False)

    class _Worlds(dict):
        def __missing__(self, tp):
            res = futures[tp].result()
            res[0]["workdir"] = work[tp]
            self[tp] = res
            return res

    return _Worlds()


TPS = [2, 4]


@pytest.mark.parametrize("tp", TPS)
def test_prefill_logits_match_jax_and_tp1(worlds, tp1, jax_tp, tp):
    got = worlds[tp][0]["logits"]
    assert got.shape == (2, 8, VOCAB)
    assert _rel(got, tp1["logits"]) < REL
    assert _rel(got, jax_tp["logits"]) < REL


@pytest.mark.parametrize("tp", TPS)
def test_greedy_tokens_match_jax_tp_mesh_and_tp1(worlds, tp1, jax_tp, tp):
    got = worlds[tp][0]["one_shot"]["greedy"]
    assert got == tp1["one_shot"]["greedy"] == jax_tp[("greedy", tp)]


@pytest.mark.parametrize("tp", TPS)
def test_every_rank_ran_the_same_programs(worlds, tp):
    """A follower's device programs return rank 0's tokens: the command
    carried the prompt, the budget and the generator state."""
    lead = worlds[tp][0]
    for r in range(1, tp):
        runs = worlds[tp][r]
        # the batch, then the chunked long prompt (score_exact is a program of its own)
        assert len(runs["one_shot"]) == 2
        assert runs["one_shot"][0] == lead["one_shot"]["greedy"]
        assert runs["one_shot"][1] == lead["one_shot"]["long"]
        assert runs["sampled"][0] == lead["sampled"]


@pytest.mark.parametrize("tp", TPS)
def test_chunked_long_prompt_matches_tp1(worlds, tp1, tp):
    assert worlds[tp][0]["one_shot"]["long"] == tp1["one_shot"]["long"]


@pytest.mark.parametrize("tp", TPS)
def test_prompt_lookup_verify_matches_tp1(worlds, tp1, tp):
    got, iters = worlds[tp][0]["spec"]
    assert iters > 0
    assert (got, iters) == tuple(tp1["spec"])


@pytest.mark.parametrize("tp", TPS)
def test_sampled_draws_match_tp1_given_the_seed(worlds, tp1, tp):
    assert worlds[tp][0]["sampled"] == tp1["sampled"]


@pytest.mark.parametrize("tp", TPS)
def test_shadow_score_exact_matches_tp1(worlds, tp1, tp):
    got, want = worlds[tp][0]["one_shot"]["score"], tp1["one_shot"]["score"]
    assert got["argmax"] == want["argmax"]
    for k in ("max_logit", "chosen_logit"):
        np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=REL)


@pytest.mark.parametrize("tp", TPS)
def test_tp_keeps_the_unfused_layout_and_refuses_a_fused_tree(worlds, tp):
    res = worlds[tp][0]
    assert res["fused"] is False and res["fused_refused"] is True
    shapes = res["shapes"]
    assert shapes["layers.0.attn.wq.weight"] == (TP_CFG.num_heads * TP_CFG.head_dim // tp, TP_CFG.hidden_size)
    assert shapes["layers.0.attn.wo.weight"] == (TP_CFG.hidden_size, TP_CFG.num_heads * TP_CFG.head_dim // tp)
    assert shapes["embed.weight"] == (VOCAB // tp, TP_CFG.hidden_size)
    assert shapes["layers.0.mlp.w_down.weight"] == (TP_CFG.hidden_size, TP_CFG.intermediate_size // tp)


@pytest.mark.parametrize("tp", TPS)
def test_int8_tree_on_tp_matches_jax_and_tp1(worlds, tp1, jax_tp, tp):
    res = worlds[tp][0]
    assert _rel(res["q8_logits"], tp1["q8_logits"]) < REL
    assert res["q8_tree"] == tp1["q8_tree"] == jax_tp[("q8", tp)]


@pytest.mark.parametrize("tp", TPS)
def test_int8_quantized_on_the_mesh_equals_the_whole_models_slices(worlds, tp1, tp):
    """Row-parallel scales are completed over tp, so every rank's scales
    are the tp=1 quantizer's, sliced."""
    from rag_llm_k8s_tpu_torch.core.mesh import MeshContext

    ctx = MeshContext(1, 1, tp, rank=0)
    want = shard_params(tp1["q8_scales"], llama_param_specs(TP_CFG, ctx, quantized=True), ctx)
    got = worlds[tp][0]["q8_scales"]
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_array_equal(got[n], w)
    assert worlds[tp][0]["q8_engine"] == tp1["q8_engine"]


def test_undividable_heads_run_replicated_on_tp4(worlds, tp1, jax_tp):
    res = worlds[4][0]
    assert res["odd_shapes"]["layers.0.attn.wk.weight"] == (ODD_CFG.num_kv_heads * ODD_CFG.head_dim,
                                                             ODD_CFG.hidden_size)
    assert res["odd_shapes"]["layers.0.mlp.w_up.weight"] == (ODD_CFG.intermediate_size // 4, ODD_CFG.hidden_size)
    assert _rel(res["odd_logits"], tp1["odd_logits"]) < REL
    assert _rel(res["odd_logits"], jax_tp["odd_logits"]) < REL
    assert res["odd"] == tp1["odd"]


@pytest.mark.parametrize("tp", TPS)
def test_sharded_restore_reads_only_its_own_mesh_and_rank(worlds, tp):
    cache = worlds[tp][0]["cache"]
    assert cache["same"] and cache["tp1_template_refused"]
    assert cache["dir"] == f"tpu_rag_param_cache_mesh1x1x{tp}" and cache["file"] == "params.rank0.safetensors"
    files = sorted(os.listdir(os.path.join(worlds[tp][0]["workdir"], cache["dir"])))
    assert files == [f"params.rank{r}.safetensors" for r in range(tp)]


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("tp", TPS)
def test_streaming_put_loads_the_slices_of_the_whole_checkpoint(worlds, tp1, tp, quant):
    from rag_llm_k8s_tpu_torch.core.mesh import MeshContext

    whole = {n: p.numpy() for n, p in tp1["loaded"][quant].named_parameters()}
    ctx = MeshContext(1, 1, tp, rank=0)
    want = shard_params(whole, llama_param_specs(TP_CFG, ctx, quantized=quant == "int8"), ctx)
    got = worlds[tp][0][f"loaded_{quant}"]
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


def test_fused_service_on_tp2_answers_as_the_meshless_one(worlds, tp1):
    res = worlds[2][0]["service"]
    assert res["answer"] == tp1["answer"]
    assert res["single_fetch"] == 1


def test_mesh_health_heartbeat_and_device_gauges(worlds):
    res = worlds[2][0]["service"]
    hz = res["healthz"]
    assert hz["ready"] is True and hz["followers_ready"] is True
    assert hz["mesh"] == {"dp": 1, "sp": 1, "tp": 2}
    assert sorted(res["heartbeat"]) == [0, 1]
    assert res["hbm_children"] == ['rag_device_hbm_bytes_in_use{device="0",rank="0"}',
                                   'rag_device_hbm_bytes_in_use{device="0",rank="1"}']
    assert res["ready_after_stop"] is False


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_init_random_sharded_keeps_the_slices_of_the_seeded_fused_model(tp):
    """``chip_smoke.py``'s mesh ranks draw ``init_random_``'s fused model a
    tensor at a time and keep their slice: each rank's shard equals the
    whole model's, unfused and sliced."""
    from rag_llm_k8s_tpu_torch.core.mesh import MeshContext

    full = convert.init_random_(build_llama(TP_CFG, FP32, torch.device("cpu"), fused=True),
                                torch.Generator().manual_seed(0))
    whole = {n2: t for n, p in full.named_parameters() for n2, t in convert._unfused(n, p, TP_CFG)}
    for r in range(tp):
        ctx = MeshContext(1, 1, tp, rank=r)
        got = convert.init_random_sharded(TP_CFG, FP32, ctx, torch.Generator().manual_seed(0), fused_source=True)
        want = shard_params(whole, llama_param_specs(TP_CFG, ctx), ctx)
        assert {n: tuple(p.shape) for n, p in got.named_parameters()} == {n: tuple(w.shape) for n, w in want.items()}
        for n, p in got.named_parameters():
            assert torch.equal(p, want[n]), n
