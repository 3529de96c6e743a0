"""The port's mesh on ``torch.distributed`` against the JAX package's
(mirrors ``tests/test_core.py`` ``TestMesh``): ``MeshConfig`` and
``TPU_RAG_MESH`` parse as JAX parses them, rank ``r`` sits where JAX's
``make_mesh`` puts device ``r``, the collectives a sharded matmul needs give
the unsharded result, and the launcher fails a world that raises or hangs
instead of waiting on it. ``server.main`` under ``TPU_RAG_MESH=tp=2`` boots
a tiny staged directory on the CPU with its follower, answers, and drains
on SIGTERM.

The worlds (gloo, on the CPU) are spawned once for the module, side by
side, with join timeouts; the test functions assert their cases one by
one. Tolerance: fp32 products within 1e-5 relative (RMS), collectives of
integers exact.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu_torch.core.config import AppConfig, EncoderConfig, LlamaConfig, MeshConfig
from rag_llm_k8s_tpu_torch.core.mesh import axis_lines, make_mesh, single_device_mesh
from rag_llm_k8s_tpu_torch.parallel.launch import spawn_world

REL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


# ---------------------------------------------------------------------------
# config and layout, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,n", [((2, 1, -1), 8), ((1, 1, -1), 8), ((1, 2, 2), 4), ((3, 1, -1), 8),
                                    ((1, 1, 2), 4)])
def test_resolved_matches_jax(mesh, n):
    from rag_llm_k8s_tpu.core.config import MeshConfig as JMeshConfig

    dp, sp, tp = mesh
    try:
        want = JMeshConfig(dp=dp, sp=sp, tp=tp).resolved(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshConfig(dp=dp, sp=sp, tp=tp).resolved(n)
        assert str(got.value) == str(e)
        return
    assert MeshConfig(dp=dp, sp=sp, tp=tp).resolved(n) == want
    assert MeshConfig(dp=dp, sp=sp, tp=tp).world(n) == int(np.prod(want))


@pytest.mark.parametrize("spec", ["tp=8", "dp=2,tp=4", "sp=2,tp=2", "tp=-1", "dp=2,sp=1,tp=1", "bogus", "tp=x"])
def test_tpu_rag_mesh_parses_as_jax_parses_it(spec):
    from rag_llm_k8s_tpu.core.config import AppConfig as JAppConfig

    env = {"TPU_RAG_MESH": spec}
    try:
        want = JAppConfig.from_env(env).mesh
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            AppConfig.from_env(env)
        assert str(got.value) == str(e)
        return
    got = AppConfig.from_env(env).mesh
    assert (got.dp, got.sp, got.tp, got.axis_names) == (want.dp, want.sp, want.tp, want.axis_names)


def test_a_tp_mesh_serves_the_one_shot_engine_with_coalesce_batching():
    cfg = AppConfig.from_env({"TPU_RAG_MESH": "tp=2", "TPU_RAG_BATCHING": "coalesce", "TPU_RAG_FUSED": "1",
                              "TPU_RAG_WEIGHT_QUANT": "int8"})
    assert cfg.mesh.world(1) == 2 and cfg.engine.batching == "coalesce"


@pytest.mark.parametrize("env", [
    {"TPU_RAG_BATCHING": "continuous"}, {"TPU_RAG_KV_PAGED": "1"},
    {"TPU_RAG_KV_PAGED": "1", "TPU_RAG_POOL_ROLE": "decode"}, {"TPU_RAG_KV_QUANT": "int8"},
    {"TPU_RAG_PREFIX_CACHE": "1"},
])
def test_what_item_10b_ports_still_raises_on_a_mesh(env):
    """What raised on a mesh before item 10b was ported now parses on
    ``dp=1,tp=2`` and builds rank 0's tp = 2 engines (the one-shot engine
    and the continuous engine, whose cache holds K/tp kv heads); building
    reaches no collective, so rank 0's mesh context stands alone."""
    from rag_llm_k8s_tpu_torch.core.config import DTypePolicy
    from rag_llm_k8s_tpu_torch.core.mesh import MeshContext
    from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
    from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
    from rag_llm_k8s_tpu_torch.models.llama import build_llama

    cfg = AppConfig.from_env({"TPU_RAG_MESH": "dp=1,tp=2", **env})
    assert cfg.mesh.world(1) == 2
    AppConfig.from_env(env)  # one device: served
    ctx = MeshContext(1, 1, 2, rank=0, device=torch.device("cpu"))
    lc, fp32 = LlamaConfig.tiny(64), DTypePolicy.fp32()
    model = build_llama(lc, fp32, "cpu", mesh=ctx)
    ec = dataclasses.replace(cfg.engine, max_seq_len=256, prompt_buckets=(64, 128),
                             prefix_cache=dataclasses.replace(cfg.engine.prefix_cache, max_prefix_tokens=64))
    one = InferenceEngine(lc, model, cfg.sampling, ec, fp32, "cpu", mesh=ctx)
    assert one.commands is not None and (one.prefix_cache is not None) == (env.get("TPU_RAG_PREFIX_CACHE") == "1")
    cont = ContinuousEngine(lc, one.model, cfg.sampling, ec, fp32, "cpu", mesh=ctx)
    assert cont._commands is one.commands  # one stream per mesh
    planes = cont._cache_planes(cont.arena if cont.paged else None)
    assert planes[0].shape[2] == lc.num_kv_heads // 2 and len(planes) == (4 if ec.kv_quant == "int8" else 2)


def test_validate_tp_layout_is_jax_rule():
    from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig

    from rag_llm_k8s_tpu_torch.core.config import EngineConfig

    for paged, tp, k in ((True, 4, 8), (True, 3, 8), (False, 3, 8), (True, 1, 3)):
        try:
            JEngineConfig(kv_paged=paged).validate_tp_layout(tp, k)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                EngineConfig(kv_paged=paged).validate_tp_layout(tp, k)
            assert str(got.value) == str(e)
        else:
            EngineConfig(kv_paged=paged).validate_tp_layout(tp, k)


@pytest.mark.parametrize("shape", [(2, 1, 4), (1, 2, 4), (2, 2, 2), (1, 1, 8)])
def test_rank_layout_matches_jax_make_mesh(devices8, shape):
    """Rank r of the port's mesh holds the coordinate of device r in JAX's
    mesh, so its groups are JAX's axis lines."""
    from rag_llm_k8s_tpu.core.config import MeshConfig as JMeshConfig
    from rag_llm_k8s_tpu.core.mesh import make_mesh as jmake_mesh

    dp, sp, tp = shape
    jm = jmake_mesh(JMeshConfig(dp=dp, sp=sp, tp=tp), devices=devices8)
    ids = np.vectorize(lambda d: d.id)(jm.mesh.devices)
    order = {int(d): i for i, d in enumerate(sorted(ids.ravel()))}
    ranks = np.vectorize(order.get)(ids)
    lines = axis_lines(dp, sp, tp)
    assert lines["tp"] == [ranks[d, s, :].tolist() for d in range(dp) for s in range(sp)]
    assert lines["sp"] == [ranks[d, :, t].tolist() for d in range(dp) for t in range(tp)]
    assert lines["dp"] == [ranks[:, s, t].tolist() for s in range(sp) for t in range(tp)]


def test_single_device_mesh():
    ctx = single_device_mesh("cpu")
    assert ctx.n_devices == 1 and ctx.tp == 1 and ctx.leader
    x = torch.arange(4.0)
    assert ctx.all_reduce(x) is x and ctx.all_gather(x, 0) is x and ctx.ring_shift((x,), "sp")[0] is x
    assert ctx.broadcast_object({"a": 1}) == {"a": 1} and ctx.gather_object(3) == [3]
    # without an initialized process group, make_mesh is the single-device mesh
    assert make_mesh(MeshConfig(), device="cpu").n_devices == 1


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

D, N, F = 16, 6, 12


def _mats():
    r = np.random.default_rng(0)
    return tuple(r.standard_normal(s).astype(np.float32) for s in ((N, D), (F, D), (D, F)))


def _collectives(ctx):
    """dp=2 x tp=2 (the launcher's mesh) and sp=2 x tp=2 over the same four
    ranks: coordinates, groups, and the collectives of the tp layers."""
    out = {"coords": ctx.coords, "groups": {a: ctx.group_ranks.get(a) for a in ("dp", "sp", "tp")}}
    x, w_up, w_down = (torch.from_numpy(a) for a in _mats())
    t = ctx.axis_index("tp")
    # column parallel (this rank's output features), then all-gather
    cols = w_up[t * F // 2:(t + 1) * F // 2]
    out["column"] = ctx.all_gather(x @ cols.T, dim=-1, axis="tp").numpy()
    # row parallel (this rank's input features), then all-reduce
    rows = w_down[:, t * F // 2:(t + 1) * F // 2]
    h = x @ w_up.T
    out["row"] = ctx.all_reduce((h[:, t * F // 2:(t + 1) * F // 2] @ rows.T).contiguous(), "tp").numpy()
    out["max"] = ctx.all_reduce(torch.tensor([float(ctx.rank)]), "tp", op="max").item()
    out["dp_sum"] = ctx.all_reduce(torch.tensor([ctx.rank]), "dp").item()
    sp = make_mesh(MeshConfig(dp=1, sp=2, tp=2), device="cpu", timeout_s=30)
    out["sp_coords"] = sp.coords
    out["sp_groups"] = {a: sp.group_ranks.get(a) for a in ("dp", "sp", "tp")}
    shifted, flag = sp.ring_shift((torch.full((3,), float(sp.rank)), torch.tensor([sp.rank % 2 == 0])), "sp")
    out["ring"] = (shifted.tolist(), flag.tolist())
    out["gathered_sp"] = sp.all_gather(torch.tensor([[sp.rank]]), dim=0, axis="sp").ravel().tolist()
    out["objects"] = ctx.broadcast_object({"from": ctx.rank} if ctx.leader else None)
    out["gather"] = ctx.gather_object(ctx.rank * 10)
    ctx.barrier(30)
    return out


def _raises(ctx):
    if ctx.rank == 1:
        raise RuntimeError("planted failure on rank 1")
    return ctx.rank


def _hangs(ctx):
    if ctx.rank == 1:
        time.sleep(600)
    return ctx.rank


# server.main on the CPU with every rank there and the tiny configs
MAIN = """
import dataclasses
from rag_llm_k8s_tpu_torch.core.config import AppConfig, DTypePolicy, EncoderConfig, RetrievalConfig
from rag_llm_k8s_tpu_torch.server import main as m

m.main(dataclasses.replace(AppConfig.from_env(), dtypes=DTypePolicy.fp32(), encoder=EncoderConfig.tiny(512),
                           retrieval=RetrievalConfig(embed_dim=32)), device="cpu")
"""


def _pdf(text):
    content = f"BT /F1 12 Tf ({text}) Tj ET".encode()
    return b"".join([
        b"%PDF-1.4\n", b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n",
        b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj\n",
        b"3 0 obj << /Type /Page /Parent 2 0 R /Contents 4 0 R /Resources << /Font << /F1 5 0 R >> >> >> endobj\n",
        b"4 0 obj << /Length %d >> stream\n%s\nendstream endobj\n" % (len(content), content),
        b"5 0 obj << /Type /Font /Subtype /Type1 /BaseFont /Helvetica >> endobj\n", b"%%EOF",
    ])


def _staged(root):
    """A tiny staged directory (the ``staged`` fixture of
    ``tests/test_torch_main.py``)."""
    from rag_llm_k8s_tpu_torch.utils import synth

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizers")
    lc = LlamaConfig.tiny(512)
    synth.write_synth_checkpoint(root, lc, n_shards=2, seed=3)
    synth.write_hf_config(root, lc)
    shutil.copy(os.path.join(fixtures, "bpe_multi.json"), os.path.join(root, "tokenizer.json"))
    enc_dir = os.path.join(root, "bge-m3")
    synth.write_synth_encoder(enc_dir, EncoderConfig.tiny(512), seed=4)
    shutil.copy(os.path.join(fixtures, "unigram_norm.json"), os.path.join(enc_dir, "tokenizer.json"))
    os.makedirs(os.path.join(root, "pdfs"))
    for i, text in enumerate(["flash attention kernels tile queries and keys in shared memory",
                              "retrieval ranks chunk embeddings by squared distance"]):
        with open(os.path.join(root, "pdfs", f"doc{i}.pdf"), "wb") as f:
            f.write(_pdf(text))


def _serve_main_on_a_mesh(root):
    """Boot, /healthz, one /query, SIGTERM; returns what it saw."""
    from rag_llm_k8s_tpu_torch.parallel.launch import free_port

    _staged(root)
    port = free_port()
    env = {**os.environ, "MODEL_PATH": root, "TPU_RAG_PDF_DIR": os.path.join(root, "pdfs"), "TPU_RAG_PORT": str(port),
           "TPU_RAG_LOG_LEVEL": "INFO", "TPU_RAG_MAX_NEW_TOKENS": "8", "TPU_RAG_DO_SAMPLE": "0",
           "TPU_RAG_MESH": "tp=2", "TPU_RAG_BATCHING": "coalesce", "TPU_RAG_FUSED": "1", "TPU_RAG_SHADOW": "0"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log_path = os.path.join(root, "main.log")

    def http(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())

    out = {}
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", MAIN], env=env, cwd=repo, stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        t_end = time.monotonic() + 150
        while time.monotonic() < t_end and proc.poll() is None:
            try:
                code, hz = http("/healthz")
                if hz.get("status") == "ok":
                    out["healthz"] = hz
                    break
            except OSError:
                pass
            time.sleep(0.5)
        if "healthz" in out:
            out["query"] = http("/query", {"prompt": "what do kernels tile?"})
            out["cache"] = sorted(os.listdir(os.path.join(root, "tpu_rag_param_cache_mesh1x1x2")))
            proc.send_signal(signal.SIGTERM)
            out["rc"] = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        out["log"] = f.read()
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds and the server.main boot at once; each world entry
    is ``("ok", results)`` or ``("error", exception, seconds)``."""
    from concurrent.futures import ThreadPoolExecutor

    def run(fn, cfg, join):
        t = time.monotonic()
        try:
            return ("ok", spawn_world(fn, cfg, device="cpu", timeout_s=30, join_timeout_s=join))
        except Exception as e:  # noqa: BLE001 — the failure cases return theirs
            return ("error", e, time.monotonic() - t)

    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = {
            "collectives": pool.submit(run, _collectives, MeshConfig(dp=2, sp=1, tp=2), 120),
            "raises": pool.submit(run, _raises, MeshConfig(tp=2), 120),
            "hangs": pool.submit(run, _hangs, MeshConfig(tp=2), 25),
            "main": pool.submit(_serve_main_on_a_mesh, str(tmp_path_factory.mktemp("staged_mesh"))),
        }
        return {k: f.result() for k, f in futs.items()}


def _ok(worlds):
    kind, res = worlds["collectives"][:2]
    assert kind == "ok", res
    return res


def test_make_mesh_shapes_and_groups(worlds):
    res = _ok(worlds)
    assert [r["coords"] for r in res] == [(0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]
    assert res[0]["groups"] == {"dp": [0, 2], "sp": None, "tp": [0, 1]}
    assert res[3]["groups"] == {"dp": [1, 3], "sp": None, "tp": [2, 3]}
    assert [r["sp_coords"] for r in res] == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    assert res[1]["sp_groups"] == {"dp": None, "sp": [1, 3], "tp": [0, 1]}


def test_sharded_matmul_over_tp_matches_unsharded(worlds):
    x, w_up, w_down = _mats()
    for r in _ok(worlds):
        assert _rel(r["column"], x @ w_up.T) < REL
        assert _rel(r["row"], (x @ w_up.T) @ w_down.T) < REL


def test_reductions_follow_their_axis(worlds):
    res = _ok(worlds)
    assert [r["max"] for r in res] == [1.0, 1.0, 3.0, 3.0]
    assert [r["dp_sum"] for r in res] == [2, 4, 2, 4]


def test_ring_shift_and_sp_gather(worlds):
    res = _ok(worlds)
    # rank r receives from the previous rank of its sp ring ({0, 2}, {1, 3})
    prev = {0: 2, 2: 0, 1: 3, 3: 1}
    for r, out in enumerate(res):
        vals, flag = out["ring"]
        assert vals == [float(prev[r])] * 3 and flag == [prev[r] % 2 == 0]
        assert out["gathered_sp"] == ([0, 2] if r % 2 == 0 else [1, 3])


def test_control_group_objects(worlds):
    res = _ok(worlds)
    assert all(r["objects"] == {"from": 0} for r in res)
    assert res[0]["gather"] == [0, 10, 20, 30] and res[1]["gather"] is None


def test_a_rank_that_raises_fails_the_world_with_its_traceback(worlds):
    kind, err, seconds = worlds["raises"]
    assert kind == "error" and isinstance(err, RuntimeError)
    assert "rank 1 failed" in str(err) and "planted failure on rank 1" in str(err)
    assert seconds < 60


def test_a_rank_that_hangs_fails_the_world_at_the_join_timeout(worlds):
    kind, err, seconds = worlds["hangs"]
    assert kind == "error" and isinstance(err, TimeoutError)
    assert 25 <= seconds < 40


def test_server_main_boots_a_tp2_mesh_answers_and_drains(worlds):
    out = worlds["main"]
    log = out["log"]
    assert out.get("healthz", {}).get("followers_ready") is True, log
    assert out["healthz"]["mesh"] == {"dp": 1, "sp": 1, "tp": 2}
    code, body = out["query"]
    assert code == 200 and "Document '" in body["context"], log
    # one shard file per rank, beside (never instead of) the tp=1 cache
    assert out["cache"] == ["params.rank0.safetensors", "params.rank1.safetensors"]
    assert out["rc"] == 0, log
    assert "starting a 2-rank mesh" in log and "rank 1: stopped after" in log and "drained: exiting" in log, log
