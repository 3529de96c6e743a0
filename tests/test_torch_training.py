"""The port's training step (``engine/training.py``) against the JAX
package's: ``lm_loss``, its per-parameter gradients (``jax.grad``), one and
two AdamW steps of ``make_train_step(cfg, FP32)``, and two steps with a
larger learning rate and weight decay given to both through ``optimizer``
(the parameters move far enough that the second step's gradient differs
from the first, so the betas, Adam's bias correction at t = 2 and the decay
term each show in the update), the ring's q/k/v gradients against
``jax.grad`` of dense attention (mirrors ``tests/test_ring_attention.py``
``test_gradients_flow``), and a ``dp=2 x sp=2 x tp=2`` step on a world of
eight processes (gloo, CPU) against JAX's step without a mesh (mirrors
``test_train_step_grads_match_sp1``; JAX's own tests hold its mesh step to
its meshless one). The batch is right-padded with rows of different
lengths, so the two dp shards hold different numbers of real tokens and
only the global masked mean gives JAX's loss.

Tolerances (fp32 on both sides): loss rtol 1e-5; updated parameters rtol
2e-4, atol 2e-5 (JAX's mesh test); each parameter's update ``p_k - p_0``
within relative RMS 1e-3 of JAX's (a wrong optimizer setting moves every
element), and each element of it within rtol 1e-2 of JAX's, atol 1e-9 plus
the fp32 rounding of the parameter itself (4 ulp of ``|p_0|``: a 1e-5 step
on a norm weight of 1.0 spans only ~84 ulp, and the two sides round ``p``
in different orders; Adam divides a gradient near zero by its own root
mean square, which magnifies the two sides' fp32 difference there to a few
1e-3 of the update on a few elements); gradients rtol 1e-4, atol 1e-6; ring
gradients rtol 1e-3, atol 1e-4 (``test_gradients_flow``). One spawned world
runs every multi-rank case, the port's dry run (``parallel/dryrun.py``)
included. Also: the kernel wrappers refuse inputs that require grad, the
differentiable fp32 head, and the trainable build's checks.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, LlamaConfig, MeshConfig
from rag_llm_k8s_tpu_torch.core.mesh import MeshContext, make_mesh
from rag_llm_k8s_tpu_torch.engine import training
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import HeadMatmul, LlamaModel, build_llama
from rag_llm_k8s_tpu_torch.ops import attention as A
from rag_llm_k8s_tpu_torch.ops import knn
from rag_llm_k8s_tpu_torch.parallel import dryrun
from rag_llm_k8s_tpu_torch.parallel import ring_attention as ring
from rag_llm_k8s_tpu_torch.parallel.launch import spawn_world
from rag_llm_k8s_tpu_torch.parallel.sharding import llama_param_specs, shard_llama_params

FP32 = DTypePolicy.fp32()
CFG = dataclasses.replace(LlamaConfig.tiny(), num_heads=4, num_kv_heads=2, head_dim=8, hidden_size=32)
B, S = 4, 32
# right-padded rows: dp rank 0 holds rows 0-1 (50 weighted tokens), rank 1
# rows 2-3 (30)
LENS = [32, 20, 5, 27]
MESH = MeshConfig(dp=2, sp=2, tp=2)
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-4, 2e-5, 1e-4, 1e-6
UPDATE_RMS, UPDATE_RTOL, UPDATE_ATOL, UPDATE_ULPS = 1e-3, 1e-2, 1e-9, 4
# the second optimizer, given to both sides: optax.adamw(LR, weight_decay=WD)
LR, WD = 1e-2, 0.1
with torch.device("meta"):
    PARAMS = [n for n, _ in LlamaModel(CFG, FP32).named_parameters()]
SPECS = llama_param_specs(CFG, MeshContext(tp=2))  # each parameter's shard dim at tp=2
# (name, causal, valid prefix or None): B = 1, S = 32, H = 4, K = 2, hd = 8
RING_CASES = [("causal", True, None), ("kv_validity", False, 20)]


def _batch():
    tokens = np.random.default_rng(1).integers(2, CFG.vocab_size, (B, S))
    mask = (np.arange(S)[None, :] < np.array(LENS)[:, None]).astype(np.int32)
    return tokens, mask


def _assert_update_close(got, want, p0, err_msg):
    """The update ``got - p0`` against JAX's ``want - p0``: relative RMS,
    then each element."""
    du, dw = got.astype(np.float64) - p0, want.astype(np.float64) - p0
    rms = np.linalg.norm(du - dw) / np.linalg.norm(dw)
    assert rms <= UPDATE_RMS, f"{err_msg}: update rel RMS {rms:.3g} (limit {UPDATE_RMS})"
    tol = UPDATE_RTOL * np.abs(dw) + UPDATE_ATOL + UPDATE_ULPS * np.spacing(np.abs(p0).astype(np.float32))
    bad = np.abs(du - dw) > tol
    assert not bad.any(), (f"{err_msg}: {int(bad.sum())} of {bad.size} updates off; worst |du - dw| "
                           f"{np.abs(du - dw).max():.3g} where |dw| {np.abs(dw).max():.3g}")


def _ring_problem(valid):
    r = np.random.default_rng(3)
    q, k, v = (r.standard_normal((1, S, h, 8)).astype(np.float32) for h in (4, 2, 2))
    return q, k, v, (None if valid is None else np.arange(S)[None, :] < valid)


def _state(tree):
    return convert.llama_state_dict(convert.flatten_tree(tree), CFG.num_layers)


def _rank(ctx, params_path):
    """One rank of the world: the ring's gradients on an sp=8 mesh of the
    same ranks, two steps on the dp=2 x sp=2 x tp=2 mesh, the dry run."""
    import rag_llm_k8s_tpu_torch.models.llama as llama

    with np.load(params_path) as f:
        flat = dict(f)
    out = {"coords": ctx.coords}
    sp8 = make_mesh(MeshConfig(dp=1, sp=8, tp=1), device="cpu", timeout_s=60)
    for name, causal, valid in RING_CASES:
        q, k, v, val = _ring_problem(valid)
        qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        o = ring.ring_attention_sharded(sp8, *qkv, causal=causal,
                                        kv_valid=None if val is None else torch.from_numpy(val))
        (o ** 2).sum().backward()
        out[name] = [t.grad.numpy() for t in qkv]
    calls, real = [], llama.ring_attention_sharded
    llama.ring_attention_sharded = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    model = shard_llama_params(flat, ctx, CFG, FP32, "cpu", attn_impl="xla", trainable=True)
    init_opt, step = training.make_train_step(CFG, FP32, mesh=ctx)
    opt = init_opt(model)
    tokens, mask = _batch()
    out["loss"] = [float(step(model, opt, tokens, mask))]
    out["grads"] = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    out["params"] = [{n: p.detach().numpy().copy() for n, p in model.named_parameters()}]
    out["loss"].append(float(step(model, opt, tokens, mask)))
    out["params"].append({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    out["ring_calls"] = len(calls)
    out["staged_calls"] = ctx.staged_calls
    out["dryrun_loss"] = dryrun.dryrun_rank(ctx)
    return out


@pytest.fixture(scope="module")
def jparams():
    import jax

    from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
    from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
    from rag_llm_k8s_tpu.models.llama import init_llama_params

    jcfg = JLlamaConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    return jcfg, init_llama_params(jax.random.PRNGKey(0), jcfg, JDTypes.fp32())


@pytest.fixture(scope="module")
def ref(jparams):
    import jax
    import jax.numpy as jnp

    from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
    from rag_llm_k8s_tpu.engine.training import lm_loss, make_train_step
    from rag_llm_k8s_tpu.models.llama import LlamaModel as JLlamaModel

    import optax

    jcfg, params = jparams
    flat = convert.flatten_tree(params)
    tokens, mask = (jnp.asarray(a) for a in _batch())
    model = JLlamaModel(jcfg, JDTypes.fp32(), attn_impl="xla")
    loss, grads = jax.value_and_grad(lambda p: lm_loss(model, p, tokens, mask))(params)
    out = dict(flat=flat, p0=_state(params), loss=float(loss), grads=_state(grads))
    for tag, opt in (("", None), ("decay_", optax.adamw(LR, weight_decay=WD))):
        init_opt, step = make_train_step(jcfg, JDTypes.fp32(), optimizer=opt)
        step = jax.jit(step)
        p1, st, l1 = step(params, init_opt(params), tokens, mask)
        p2, _, l2 = step(p1, st, tokens, mask)
        out.update({tag + "losses": [float(l1), float(l2)], tag + "params": [_state(p1), _state(p2)]})
    return out


@pytest.fixture(scope="module", autouse=True)
def world(jparams, tmp_path_factory):
    """The world's per-rank results, computed beside the other fixtures
    (set up first, so the JAX references compile while it runs). The
    parameters reach the ranks as a file: arguments past a pipe's buffer
    would make each rank's start wait for the one before it to import."""
    from concurrent.futures import ThreadPoolExecutor

    path = tmp_path_factory.mktemp("training") / "params.npz"
    np.savez(path, **convert.flatten_tree(jparams[1]))
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(spawn_world, _rank, MESH, device="cpu", timeout_s=60, args=(str(path),),
                      join_timeout_s=300)
    pool.shutdown(wait=False)

    class _Ranks:
        def __getitem__(self, r):
            return fut.result()[r]

        def __iter__(self):
            return iter(fut.result())

    return _Ranks()


@pytest.fixture(scope="module")
def jax_ring():
    import jax
    import jax.numpy as jnp

    from test_ring_attention import dense_attention

    out = {}
    for name, causal, valid in RING_CASES:
        q, k, v, val = _ring_problem(valid)
        kv_valid = None if val is None else jnp.asarray(val)

        def loss(q, k, v, causal=causal, kv_valid=kv_valid):
            return jnp.sum(dense_attention(q, k, v, causal=causal, kv_valid=kv_valid) ** 2)

        out[name] = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]
    return out


def _trainable(flat):
    return convert.load_llama(build_llama(CFG, FP32, torch.device("cpu"), attn_impl="xla", trainable=True), flat)


@pytest.fixture(scope="module")
def port(ref):
    """One rank: the loss and its gradients, then two steps."""
    tokens, mask = (torch.from_numpy(a) for a in _batch())
    model = _trainable(ref["flat"])
    loss = training.lm_loss(model, tokens, mask)
    loss.backward()
    out = dict(loss=float(loss.detach()), grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()})
    decay = functools.partial(torch.optim.AdamW, lr=LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=WD)
    for tag, optimizer in (("", None), ("decay_", decay)):
        model = _trainable(ref["flat"])
        init_opt, step = training.make_train_step(CFG, FP32, optimizer=optimizer, device="cpu")
        opt = init_opt(model)
        out[tag + "losses"], out[tag + "params"] = [], []
        for _ in range(2):
            out[tag + "losses"].append(float(step(model, opt, tokens, mask)))
            out[tag + "params"].append({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    return out


def test_lm_loss_matches_jax(ref, port):
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", PARAMS)
def test_gradients_match_jax(ref, port, name):
    np.testing.assert_allclose(port["grads"][name], ref["grads"][name], rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("step", [1, 2])
def test_train_step_matches_jax(ref, port, step):
    np.testing.assert_allclose(port["losses"][step - 1], ref["losses"][step - 1], rtol=LOSS_RTOL)
    for name in PARAMS:
        got, want = port["params"][step - 1][name], ref["params"][step - 1][name]
        np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
        _assert_update_close(got, want, ref["p0"][name], name)


@pytest.mark.parametrize("step", [1, 2])
def test_train_step_with_a_larger_lr_and_decay_matches_jax(ref, port, step):
    """``optax.adamw(LR, weight_decay=WD)`` against ``torch.optim.AdamW`` at
    the same settings: the second step's gradient differs from the first,
    so a wrong beta, a missing bias correction or a wrong decay moves the
    update past its tolerance."""
    np.testing.assert_allclose(port["decay_losses"][step - 1], ref["decay_losses"][step - 1], rtol=LOSS_RTOL)
    for name in PARAMS:
        _assert_update_close(port["decay_params"][step - 1][name], ref["decay_params"][step - 1][name],
                             ref["p0"][name], name)


@pytest.mark.parametrize("arg", ["q", "k", "v"])
@pytest.mark.parametrize("case", [c[0] for c in RING_CASES])
def test_ring_gradients_match_dense(world, jax_ring, case, arg):
    i = "qkv".index(arg)
    for r in world:  # every sp rank holds the whole gradient
        np.testing.assert_allclose(r[case][i], jax_ring[case][i], rtol=1e-3, atol=1e-4)


def _gathered(world, name, pick):
    """A parameter's whole array (``pick(rank result)[name]``) from the tp
    ranks at dp = sp = 0, concatenated along its shard dim."""
    parts = [pick(r)[name] for r in world if r["coords"][:2] == (0, 0)]
    return parts[0] if SPECS[name] is None else np.concatenate(parts, axis=SPECS[name])


@pytest.mark.parametrize("step", [1, 2])
def test_mesh_step_matches_jax(ref, world, step):
    """dp=2 x sp=2 x tp=2 with ragged masks against JAX's meshless step."""
    for r in world:
        np.testing.assert_allclose(r["loss"][step - 1], ref["losses"][step - 1], rtol=LOSS_RTOL)
    for name in PARAMS:
        got, want = _gathered(world, name, lambda r: r["params"][step - 1]), ref["params"][step - 1][name]
        np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
        _assert_update_close(got, want, ref["p0"][name], name)


@pytest.mark.parametrize("name", PARAMS)
def test_mesh_gradients_match_jax(ref, world, name):
    np.testing.assert_allclose(_gathered(world, name, lambda r: r["grads"]), ref["grads"][name],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_mesh_replicas_are_equal(world):
    """Every rank of a tp coordinate holds the same parameters after the
    steps (replicated ones: every rank), and the training prefill took the
    ring on every rank, with no collective staged (CPU tensors)."""
    first = {}
    for r in world:
        for name, arr in r["params"][1].items():
            key = (name, r["coords"][2] if SPECS[name] is not None else None)
            if key in first:
                np.testing.assert_array_equal(arr, first[key], err_msg=f"{name} on rank coords {r['coords']}")
            else:
                first[key] = arr
        assert r["ring_calls"] == 2 * CFG.num_layers  # two steps, each layer
        assert r["staged_calls"] == 0


def test_dryrun_loss_is_finite(world):
    losses = [r["dryrun_loss"] for r in world]
    assert np.isfinite(losses[0]) and len(set(losses)) == 1
    assert dryrun.dryrun_mesh(8) == MeshConfig(dp=2, sp=2, tp=2)


def test_make_train_step_needs_the_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.make_train_step(CFG, FP32)
    training.make_train_step(CFG, FP32, device="cpu")


def _meta(*shape, dtype=torch.bfloat16, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _wrapper_calls():
    i32 = dict(dtype=torch.int32, grad=False)
    q, q1 = _meta(1, 16, 4, 64), _meta(1, 1, 4, 64)
    kv, cache, arena = _meta(1, 16, 2, 64), _meta(1, 1, 2, 64, 64), _meta(1, 4, 2, 16, 64)
    c8, a8 = _meta(1, 1, 2, 64, 64, dtype=torch.int8, grad=False), _meta(1, 4, 2, 16, 64, dtype=torch.int8, grad=False)
    cs, as_ = _meta(1, 1, 2, 64, dtype=torch.float32, grad=False), _meta(1, 4, 2, 16, dtype=torch.float32, grad=False)
    w, tables = _meta(1, **i32), _meta(1, 4, **i32)
    return {
        "flash_attention": lambda: A.flash_attention(q, kv, kv),
        "decode_attention": lambda: A.decode_attention(q1, cache, cache, w, w, 0),
        "chunk_prefill_attention": lambda: A.chunk_prefill_attention(q, cache, cache, w, w, 0, 0),
        "paged_decode_attention": lambda: A.paged_decode_attention(q1, arena, arena, tables, w, 0),
        "paged_chunk_attention": lambda: A.paged_chunk_attention(q, arena, arena, tables, w, 0, w),
        "decode_attention_q8": lambda: A.decode_attention_q8(q1, c8, c8, cs, cs, w, w, 0),
        "chunk_prefill_attention_q8": lambda: A.chunk_prefill_attention_q8(q, c8, c8, cs, cs, w, w, 0, 0),
        "paged_decode_attention_q8": lambda: A.paged_decode_attention_q8(q1, a8, a8, as_, as_, tables, w, 0),
        "paged_chunk_attention_q8": lambda: A.paged_chunk_attention_q8(q, a8, a8, as_, as_, tables, w, 0, w),
        "knn_topk": lambda: knn.knn_topk(_meta(1, 64, dtype=torch.float32), _meta(8, 64, dtype=torch.float32),
                                         _meta(8, dtype=torch.float32, grad=False)),
    }


@pytest.mark.parametrize("wrapper", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_inputs_that_require_grad(wrapper):
    """Off the CPU a wrapper launches its kernel, whose output carries no
    gradient: with grad enabled it raises first (meta tensors stand for the
    card's here, which nothing launches on)."""
    with pytest.raises(RuntimeError, match="no backward"):
        _wrapper_calls()[wrapper]()


def test_head_matmul_gives_the_serving_logits_and_a_gradient():
    """The differentiable fp32-accumulating head (the card's training head):
    the serving head's logits and, within bf16 rounding of the cotangent,
    the fp32 product's gradients."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(24, 32, generator=g).to(torch.bfloat16).requires_grad_()
    w = (0.1 * torch.randn(40, 32, generator=g)).to(torch.bfloat16).requires_grad_()
    ct = torch.randn(24, 40, generator=g)
    got = HeadMatmul.apply(h, w)
    want = torch.nn.functional.linear(h.float(), w.float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
    gh, gw = torch.autograd.grad((got * ct).sum(), (h, w))
    wh, ww = torch.autograd.grad((want * ct).sum(), (h, w))
    for a, b in ((gh, wh), (gw, ww)):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b.float()).norm() / b.float().norm()) < 2 ** -7


def test_trainable_build_and_step_checks(ref):
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="unfused"):
        build_llama(CFG, FP32, cpu, fused=True, trainable=True)
    init_opt, _ = training.make_train_step(CFG, FP32, device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        init_opt(convert.load_llama(build_llama(CFG, FP32, cpu, trainable=True), ref["flat"]))
    with pytest.raises(ValueError, match="trainable"):
        init_opt(convert.load_llama(build_llama(CFG, FP32, cpu, attn_impl="xla"), ref["flat"]))
    model = _trainable(ref["flat"])
    assert model.training and all(p.requires_grad for p in model.parameters())
    # the same forward through either attention choice on the CPU (the
    # kernels' wrappers take their plain versions there)
    tokens, mask = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad():
        a = training.lm_loss(model, tokens, mask)
        b = training.lm_loss(model.set_attn_impl("kernels"), tokens, mask)
    assert float(a) == float(b)
