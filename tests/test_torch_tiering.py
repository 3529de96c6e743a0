"""The port's KV tiering primitives and RoPE re-rotation against the JAX
package's, on the CPU.

- ``rope_rerotate`` against the jitted JAX op (fp32 and bf16), and
  ``rope_rerotate_q8`` bit for bit (payloads and scales: the port copies
  the compiled arithmetic, ``cosf``/``sinf`` phases and fused
  multiply-adds); ``rerotate_prefix_planes`` at ``delta == 0`` returns the
  very tuple it was given;
- ``HotnessTracker`` scores under one fake clock, ``HostSpillStore``
  eviction order, bytes and manifest, and ``quantize_planes`` /
  ``dequantize_planes`` bit for bit;
- ``KVTieringConfig.validate`` with the JAX messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import KVTieringConfig as JKVTieringConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.engine import tiering as jtiering
from rag_llm_k8s_tpu.models.llama import rerotate_prefix_planes as jrerotate_planes
from rag_llm_k8s_tpu.models.llama import rope_frequencies as jrope_frequencies
from rag_llm_k8s_tpu.ops.attention import quantize_kv as jquantize_kv
from rag_llm_k8s_tpu.ops.attention import rope_rerotate as jrope_rerotate
from rag_llm_k8s_tpu.ops.attention import rope_rerotate_q8 as jrope_rerotate_q8
from rag_llm_k8s_tpu_torch.core.config import KVTieringConfig, LlamaConfig
from rag_llm_k8s_tpu_torch.engine import tiering
from rag_llm_k8s_tpu_torch.models.llama import rerotate_prefix_planes, rope_frequencies
from rag_llm_k8s_tpu_torch.ops.attention import quantize_kv, rope_rerotate, rope_rerotate_q8

CPU = torch.device("cpu")
DELTAS = (1, 7, -37, 1234, -4000)
CONFIGS = {"tiny": (JLlamaConfig.tiny(), LlamaConfig.tiny()), "8b": (JLlamaConfig(), LlamaConfig())}


def _k(cfg, seed, S=24, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 1, cfg.num_kv_heads, S, cfg.head_dim)) * scale).astype(np.float32)


def _freqs(name):
    jcfg, tcfg = CONFIGS[name]
    return jcfg, jrope_frequencies(jcfg), rope_frequencies(tcfg, CPU)


# ---------------------------------------------------------------------------
# RoPE re-rotation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_two_packages_share_the_inverse_frequencies(name):
    _, jinv, tinv = _freqs(name)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("delta", DELTAS)
def test_rope_rerotate_matches_the_jitted_jax_op(name, delta):
    cfg, jinv, tinv = _freqs(name)
    k = _k(cfg, seed=delta & 0xFF)
    want = np.asarray(jrope_rerotate(jnp.asarray(k), jnp.int32(delta), jinv))
    got = rope_rerotate(torch.from_numpy(k), delta, tinv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("delta", DELTAS)
def test_rope_rerotate_in_bf16_matches_the_jitted_jax_op(delta):
    cfg, jinv, tinv = _freqs("8b")
    kb = jnp.asarray(_k(cfg, seed=5)).astype(jnp.bfloat16)
    want = np.asarray(jrope_rerotate(kb, jnp.int32(delta), jinv).astype(jnp.float32))
    got = rope_rerotate(torch.from_numpy(np.array(kb.astype(jnp.float32))).to(torch.bfloat16), delta, tinv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)  # the same fp32 math, the same rounding


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("delta", DELTAS)
def test_rope_rerotate_q8_is_bit_for_bit_with_jax(name, delta):
    cfg, jinv, tinv = _freqs(name)
    kq, ks = map(np.asarray, jax.jit(jquantize_kv)(jnp.asarray(_k(cfg, seed=3))))
    wq, ws = map(np.asarray, jrope_rerotate_q8(jnp.asarray(kq), jnp.asarray(ks), jnp.int32(delta), jinv))
    gq, gs = rope_rerotate_q8(torch.from_numpy(kq), torch.from_numpy(ks), delta, tinv)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), wq)
    np.testing.assert_array_equal(gs.numpy(), ws)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_rerotate_prefix_planes_matches_jax_and_is_the_identity_at_zero(quant):
    jcfg, tcfg = CONFIGS["tiny"]
    k, v = _k(jcfg, 1), _k(jcfg, 2)
    if quant == "int8":
        (kq, ks), (vq, vs) = (tuple(map(np.asarray, jax.jit(jquantize_kv)(jnp.asarray(x)))) for x in (k, v))
        host = (kq, vq, ks, vs)
    else:
        host = (k, v)
    jplanes = tuple(jnp.asarray(p) for p in host)
    tplanes = tuple(torch.from_numpy(p) for p in host)
    assert rerotate_prefix_planes(tcfg, tplanes, 0) is tplanes
    assert jrerotate_planes(jcfg, jplanes, 0) is jplanes
    want = jrerotate_planes(jcfg, jplanes, 9)
    got = rerotate_prefix_planes(tcfg, tplanes, 9)
    assert len(got) == len(want)
    assert got[1] is tplanes[1]  # V passes through
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# hotness, the spill store and the warm tier's conversion
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_hotness_scores_under_one_fake_clock_match_jax():
    clocks = {"jax": FakeClock(), "port": FakeClock()}
    trackers = {
        "jax": jtiering.HotnessTracker(half_life_s=7.0, clock=clocks["jax"]),
        "port": tiering.HotnessTracker(half_life_s=7.0, clock=clocks["port"]),
    }
    script = [("touch", "a", 1.0, 0.0), ("touch", "b", 2.5, 1.5), ("touch", "a", 1.0, 3.0), ("score", "a", 0, 4.0),
              ("score", "zz", 0, 4.0), ("touch", "c", 0.001, 5.0), ("prune", None, 0, 60.0), ("score", "b", 0, 0.0),
              ("forget", "a", 0, 0.0), ("score", "a", 0, 0.0), ("touch", "b", 1.0, 2.0)]
    seen = {}
    for side, tr in trackers.items():
        out = []
        for op, key, w, dt in script:
            clocks[side].t += dt
            if op == "touch":
                out.append(tr.touch(key, w))
            elif op == "score":
                out.append(tr.score(key))
            elif op == "prune":
                out.append(tr.prune(floor=0.05))
            else:
                tr.forget(key)
            out.append(len(tr))
        seen[side] = out
    assert seen["port"] == seen["jax"]  # the same floats, bit for bit


def test_the_validation_messages_match():
    for cls in (jtiering.HotnessTracker, tiering.HotnessTracker):
        with pytest.raises(ValueError, match=r"half_life_s=0: expected > 0"):
            cls(half_life_s=0)
    for cls in (jtiering.HostSpillStore, tiering.HostSpillStore):
        with pytest.raises(ValueError, match=r"budget_mb=0: expected >= 1"):
            cls(budget_mb=0)
    for bad in (dict(cold_below=0.5, warm_below=0.25), dict(half_life_s=0.0), dict(host_spill_mb=0)):
        with pytest.raises(ValueError) as want:
            JKVTieringConfig(**bad).validate()
        with pytest.raises(ValueError) as got:
            KVTieringConfig(**bad).validate()
        assert str(got.value) == str(want.value)
    assert dataclasses.asdict(KVTieringConfig()) == dataclasses.asdict(JKVTieringConfig())


def test_the_spill_store_evicts_the_same_entries_and_counts_the_same_bytes():
    """A 1 MiB budget; bf16, fp32 and int8 planes of mixed sizes. bf16 holds
    2 bytes an element on both sides (a torch tensor, a numpy copy of a
    bf16 JAX array)."""
    rng = np.random.default_rng(0)
    sizes = [(64, 1024, "bf16"), (48, 1024, "fp32"), (200, 1024, "int8"), (100, 1024, "bf16"),
             (30, 1024, "fp32"), (128, 1024, "bf16")]
    stores = {"jax": jtiering.HostSpillStore(budget_mb=1), "port": tiering.HostSpillStore(budget_mb=1)}
    log = {"jax": [], "port": []}
    for i, (rows, cols, kind) in enumerate(sizes):
        x = rng.standard_normal((rows, cols)).astype(np.float32)
        if kind == "int8":
            x = (x * 20).astype(np.int8)
        key = ("seg", i)
        jx = jnp.asarray(x).astype(jnp.bfloat16) if kind == "bf16" else jnp.asarray(x)
        tx = torch.from_numpy(x).to(torch.bfloat16) if kind == "bf16" else torch.from_numpy(x)
        for side, planes in (("jax", (jx, jx)), ("port", (tx, tx))):
            st = stores[side]
            log[side].append((st.put(key, planes, meta={"i": i}), st.bytes, st.evictions, len(st)))
    assert log["port"] == log["jax"]
    man = {side: [(m["key"], m["nbytes"], m["meta"]) for m in st.manifest()] for side, st in stores.items()}
    assert man["port"] == man["jax"]
    # what comes back is what went in, and nothing else holds it
    key = man["port"][-1][0]
    (p0, p1), meta = stores["port"].get(key)
    assert meta == {"i": 5} and p0.dtype == torch.bfloat16 and p0.device.type == "cpu"
    assert torch.equal(p0, p1)
    for side, st in stores.items():
        assert st.drop(key) and not st.drop(key) and key not in st
        st.clear()
        assert st.bytes == 0 and len(st) == 0


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_and_dequantize_planes_are_bit_for_bit_with_jax(dtype):
    cfg = JLlamaConfig.tiny()
    k, v = _k(cfg, 7), _k(cfg, 8)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jpl = (jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt))
    tpl = tuple(torch.from_numpy(np.array(p.astype(jnp.float32))).to(tdt) for p in jpl)
    wq = jtiering.quantize_planes(jpl)
    gq = tiering.quantize_planes(tpl)
    assert [g.dtype for g in gq] == [torch.int8, torch.int8, torch.float32, torch.float32]
    for w, g in zip(wq, gq):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    wd = jtiering.dequantize_planes(wq, jdt)
    gd = tiering.dequantize_planes(gq, tdt)
    for w, g in zip(wd, gd):
        assert g.dtype == tdt
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
    # an int8 pair and an already-quantized tuple are left to the caller
    assert tiering.quantize_planes(gq) is None and jtiering.quantize_planes(wq) is None
    assert tiering.quantize_planes(gq[:2]) is None and jtiering.quantize_planes(wq[:2]) is None
    assert tiering.dequantize_planes(tpl, tdt) is tpl


def test_the_port_quantizer_is_the_compiled_jax_one_on_rotated_planes():
    """``quantize_planes`` of a re-rotated block (the warm tier of a shifted
    chunk) stays bit for bit: both halves copy the compiled arithmetic."""
    cfg, jinv, tinv = _freqs("8b")
    k = _k(cfg, 11)
    jr = jrope_rerotate(jnp.asarray(k), jnp.int32(321), jinv)
    tr = rope_rerotate(torch.from_numpy(k), 321, tinv)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    wq, ws = jax.jit(jquantize_kv)(jr)
    gq, gs = quantize_kv(tr)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
