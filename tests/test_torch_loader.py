"""The port's safetensors loader, its converted-parameter cache and its
safetensors reader/writer against the JAX package's loader, on tiny
checkpoints of seeded random values in two shards, tied and untied heads,
written two ways: fp32 through ``safetensors.numpy`` (as
``tests/test_llama.py`` writes them) and bf16 through ``ml_dtypes`` (as the
JAX ``utils/synth.py`` does); F16 too.

- The port's load equals the JAX ``load_safetensors_params`` tree carried
  through ``convert.load_llama``, bit for bit; the ``quant="int8"`` stream
  equals the JAX int8 tree (int8 weights and fp32 scales identical).
- A tiny forward from each gives the same logits (fp32, ``atol=1e-4`` as in
  ``tests/test_torch_models.py``).
- The encoder likewise, with and without the ``roberta.`` prefix.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EncoderConfig as JEncoderConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.models import llama as jllama
from rag_llm_k8s_tpu.models import loader as jloader
from rag_llm_k8s_tpu.models.bge_m3 import BgeM3Encoder as JEncoder
from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EncoderConfig, LlamaConfig
from rag_llm_k8s_tpu_torch.models import checkpoint, convert, loader
from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
from rag_llm_k8s_tpu_torch.models.llama import build_llama, make_kv_cache, mask_window
from rag_llm_k8s_tpu_torch.utils import safetensors_io, synth

CPU = torch.device("cpu")
FP32, JFP32 = DTypePolicy.fp32(), JDTypes.fp32()
VOCAB = 96


def _cfgs(tied):
    return (dataclasses.replace(LlamaConfig.tiny(VOCAB), tie_word_embeddings=tied),
            dataclasses.replace(JLlamaConfig.tiny(VOCAB), tie_word_embeddings=tied))


def _state(cfg, seed=1):
    """A seeded HF Llama state dict (numpy fp32): norms near 1, the rest
    N(0, 0.05^2), the scale of an initialized model."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in synth.llama_tensor_specs(cfg):
        a = rng.standard_normal(shape).astype(np.float32)
        out[name] = 1.0 + 0.1 * a if name.endswith("norm.weight") or "layernorm" in name else 0.05 * a
    return out


def _write(state, directory, dtype):
    """Two shards, split by sorted name as tests/test_llama.py splits them."""
    os.makedirs(directory, exist_ok=True)
    keys = sorted(state)
    half = len(keys) // 2
    for i, part in enumerate((keys[:half], keys[half:])):
        np_save_file({k: state[k].astype(dtype) for k in part},
                     os.path.join(directory, f"model-0000{i + 1}-of-00002.safetensors"))
    return directory


DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "f16": np.float16}


@pytest.fixture(scope="module", params=[(t, d) for t in (False, True) for d in ("f32", "bf16", "f16")],
                ids=lambda p: f"{'tied' if p[0] else 'untied'}-{p[1]}")
def staged(request, tmp_path_factory):
    tied, dname = request.param
    cfg, jcfg = _cfgs(tied)
    path = _write(_state(cfg), str(tmp_path_factory.mktemp(f"ckpt_{dname}")), DTYPES[dname])
    return cfg, jcfg, path


def _named(model):
    return dict(model.named_parameters())


def _assert_same(got, want):
    a, b = _named(got), _named(want)
    assert a.keys() == b.keys()
    for n in a:
        assert a[n].dtype == b[n].dtype, n
        assert torch.equal(a[n], b[n]), n


def test_bf16_policy_load_equals_the_jax_load_bit_for_bit(staged):
    cfg, jcfg, path = staged
    got = loader.load_safetensors_params(path, cfg, FP32, "cpu")
    want = convert.load_llama(build_llama(cfg, FP32, CPU),
                              convert.flatten_tree(jloader.load_safetensors_params(path, jcfg, JFP32)))
    _assert_same(got, want)


def test_bf16_storage_keeps_the_staged_bits(staged):
    cfg, _, path = staged
    got = _named(loader.load_safetensors_params(path, cfg, DTypePolicy(), "cpu"))
    for f in sorted(os.listdir(path)):
        with safe_open(os.path.join(path, f), framework="pt") as st:
            for name in st.keys():
                want = st.get_tensor(name).to(torch.bfloat16)  # exact for BF16 files; RNE otherwise
                port = name.replace("model.embed_tokens", "embed").replace("model.norm", "final_norm")
                port = port.replace("model.layers.", "layers.").replace("self_attn.", "attn.")
                for hf, ours in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"), ("o_proj", "wo"),
                                 ("gate_proj", "w_gate"), ("up_proj", "w_up"), ("down_proj", "w_down"),
                                 ("input_layernorm", "input_norm"),
                                 ("post_attention_layernorm", "post_attn_norm")):
                    port = port.replace(hf, ours)
                assert torch.equal(got[port], want), name


def test_int8_stream_equals_the_jax_int8_tree(staged):
    cfg, jcfg, path = staged
    got = loader.load_safetensors_params(path, cfg, FP32, "cpu", quant="int8")
    jtree = jloader.load_safetensors_params(path, jcfg, JFP32, quant="int8")
    want = convert.load_llama(build_llama(cfg, FP32, CPU, quantized=True), convert.flatten_tree(jtree))
    _assert_same(got, want)
    assert got.layers[0].attn.wq.weight.dtype == torch.int8
    assert got.layers[0].attn.wq.scale.dtype == torch.float32


def _prefill_logits_pair(jcfg, jparams, model, quantized):
    rng = np.random.default_rng(3)
    B, S = 2, 12
    tokens = rng.integers(3, VOCAB, size=(B, S))
    pad = np.ones((B, S), np.int64)
    pad[1, :4] = 0
    tokens[1, :4] = 0
    ks, _ = mask_window(torch.from_numpy(pad))
    positions = np.clip(np.cumsum(pad, -1) - 1, 0, None)
    jmodel = jllama.LlamaModel(jcfg, JFP32, attn_impl="xla", quantized=quantized)
    jl, _ = jmodel.apply(
        {"params": jparams}, jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32),
        jllama.make_kv_cache(jcfg, B, S, jnp.float32), jnp.asarray(ks.numpy(), jnp.int32),
        jnp.full((B,), S, jnp.int32), jnp.int32(0),
    )
    with torch.no_grad():
        tl = model(torch.from_numpy(tokens), torch.from_numpy(positions), make_kv_cache(model.config, B, S,
                   torch.float32, CPU), ks, torch.full((B,), S), 0)
    return tl.numpy(), np.asarray(jl)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_a_forward_from_each_load_gives_the_same_logits(staged, quant):
    cfg, jcfg, path = staged
    model = loader.load_safetensors_params(path, cfg, FP32, "cpu", quant=quant)
    jparams = jloader.load_safetensors_params(path, jcfg, JFP32, quant=quant)
    got, want = _prefill_logits_pair(jcfg, jparams, model, quant == "int8")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_quantize_np_is_the_jax_loaders_quantizer_bit_for_bit():
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((300, 70)) * rng.uniform(0.01, 3, size=(300, 1))).astype(np.float32)
    w[5] = 0.0  # an all-zero channel takes the 1e-8 floor
    q, s = loader.quantize_np(torch.from_numpy(w))
    jq, js = jloader._quantize_np(w.T, 0)  # the JAX layout: [in, out], contracted over axis 0
    np.testing.assert_array_equal(q, jq.T)
    np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("prefix", ["", "roberta."])
def test_encoder_load_matches_the_jax_load_and_forward(tmp_path, prefix):
    cfg, jcfg = EncoderConfig.tiny(VOCAB), JEncoderConfig.tiny(VOCAB)
    synth.write_synth_encoder(str(tmp_path), cfg, prefix=prefix, seed=5)
    got = loader.load_encoder_safetensors(str(tmp_path), cfg, FP32, "cpu")
    jparams = jloader.load_encoder_safetensors(str(tmp_path), jcfg, JFP32)
    want = convert.load_encoder(build_encoder(cfg, FP32, CPU), convert.flatten_tree(jparams))
    _assert_same(got, want)
    rng = np.random.default_rng(4)
    tokens = rng.integers(3, VOCAB, size=(2, 16))
    mask = np.ones((2, 16), np.int64)
    tokens[1, 9:], mask[1, 9:] = cfg.pad_token_id, 0
    jout = JEncoder(jcfg, JFP32, attn_impl="xla").apply(
        {"params": jparams}, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask, jnp.int32))
    with torch.no_grad():
        out = got(torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)


@pytest.mark.parametrize("rope", [True, False])
def test_config_from_hf_json_matches_field_by_field(tmp_path, rope):
    cfg = dataclasses.replace(LlamaConfig.llama_3_1_8b(), num_layers=3)
    if not rope:
        cfg = dataclasses.replace(cfg, rope_scaling=None, eos_token_ids=(7,))
    synth.write_hf_config(str(tmp_path), cfg)
    got = loader.config_from_hf_json(str(tmp_path))
    want = jloader.config_from_hf_json(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == cfg
    # a bare eos id, and keys left to their defaults
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    hf["eos_token_id"] = 128009
    for k in ("head_dim", "num_key_value_heads", "rope_theta", "rms_norm_eps"):
        hf.pop(k)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf, f)
    assert dataclasses.asdict(loader.config_from_hf_json(str(tmp_path))) == dataclasses.asdict(
        jloader.config_from_hf_json(str(tmp_path)))


def test_files_the_port_writes_open_with_safe_open_unchanged(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
        "f32": torch.randn(3, generator=g),
        "f16": torch.randn(2, 2, generator=g).to(torch.float16),
        "i8": torch.randint(-127, 128, (4, 3), generator=g, dtype=torch.int8),
        "i64": torch.arange(6).reshape(2, 3),
        "np_f32": np.arange(4, dtype=np.float32),
        "np_bf16": np.arange(3, dtype=np.float32).astype(ml_dtypes.bfloat16),
    }
    path = str(tmp_path / "x.safetensors")
    safetensors_io.save_file(tensors, path, metadata={"note": "port"})
    with safe_open(path, framework="pt") as st:
        assert sorted(st.keys()) == sorted(tensors)
        assert st.metadata() == {"note": "port"}
        for k, v in tensors.items():
            want = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                v.view(np.int16)).view(torch.bfloat16) if k == "np_bf16" else torch.from_numpy(v)
            assert torch.equal(st.get_tensor(k), want), k
    # and back through the port's reader
    ours = safetensors_io.SafetensorsFile(path)
    assert torch.equal(ours.get("bf16"), tensors["bf16"])
    assert ours.metadata == {"note": "port"}


@pytest.mark.parametrize("tied", [False, True])
def test_missing_and_unknown_key_errors_match(tied):
    cfg, jcfg = _cfgs(tied)
    state = _state(cfg)
    extra = dict(state, **{"model.layers.0.mlp.extra.weight": np.zeros(2, np.float32)})
    with pytest.raises(KeyError) as want:
        jloader.convert_hf_state_dict(extra, jcfg, JFP32)
    with pytest.raises(KeyError) as got:
        loader.convert_hf_state_dict(extra, cfg, FP32, "cpu")
    assert str(got.value) == str(want.value)
    missing = dict(state)
    del missing["model.layers.1.self_attn.k_proj.weight"]
    with pytest.raises(ValueError) as want:
        jloader.convert_hf_state_dict(missing, jcfg, JFP32)
    with pytest.raises(ValueError) as got:
        loader.convert_hf_state_dict(missing, cfg, FP32, "cpu")
    assert str(got.value) == str(want.value)
    # rotary inv_freq buffers are tolerated by both
    ok = dict(state, **{"model.layers.0.self_attn.rotary_emb.inv_freq": np.zeros(2, np.float32)})
    loader.convert_hf_state_dict(ok, cfg, FP32, "cpu")
    with pytest.raises(ValueError, match="quant="):
        loader.convert_hf_state_dict(state, cfg, FP32, "cpu", quant="int4")


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_the_checkpoint_cache_round_trips(tmp_path, quant):
    cfg, _ = _cfgs(False)
    path = _write(_state(cfg), str(tmp_path / "model"), ml_dtypes.bfloat16)
    calls = []

    def convert_fn():
        calls.append(1)
        return loader.load_safetensors_params(path, cfg, DTypePolicy(), "cpu", quant=quant)

    def template():
        return build_llama(cfg, DTypePolicy(), CPU, quantized=quant == "int8")

    cache = os.path.join(path, checkpoint.CACHE_SUBDIR + ("" if quant == "bf16" else "_int8"))
    info1, info2 = {}, {}
    first = checkpoint.load_params_cached(path, convert_fn, template, cache_dir=cache, info=info1)
    second = checkpoint.load_params_cached(path, convert_fn, template, cache_dir=cache, info=info2)
    assert calls == [1] and info1 == {"params_source": "converted"} and info2 == {"params_source": "cache"}
    _assert_same(second, first)
    # a cache of the other layout is a structure mismatch: reconvert
    other = lambda: build_llama(cfg, DTypePolicy(), CPU, quantized=quant != "int8")  # noqa: E731
    info3 = {}
    checkpoint.load_params_cached(path, convert_fn, other, cache_dir=cache, info=info3)
    assert calls == [1, 1] and info3 == {"params_source": "converted"}
