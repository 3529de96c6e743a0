"""The plain reference against the port at toy widths on the CPU, both in
float32 from the same drawn weights, and the reference's tokenizers
against the port's."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import models
from benchmark.reference.tokenize import BPE_FILE, UNIGRAM_FILE, PlainBPE, PlainUnigram

TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 512, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
        "bos_token_id": 1, "eos_token_id": 2}
TINY_ENC = {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
            "vocab_size": 256, "max_position_embeddings": 128, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
            "pad_token_id": 1}


def _load_drawn(model, shapes, seed):
    """The drawn bf16 values, widened, into a float32 port model."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights.draw(seed, name, shapes[name], torch.bfloat16, "cpu").float())


def test_decoder_matches_the_port_in_fp32():
    from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, LlamaConfig
    from rag_llm_k8s_tpu_torch.models.llama import build_llama

    cfg = LlamaConfig.tiny(vocab_size=512)
    model = build_llama(cfg, DTypePolicy.fp32(), torch.device("cpu"), fused=True, attn_impl="xla")
    _load_drawn(model, weights.decoder_shapes(TINY), 11)
    seq = list(np.random.default_rng(0).integers(3, 400, 40))
    n = len(seq)
    with torch.no_grad():
        got = model(torch.tensor([seq]), torch.arange(n)[None], None, torch.zeros(1, dtype=torch.long),
                    torch.full((1,), n), 0)[0]
    ref = models.decoder_logits(TINY, 11, [seq], [range(n)], "cpu")[0]
    assert torch.allclose(got, ref, atol=2e-4, rtol=0), float((got - ref).abs().max())


def test_encoder_matches_the_port_in_fp32():
    from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EncoderConfig
    from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder

    enc = build_encoder(EncoderConfig.tiny(vocab_size=256), DTypePolicy.fp32(), torch.device("cpu"))
    _load_drawn(enc, weights.encoder_shapes(TINY_ENC), 5)
    ids = [0] + list(np.random.default_rng(1).integers(3, 250, 20)) + [2]
    with torch.no_grad():
        got = enc(torch.tensor([ids]), torch.ones(1, len(ids), dtype=torch.long))[0].double()
    ref = models.embed(TINY_ENC, 5, [ids], "cpu")[0]
    assert torch.allclose(got, ref, atol=1e-5), float((got - ref).abs().max())


def test_fp8_control_moves_the_logits_and_the_embedding():
    seq = list(range(3, 40))
    ref = models.decoder_logits(TINY, 3, [seq], [range(len(seq))], "cpu")[0]
    ctl = models.decoder_logits(TINY, 3, [seq], [range(len(seq))], "cpu", quant="fp8")[0]
    assert 0 < float((ref - ctl).abs().max()) < 0.2
    e = models.embed(TINY_ENC, 5, [[0, 7, 9, 2]], "cpu")
    ec = models.embed(TINY_ENC, 5, [[0, 7, 9, 2]], "cpu", quant="fp8")
    assert 0 < float((e - ec).abs().max()) < 0.2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tokenizers_match_the_port(seed):
    from rag_llm_k8s_tpu_torch.tokenizer import load_tokenizer

    bpe, uni = load_tokenizer(BPE_FILE), load_tokenizer(UNIGRAM_FILE)
    pb, pu = PlainBPE(), PlainUnigram()
    rng = np.random.default_rng(seed)
    chars = list("abcdefghijklmnopqrstuvwxyzABCXYZ0123456789 .,'():?-\n\t")
    for _ in range(100):
        s = "".join(rng.choice(chars, int(rng.integers(1, 300))))
        assert bpe.encode(s) == pb.encode(s)
        assert uni.encode(s) == pu.encode(s)
        ids = [int(i) for i in rng.integers(0, 1000, 40)]
        assert bpe.decode(ids) == pb.decode(ids)


def test_gap_of_the_perturbed_argmax_is_nought_and_of_another_token_is_not():
    from benchmark.check import _gaps

    logits = torch.tensor([[3.0, 2.0, 1.0, -5.0]])
    noise = torch.tensor([[0.0, 1.5, 0.0, 0.0]])
    assert float(_gaps(logits, noise, [1], 1.0)[0]) == 0.0  # token 1 wins under the noise
    assert float(_gaps(logits, noise, [0], 1.0)[0]) == pytest.approx(0.5)
