"""Tokenizers: byte-level BPE (Llama-3) and Unigram (XLM-R / bge-m3), loaded
from HF ``tokenizer.json``; the port's copy of ``rag_llm_k8s_tpu/tokenizer``.

A C++ merge loop (``rag_llm_k8s_tpu_torch/native/bpe.cpp``) serves the BPE
encode when it builds; the pure-Python loop is its plain version. The
pre-tokenization regexes run on the standard library's ``re``
(``bpe.translate_hf_regex``).
"""

from rag_llm_k8s_tpu_torch.tokenizer.bpe import ByteLevelBPETokenizer
from rag_llm_k8s_tpu_torch.tokenizer.hf_json import load_tokenizer
from rag_llm_k8s_tpu_torch.tokenizer.unigram import UnigramTokenizer

__all__ = ["load_tokenizer", "ByteLevelBPETokenizer", "UnigramTokenizer"]
