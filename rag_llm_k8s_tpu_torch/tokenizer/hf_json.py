"""Dispatch loader for HF ``tokenizer.json`` files (the port's copy of
``rag_llm_k8s_tpu/tokenizer/hf_json.py``)."""

from __future__ import annotations

import json
import os


def load_tokenizer(path: str, native: bool = True):
    """Load a tokenizer from a ``tokenizer.json`` file or a directory holding
    one. Returns :class:`ByteLevelBPETokenizer` or :class:`UnigramTokenizer`
    depending on the model type; ``native`` is the BPE tokenizer's switch
    for its C++ merge loop."""
    from rag_llm_k8s_tpu_torch.tokenizer.bpe import ByteLevelBPETokenizer
    from rag_llm_k8s_tpu_torch.tokenizer.unigram import UnigramTokenizer

    if os.path.isdir(path):
        path = os.path.join(path, "tokenizer.json")
    with open(path, encoding="utf-8") as f:
        kind = json.load(f)["model"]["type"]
    if kind == "BPE":
        return ByteLevelBPETokenizer.from_tokenizer_json(path, native=native)
    if kind == "Unigram":
        return UnigramTokenizer.from_tokenizer_json(path)
    raise ValueError(f"unsupported tokenizer model type: {kind}")
