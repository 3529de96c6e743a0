"""Prompt assembly (a copy of the JAX package's module, plain format only).

- context block: ``Document '{filename}' (chunk {chunk_id}, score: {d:.4f}): {text}\\n\\n``
  for the top results;
- full prompt: ``{SYSTEM_MESSAGE}\\n\\nContext: {context}\\n\\nUser: {q}\\n\\nChatbot:``.
"""

from __future__ import annotations

from typing import Sequence

from rag_llm_k8s_tpu_torch.core.config import SYSTEM_MESSAGE


def assemble_context(results: Sequence, top_n: int = 3) -> str:
    """``results`` are ``index.store.SearchResult``s (metadata + distance)."""
    context = ""
    for r in results[:top_n]:
        doc = r.metadata
        context += (
            f"Document '{doc.get('filename')}' (chunk {doc.get('chunk_id')}, "
            f"score: {r.distance:.4f}): {doc.get('text')}\n\n"
        )
    return context


def assemble_prompt(
    user_prompt: str, context: str, system_message: str = SYSTEM_MESSAGE
) -> str:
    return f"{system_message}\n\nContext: {context}\n\nUser: {user_prompt}\n\nChatbot:"


def extract_answer(generated_text: str) -> str:
    """The answer is what follows the last 'Chatbot:'."""
    return generated_text.split("Chatbot:")[-1].strip()
