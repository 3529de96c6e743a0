"""Training step: the causal-LM loss and an AdamW update, on one device or
a ``dp x sp x tp`` mesh; counterpart of ``rag_llm_k8s_tpu/engine/training.py``.

- ``lm_loss(model, tokens, mask)``: the model over the batch
  (``lm_logits``) with the key window of ``mask_window(mask)`` and
  positions ``clip(cumsum(mask) - 1, 0)`` (right-padded rows), then the next-token cross entropy in fp32 of
  ``logits[:, :-1]``, weighted by ``mask[:, :-1] * mask[:, 1:]``, summed and
  divided by ``max(sum(w), 1)``. The forward runs without a cache
  (``cache=None``): JAX's loss throws its cache away.
- ``make_train_step(config, ...)`` returns ``(init_opt_state,
  train_step)``, the PyTorch idiom of JAX's pair: ``init_opt_state(model)``
  builds the optimizer over the model's parameters and
  ``train_step(model, opt_state, tokens, mask)`` updates the model in
  place and returns the fp32 loss. The default optimizer is JAX's
  ``optax.adamw(1e-5)``: ``torch.optim.AdamW`` at lr 1e-5, betas (0.9,
  0.999), eps 1e-8 and weight decay 1e-4 on every parameter (torch's own
  default decay is 0.01).

The model trains through the plain attention (``attn_impl="xla"``, as
JAX's step builds its model): the kernels have no backward. Build it with
``models.llama.build_llama(..., attn_impl="xla", trainable=True)`` (on a
mesh, ``parallel.sharding.shard_llama_params`` or
``models.convert.init_random_sharded`` with the same two arguments).

On a mesh each rank takes its dp slice of the batch (the batch arrives
whole on every rank, as in the tests, and its rows must divide over dp).
The loss is the global masked mean: each rank sums ``nll * w`` over its
rows and divides by the weight summed over dp; the gradients are summed
over dp only, since the collectives' rules (``core/mesh.py``) already give
every tp and sp rank the whole gradient of a replicated parameter. With
``sp > 1`` attention runs as the differentiable ring
(``parallel/ring_attention.py``) when ``S`` divides over sp.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Optional, Tuple

import torch

from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, LlamaConfig
from rag_llm_k8s_tpu_torch.core.device import DeviceLike, resolve_device
from rag_llm_k8s_tpu_torch.models.llama import LlamaModel, mask_window

# JAX's optax.adamw(1e-5): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
default_optimizer: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer] = functools.partial(
    torch.optim.AdamW, lr=1e-5, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
)


def loss_terms(logits: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum(nll * w), sum(w))`` of next-token prediction, fp32: ``nll``
    of ``tokens[:, 1:]`` under ``log_softmax(logits[:, :-1])``, ``w =
    mask[:, :-1] * mask[:, 1:]``."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    w = (mask[:, :-1] * mask[:, 1:]).float()
    return (nll * w).sum(), w.sum()


def lm_logits(model: LlamaModel, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The loss's forward: logits ``[B, S, V]`` of right-padded ``tokens``
    under ``mask``, without a cache."""
    kv_start, kv_len = mask_window(mask)
    positions = (torch.cumsum(mask, dim=-1) - 1).clamp_min(0)
    return model(tokens, positions, None, kv_start, kv_len, 0)


def lm_loss(model: LlamaModel, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy, fp32, masked mean over ``tokens [B, S]``
    with ``mask [B, S]`` (1 = real token, one contiguous run per row)."""
    total, weight = loss_terms(lm_logits(model, tokens, mask), tokens, mask)
    return total / weight.clamp_min(1.0)


def _check_model(model: LlamaModel, config: LlamaConfig, dtypes: DTypePolicy, mesh) -> None:
    if model.config != config or model.dtypes != dtypes:
        raise ValueError("train_step: the model's config or dtypes differ from make_train_step's")
    if model.attn_impl != "xla":
        raise ValueError("train_step: the model must attend through the plain version (attn_impl='xla'); "
                         "the kernels have no backward")
    if not all(p.requires_grad for p in model.parameters()):
        raise ValueError("train_step: build the model with build_llama(..., trainable=True)")
    if mesh is not None and model.mesh is not mesh:
        raise ValueError("train_step: the model is not this mesh's shard")
    if mesh is None and model.mesh is not None and model.mesh.world > 1:
        raise ValueError("train_step: the model is a mesh shard; pass make_train_step(..., mesh=)")


def make_train_step(
    config: LlamaConfig,
    dtypes: DTypePolicy = DTypePolicy(),
    optimizer: Optional[Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]] = None,
    mesh=None,
    device: DeviceLike = None,
):
    """``(init_opt_state, train_step)`` for models of ``config`` and
    ``dtypes`` on ``device`` (default: the mesh's device, else the card;
    raises without one unless ``device="cpu"``). ``optimizer`` builds the
    optimizer from the parameters (default ``default_optimizer``). ``mesh``
    (a ``core.mesh.MeshContext``): every rank calls ``train_step`` with the
    whole batch and its own shard of the model."""
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    make_opt = optimizer or default_optimizer
    dp = mesh.dp if mesh is not None else 1

    def init_opt_state(model: LlamaModel) -> torch.optim.Optimizer:
        _check_model(model, config, dtypes, mesh)
        return make_opt(model.parameters())

    def train_step(model: LlamaModel, opt_state: torch.optim.Optimizer, tokens, mask) -> torch.Tensor:
        _check_model(model, config, dtypes, mesh)
        tokens = torch.as_tensor(tokens, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        if dp > 1:
            B = tokens.shape[0]
            if B % dp:
                raise ValueError(f"train_step: batch {B} does not divide over dp={dp}")
            rows = slice(mesh.axis_index("dp") * (B // dp), (mesh.axis_index("dp") + 1) * (B // dp))
            tokens, mask = tokens[rows], mask[rows]
        opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            total, weight = loss_terms(lm_logits(model, tokens, mask), tokens, mask)
            if dp > 1:
                weight = mesh.all_reduce(weight.detach().clone(), "dp")
            loss = total / weight.clamp_min(1.0)
            loss.backward()
        if dp > 1:
            for p in model.parameters():
                if p.grad is None:  # every rank takes part in every sum
                    p.grad = torch.zeros_like(p)
                mesh.all_reduce(p.grad, "dp")
            loss = mesh.all_reduce(loss.detach().clone(), "dp")
        opt_state.step()
        return loss.detach()

    return init_opt_state, train_step
