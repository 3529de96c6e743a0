"""The multi-rank dry run of the training step: the training half of the
JAX package's ``__graft_entry__.dryrun_multichip``, on ``torch.distributed``.

One step of ``engine.training.make_train_step`` on a mesh of ``n`` ranks
(``parallel/launch.py``, one process each), at JAX's dry-run shapes: with 8
or more ranks the mesh is ``dp=2 x sp=2 x tp=n/4``, so all three axes run
in one step (the dp-sliced batch and its gradient sum, the ring over sp,
the tp-sharded projections); with 4, ``2 x 1 x 2``; else tp alone. The
model is the tiny Llama with kv heads sized to divide tp (``dryrun_config``),
fp32, seeded random weights (``models.convert.init_random_sharded``); the
batch is ``2 * dp`` rows of 16 seeded random tokens. Every rank must reach
the same finite loss.

Run: ``python -m rag_llm_k8s_tpu_torch.parallel.dryrun [--devices 8]
[--device cpu]`` (by default rank ``r`` takes ``cuda:(r % device_count)``;
ranks sharing a card, or the CPU, talk over gloo).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional

import torch

from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, LlamaConfig, MeshConfig
from rag_llm_k8s_tpu_torch.engine.training import make_train_step
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.parallel.launch import spawn_world

SEQ = 16


def dryrun_mesh(n_devices: int) -> MeshConfig:
    """JAX's dry-run mesh over ``n_devices`` ranks."""
    if n_devices % 8 == 0:
        dp, sp = 2, 2
    elif n_devices % 4 == 0:
        dp, sp = 2, 1
    else:
        dp, sp = 1, 1
    return MeshConfig(dp=dp, sp=sp, tp=n_devices // (dp * sp))


def dryrun_config(tp: int) -> LlamaConfig:
    """The tiny Llama with its heads sized to divide ``tp``."""
    return dataclasses.replace(LlamaConfig.tiny(), num_heads=max(8, tp), num_kv_heads=max(8, tp), head_dim=16,
                               hidden_size=64, intermediate_size=128)


def dryrun_rank(ctx) -> float:
    """One rank's step on its mesh ``ctx``; returns the loss (raises if it
    is not finite)."""
    config, dtypes = dryrun_config(ctx.tp), DTypePolicy.fp32()
    model = convert.init_random_sharded(config, dtypes, ctx, torch.Generator(device=ctx.device).manual_seed(0),
                                        attn_impl="xla", trainable=True)
    init_opt, train_step = make_train_step(config, dtypes, mesh=ctx)
    tokens = torch.randint(0, config.vocab_size, (2 * ctx.dp, SEQ), generator=torch.Generator().manual_seed(1))
    loss = float(train_step(model, init_opt(model), tokens, torch.ones_like(tokens)))
    if not math.isfinite(loss):
        raise FloatingPointError(f"dry run: non-finite loss {loss} on rank {ctx.rank}")
    return loss


def dryrun_multichip(n_devices: int = 8, device: Optional[str] = None) -> float:
    """The dry run on ``n_devices`` ranks; returns the loss."""
    mesh = dryrun_mesh(n_devices)
    losses = spawn_world(dryrun_rank, mesh, device=device)
    if len(set(losses)) != 1:
        raise RuntimeError(f"dry run: the ranks' losses differ: {losses}")
    print(f"dryrun_multichip({n_devices}): mesh dp={mesh.dp} sp={mesh.sp} tp={mesh.tp} loss={losses[0]:.4f}")
    return losses[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One training step on a dp x sp x tp mesh of processes.")
    ap.add_argument("--devices", type=int, default=8, help="ranks (8: dp=2 x sp=2 x tp=2)")
    ap.add_argument("--device", default=None, help="'cpu' runs every rank on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
