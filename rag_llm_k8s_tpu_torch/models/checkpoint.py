"""Converted-parameter cache, the counterpart of
``rag_llm_k8s_tpu/models/checkpoint.py`` (orbax there): the converted model
is written next to the staged weights as one safetensors file of its own
parameter names (``utils/safetensors_io``; no pickle), so a later boot reads
it straight into an unfilled model instead of converting the HF layout again
(for ``quant="int8"``, instead of quantizing again on the host).

The cache holds whichever layout was converted; ``cache_location`` keys
its directory by quant mode (``CACHE_SUBDIR``, ``CACHE_SUBDIR_int8``) and,
on a mesh of more than one rank, by the mesh's shape, with one shard file
per rank (``params.rank{r}.safetensors``): a tp=2 boot never reads a tp=1
cache. A cache whose parameter names, shapes or dtypes differ from the
model it is restored into fails the restore, and the model is converted
again.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional, Tuple

import torch

from rag_llm_k8s_tpu_torch.utils.safetensors_io import SafetensorsFile, save_file

logger = logging.getLogger(__name__)

CACHE_SUBDIR = "tpu_rag_param_cache"
PARAMS_FILE = "params.safetensors"


def cache_location(model_dir: str, quant: str = "bf16", mesh=None) -> Tuple[str, str]:
    """``(directory, file name)`` of the converted-parameter cache for a
    quant mode and, on a mesh of more than one rank, that mesh's shape and
    this rank."""
    d = os.path.join(model_dir, CACHE_SUBDIR if quant == "bf16" else f"{CACHE_SUBDIR}_{quant}")
    if mesh is None or mesh.world == 1:
        return d, PARAMS_FILE
    return f"{d}_mesh{mesh.dp}x{mesh.sp}x{mesh.tp}", f"params.rank{mesh.rank}.safetensors"


def save_params(path: str, model: torch.nn.Module, filename: str = PARAMS_FILE) -> None:
    """Write ``model``'s parameters under the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    save_file(dict(model.named_parameters()), os.path.join(path, filename))
    logger.info("saved the converted-parameter cache at %s", os.path.join(path, filename))


@torch.no_grad()
def restore_params(path: str, template: torch.nn.Module, filename: str = PARAMS_FILE) -> torch.nn.Module:
    """Fill ``template`` (an unfilled model of the cached structure, on its
    device) from the cache under ``path``. Raises ``ValueError`` when the
    names, shapes or dtypes differ."""
    st = SafetensorsFile(os.path.join(path, filename))
    params = dict(template.named_parameters())
    if set(st.keys()) != set(params):
        extra, missing = set(st.keys()) - set(params), set(params) - set(st.keys())
        raise ValueError(f"param cache structure mismatch: unexpected {sorted(extra)[:3]}, "
                         f"missing {sorted(missing)[:3]}")
    for name, p in params.items():
        if st.shape(name) != tuple(p.shape):
            raise ValueError(f"param cache: {name} has shape {st.shape(name)}, the model {tuple(p.shape)}")
    for name, p in params.items():
        t = st.get(name)
        if t.dtype != p.dtype:
            raise ValueError(f"param cache: {name} is {t.dtype}, the model {p.dtype}")
        p.copy_(t)
    return template


def load_params_cached(
    model_dir: str,
    convert: Callable[[], torch.nn.Module],
    abstract_params_fn: Optional[Callable[[], torch.nn.Module]] = None,
    cache_dir: Optional[str] = None,
    info: Optional[dict] = None,
    filename: str = PARAMS_FILE,
) -> torch.nn.Module:
    """Restore the converted model from the cache, or convert it from the
    staged safetensors (``convert``) and write the cache.
    ``abstract_params_fn`` builds the unfilled target model; without it the
    cache is never read. ``info["params_source"]`` records which happened
    (``"cache"`` or ``"converted"``). ``filename`` names this rank's
    file (``cache_location``)."""
    cache = cache_dir or os.path.join(model_dir, CACHE_SUBDIR)
    info = {} if info is None else info
    if os.path.exists(os.path.join(cache, filename)) and abstract_params_fn is not None:
        try:
            model = restore_params(cache, abstract_params_fn(), filename)
            logger.info("restored params from the cache %s", cache)
            info["params_source"] = "cache"
            return model
        except (OSError, ValueError, KeyError):
            logger.exception("param cache restore failed; reconverting")
    model = convert()
    info["params_source"] = "converted"
    try:
        save_params(cache, model, filename)
    except OSError:  # caching is best-effort
        logger.exception("param cache save failed (continuing without cache)")
    return model
