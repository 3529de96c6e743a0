"""The bf16 continuous burst through two versions of the paged decode kernel, in one process.

``chip_smoke.py``'s service (Llama-3.1-8B and bge-m3 at full width, seeded
random weights, the store ingested by its one-shot phase) serves its
8-request continuous burst, then the last request alone, again and again.
Before each burst the model's paged decode attention is set to this tree's
wrapper ("change") or to the wrapper and kernel of another checkout
("parent", e.g. an unpacked ``git archive`` of the parent commit, whose
``ops/_build.py`` builds its own ``paged_attention.cu``), in the order
parent, change, change, parent, ``--rounds`` times. Everything else (the
model, the store, the scheduler's code, the other kernels) is this tree's,
so the two sides differ only in that wrapper and kernel; one process keeps
them on one host, one card and one power limit.

Run on the card from the repo root:

    python3 rag_llm_k8s_tpu_torch/tools/paged_decode_ab.py --parent _archive/parent --rounds 3

It prints ``chip_smoke.py``'s lines for each burst, then for each side
the burst wall times, the decode and mixed window times of the bursts and
the decode window times of the request alone, each list in run order with
its median.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import re
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_parent(parent: str):
    """The other checkout's ``ops/attention.py``, bound to its own
    ``ops/_build.py`` (its sources, its build directory, its counters)."""

    def load(name, file):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(os.path.abspath(parent), "rag_llm_k8s_tpu_torch", "ops", file))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    build = load("parent_ops_build", "_build.py")
    attention = load("parent_ops_attention", "attention.py")
    attention._build = build
    return attention, build


class _Tee(io.TextIOBase):
    """Writes through to ``out`` and keeps every line."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a checkout whose paged decode kernel is compared")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of parent, change, change, parent")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as c
    from rag_llm_k8s_tpu_torch.models import llama as L
    from rag_llm_k8s_tpu_torch.ops import _build
    from rag_llm_k8s_tpu_torch.ops import attention as A

    parent_attention, parent_build = load_parent(args.parent)
    parent_build.build(["paged_attention"])
    _build.build()
    sides = {"parent": parent_attention.paged_decode_attention, "change": A.paged_decode_attention}
    need = {"parent": tuple(k for k in c.CONTINUOUS_KERNELS if k != "paged_decode_attention"),
            "change": c.CONTINUOUS_KERNELS}
    bits = c.build_service()
    c.phase_service(bits)  # ingests the store the requests retrieve from
    tee = _Tee(sys.stdout)
    sys.stdout = tee
    try:
        for side in ["parent", "change", "change", "parent"] * args.rounds:
            # phase_continuous_service restores the model's wrapper from A
            # when it ends, so both are set
            A.paged_decode_attention = L.paged_decode_attention = sides[side]
            parent_build.reset_launches()
            c.phase_continuous_service(bits, tag=f"bf16 {side}", need=need[side], plain_yardstick=False)
            if side == "parent" and not parent_build.LAUNCHES["paged_decode_attention"]:
                c.fail("the parent's paged decode kernel was never launched")
    finally:
        A.paged_decode_attention = L.paged_decode_attention = sides["change"]
        sys.stdout = tee.out
    text = "".join(tee.text)
    for side in sides:
        burst = re.findall(rf"phase continuous_service bf16 {side}: .*?wall_s=([\d.]+) .*?"
                           rf"ms_per_decode_window=([\d.]+) .*?ms_per_mixed_window=([\d.]+)", text)
        alone = re.findall(rf"request bf16 {side} continuous /generate alone .*?ms_per_decode_window=([\d.]+)", text)
        cols = dict(wall_s=[b[0] for b in burst], decode_window_ms=[b[1] for b in burst],
                    mixed_window_ms=[b[2] for b in burst], alone_decode_window_ms=alone)
        summary = {k: dict(runs=[float(x) for x in v], median=statistics.median(float(x) for x in v))
                   for k, v in cols.items()}
        print(f"side {side}: {json.dumps(summary)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
