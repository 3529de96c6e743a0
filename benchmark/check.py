"""What decides ``correct``: the timed path's own outputs against the plain
reference, once the window has closed and the program is gone.

For every answer served in the window:

- ``prompt_mismatch``: the prompt the reference assembles from the chunks
  the response names (``reference/assemble.py``, the reference's own
  tokenizer and the harness's chunk texts) is the prompt of one row that a
  generate call of the program ran, and the response's context is the
  reference's; else the answer counts here.
- ``text_mismatch``: the response's text is what that row's tokens decode
  to.

For a sample drawn from the seed, with the longest request in it:

- ``score_err``: the reference embeds the question (bge-m3, fp32) and
  measures its distance to every chunk of the index; the root mean square,
  over the chunks the sampled responses name, of how far the score a
  response prints for a chunk lies from the chunk's reference distance. A
  wrong embedding, a wrong distance or a chunk named for another row all
  show here. ``score_err_median``: the median over the sampled requests
  of each request's RMS of the same differences, steadier from seed to
  seed than the RMS over all of them, which a few requests carry. Each
  cell's limits file names the ones it compares. Not compared, and printed
  with the judged counts:
  ``retrieval_gap``, how far a named chunk's reference distance lies above
  the reference's best at its rank (the fp8 control leaves it at 0 on some
  seeds, so it has no upper reading).
- ``decode_gap``: the reference runs once over each
  sampled request's prompt and served tokens. A served token was drawn as
  ``argmax(l / T + g)`` over the top-p nucleus, with Gumbel noise ``g``
  from the call's generator (``torch.rand`` on the card, seeded as the
  call's generator was). The reference draws that noise again, and
  ``decode_gap`` is the widest amount by which the served token's perturbed
  reference logit lies below the best perturbed reference logit inside the
  reference's nucleus at ``P_STRICT`` (a little under the deployment's
  top-p, so that a token on the nucleus's edge, in one precision and not
  the other, cannot open a gap). Calls that ran the speculative loop draw differently
  (rejection sampling) and are left out of this sample; ``checked_tokens``
  counts what was compared.

The control (``control=True``) is the reference computed in fp8
(``reference/models.py``): the chunks its bge-m3 ranks first, judged as
the program's are (``control_score_err``, and ``control_retrieval_gap``), and
at each sampled position the token its decoder puts first under the same
noise (``control_decode_gap``). ``control_numbers`` puts them under the
program's names, and ``verdict`` holds them to the same limits: a control
run's ``correct`` is the control's.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark import traffic, weights
from benchmark.reference import assemble, models
from benchmark.reference.tokenize import PlainBPE, PlainUnigram

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT_DIR = os.path.join(HERE, "limits")
P_STRICT = 0.85


@dataclass
class Row:
    """One prompt row of one generate call of the program."""

    prompt: List[int]
    out: np.ndarray  # the row as the call returned it: [max_new]
    call: "Call"
    index: int

    def served(self, eos: Sequence[int]) -> List[int]:
        """The tokens drawn for this row: through its first EOS."""
        toks = [int(t) for t in self.out]
        for j, t in enumerate(toks):
            if t in eos:
                return toks[: j + 1]
        return toks

    def answer(self, eos: Sequence[int]) -> List[int]:
        s = self.served(eos)
        return s[:-1] if s and s[-1] in eos else s


@dataclass
class Call:
    """One run of the program's device program (``_device_run``)."""

    t0: float
    t1: float
    tokens: object  # [B, S] ids, on the card until the window closes
    mask: object  # [B, S] 0/1
    S: int
    max_new: int
    chunk: Optional[int]
    spec: bool
    gen_seed: int
    out: np.ndarray
    steps: int
    rows: List[Row] = field(default_factory=list)

    @property
    def B(self) -> int:
        return int(self.out.shape[0])

    def fetch(self) -> None:
        """Move the prompt rows to the host (after the window)."""
        tok = self.tokens.cpu().numpy()
        mask = self.mask.cpu().numpy()
        self.starts = [int(np.argmax(m)) for m in mask]
        self.rows = [Row([int(t) for t in tok[b][mask[b] == 1]], self.out[b], self, b)
                     for b in range(tok.shape[0]) if mask[b].sum() > 1]
        self.tokens = self.mask = None


def load_limits(cell: str):
    """A cell's limits (``limits/<cell>.json``): ``(limits by number,
    (retrieval sample, decode sample))``. Prompts of some thousands of
    tokens are judged a few at a time, so that the reference stays shorter
    than the window."""
    with open(os.path.join(LIMIT_DIR, f"{cell}.json")) as f:
        d = json.load(f)
    return {k: float(v) for k, v in d["limits"].items()}, (int(d["sample"]["retrieve"]), int(d["sample"]["decode"]))


def _gumbel_rows(call: Call, rows: Sequence[int], steps: int, vocab: int, device) -> Dict[int, torch.Tensor]:
    """The noise each of ``rows`` of ``call`` drew: ``[steps, vocab]`` per
    row, the ``j``-th ``torch.rand((B, vocab))`` of a generator seeded as the
    call's."""
    g = torch.Generator(device=device)
    g.manual_seed(int(call.gen_seed))
    got = {b: [] for b in rows}
    tiny = torch.finfo(torch.float32).tiny
    for _ in range(steps):
        u = torch.rand((call.B, vocab), generator=g, device=device, dtype=torch.float32)
        for b in rows:
            got[b].append(-torch.log(-torch.log(u[b].clamp_min(tiny))))
    return {b: torch.stack(v) for b, v in got.items()}


def _rms(v: Sequence[float]) -> float:
    return float(np.sqrt(np.mean(np.square(v)))) if len(v) else 0.0


def _median_rms(per_request: Sequence[Sequence[float]]) -> float:
    """The median over requests of each request's RMS."""
    v = [_rms(r) for r in per_request if len(r)]
    return float(np.median(v)) if v else 0.0


def _gaps(logits: torch.Tensor, noise: torch.Tensor, tokens: Sequence[int], temp: float) -> torch.Tensor:
    """Per position: the perturbed gap of ``tokens``."""
    z = logits.double() / temp
    p = torch.softmax(z, dim=-1)
    ps, order = torch.sort(p, dim=-1, descending=True)
    before = torch.cumsum(ps, dim=-1) - ps
    strict = torch.zeros_like(p, dtype=torch.bool).scatter_(1, order, before < P_STRICT)
    score = z + noise.double()
    best = torch.where(strict, score, torch.full_like(score, -float("inf"))).amax(dim=-1)
    t = torch.tensor(list(tokens), device=logits.device)[:, None]
    return (best - score.gather(1, t)[:, 0]).clamp_min(0.0)


def _first_in_nucleus(logits: torch.Tensor, noise: torch.Tensor, temp: float, top_p: float) -> List[int]:
    """The token a sampler at ``temp`` and ``top_p`` draws under ``noise``."""
    z = logits.double() / temp
    p = torch.softmax(z, dim=-1)
    ps, order = torch.sort(p, dim=-1, descending=True)
    before = torch.cumsum(ps, dim=-1) - ps
    keep = torch.zeros_like(p, dtype=torch.bool).scatter_(1, order, before < top_p)
    score = torch.where(keep, z + noise.double(), torch.full_like(z, -float("inf")))
    return score.argmax(dim=-1).tolist()


def judge(cfg: Dict, seed: int, mix: "traffic.Mix", metas: List[Dict], records: List[Dict], calls: List[Call],
          device, sampling: Dict, n_retrieve: int, n_decode: int, control: bool = False) -> Dict:
    """The numbers compared, by name, and what was judged."""
    model, enc = cfg["model"], cfg["encoder"]
    bos, eos = int(model["bos_token_id"]), [int(model["eos_token_id"])]
    largest = int(sampling["largest_bucket"])
    bpe, uni = PlainBPE(), PlainUnigram()
    by_prompt: Dict[tuple, List[Row]] = {}
    for c in calls:
        for r in c.rows:
            by_prompt.setdefault(tuple(r.prompt), []).append(r)

    numbers: Dict[str, float] = {"prompt_mismatch": 0, "text_mismatch": 0}
    judged = []
    for rec in records:
        if rec["status"] != 200:
            continue
        body = rec["body"]
        shown = assemble.parse_context(body.get("context", ""))
        items = [(metas[traffic.row_of(fn, cid, mix)], score) for fn, cid, score in shown]
        pw = assemble.piecewise(bpe, rec["q"], [m for m, _ in items], bos, largest)
        if pw is not None:
            n, ids = pw
            context = assemble.context_text(items[:n])
        else:
            context, ids = assemble.whole_string(bpe, rec["q"], items, bos, largest)
        rows = by_prompt.get(tuple(ids), [])
        if not shown or context != body.get("context") or not rows:
            numbers["prompt_mismatch"] += 1
            continue
        texts = [assemble.extract_answer(bpe.decode(r.answer(eos))) for r in rows]
        if body.get("generated_text") not in texts:
            numbers["text_mismatch"] += 1
            continue
        row = rows[texts.index(body["generated_text"])]
        judged.append({"rec": rec, "row": row, "shown": shown, "ids": ids})

    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, 7])

    def sample(pool: List[Dict], n: int) -> List[Dict]:
        if not pool:
            return []
        longest = max(range(len(pool)), key=lambda i: len(pool[i]["ids"]) + len(pool[i]["row"].out))
        rest = [i for i in range(len(pool)) if i != longest]
        pick = [longest] + [rest[i] for i in rng.permutation(len(rest))[: max(0, n - 1)]]
        return [pool[i] for i in pick]

    # retrieval
    ret = sample(judged, n_retrieve)
    eseed = weights.tensor_seed(seed, "encoder")
    limit = int(enc["max_encode_len"])
    toks = []
    for j in ret:
        t = uni.encode(j["rec"]["q"])
        if len(t) > limit:
            t = t[:limit]
            t[-1] = uni.eos_id
        toks.append(t)
    gap = emax = cgap = 0.0
    errs, cerrs = [], []
    if ret:
        e = models.embed(enc, eseed, toks, device)
        ec = models.embed(enc, eseed, toks, device, quant="fp8") if control else e
        x = weights.index_vectors(weights.tensor_seed(seed, "index"), mix.chunks, int(enc["hidden_size"]),
                                  device).double()
        xn = (x * x).sum(dim=1)
        for j, q, qc in zip(ret, e, ec):
            d = (q @ q) + xn - 2.0 * (x @ q)
            best = torch.sort(d).values
            errs.append([])
            for r, (fn, cid, score) in enumerate(j["shown"]):
                dr = float(d[traffic.row_of(fn, cid, mix)])
                gap = max(gap, dr - float(best[r]))
                errs[-1].append(float(score) - dr)
            if control:
                # the chunks the fp8 embedding ranks first, judged alike
                dc = (qc @ qc) + xn - 2.0 * (x @ qc)
                top = torch.sort(dc).indices[: len(j["shown"])]
                cerrs.append([])
                for r, row in enumerate(top.tolist()):
                    cgap = max(cgap, float(d[row]) - float(best[r]))
                    cerrs[-1].append(float(dc[row]) - float(d[row]))
        del x, xn, e, ec
    for side, per in (("program", errs), ("control", cerrs)):
        if per:
            print(f"retrieval errors per request ({side}, score - reference distance): "
                  + json.dumps([[float(f"{v:.4g}") for v in req] for req in per]), file=sys.stderr)
    numbers["score_err_median"] = _median_rms(errs)
    if control:
        numbers["control_score_err_median"] = _median_rms(cerrs)
    errs = [v for req in errs for v in req]
    cerrs = [v for req in cerrs for v in req]
    numbers["score_err"] = _rms(errs)
    readings = {"retrieval_gap": gap}
    if control:
        numbers["control_score_err"] = _rms(cerrs)
        numbers["control_retrieval_gap"] = cgap
        readings["control_retrieval_gap"] = cgap

    # decode
    dec = sample([j for j in judged if not j["row"].call.spec], n_decode)
    temp, top_p = float(sampling["temperature"]), float(sampling["top_p"])
    seqs, want, served = [], [], []
    for j in dec:
        s = j["row"].served(eos)
        P = len(j["ids"])
        seqs.append(j["ids"] + s[:-1])
        want.append(range(P - 1, P - 1 + len(s)))
        served.append(s)
    numbers["checked_tokens"] = sum(len(s) for s in served)
    dgap = cgap = 0.0
    if dec:
        dseed = weights.tensor_seed(seed, "decoder")
        ref = models.decoder_logits(model, dseed, seqs, want, device)
        ctl = models.decoder_logits(model, dseed, seqs, want, device, quant="fp8") if control else None
        V = int(model["vocab_size"])
        for k, (j, s) in enumerate(zip(dec, served)):
            row = j["row"]
            noise = _gumbel_rows(row.call, [row.index], len(s), V, device)[row.index]
            dgap = max(dgap, float(_gaps(ref[k], noise, s, temp).max()))
            if ctl is not None:
                firsts = _first_in_nucleus(ctl[k], noise, temp, top_p)
                cgap = max(cgap, float(_gaps(ref[k], noise, firsts, temp).max()))
    numbers["decode_gap"] = dgap
    if control:
        numbers["control_decode_gap"] = cgap
    return {"numbers": numbers, "readings": readings, "judged": len(judged), "retrieval_sample": len(ret),
            "decode_sample": len(dec)}


def control_numbers(numbers: Dict[str, float]) -> Dict[str, float]:
    """The numbers with the control in the program's place: its
    ``score_err``, ``score_err_median`` and ``decode_gap`` under those names (the prompt, the
    text and the sample's size are the run's own), for ``verdict``."""
    out = {k: v for k, v in numbers.items() if not k.startswith("control_")}
    for name in ("score_err", "score_err_median", "decode_gap"):
        out[name] = numbers[f"control_{name}"]
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float], failed: int) -> (bool, Dict[str, List[float]]):
    """``correct`` and each number beside its limit. ``checked_tokens`` and
    ``served`` have lower limits; every other number an upper one."""
    checks = {"failed": [failed, 0]}
    ok = failed == 0
    for name, lim in limits.items():
        v = numbers.get(name)
        if v is None:
            ok = False
            checks[name] = [None, lim]
            continue
        checks[name] = [v, lim]
        ok = ok and ((v >= lim) if name in ("checked_tokens", "served") else (v <= lim))
    return ok, checks
