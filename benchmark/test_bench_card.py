"""The control on the card, at the cells' own sizes: with the reference in
fp8 put in the program's place, the harness's own verdict comes out not
correct, while the program's run in the same process passes. ``python3 -m
pytest benchmark -m card`` on a machine with an H100 (about three minutes a
cell)."""

import pytest

from benchmark import harness


@pytest.mark.card
@pytest.mark.parametrize("name", ["nemo12b.rag.c16", "nemo12b.longdoc.c8"])
def test_the_fp8_control_fails_where_the_program_passes(card, name):
    from benchmark import run

    cell = harness.load_cell(name)
    r = run.execute(cell, 2**31 + 4242, 30.0, control=True)
    print(name, "control:", r["checks"], "program:", r["program"]["checks"])
    assert r["program"]["correct"], r["program"]["checks"]
    assert not r["correct"], r["checks"]
    assert any(v > lim for k, (v, lim) in r["checks"].items() if k in ("score_err", "decode_gap")), r["checks"]
