"""Whole runs of the one-card cells at their own sizes on the card: the
program correct, the eps = 1 control not.  They skip without a card;
run them on one with ``python -m pytest benchmark/tests/test_bench_card.py``
(about three minutes)."""

import pytest

from benchmark import core, plugins

ONE_CARD = [w["name"] for w in plugins.read_json(plugins.MANIFEST)[
    "workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_on_the_card(card, cell):
    sound = core.run(cell, 7100000001, 5.0, False, card)
    assert sound["correct"] and sound["checked"] > 0
    control = core.run(cell, 7100000002, 5.0, False, card,
                       control={"eps": 1.0})
    assert not control["correct"]
