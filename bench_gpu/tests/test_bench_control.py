"""The control of each traffic mix comes out not correct: on the CPU at a
tiny size here, and on the card at the cell's own size (`-m gpu`).  The
control is the program with the mix's `control` switched on: for `asm` its
own config overlay with error removal off, for `ec` its corrector with
Hamming clustering off (tau = 0)."""
from __future__ import annotations

import pytest

from bench_gpu import harness

MOVES = {"isolate.asm": "contig_kmers_absent_ppm", "isolate.ec": "ec_wrong_bases_ppm"}


@pytest.mark.parametrize("workload", sorted(MOVES))
def test_control_is_not_correct(tiny_root, workload):
    res = harness.run(workload, 2**31 + 99, 1, False, device="cpu", root=tiny_root, control=True,
                      log=lambda m: None)
    assert res["correct"] is False
    c = res["checks"][MOVES[workload]]
    assert c["value"] >= 3 * c["limit"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(MOVES))
def test_control_on_the_card_at_the_cells_size(card, workload):
    res = harness.run(workload, 2**31 + 7, 1, False, control=True, log=lambda m: None)
    assert res["correct"] is False
    c = res["checks"][MOVES[workload]]
    assert c["value"] > c["limit"]
