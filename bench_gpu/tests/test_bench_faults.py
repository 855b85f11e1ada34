"""A run with the timed path broken underneath comes out not correct, for
each fault the cells can have: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced or left
out where it is written.  (The
cells run on one chip: there is no exchange between chips to leave out.)
The runs skip the harness's look for a chip and run the program on the CPU
at a tiny size; the unbroken run is correct."""
from __future__ import annotations

import pytest

from bench_gpu import harness

SEED = 2**31 + 4242


def _run(root, workload):
    return harness.run(workload, SEED, 1, False, device="cpu", root=root, log=lambda m: None)


def _flip(seq: str, every: int) -> str:
    swap = {"A": "C", "C": "A", "G": "T", "T": "G"}
    return "".join(swap.get(c, c) if i % every == every // 2 else c for i, c in enumerate(seq))


@pytest.mark.parametrize("workload", ["isolate.asm", "isolate.ec"])
def test_sound_run_is_correct(tiny_root, workload):
    assert _run(tiny_root, workload)["correct"] is True


def _half_of_the_reads(monkeypatch):
    import spades_tpu_torch.io.fastx as fastx

    inner = fastx.read_fastx

    def read_fastx(path, *args, **kwargs):
        for i, rec in enumerate(inner(path, *args, **kwargs)):
            if i % 2 == 0:
                yield rec

    monkeypatch.setattr(fastx, "read_fastx", read_fastx)


def test_asm_simplification_returns_its_graph_unchanged(tiny_root, monkeypatch):
    from spades_tpu_torch.pipeline import spades_stages

    for cls in (spades_stages.Simplification, spades_stages.RawSimplification):
        monkeypatch.setattr(cls, "run", lambda self, ctx: None)
    res = _run(tiny_root, "isolate.asm")
    assert res["correct"] is False
    c = res["checks"]["contig_kmers_absent_ppm"]
    assert c["value"] > c["limit"]


def test_asm_half_of_the_reads_left_out(tiny_root, monkeypatch):
    _half_of_the_reads(monkeypatch)
    res = _run(tiny_root, "isolate.asm")
    assert res["correct"] is False
    assert res["checks"]["k1_kmers_off"]["value"] > 0


def test_asm_contigs_altered_where_written(tiny_root, monkeypatch):
    import dataclasses

    from spades_tpu_torch.pipeline import spades_stages

    inner = spades_stages.write_contigs

    def write_contigs(path, contigs):
        inner(path, [dataclasses.replace(c, seq=_flip(c.seq, 1000)) for c in contigs])

    monkeypatch.setattr(spades_stages, "write_contigs", write_contigs)
    res = _run(tiny_root, "isolate.asm")
    assert res["correct"] is False
    c = res["checks"]["contig_kmers_absent_ppm"]
    assert c["value"] > c["limit"]


def test_asm_half_of_the_contigs_left_out_where_written(tiny_root):
    from bench_gpu import calibrate

    undo = calibrate.FAULTS["half_contigs"]()     # the fault read on the card
    try:
        res = _run(tiny_root, "isolate.asm")
    finally:
        undo()
    assert res["correct"] is False
    c = res["checks"]["genome_kmers_missing_ppm"]
    assert c["value"] > c["limit"]


def _wrap_correct_reads(monkeypatch, change):
    import spades_tpu_torch.hammer as hammer

    inner = hammer.correct_reads

    def correct_reads(seqs, *args, **kwargs):
        out, stats = inner(seqs, *args, **kwargs)
        return change(seqs, out), stats

    monkeypatch.setattr(hammer, "correct_reads", correct_reads)


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_ec_faults(tiny_root, monkeypatch, fault):
    change = {
        "unchanged": lambda seqs, out: list(seqs),
        "half_left_out": lambda seqs, out: list(out[: len(out) // 2]) + list(seqs[len(seqs) // 2 :]),
        "altered": lambda seqs, out: [_flip(s, 150) for s in out],
    }[fault]
    _wrap_correct_reads(monkeypatch, change)
    res = _run(tiny_root, "isolate.ec")
    assert res["correct"] is False
    c = res["checks"]["ec_wrong_bases_ppm"]
    assert c["value"] > c["limit"]
