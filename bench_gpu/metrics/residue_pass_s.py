"""residue_pass_s: seconds per job in the kmer-mapper's host residue pass
(the program's `map_store.residue` spans, `alignment/mapper.py`), summed
over every K and both mates; 0 in a job where no store mapped with a
kmer-mapper on the device."""
from bench_gpu.spans import span_seconds


def read(rec):
    return span_seconds(rec, ("map_store.residue",))
