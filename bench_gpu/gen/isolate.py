"""An isolate: one genome with planted repeats, FR pairs with substitutions
and phred qualities (`make_e2e_dataset`, `error_qualities`)."""
from __future__ import annotations

from .synthetic import error_qualities, make_e2e_dataset


def make(params: dict, seed: int) -> dict:
    genome, r1, r2, c1, c2 = make_e2e_dataset(
        params["genome_nt"], params["coverage"], params["read_length"],
        params["error_rate"], seed=seed, insert_mean=params["insert_mean"],
        insert_sd=params["insert_sd"], truth=True)
    return {"r1": r1, "r2": r2, "clean1": c1, "clean2": c2, "genomes": [genome],
            "q1": error_qualities(r1, c1, seed + 1), "q2": error_qualities(r2, c2, seed + 2)}
