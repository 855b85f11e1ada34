"""Sample generators, one module per name that a configuration gives under
`generator`.  Each has `make(params, seed) -> dict` with the keys `r1`, `r2`
((n, rl) uint8 base codes), `genomes` (a list of uint8 code arrays) and,
where the generator knows them, `q1`, `q2` (ASCII qualities) and `clean1`,
`clean2` (the reads before their substitutions)."""
