"""parse_s: seconds per job in the CLI's FASTQ parse (the program's
`cli.parse` spans, one per file read, `pipeline/main.py`)."""
from bench_gpu.spans import span_seconds


def read(rec):
    return span_seconds(rec, ("cli.parse",))
