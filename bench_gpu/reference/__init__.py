"""The plain reference: NumPy code that works out again what the program's
outputs should hold and judges them.  One module per check that a traffic
mix names under `checks`; each has `readings(job, sample, traffic) -> dict`
of the numbers compared and `NEEDS`, the program state it reads besides the
job's output directory.  Nothing here imports the program, `spades_tpu` or
`jax`."""
