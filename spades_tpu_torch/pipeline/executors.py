"""Executor surface: pipeline descriptions and batch-system submission.

Capability mirror of SPAdes' executor family
(`src/projects/spades/pipeline/spades_pipeline/executors/`:
`ExecutorSaveYaml` dumps `run_spades.yaml`, `commands_parser.py:33-70` dumps
`run_spades.sh`, `ExecutorSLURM` builds sbatch job chains).  The pipeline
runs in-process, so a "command" is a stage record; the YAML/sh artifacts keep
the same shape so downstream tooling (and `--continue` style re-runs) keep
working, and the SLURM writer emits a submittable script for cluster
schedulers.

`run_spades.yaml` is written by a small emitter of its own, not PyYAML, so
the CLI runs where PyYAML is not installed; its bytes are what
`yaml.safe_dump(commands, sort_keys=False)` writes for a pipeline
description."""
from __future__ import annotations

import os
import re
import shlex
import sys

# strings YAML 1.1 would read back as booleans or null (PyYAML's resolvers)
_YAML_SPECIAL = {
    "yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE", "false",
    "False", "FALSE", "on", "On", "ON", "off", "Off", "OFF", "null", "Null",
    "NULL",
}
# a plain (unquoted) scalar: starts with a letter or '_', no character that
# YAML gives a meaning to, no space at either end
_YAML_PLAIN = re.compile(r"[A-Za-z_](?:[A-Za-z0-9_ ./'-]*[A-Za-z0-9_./-])?")


def pipeline_description(k_list, mode: str, careful: bool, has_long: bool, has_hmms: bool):
    """The outer command list (run_spades.yaml shape): one entry per K plus
    the shared outer stages."""
    cmds = [
        {"STAGE": "preprocess", "stage": "before_start"},
        {"STAGE": "error correction", "stage": "error_correction"},
    ]
    for i, k in enumerate(k_list):
        stages = ["construction", "ec_threshold_finder", "simplification", "gap_closer_late"]
        if i == len(k_list) - 1:
            if has_long:
                stages.append("hybrid_aligning")
            if careful:
                stages.append("mismatch_correction")
            stages.append("repeat_resolving")
            if has_hmms:
                stages.append("domain_analysis")
        stages.append("contig_output")
        cmds.append({"STAGE": f"K{k}", "stage": f"spades_k{k}", "phases": stages})
    cmds.append({"STAGE": "copy files", "stage": "terminate"})
    return cmds


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if not isinstance(v, str):
        raise TypeError(f"run_spades.yaml holds no {type(v).__name__} values")
    if _YAML_PLAIN.fullmatch(v) and v not in _YAML_SPECIAL:
        return v
    if any(c < " " or c == "\x7f" for c in v):
        raise ValueError(f"run_spades.yaml holds no control characters: {v!r}")
    return "'" + v.replace("'", "''") + "'"


def yaml_list_of_dicts(commands: list[dict]) -> str:
    """Block-style YAML of a list of flat dicts (values: scalars or lists of
    scalars), as `yaml.safe_dump(commands, sort_keys=False)` lays it out.
    Strings that start with a digit or a symbol are single-quoted, where
    PyYAML would leave some of them plain; they load back the same."""
    if not commands:
        return "[]\n"
    out = []
    for cmd in commands:
        if not cmd:
            out.append("- {}")
            continue
        for i, (key, v) in enumerate(cmd.items()):
            lead = "- " if i == 0 else "  "
            k = _yaml_scalar(key)
            if isinstance(v, (list, tuple)):
                if not v:
                    out.append(f"{lead}{k}: []")
                    continue
                out.append(f"{lead}{k}:")
                out.extend(f"  - {_yaml_scalar(x)}" for x in v)
            else:
                out.append(f"{lead}{k}: {_yaml_scalar(v)}")
    return "\n".join(out) + "\n"


def dump_yaml(path: str, commands: list[dict]) -> None:
    with open(path, "w") as fh:
        fh.write(yaml_list_of_dicts(commands))


def dump_sh(path: str, argv: list[str]) -> None:
    """run_spades.sh: re-runs this assembly with the same arguments."""
    with open(path, "w") as fh:
        fh.write("#!/bin/bash\nset -e\n")
        fh.write(
            f"{shlex.quote(sys.executable)} -m spades_tpu_torch.pipeline.main "
            + " ".join(shlex.quote(a) for a in argv)
            + "\n"
        )
    os.chmod(path, 0o755)


def dump_slurm(path: str, argv: list[str], threads: int = 16, memory_gb: int = 250,
               partition: str | None = None, time_limit: str = "24:00:00",
               nnodes: int = 1, extra: str | None = None) -> None:
    """submit_spades.sh: sbatch script (executor_slurm.py surface; the
    --grid-queue/--grid-time/--grid-nnodes/--grid-extra option family)."""
    with open(path, "w") as fh:
        fh.write("#!/bin/bash\n")
        fh.write("#SBATCH --job-name=spades_tpu_torch\n")
        fh.write(f"#SBATCH --cpus-per-task={threads}\n")
        fh.write(f"#SBATCH --mem={memory_gb}G\n")
        fh.write(f"#SBATCH --time={time_limit}\n")
        if nnodes > 1:
            fh.write(f"#SBATCH --nodes={nnodes}\n")
        if partition:
            fh.write(f"#SBATCH --partition={partition}\n")
        if extra:
            fh.write(f"#SBATCH {extra}\n")
        fh.write("set -e\n")
        fh.write(
            f"{shlex.quote(sys.executable)} -m spades_tpu_torch.pipeline.main "
            + " ".join(shlex.quote(a) for a in argv)
            + "\n"
        )
    os.chmod(path, 0o755)
