"""Sequencing-library dataset model.

Capability mirror of SPAdes' library descriptors
(`src/common/library/library.hpp` `io::SequencingLibrary`,
`io::DataSet`, `io::LibraryType`, and `library_data.hpp` per-library stats):
typed libraries (paired-end, mate-pairs, single, long reads, contig inputs)
with orientation, YAML (de)serialization compatible with SPAdes'
dataset YAML (`--dataset`), and the RF->FR mate transform used throughout the
paired-info machinery."""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core import dna

# SPAdes library type strings (library.hpp LibraryType enum)
PAIRED_TYPES = ("paired-end", "mate-pairs", "hq-mate-pairs")
LONG_TYPES = ("pacbio", "nanopore", "sanger", "tslr")
CONTIG_TYPES = ("trusted-contigs", "untrusted-contigs", "path-extend-contigs", "fl-rna")
SINGLE_TYPES = ("single",)
ALL_TYPES = PAIRED_TYPES + LONG_TYPES + CONTIG_TYPES + SINGLE_TYPES

DEFAULT_ORIENTATION = {"paired-end": "fr", "mate-pairs": "rf", "hq-mate-pairs": "fr"}


@dataclass
class SequencingLibrary:
    """One library: type + read sequences (+ per-lib stats once estimated)."""

    type: str = "paired-end"
    orientation: str = ""
    left: list[str] = field(default_factory=list)    # left mates / all reads
    right: list[str] = field(default_factory=list)   # right mates (paired only)
    # parallel PHRED strings ("" when the source was FASTA) — consumed by the
    # quality-aware hammer path (projects/hammer/kmer_cluster.cpp analog)
    left_quals: list[str] = field(default_factory=list)
    right_quals: list[str] = field(default_factory=list)
    # per-library data (library_data.hpp): filled in by the pipeline
    read_length: int = 0
    insert_size: float = 0.0
    insert_size_dev: float = 0.0

    def __post_init__(self):
        if not self.orientation:
            self.orientation = DEFAULT_ORIENTATION.get(self.type, "fr")

    @property
    def is_paired(self) -> bool:
        return self.type in PAIRED_TYPES

    @property
    def is_mate_pair(self) -> bool:
        return self.type in ("mate-pairs",)

    @property
    def is_long(self) -> bool:
        return self.type in LONG_TYPES

    def all_reads(self) -> list[str]:
        return self.left + self.right

    def fr_pairs(self) -> tuple[list[str], list[str]]:
        """Mates in FR orientation: RF libraries (mate-pairs) have both mates
        reverse-complemented, turning an RF pair into an FR pair with the same
        insert size (the transform SPAdes applies when feeding
        mate-pairs through the FR paired-info path)."""
        if self.orientation == "rf":
            return (
                [dna.revcomp_str(s) for s in self.left],
                [dna.revcomp_str(s) for s in self.right],
            )
        return self.left, self.right


@dataclass
class DataSet:
    libraries: list[SequencingLibrary] = field(default_factory=list)

    def paired(self) -> list[SequencingLibrary]:
        return [l for l in self.libraries if l.is_paired]

    def long_reads(self) -> list[str]:
        return [s for l in self.libraries if l.is_long for s in l.left]

    def contigs(self) -> list[str]:
        return [s for l in self.libraries if l.type in CONTIG_TYPES for s in l.left]

    def singles(self) -> list[str]:
        return [s for l in self.libraries if l.type in SINGLE_TYPES for s in l.left]

    def all_short_reads(self) -> list[str]:
        out: list[str] = []
        for l in self.libraries:
            if l.is_paired:
                out += l.left + l.right
            elif l.type in SINGLE_TYPES:
                out += l.left
        return out


def load_dataset_yaml(path: str) -> DataSet:
    """Parse SPAdes' dataset YAML (list of library dicts)."""
    import yaml

    from .fastx import read_fastx

    with open(path) as fh:
        data = yaml.safe_load(fh)
    ds = DataSet()
    for entry in data or []:
        t = entry.get("type", "paired-end")
        lib = SequencingLibrary(type=t, orientation=entry.get("orientation", "").lower())
        for key in ("left reads",):
            for f in entry.get(key, []):
                lib.left += [r.seq for r in read_fastx(f)]
        for key in ("right reads",):
            for f in entry.get(key, []):
                lib.right += [r.seq for r in read_fastx(f)]
        for key in ("single reads", "merged reads"):
            for f in entry.get(key, []):
                lib.left += [r.seq for r in read_fastx(f)]
        if entry.get("interlaced reads"):
            for f in entry["interlaced reads"]:
                rs = [r.seq for r in read_fastx(f)]
                lib.left += rs[0::2]
                lib.right += rs[1::2]
        ds.libraries.append(lib)
    return ds


def iter_fr_libs(paired) -> list[tuple[list[str], list[str], str]]:
    """Normalize a mixed list (legacy (l, r) tuples or SequencingLibrary) into
    (left, right, type) triples in FR orientation."""
    out = []
    for lib in paired:
        if isinstance(lib, SequencingLibrary):
            l, r = lib.fr_pairs()
            out.append((l, r, lib.type))
        else:
            l, r = lib
            out.append((l, r, "paired-end"))
    return out
