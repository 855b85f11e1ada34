"""MTS (metagenomic time series) capability surface.

Mirror of SPAdes' `src/projects/mts/`: multi-sample k-mer
multiplicity profiles (`kmer_multiplicity_counter.cpp`), contig abundance
profiles (`contig_abundance.{hpp,cpp}`), profile-based binning (the Snakemake
workflow's binner step), and read binning (`read_binning.cpp`).
"""
from .multiplicity import KmerProfiles, combine_multiplicities
from .abundance import contig_profiles, median_mad, winsorized_mean_var
from .binning import canopy_bins

__all__ = [
    "KmerProfiles",
    "combine_multiplicities",
    "contig_profiles",
    "median_mad",
    "winsorized_mean_var",
    "canopy_bins",
]
