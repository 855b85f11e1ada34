"""Profile HMMs: HMMER3 text IO and PathRacer's cursor DP over the graph
(host numpy, the same code as `spades_tpu.hmm`)."""
from .align import align_hmm_to_graph, viterbi_score
from .io import ProfileHMM, read_hmm

__all__ = ["ProfileHMM", "read_hmm", "viterbi_score", "align_hmm_to_graph"]
