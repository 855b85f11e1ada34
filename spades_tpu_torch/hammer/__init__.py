from .hammer import HammerConfig, correct_reads
