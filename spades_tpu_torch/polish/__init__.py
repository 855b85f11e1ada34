"""Post-assembly polishing (spades-corrector-core capability surface)."""
from .corrector import CorrectorConfig, polish_contigs  # noqa: F401
