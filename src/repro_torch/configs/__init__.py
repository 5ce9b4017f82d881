"""Configurations of the port: the LDA model MLego trains and merges."""
from repro_torch.configs.lda_default import DEFAULT as LDA_DEFAULT
from repro_torch.configs.lda_default import LDAConfig

__all__ = ["LDAConfig", "LDA_DEFAULT"]
