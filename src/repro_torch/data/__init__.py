from repro_torch.data.corpus import (
    Corpus,
    DataIndex,
    make_corpus,
    doc_term_matrix,
    train_test_split,
)

__all__ = [
    "Corpus",
    "DataIndex",
    "make_corpus",
    "doc_term_matrix",
    "train_test_split",
]
