"""Default LDA configuration for the MLego core (the paper's own model).

Paper setting (§VI.A): K=100 topics, 100 max iterations.  The CUDA
kernels of the port take K and V as they are; ``padded_topics`` and
``padded_vocab`` keep the JAX package's 128-multiples for callers that
compare layouts.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class LDAConfig:
    n_topics: int = 100
    vocab_size: int = 8192
    alpha: float = 0.5         # document-topic Dirichlet prior
    eta: float = 0.01          # topic-word Dirichlet prior
    max_iters: int = 100       # M_i in the paper's cost model
    e_step_iters: int = 20     # inner coordinate-ascent iterations
    gibbs_sweeps: int = 30
    decay: float = 0.95        # DSGS decay factor lambda (Eq. 9)
    mean_change_tol: float = 1e-3
    seed: int = 0

    @property
    def padded_topics(self) -> int:
        return ((self.n_topics + 127) // 128) * 128

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128


DEFAULT = LDAConfig()
