"""Streaming ingestion & speculative capital building.

Turns the static model store into a living one: ``IngestPipeline``
appends document batches and trains per-time-slice base models in the
background, ``Compactor`` keeps the resulting capital under a byte
budget (merge-family compaction + cold eviction), and
``SpeculativeTrainer`` pre-trains the gap segments the serving layer's
query log predicts will be asked again.  Every store mutation all
three make flows through ``ModelStore.subscribe`` — the same channel
manual saves use — so plan caches and device LRUs stay coherent
without any new invalidation machinery.
"""
from repro_torch.ingest.compaction import (
    CompactionPolicy,
    CompactionReport,
    CompactionTotals,
    Compactor,
)
from repro_torch.ingest.pipeline import IngestPipeline, IngestReport
from repro_torch.ingest.speculate import (
    SPECULATION_TENANT,
    QueryLogEntry,
    SpeculationReport,
    SpeculativeTrainer,
)

__all__ = [
    "CompactionPolicy",
    "CompactionReport",
    "CompactionTotals",
    "Compactor",
    "IngestPipeline",
    "IngestReport",
    "QueryLogEntry",
    "SPECULATION_TENANT",
    "SpeculationReport",
    "SpeculativeTrainer",
]
