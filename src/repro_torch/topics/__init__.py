"""Topic substrate of the port: LDA training/inference + query-topic
assignment, and the pipeline from a query log to the cache's statistics.
The same names as ``repro.topics``, plus :func:`assign_topics_csr`."""
from .assign import TopicAssignment, assign_topics, assign_topics_csr
from .lda import BagOfWords, LDAModel, em_train, gibbs_train, infer_argmax, infer_scores
from .pipeline import TopicPipelineResult, oracle_pipeline, run_pipeline

__all__ = [
    "BagOfWords",
    "LDAModel",
    "TopicAssignment",
    "TopicPipelineResult",
    "assign_topics",
    "assign_topics_csr",
    "em_train",
    "gibbs_train",
    "infer_argmax",
    "infer_scores",
    "oracle_pipeline",
    "run_pipeline",
]
