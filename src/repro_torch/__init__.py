"""PyTorch + CUDA port of the topical result cache (``repro``) for NVIDIA
Hopper.

The JAX package ``repro`` stays the reference; this package imports
nothing of it (and nothing of JAX).  Layout mirrors ``repro``:

* :mod:`repro_torch.core`, :mod:`repro_torch.freshness` -- copies of the
  numpy pieces the port needs (the log's training statistics
  ``VecStats`` among them);
* :mod:`repro_torch.querylog` -- the synthetic query log with its clicked
  documents;
* :mod:`repro_torch.topics` -- the paper's topic pipeline: MAP-EM LDA and
  the query-topic assignment that plans the cache's topic layer;
* :mod:`repro_torch.kernels.cache_ops` -- the cache ops and their two
  hand-written CUDA kernels (``csrc/cache_ops.cu``), each beside its plain
  PyTorch version;
* :mod:`repro_torch.kernels.topic_score` -- LDA topic inference and its
  hand-written CUDA kernel (``csrc/topic_score.cu``), beside its plain
  PyTorch version;
* :mod:`repro_torch.kernels.decode_attention` -- GQA decode attention over
  a KV cache and its hand-written CUDA kernel (``csrc/decode_attention.cu``),
  beside its plain PyTorch version;
* :mod:`repro_torch.kernels.embedding_bag` -- the recsys EmbeddingBag and
  its hand-written CUDA kernel (``csrc/embedding_bag.cu``), beside its
  plain PyTorch version;
* :mod:`repro_torch.models`, :mod:`repro_torch.configs` -- the dense LM
  (forward, prefill, KV-cache decode, ``loss_fn``), the recsys models and
  losses (two-tower, SASRec, DIN, MIND) and their architectures;
* :mod:`repro_torch.train` -- AdamW and Adafactor, the synthetic token
  stream and the checkpoints;
* :mod:`repro_torch.launch.serve`, :mod:`repro_torch.launch.train` -- the
  serving CLI (with its LM back end) and the training CLI;
* :mod:`repro_torch.launch.steps` -- the LM's train, prefill and decode
  steps, the recsys train, serve and retrieval steps;
* :mod:`repro_torch.serving` -- the device cache and the broker.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise.
"""
