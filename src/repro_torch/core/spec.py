"""The reserved pad key of the static-shape serving contract.

Only ``PAD_KEY`` of ``repro.core.spec`` is ported so far; the declarative
``CacheSpec`` comes in a later slice (ROADMAP.md, Queue 1 item 4).
"""

#: The reserved *pad key*: a sentinel query id that is never admitted,
#: never hits, and never displaces a resident entry in any cache engine.
#: The broker pads ragged batches up to shape buckets with it.  Its 64-bit
#: hash is pinned to all-ones (``repro_torch.serving.device_cache.PAD_H64``);
#: ``splitmix64`` never hashes a real key there (or to 0, the empty-slot
#: sentinel).  Real query ids are always >= 0.
PAD_KEY = -1
