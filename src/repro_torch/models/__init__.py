"""Model stack of the port: the LM family's dense transformer
(:mod:`.transformer`: serving and ``loss_fn``) on the building blocks of
:mod:`.common`, and the recsys family's models and losses (:mod:`.recsys`).
The GNN family is not ported yet (ROADMAP.md, Queue 1 item 12)."""
