"""Model stack of the port: the LM family's dense transformer
(:mod:`.transformer`) on the building blocks of :mod:`.common`, and the
recsys family's serving path (:mod:`.recsys`).  The GNN family is not
ported yet (ROADMAP.md, Queue 1 item 12)."""
