"""Model stack of the port: the LM family's dense transformer
(:mod:`.transformer`) on the building blocks of :mod:`.common`.  The GNN
and recsys families are not ported yet (ROADMAP.md, Queue 1 item 12)."""
