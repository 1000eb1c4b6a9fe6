"""Launchers of the port: the serving CLI's LM back end (:mod:`.serve`) and
the recsys family's serve and retrieval steps (:mod:`.steps`); the CLI
itself is still to port (ROADMAP.md, Queue 1 item 9)."""
