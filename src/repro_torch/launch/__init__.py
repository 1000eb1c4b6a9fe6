"""Launchers of the port.  So far only the serving CLI's LM back end
(:mod:`.serve`); the CLI itself is still to port (ROADMAP.md, Queue 1
item 9)."""
