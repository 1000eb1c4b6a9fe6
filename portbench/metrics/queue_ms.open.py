"""queue_ms.open: see readers.queue_ms."""
from readers import queue_ms as read  # noqa: F401
