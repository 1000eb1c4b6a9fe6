"""broker_ms.open: see readers.broker_ms."""
from readers import broker_ms as read  # noqa: F401
