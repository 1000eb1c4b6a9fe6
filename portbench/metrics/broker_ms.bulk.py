"""broker_ms.bulk: see readers.broker_ms."""
from readers import broker_ms as read  # noqa: F401
