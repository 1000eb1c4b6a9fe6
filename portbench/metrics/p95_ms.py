"""p95_ms: see readers.p95_ms."""
from readers import p95_ms as read  # noqa: F401
