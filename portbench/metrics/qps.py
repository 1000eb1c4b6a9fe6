"""qps: see readers.qps."""
from readers import qps as read  # noqa: F401
