"""setup_s: see readers.setup_s."""
from readers import setup_s as read  # noqa: F401
