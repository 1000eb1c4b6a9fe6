"""mfu.bulk: see readers.mfu_window."""
from readers import mfu_window as read  # noqa: F401
