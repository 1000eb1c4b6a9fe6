"""mfu.open: see readers.mfu_backend."""
from readers import mfu_backend as read  # noqa: F401
