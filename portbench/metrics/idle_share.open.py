"""idle_share.open: see readers.idle_share."""
from readers import idle_share as read  # noqa: F401
