"""idle_share.bulk: see readers.idle_share."""
from readers import idle_share as read  # noqa: F401
