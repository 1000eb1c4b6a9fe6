"""hit_rate.bulk: see readers.hit_rate."""
from readers import hit_rate as read  # noqa: F401
