"""serve_fused_roofline.open: see readers.serve_fused_roofline."""
from readers import serve_fused_roofline as read  # noqa: F401
