"""Architecture configs of the port: the LM, GNN and recsys registry with
its 40 dry-run cells, and a module per architecture."""
from .registry import ARCHS, Arch, ShapeSpec, all_cells, get_arch

__all__ = ["ARCHS", "Arch", "ShapeSpec", "all_cells", "get_arch"]
