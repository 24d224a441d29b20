"""Distributed selection (port of ``repro.distributed``): the int8
candidate and gradient codecs (``compression``), hierarchical tree
selection over one process or a mesh (``tree_select``), and one process
per leaf over a ``TCPStore`` (``process_tree``).  The model-parallel
modules of the reference (``sharding``, ``collectives``, ``annotate``)
need more than one card and are a later item (ROADMAP.md queue 1)."""
from repro_torch.distributed import compression, process_tree, tree_select

__all__ = ["compression", "process_tree", "tree_select"]
