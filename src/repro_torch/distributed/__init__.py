"""Distribution substrate (port of ``repro.distributed``): the sharding
rules of the "fsdp × tensor" policy and their DTensor placements
(``sharding``), explicit reduce-scatter and all-gather gradient sync
(``collectives``), activation layout constraints (``annotate``), the
int8 candidate and gradient codecs (``compression``), hierarchical tree
selection in one process, over a single-controller mesh or over a
``torch.distributed`` group one program a rank (``tree_select``), and one
process per leaf over a ``TCPStore`` (``process_tree``)."""
from repro_torch.distributed import (
    collectives,
    compression,
    process_tree,
    sharding,
    tree_select,
)

__all__ = ["collectives", "compression", "process_tree", "sharding", "tree_select"]
