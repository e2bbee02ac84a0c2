"""Adaptive-Group communication (the paper's §3.2) over the port's own
transport: the :class:`~.group.Group` interface, ring relays, the grouped
direct-send exchange, the Hockney router, the exact narrow wire and the
lossy int8 gradient ring (:mod:`.compress`); an abstract rank on
``meta`` tensors for the dry-run (:mod:`.abstract`); partition specs
(:mod:`.spec`) and the collectives autograd differentiates
(:mod:`.differentiable`) for the LM on a mesh."""

from .abstract import AbstractGroup, AbstractMesh, CollectiveBytes  # noqa: F401
from .adaptive import (  # noqa: F401
    V5E_DCI,
    V5E_ICI,
    HockneyModel,
    calibrate,
    choose_mode,
    choose_mode_full,
    fused_cost,
    overlap_ratio,
    pipeline_cost,
)
from .compress import (  # noqa: F401
    WIRE_DTYPES,
    WIRE_ESCALATION,
    compressed_ring_reduce_scatter,
    int8_compress,
    int8_decompress,
    mask_column_count,
    mask_columns,
    mask_from_columns,
    narrow_cast,
    widen,
    wire_itemsize,
)
from .group import (  # noqa: F401
    Group,
    LocalGroup,
    LocalMesh,
    MeshAborted,
    ProcessGroupComm,
    ProcessMesh,
    RankContext,
    SoloGroup,
    Work,
    current_rank,
)
from .differentiable import (  # noqa: F401
    DifferentiableGroup,
    all_gather_cat,
    all_gather_cat_many,
    copy_to,
    gather_cat_replicated,
    gather_replicated,
    reduce_from,
    reduce_scatter,
    split,
)
from .pipelined import fused_exchange, grouped_exchange  # noqa: F401
from .ring import ring_allgather, ring_allgather_overlap, ring_reduce_scatter  # noqa: F401
from .spec import PartitionSpec, gather_whole, local_shape, shard_of  # noqa: F401
