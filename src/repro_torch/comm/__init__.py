"""Adaptive-Group communication (the paper's §3.2) over the port's own
transport: the :class:`~.group.Group` interface, ring relays, the grouped
direct-send exchange and the Hockney router.  The narrow wire of
``repro/comm/compress.py`` waits for ROADMAP queue 1 item 7."""

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
)
from .pipelined import fused_exchange, grouped_exchange  # noqa: F401
from .ring import ring_allgather, ring_allgather_overlap, ring_reduce_scatter  # noqa: F401
