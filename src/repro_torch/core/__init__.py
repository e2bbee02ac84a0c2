"""Host-side planning and the single-device DP engine of the port.

The names below are the reference package's (``repro.core``); most callers
go through :class:`repro_torch.api.Counter`:
  - templates: Tree, template(name), partition_tree, automorphism_count
  - graphs: Graph, rmat, erdos_renyi, from_edges, load_edge_file,
    save_npz/load_npz
  - table_program: run_table_program, the partition-chain DP
  - count_engine: build_counting_plan, colorful_map_count, count_fn,
    plan_sample_fn
  - estimator: estimate_counts, niter_bound
  - supervisor: Supervisor, RetryPolicy
The distributed engine is ``core.distributed``; ``core.brute_force`` holds
the exact oracles.
"""

from .templates import (  # noqa: F401
    TEMPLATES,
    TemplateDag,
    Tree,
    automorphism_count,
    compile_templates,
    partition_complexity,
    partition_tree,
    path_tree,
    random_tree,
    spider_tree,
    star_tree,
    template,
)
from .graphs import (  # noqa: F401
    Graph,
    GraphFormatError,
    erdos_renyi,
    from_edges,
    load_edge_file,
    load_npz,
    relabel_random,
    rmat,
    save_npz,
)
from .table_program import (  # noqa: F401
    build_node_tables,
    local_node_fn,
    root_count,
    run_table_program,
)
from .count_engine import (  # noqa: F401
    CountingPlan,
    MultiCountingPlan,
    build_counting_plan,
    build_multi_counting_plan,
    colorful_map_count,
    colorful_map_count_many,
    count_fn,
    count_fn_many,
    multi_sample_fn,
    plan_sample_fn,
)
from .estimator import (  # noqa: F401
    CountEstimate,
    EstimationAborted,
    EstimatorState,
    MultiCountEstimate,
    ResumeMismatchError,
    estimate_counts,
    estimate_counts_many,
    niter_bound,
    num_groups_for,
)
from .supervisor import (  # noqa: F401
    QuarantinedBatch,
    RetryPolicy,
    Supervisor,
)
