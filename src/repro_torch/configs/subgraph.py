"""Counting-workload configs — the paper's own experiment grid (Table 2/Fig 5).

A data copy of ``repro/configs/subgraph.py``'s ``CountingConfig`` rows
and its ``ServiceWorkloadConfig`` request scripts.
The port's launcher runs the single-device rows through
:meth:`CountingConfig.to_request`; the distributed fields (``num_shards``,
``mode``, ...) ride the request as the reference's do, and the single
backend drops them.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CountingConfig", "COUNTING_CONFIGS", "PAPER_DATASETS", "ServiceWorkloadConfig",
           "SERVICE_WORKLOADS"]


@dataclasses.dataclass(frozen=True)
class CountingConfig:
    name: str
    num_vertices: int
    num_edges: int  # undirected
    template: str  # name in core.templates.TEMPLATES
    num_shards: int  # graph shards over the data axis
    mode: str = "adaptive"  # alltoall | pipeline | adaptive | ring
    group_factor: int = 1
    bucket_tile: int = 128  # §3.3 task size of the tiled bucket layout
    skew: int = 3  # RMAT skew when synthesized
    compact: bool = False
    density_threshold: float = 0.25
    capacity_factor: float = 1.5
    wire_dtype: str = "float32"
    adaptive: str = "model"
    templates: tuple = ()
    mesh_kind: str = "grid"
    max_retries: int | None = None
    checkpoint_every: int = 0
    target_rsd: float | None = None

    @property
    def avg_degree(self) -> float:
        return 2 * self.num_edges / self.num_vertices

    def synthesize(self, seed: int = 0):
        """Materialize the configured RMAT graph (randomly relabeled)."""
        from ..core.graphs import relabel_random, rmat

        g = rmat(self.num_vertices, self.num_edges, skew=self.skew, seed=seed, name=self.name)
        return relabel_random(g, seed=seed + 1)

    def to_request(self, graph=None, *, backend: str = "auto", n_iter=None, eps=None,
                   delta: float = 0.1, batch=None, **plan_opts):
        """Resolve this config row to a :class:`repro_torch.api.CountRequest`
        (the reference's ``to_request``, ``configs/subgraph.py:73-113``).

        ``graph`` defaults to the synthesized RMAT dataset.  The request
        carries both backends' options, and ``plan_opts`` overrides or
        extends the row's own (e.g. ``fuse=True``, ``device="cpu"``).
        """
        from ..api import CountRequest

        if graph is None:
            graph = self.synthesize()
        return CountRequest(
            graph=graph,
            template=self.template,
            backend=backend,
            n_iter=n_iter,
            eps=eps,
            delta=delta,
            batch=batch,
            max_retries=self.max_retries,
            checkpoint_every=self.checkpoint_every,
            target_rsd=self.target_rsd,
            plan_opts={
                "num_shards": self.num_shards,
                "mode": self.mode,
                "group_factor": self.group_factor,
                "bucket_tile": self.bucket_tile,
                "compact": self.compact,
                "density_threshold": self.density_threshold,
                "capacity_factor": self.capacity_factor,
                "wire_dtype": self.wire_dtype,
                "adaptive": self.adaptive,
                **plan_opts,
            },
        )


# Paper Table 2 datasets (name -> (V, E, source))
PAPER_DATASETS = {
    "miami": (2_100_000, 51_000_000, "social network"),
    "orkut": (3_000_000, 230_000_000, "social network"),
    "nyc": (18_000_000, 480_000_000, "social network"),
    "twitter": (44_000_000, 2_000_000_000, "Twitter users"),
    "sk-2005": (50_000_000, 3_800_000_000, "UbiCrawler"),
    "friendster": (66_000_000, 5_000_000_000, "social network"),
    "rmat-250m": (5_000_000, 250_000_000, "PaRMAT"),
    "rmat-500m": (5_000_000, 500_000_000, "PaRMAT"),
}

COUNTING_CONFIGS = {
    "rmat500-u10-2": CountingConfig("rmat500-u10-2", *PAPER_DATASETS["rmat-500m"][:2],
                                    template="u10-2", num_shards=16,
                                    mode="pipeline", mesh_kind="grid"),
    "rmat500-u12-2": CountingConfig("rmat500-u12-2", *PAPER_DATASETS["rmat-500m"][:2],
                                    template="u12-2", num_shards=16,
                                    mode="alltoall", mesh_kind="grid"),
    "twitter-u12-2": CountingConfig("twitter-u12-2", *PAPER_DATASETS["twitter"][:2],
                                    template="u12-2", num_shards=256,
                                    mode="ring", mesh_kind="flat"),
    "rmat500-u12-2-ring": CountingConfig(
        "rmat500-u12-2-ring", *PAPER_DATASETS["rmat-500m"][:2],
        template="u12-2", num_shards=256, mode="ring", mesh_kind="flat"),
    "friendster-u12-1": CountingConfig(
        "friendster-u12-1", *PAPER_DATASETS["friendster"][:2],
        template="u12-1", num_shards=256, mode="ring", mesh_kind="flat"),
    "rmat-sparse-u10-2": CountingConfig(
        "rmat-sparse-u10-2", 50_000_000, 25_000_000, template="u10-2",
        num_shards=16, mode="pipeline", compact=True),
    "rmat500-family": CountingConfig(
        "rmat500-family", *PAPER_DATASETS["rmat-500m"][:2],
        template="u10-2", num_shards=16, mode="pipeline",
        templates=("u5-2", "u7-2", "u10-2")),
    "bench-sparse": CountingConfig("bench-sparse", 4_096, 6_000,
                                   template="u10-2", num_shards=8, skew=8,
                                   compact=True, density_threshold=0.5),
    "bench-small": CountingConfig("bench-small", 20_000, 200_000, template="u5-2",
                                  num_shards=8),
    "bench-medium": CountingConfig("bench-medium", 50_000, 1_000_000,
                                   template="u10-2", num_shards=8),
    "bench-family": CountingConfig("bench-family", 20_000, 200_000,
                                   template="u7-2", num_shards=8,
                                   templates=("u3-1", "u5-2", "u7-2")),
    "bench-cycles": CountingConfig(
        "bench-cycles", 256, 2_000, template="cycle5", num_shards=8,
        templates=("cycle3", "cycle5", "diamond")),
    "bench-tw2-mixed": CountingConfig(
        "bench-tw2-mixed", 256, 2_000, template="cycle6", num_shards=8,
        templates=("u3-1", "cycle4", "u5-2", "cycle6", "diamond")),
}


@dataclasses.dataclass(frozen=True)
class ServiceWorkloadConfig:
    """A synthetic multi-tenant request stream for the counting service.

    ``graph`` names a :data:`COUNTING_CONFIGS` row (synthesized at run
    time); ``requests`` is the admission script — ``(tenant, templates,
    kwargs)`` tuples submitted in order, each repeated ``repeats`` times so
    the plan cache and the coalescer have something to chew on.  The
    service runs with ``n_colors = k`` and per-call batch ``batch``.
    """

    name: str
    graph: str  # COUNTING_CONFIGS row to synthesize
    k: int  # service-wide shared color budget
    batch: int = 8
    repeats: int = 1
    requests: tuple = ()  # ((tenant, templates, kwargs), ...)

    def counting_config(self) -> CountingConfig:
        return COUNTING_CONFIGS[self.graph]


SERVICE_WORKLOADS = {
    # three tenants, overlapping template families and shared default key:
    # alice re-asks the same family (plan-cache hits), bob's family shares
    # subtrees with alice's, carol's scalar queries coalesce into whatever
    # family pass is in flight
    "bench-service": ServiceWorkloadConfig(
        "bench-service", graph="bench-small", k=7, batch=8, repeats=2,
        requests=(
            ("alice", ("u3-1", "u5-2"), {"n_iter": 48}),
            ("bob", ("u5-2", "u7-2"), {"n_iter": 32}),
            ("carol", ("u3-1",), {"n_iter": 64, "target_rsd": 0.2}),
            ("alice", ("u3-1", "u5-2"), {"n_iter": 24}),
            ("carol", ("u5-2",), {"n_iter": 40}),
        ),
    ),
    # single-tenant smoke row for CI (small budgets, tiny graph)
    "smoke-service": ServiceWorkloadConfig(
        "smoke-service", graph="bench-small", k=5, batch=4,
        requests=(
            ("alice", ("u3-1", "u5-2"), {"n_iter": 8}),
            ("bob", ("u5-2",), {"n_iter": 8}),
            ("alice", ("u3-1",), {"n_iter": 12}),
        ),
    ),
}
