"""Counting-service launcher of the port: ``python -m repro_torch.launch.serve``.

Boots a resident :class:`~repro_torch.serve.CountingService` over a
synthesized graph and drives a scripted multi-tenant request stream through
it (:data:`repro_torch.configs.subgraph.SERVICE_WORKLOADS`), printing
per-request results and the service's cache/coalescing/fairness counters —
the single-process analogue of N clients sharing one resident engine, with
the flags of ``repro.launch.serve``.  The plans live on ``--device``
(``cuda`` unless ``--device cpu``); ``--backend distributed`` runs a
``LocalMesh`` of the config row's ``num_shards`` thread ranks there.

Run::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload bench-service
    PYTHONPATH=src python -m repro_torch.launch.serve --workload smoke-service \\
        --backend single --repeats 1 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --threaded --timeout-s 30 \\
        --deadline-s 60 --shed-oldest --max-pending 16
"""

from __future__ import annotations

import argparse
import json

from ..configs.subgraph import SERVICE_WORKLOADS
from ..serve import CountingService, ServiceConfig


def run_workload(
    wl,
    *,
    backend: str = "auto",
    repeats: int | None = None,
    batch: int | None = None,
    seed: int = 0,
    verbose: bool = True,
    threaded: bool = False,
    deadline_s: float | None = None,
    device: str = "cuda",
    **config_kw,
):
    """Drive one scripted workload; returns ``(tickets, service)``.

    ``threaded`` runs the §20 driver thread (submits race the scheduler —
    the production shape) instead of the synchronous drain; ``deadline_s``
    applies a per-request relative deadline; ``device`` is where the plans
    live; extra keywords land on :class:`~repro_torch.serve.ServiceConfig`
    (``shed_oldest=``, ``timeout_s=``, ``max_pending=``, ...).
    """
    cfg = wl.counting_config()
    graph = cfg.synthesize(seed=seed)
    opts = {"device": device}
    if backend == "distributed":
        opts["num_shards"] = cfg.num_shards
    svc = CountingService(
        graph,
        n_colors=wl.k,
        backend=backend,
        plan_opts=opts,
        config=ServiceConfig(batch=batch or wl.batch, **config_kw),
    )
    if threaded:
        svc.start()
    tickets = []
    for _ in range(repeats if repeats is not None else wl.repeats):
        for tenant, templates, kw in wl.requests:
            if deadline_s is not None:
                kw = dict(kw, timeout_s=deadline_s)
            tickets.append(svc.submit(tenant, templates, **kw))
    svc.run_until_idle()
    if threaded:
        svc.stop()
    if verbose:
        for t in tickets:
            if t.status != "done":
                print(f"  {t}: {t.status.upper()} — {t.error}")
                continue
            r = t.result()
            ests = getattr(r, "estimates", None)
            shown = (f"{r.estimate:.6g}" if ests is None
                     else "[" + ", ".join(f"{e:.6g}" for e in ests) + "]")
            print(f"  {t}: {shown}  niter={r.niter}  "
                  f"latency={t.latency_s:.3f}s")
    return tickets, svc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="bench-service", choices=sorted(SERVICE_WORKLOADS))
    ap.add_argument("--backend", default="auto", choices=("auto", "single", "distributed"))
    ap.add_argument("--repeats", type=int, default=None,
                    help="override the workload's request-stream repeats")
    ap.add_argument("--batch", type=int, default=None, help="override the per-call coloring batch")
    ap.add_argument("--seed", type=int, default=0, help="graph synthesis seed")
    ap.add_argument("--json", action="store_true",
                    help="print the stats dict as JSON (for scripting)")
    ap.add_argument("--threaded", action="store_true",
                    help="drive the service on the background driver thread")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline (relative seconds from submit)")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-pass-call supervisor timeout (hang detection)")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="pass-call retries before quarantine (default 0)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="global bounded-queue depth (queued + active)")
    ap.add_argument("--max-pending-per-tenant", type=int, default=None,
                    help="per-tenant bounded-queue depth")
    ap.add_argument("--shed-oldest", action="store_true",
                    help="under overload, shed the oldest queued request "
                         "instead of rejecting the new submit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the plans live (the CPU runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg_kw = {}
    if args.timeout_s is not None:
        cfg_kw["timeout_s"] = args.timeout_s
    if args.max_retries is not None:
        cfg_kw["max_retries"] = args.max_retries
    if args.max_pending is not None:
        cfg_kw["max_pending"] = args.max_pending
    if args.max_pending_per_tenant is not None:
        cfg_kw["max_pending_per_tenant"] = args.max_pending_per_tenant
    if args.shed_oldest:
        cfg_kw["shed_oldest"] = True

    wl = SERVICE_WORKLOADS[args.workload]
    print(f"workload {wl.name}: graph={wl.graph} k={wl.k} "
          f"{len(wl.requests)} requests x {args.repeats or wl.repeats}")
    tickets, svc = run_workload(
        wl,
        backend=args.backend,
        repeats=args.repeats,
        batch=args.batch,
        seed=args.seed,
        threaded=args.threaded,
        deadline_s=args.deadline_s,
        device=args.device,
        **cfg_kw,
    )
    stats = svc.stats()
    if args.json:
        print(json.dumps(stats, indent=2, default=str))
    else:
        cache = stats["cache"]
        print(f"served {stats.get('completed', 0)} "
              f"(failed {stats.get('failed', 0)}, "
              f"cancelled {stats.get('cancelled', 0)}, "
              f"expired {stats.get('deadline_exceeded', 0)}, "
              f"shed {stats.get('shed', 0)}) | "
              f"coalescing x{stats['coalescing_factor']:.2f} | "
              f"plan cache {cache['hits']}/{cache['hits'] + cache['misses']} "
              f"hits ({cache['hit_rate']:.0%}), "
              f"{cache['evictions']} evictions | "
              f"backfill {stats.get('backfill_calls', 0)} calls | "
              f"driver errors {stats['driver']['errors']}")
        for name, ts in stats["tenants"].items():
            print(f"  tenant {name}: charged={ts['charged']} "
                  f"weight={ts['weight']} "
                  f"saturation={ts['saturation']:.0%}")


if __name__ == "__main__":
    main()
