"""Quickstart on the PyTorch/CUDA port: count tree subgraphs in a graph with
the Counter facade.

Counts 4-vertex stars in a small Erdos-Renyi graph through
``repro_torch.api.Counter``, compares the (eps, delta) estimate with the
exact count, estimates a template family in one pass a coloring, and
prints the paper's Table 3 complexity data for the big templates.  What
``examples/quickstart.py`` does on the JAX package, with the same graph,
keys and numbers.

It runs on the card (the hand-written CUDA kernels) and raises without
one; ``--device cpu`` runs the kernels' plain versions instead.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.api import Counter
from repro_torch.core import erdos_renyi, prng
from repro_torch.core.brute_force import count_copies
from repro_torch.core.templates import (
    TEMPLATE_TABLE3,
    partition_complexity,
    partition_tree,
    star_tree,
    template,
)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    g = erdos_renyi(200, 6.0, seed=0)
    tree = star_tree(4)
    print(f"graph: {g.n} vertices, {g.num_edges} edges; template: {tree.name}")

    # one facade over both backends; "auto" picks the distributed one only
    # when given a mesh of more than one rank
    counter = Counter.from_graph(g, tree, backend="auto", device=args.device)
    est = counter.estimate(n_iter=150, key=prng.key(0))
    exact = count_copies(g, tree)
    print(f"backend                : {est.backend} on {args.device}")
    print(f"exact count            : {exact:.0f}")
    print(
        f"color-coding estimate  : {est.estimate:.0f}  (mean {est.mean:.0f}, "
        f"RSD {est.relative_sd:.2f}, {est.niter} colorings)"
    )
    print(f"relative error         : {abs(est.estimate - exact) / exact:.2%}\n")

    # a whole family in ONE pass a coloring: the templates compile into a
    # deduplicated subtree DAG, shared tables are computed once, and every
    # template gets its own unbiased estimate from the shared colorings
    family = ["u3-1", "u5-2", tree]
    many = counter.estimate_many(family, n_iter=60, key=prng.key(1))
    print(
        f"family of {len(many)} templates, k={many.k}: "
        f"{many.unique_tables} unique tables vs {many.chain_tables} chain nodes"
    )
    for one in many:
        print(f"  {one.template:>8}: estimate {one.estimate:.0f}  (RSD {one.relative_sd:.2f})")
    print()

    print("paper Table 3 (reproduced exactly from the partition chains):")
    print(f"{'template':<8} {'memory':>8} {'compute':>9} {'intensity':>10}")
    table3 = []
    for name in TEMPLATE_TABLE3:
        mem, comp = partition_complexity(partition_tree(template(name)))
        table3.append((name, mem, comp))
        print(f"{name:<8} {mem:>8} {comp:>9} {comp / mem:>10.1f}")
    return {"graph": g, "tree": tree, "exact": exact, "estimate": est, "many": many,
            "table3": table3}


if __name__ == "__main__":
    main()
