"""The port's host-side copies (graphs, templates, color sets) against the
JAX package's originals: same seeds, same graphs, same chains, same tables."""

import math

import numpy as np
import pytest

from repro.core import colorsets as ref_colorsets
from repro.core import graphs as ref_graphs
from repro.core import templates as ref_templates
from repro_torch.core import colorsets, graphs, templates


def _same_graph(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype and a.indices.dtype == b.indices.dtype


class TestGraphs:
    @pytest.mark.parametrize("n,m,skew,seed", [(200, 3000, 8, 3), (1 << 10, 8000, 3, 0), (300, 900, 1, 7)])
    def test_rmat_bit_for_bit(self, n, m, skew, seed):
        _same_graph(graphs.rmat(n, m, skew=skew, seed=seed), ref_graphs.rmat(n, m, skew=skew, seed=seed))

    @pytest.mark.parametrize("n,deg,seed", [(100, 5.0, 100), (300, 8.0, 300), (64, 3.0, 64)])
    def test_erdos_renyi_bit_for_bit(self, n, deg, seed):
        _same_graph(graphs.erdos_renyi(n, deg, seed=seed), ref_graphs.erdos_renyi(n, deg, seed=seed))

    def test_relabel_and_edge_list(self):
        g = graphs.rmat(512, 4000, skew=3, seed=2)
        rg = ref_graphs.rmat(512, 4000, skew=3, seed=2)
        _same_graph(graphs.relabel_random(g, seed=5), ref_graphs.relabel_random(rg, seed=5))
        for a, b in zip(graphs.edge_list(g), ref_graphs.edge_list(rg)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype

    def test_from_csr_and_npz_interop(self, tmp_path):
        rg = ref_graphs.erdos_renyi(80, 4.0, seed=9)
        g = graphs.from_csr(rg.n, rg.indptr, rg.indices, name="x")
        _same_graph(g, rg)
        path = str(tmp_path / "g.npz")
        ref_graphs.save_npz(rg, path)  # an archive the reference wrote
        _same_graph(graphs.load_npz(path), rg)
        with pytest.raises(graphs.GraphFormatError):
            graphs.from_csr(5, np.zeros(3, np.int64), np.zeros(0, np.int32))

    def test_edge_file(self, tmp_path):
        p = tmp_path / "e.txt"
        p.write_text("# comment\n0 1\n1 2\n2 0\n3 1\n")
        _same_graph(graphs.load_edge_file(str(p)), ref_graphs.load_edge_file(str(p)))


class TestTemplates:
    def test_table3_and_chains(self):
        for name, (mem, comp) in ref_templates.TEMPLATE_TABLE3.items():
            t, rt = templates.template(name), ref_templates.template(name)
            assert t.edges == rt.edges
            chain, rchain = templates.partition_tree(t), ref_templates.partition_tree(rt)
            assert [(nd.size, nd.left, nd.right) for nd in chain.nodes] == [
                (nd.size, nd.left, nd.right) for nd in rchain.nodes
            ]
            assert templates.partition_complexity(chain) == (mem, comp)
            assert chain.table_reads() == rchain.table_reads()

    @pytest.mark.parametrize("seed", range(6))
    def test_automorphisms_and_canon(self, seed):
        t, rt = templates.random_tree(7, seed=seed), ref_templates.random_tree(7, seed=seed)
        assert t.edges == rt.edges
        assert templates.automorphism_count(t) == ref_templates.automorphism_count(rt)
        assert templates.canonical_form(t) == ref_templates.canonical_form(rt)
        for root in range(3):
            assert templates.partition_tree(t, root).profile() == ref_templates.partition_tree(
                rt, root
            ).profile()

    def test_named_shapes(self):
        for fn in ("path_tree", "star_tree"):
            assert getattr(templates, fn)(5).edges == getattr(ref_templates, fn)(5).edges
        assert templates.spider_tree([2, 2, 1]).edges == ref_templates.spider_tree([2, 2, 1]).edges
        assert templates.automorphism_count(templates.template("u12-2")) == (
            ref_templates.automorphism_count(ref_templates.template("u12-2"))
        )

    @pytest.mark.parametrize("name", ["cycle3", "cycle6", "diamond", "bowtie", "house"])
    def test_nontree_names_raise(self, name):
        """Non-tree names resolve to the reference's treewidth-2 rows; asking
        one for its tree raises."""
        t, rt = templates.template(name), ref_templates.template(name)
        assert (t.n, t.edges, t.name) == (rt.n, rt.edges, rt.name)
        with pytest.raises(ValueError, match="is not a tree"):
            t.as_tree()


@pytest.mark.parametrize("k,t1,t2", [(3, 1, 1), (5, 2, 2), (7, 3, 2), (12, 4, 8), (12, 3, 4)])
def test_split_tables(k, t1, t2):
    a1, a2 = colorsets.split_tables(k, t1, t2)
    b1, b2 = ref_colorsets.split_tables(k, t1, t2)
    np.testing.assert_array_equal(a1, b1)
    np.testing.assert_array_equal(a2, b2)
    assert a1.shape == (math.comb(k, t1 + t2), math.comb(t1 + t2, t1))
    assert colorsets.set_masks(k, t1) == ref_colorsets.set_masks(k, t1)
