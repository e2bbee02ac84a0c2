"""The port's public surface is the reference's.

For every module ``src/repro/X.py`` the audit collects the reference's
public surface: top-level functions, classes and constants (an
``__init__.py``'s re-exports too), each public class's methods,
properties, fields and constructor parameters, each public function's and
method's parameter names, and the ``--flags`` of the four ``launch/``
entry points. Each item must be present in ``src/repro_torch/X.py``
(counting names that module imports or re-exports) or be a line of
``DEPARTURES`` that names the port's counterpart or the reason. Where
both sides have a function, method or constructor, the audit also holds
the default of every parameter both have (``rel::f(p) default``: a
module constant resolved to its value, ``jnp.X`` equal to ``torch.X``)
and the sizes of the tuple literals it returns (``rel::f returns``) to
the reference's. A departure whose item now exists in the port (or
agrees), or that names nothing of the reference, is stale and fails too.
Private names (a leading ``_``) are out of scope.

The audit reads source text only (``ast``): it imports neither JAX nor
either package, so it runs in about a second.
"""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
LAUNCHERS = ("launch/count.py", "launch/dryrun.py", "launch/serve.py", "launch/train.py")


def _public(name):
    return not name.startswith("_")


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls") and _public(x.arg)]


def _top_level(body):
    """Statements at module level, through ``if`` and ``try`` blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody
                                  + [s for h in node.handlers for s in h.body])
        else:
            yield node


def _targets(node):
    if isinstance(node, ast.Assign):
        out = []
        for t in node.targets:
            out += [n.id for n in ast.walk(t) if isinstance(n, ast.Name)]
        return out
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _class_members(cls):
    """Methods, properties, fields and class attributes; ``self.x = ...``
    in any method counts as an attribute."""
    names = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Store)
                        and isinstance(sub.value, ast.Name) and sub.value.id == "self"):
                    names.add(sub.attr)
        else:
            names.update(_targets(node))
    return names


def _ctor_params(cls):
    """A class's constructor parameters: ``__init__``'s, else its fields."""
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            return set(_params(node))
    return {t for node in cls.body if isinstance(node, ast.AnnAssign) for t in _targets(node)}


def _flags(tree):
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            out += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and a.value.startswith("--")]
    return out


def surface(rel, tree):
    """The reference module's public items, as ``rel::item`` keys."""
    items = []
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            items.append(node.name)
            items += [f"{node.name}({p})" for p in _params(node)]
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            items.append(node.name)
            items += [f"{node.name}({p})" for p in sorted(_ctor_params(node))]
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _public(sub.name):
                        items.append(f"{node.name}.{sub.name}")
                        items += [f"{node.name}.{sub.name}({p})" for p in _params(sub)]
                else:
                    items += [f"{node.name}.{t}" for t in _targets(sub) if _public(t)]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            items += [t for t in _targets(node) if _public(t)]
        elif isinstance(node, ast.ImportFrom) and rel.endswith("__init__.py"):
            items += [a.asname or a.name for a in node.names if _public(a.asname or a.name)]
    if rel in LAUNCHERS:
        items += _flags(tree)
    return [f"{rel}::{i}" for i in dict.fromkeys(items)]


def _defaults(fn):
    """A function's parameters that have a default: name -> its expression."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = dict(zip([x.arg for x in pos[len(pos) - len(a.defaults):]], a.defaults))
    out.update({x.arg: d for x, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None})
    return {k: v for k, v in out.items() if k in _params(fn)}


def _ctor_defaults(cls):
    """A class's constructor defaults: ``__init__``'s, else its fields'."""
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            return _defaults(node)
    return {node.target.id: node.value for node in cls.body
            if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name)
            and node.value is not None and _public(node.target.id)}


def _tuple_returns(fn):
    """The sizes of the tuple literals ``fn`` returns (not its nested
    functions' or lambdas')."""
    out, todo = set(), list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Tuple):
            out.add(len(node.value.elts))
        todo.extend(ast.iter_child_nodes(node))
    return out


def _positional(fn):
    """A function's public positional parameters, in order."""
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args
            if x.arg not in ("self", "cls") and _public(x.arg)]


def _ctor_positional(cls):
    """A class's positional constructor parameters: ``__init__``'s, else its
    fields in order (a dataclass's or a NamedTuple's)."""
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            return _positional(node)
    return [t for node in cls.body if isinstance(node, ast.AnnAssign) for t in _targets(node)
            if _public(t)]


def _is_generator(fn):
    """Whether ``fn`` yields (a ``yield`` in a nested function or lambda
    does not count)."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            return True
        todo.extend(ast.iter_child_nodes(node))
    return False


def _frozen(cls):
    """``True`` for a frozen dataclass or a NamedTuple, ``False`` for a
    dataclass that is not frozen, ``None`` for any other class."""
    if any(isinstance(b, ast.Name) and b.id == "NamedTuple" for b in cls.bases):
        return True
    for dec in cls.decorator_list:
        call = dec if isinstance(dec, ast.Call) else None
        name = ast.unparse(call.func if call else dec)
        if name.split(".")[-1] == "dataclass":
            return any(k.arg == "frozen" and isinstance(k.value, ast.Constant)
                       and k.value.value is True for k in (call.keywords if call else []))
    return None


def _order(theirs, ours, shared):
    """Whether the parameters ``shared`` come in the same relative order."""
    return [p for p in theirs if p in shared] == [p for p in ours if p in shared]


#: array libraries whose attributes are compared by name (``jnp.float32 == torch.float32``)
_LIBS = ("jnp", "np", "numpy", "torch")


def _value(expr, tree, rel, depth=0):
    """A default's comparable form: module constants (``tree.value``)
    resolved, a library attribute by its name, literals by value."""
    if isinstance(expr, ast.Name) and depth < 8:
        bound = tree.value(rel, expr.id)
        if bound is not None:
            return _value(bound[1], tree, bound[0], depth + 1)
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id in _LIBS:
        return f"lib.{expr.attr}"
    try:
        return repr(ast.literal_eval(expr))
    except ValueError:
        return ast.unparse(expr)


def _callables(tree):
    """The reference module's public functions, constructors and methods:
    ``(qualified name, node)``, a constructor as its class."""
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            yield node.name, node
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            yield node.name, node
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(sub.name):
                    yield f"{node.name}.{sub.name}", sub


class Port:
    """The port's modules, parsed once, with ``from`` imports resolved."""

    def __init__(self, sources, package="repro_torch"):
        self.trees = {rel: ast.parse(src) for rel, src in sources.items()}
        self.package = package

    def _module_of(self, rel, node):
        if node.level:
            base = Path(rel).parent.parts[: len(Path(rel).parent.parts) - (node.level - 1)]
        elif node.module and node.module.split(".")[0] == self.package:
            base = ()
        else:
            return None
        parts = list(base) + (node.module.split(".")[1 if not node.level else 0:]
                              if node.module else [])
        for cand in ("/".join(parts) + ".py", "/".join(parts + ["__init__.py"])):
            if cand in self.trees:
                return cand
        return None

    def definition(self, rel, name):
        """The node defining ``name`` in port module ``rel`` (following its
        imports), ``True`` for a name bound some other way, or ``None``."""
        return self.locate(rel, name)[1]

    def locate(self, rel, name, seen=()):
        """``(module, definition)``: :meth:`definition` and the module that
        holds it."""
        if rel not in self.trees or (rel, name) in seen:
            return rel, None
        seen = seen + ((rel, name),)
        for node in _top_level(self.trees[rel].body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                if node.name == name:
                    return rel, node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)) and name in _targets(node):
                value = node.value
                if isinstance(value, ast.Name) and value.id != name:
                    found = self.locate(rel, value.id, seen)
                    return found if found[1] is not None else (rel, True)
                return rel, True
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if (a.asname or a.name) == name:
                        mod = self._module_of(rel, node)
                        if mod is None:
                            return rel, True
                        sub = mod[: -len("__init__.py")] + a.name + ".py"
                        if mod.endswith("__init__.py") and sub in self.trees:
                            return rel, True  # a submodule
                        found = self.locate(mod, a.name, seen)
                        return found if found[1] is not None else (rel, True)
            elif isinstance(node, ast.Import):
                if any((a.asname or a.name.split(".")[0]) == name for a in node.names):
                    return rel, True
        return rel, None

    def value(self, rel, name, seen=()):
        """``(module, expression)`` a module-level constant ``name`` of
        ``rel`` is bound to (following imports), or ``None``."""
        if rel not in self.trees or (rel, name) in seen:
            return None
        seen = seen + ((rel, name),)
        for node in _top_level(self.trees[rel].body):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) and node.targets[0].id == name:
                return rel, node.value
            if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name) \
                    and node.target.id == name and node.value is not None:
                return rel, node.value
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if (a.asname or a.name) == name:
                        mod = self._module_of(rel, node)
                        return None if mod is None else self.value(mod, a.name, seen)
        return None

    def callable(self, rel, qual):
        """``(module, node)`` of the port's function, class (a constructor)
        or method named ``qual`` in ``rel``, or ``None``."""
        owner, _, member = qual.partition(".")
        mod, d = self.locate(rel, owner)
        if not isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return None
        if not member:
            return mod, d
        if not isinstance(d, ast.ClassDef):
            return None
        for c in self._class_chain(mod, d):
            for node in c.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node.name == member:
                    return mod, node
        return None

    def _class_chain(self, rel, cls):
        yield cls
        for base in cls.bases:
            if isinstance(base, ast.Name):
                d = self.definition(rel, base.id)
                if isinstance(d, ast.ClassDef):
                    yield from self._class_chain(rel, d)

    def has(self, key):
        rel, item = key.split("::", 1)
        if item.startswith("--"):
            return rel in self.trees and item in _flags(self.trees[rel])
        head, _, param = item.partition("(")
        param = param.rstrip(")")
        owner, _, member = head.partition(".")
        d = self.definition(rel, owner)
        if d is None:
            return False
        if member:
            if not isinstance(d, ast.ClassDef):
                return False
            classes = list(self._class_chain(rel, d))
            if not any(member in _class_members(c) for c in classes):
                return False
            if not param:
                return True
            for c in classes:
                for node in c.body:
                    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and node.name == member:
                        return param in _params(node)
            return False
        if not param:
            return True
        if isinstance(d, ast.ClassDef):
            return any(param in _ctor_params(c) for c in self._class_chain(rel, d))
        if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return param in _params(d)
        return False


def _owners(key):
    """The keys whose departure covers ``key`` as well: a name's covers its
    members and parameters, a member's its parameters, and a field's the
    constructor parameter of the same name."""
    rel, item = key.split("::", 1)
    head, _, param = item.partition("(")
    owner, _, member = head.partition(".")
    out = [f"{rel}::{owner}"] if (member or param) else []
    if member and param:
        out.append(f"{rel}::{head}")
    if param and not member:
        out.append(f"{rel}::{owner}.{param.rstrip(')')}")
    return out


def contract(ref, port, rel, departures=()):
    """``{key: agrees}`` for module ``rel``, where the reference's and the
    port's function, method or constructor both exist: the default of every
    parameter both have (``rel::f(p) default``); the sizes of the tuple
    literals both return where both return one (``rel::f returns``); the
    relative order of the positional parameters both have (``rel::f
    order``); a parameter positional in the reference that the port makes
    keyword-only (``rel::f(p) keyword-only``); whether a function is a
    generator (``rel::f generator``); and whether a dataclass is frozen
    (``rel::C frozen``).  Parameters with a departure of their own
    (``rel::f(p)``) are left out of the order and keyword-only checks."""
    out = {}
    for qual, node in _callables(ref.trees[rel]):
        found = port.callable(rel, qual)
        if found is None:
            continue
        mod, pnode = found
        if isinstance(node, ast.ClassDef):
            theirs = _ctor_defaults(node)
            ours = {}
            for c in reversed(list(port._class_chain(mod, pnode))):
                ours.update(_ctor_defaults(c))
            params = set(_ctor_params(node)) & {p for c in port._class_chain(mod, pnode)
                                                for p in _ctor_params(c)}
            if isinstance(pnode, ast.ClassDef) and None not in (_frozen(node), _frozen(pnode)):
                out[f"{rel}::{qual} frozen"] = _frozen(node) == _frozen(pnode)
            pos, kwonly = _ctor_positional(node), []
            ppos = _ctor_positional(pnode) if isinstance(pnode, ast.ClassDef) else []
        else:
            theirs, ours = _defaults(node), _defaults(pnode)
            params = set(_params(node)) & set(_params(pnode))
            want, got = _tuple_returns(node), _tuple_returns(pnode)
            if want and got:
                out[f"{rel}::{qual} returns"] = want == got
            out[f"{rel}::{qual} generator"] = _is_generator(node) == _is_generator(pnode)
            pos, ppos = _positional(node), _positional(pnode)
            kwonly = [x.arg for x in pnode.args.kwonlyargs]
        mine = {p for p in params if f"{rel}::{qual}({p})" not in departures}
        shared = mine & set(pos) & set(ppos)
        if len(shared) > 1:
            out[f"{rel}::{qual} order"] = _order(pos, ppos, shared)
        for p in sorted(mine & set(pos) & set(kwonly)):
            out[f"{rel}::{qual}({p}) keyword-only"] = False
        for p in sorted(params):
            if p in theirs or p in ours:
                same = (p in theirs and p in ours and _value(theirs[p], ref, rel)
                        == _value(ours[p], port, mod))
                out[f"{rel}::{qual}({p}) default"] = same
    return out


def audit(ref_sources, port_sources, departures):
    """(missing, stale): reference items with neither a counterpart nor a
    departure, and departures that name a present item or no item."""
    port = Port(port_sources)
    ref = Port(ref_sources, package="repro")
    items, agrees = [], {}
    for rel in sorted(ref_sources):
        if rel not in port_sources:
            items.append(rel)  # the whole module
            continue
        items += surface(rel, ref.trees[rel])
        agrees.update(contract(ref, port, rel, departures))
    known = set(items) | set(agrees)
    missing = []
    for k in items:
        if k in departures:
            continue
        if "::" not in k:
            missing.append(k)
        elif not port.has(k) and not any(o in departures for o in _owners(k)):
            missing.append(k)
    missing += [k for k, same in agrees.items() if not same and k not in departures]

    def present(k):
        if k in agrees:
            return agrees[k]
        return k in port_sources if "::" not in k else port.has(k)

    stale = [k for k in departures if k not in known or present(k)]
    return missing, stale


def _sources(root):
    return {p.relative_to(root).as_posix(): p.read_text() for p in sorted(root.rglob("*.py"))}


# ---------------------------------------------------------------------------
# The decided departures: each reference item the port does not mirror, and
# what stands in its place.

_AXIS = "a JAX mesh axis name; the port's collectives take a comm.Group"
_IMPL = ("picks XLA or Pallas; the port has one route a device: the CUDA kernel on the "
         "card, its plain version on the CPU")
_LANE = "TPU lane padding; the port's tables keep their true widths"
_SLABS = ("the TPU edge-slab and tile layout; the port's SpMMs walk CSRs (ops.SpmmPlan, "
          "ops.build_rect_csr, ops.build_bucket_csrs, ops.spmm_rect, ops.fused_count_rect)")
_BUCKETS = "the bucket CSRs of plan.shards[p].buckets (ops.BucketCsrs)"
_BLOCKS = ("the block plan's patch lists (patch_union, patch_offs, patch_slots, patch_bits) "
           "at ops.ROW_BLOCK rows")
_SHARD = ("an XLA sharding anchor; a rank holds its blocks explicitly "
          "(models.layers.MeshShard, rs=)")
_KEY = "a JAX PRNG key; the port draws from a torch.Generator (generator=)"
_UNROLL = "unrolls XLA's scanned layer groups for the dry-run's probes; the port's layers loop"
_CSR = "takes the CSR (indptr, indices); spmm_ref keeps the COO form"
_CARD = ("TPU v5e figures; the card's are BF16_FLOPS_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S, "
         "NVLINK_BYTES_PER_S and INTER_NODE_BYTES_PER_S")

DEPARTURES = {
    "compat.py": "JAX version shims (shard_map, AxisType, axis_size); the port uses no JAX",
    "comm/adaptive.py::calibrate(data_axis)": "calibrate(mesh) probes the mesh's data axis",
    "comm/compress.py::compressed_ring_reduce_scatter(axis_name)": _AXIS,
    "comm/pipelined.py::fused_exchange(axis_name)": _AXIS,
    "comm/pipelined.py::grouped_exchange(axis_name)": _AXIS,
    "comm/ring.py::ring_allgather(axis_name)": _AXIS,
    "comm/ring.py::ring_allgather_overlap(axis_name)": _AXIS,
    "comm/ring.py::ring_reduce_scatter(axis_name)": _AXIS,
    "comm/ring.py::ring_reduce_scatter(chunk_axis)": "the caller moves the axis to 0 (movedim)",
    "core/count_engine.py::CountingPlan.impl": _IMPL,
    "core/count_engine.py::CountingPlan.lane": _LANE,
    "core/count_engine.py::MultiCountingPlan.impl": _IMPL,
    "core/count_engine.py::MultiCountingPlan.lane": _LANE,
    "core/count_engine.py::build_counting_plan(impl)": _IMPL,
    "core/count_engine.py::build_counting_plan(lane)": _LANE,
    "core/count_engine.py::build_counting_plan(tile_size)": _SLABS,
    "core/count_engine.py::build_counting_plan(block_size)":
        "blocks are ops.ROW_BLOCK = 128 rows; api.Counter refuses another size",
    "core/count_engine.py::build_multi_counting_plan(impl)": _IMPL,
    "core/count_engine.py::build_multi_counting_plan(lane)": _LANE,
    "core/count_engine.py::build_multi_counting_plan(tile_size)": _SLABS,
    "core/count_engine.py::build_multi_counting_plan(block_size)":
        "blocks are ops.ROW_BLOCK = 128 rows; api.Counter refuses another size",
    "core/distributed.py::DistributedPlan.tile_dst": _BUCKETS,
    "core/distributed.py::DistributedPlan.tile_src_local": _BUCKETS,
    "core/distributed.py::DistributedPlan.tile_src_compact": _BUCKETS,
    "core/distributed.py::DistributedPlan.tile_off": _BUCKETS,
    "core/distributed.py::DistributedPlan.a2a_slab_dst":
        "the alltoall CSR of plan.shards[p].a2a (ops.RectCsr)",
    "core/distributed.py::DistributedPlan.a2a_slab_cols":
        "the alltoall CSR of plan.shards[p].a2a (ops.RectCsr)",
    "core/distributed.py::DistributedPlan.pin_adj": "plan.shards[p].pin_adj (ShardArrays)",
    "core/distributed.py::DistributedPlan.device_arrays":
        "plan.shard_arrays(p, device): one shard's arrays, moved once and kept",
    "core/distributed.py::make_count_fn returns":
        "return_raw=True gives (the rank program, its argument shapes), which the dry-run runs "
        "on meta tensors; the reference's third value is an XLA in-sharding",
    "core/distributed.py::build_distributed_plan(bucket_tile)":
        "the slab layout's tile; taken and dropped (bucket CSRs); abstract_plan reads it",
    "core/distributed.py::plan_route_report(data_axis)": _AXIS,
    "core/distributed.py::make_count_fn(data_axis)": _AXIS,
    "core/distributed.py::make_count_fn(iter_axis)":
        "the mesh's iteration ranks (LocalMesh, process_mesh) take the iterations",
    "core/distributed.py::make_count_fn(impl)": _IMPL,
    "core/frontier.py::Frontier.count":
        "the no-overflow flags go to the program's flag list (make_frontier_fn)",
    "core/frontier.py::Frontier.cap": "capacities live in CompactionSpec (table_caps, ...)",
    "core/frontier.py::Frontier.ok":
        "the no-overflow flags go to the program's flag list (make_frontier_fn)",
    "core/frontier.py::inverse_map(idx)":
        "inverse_map(keep, zero_slot) maps from the kept-row mask: no two writes meet",
    "core/frontier.py::inverse_map(n_rows)": "the mask's length",
    "core/frontier.py::compact_combine(impl)": _IMPL,
    "core/frontier.py::chunk_slots(act_chunks)": "named act: [..., L] bool, any leading axes",
    "core/table_program.py::build_node_tables(lane)": _LANE,
    "core/table_program.py::leaf_table(coloring)":
        "leaf_table(colorings [B, n_pad], k, n): a batch, the true width, pad rows from n",
    "core/table_program.py::leaf_table(k_pad)": "k, the true width (no lane padding)",
    "core/table_program.py::leaf_table(row_mask)": "n: rows >= n are zeroed",
    "core/table_program.py::run_table_program(row_mask)": "n, the vertex count",
    "core/table_program.py::local_node_fn(row_mask)":
        "pad rows have no edges, so every SpMM writes them as zeros",
    "core/table_program.py::local_node_fn(impl)": _IMPL,
    "kernels/color_combine.py::color_combine_pallas":
        "color_combine.color_combine (CUDA, csrc/color_combine.cu)",
    "kernels/flash_attention.py::flash_attention_pallas":
        "flash_attention.flash_attention (CUDA, csrc/flash_attention_wgmma.cu, "
        "csrc/flash_attention.cu)",
    "kernels/fused_count.py::fused_count_pallas":
        "fused_count.fused_count (CUDA, csrc/fused_count.cu)",
    "kernels/fused_count.py::fused_count_xla": "fused_count.fused_count_plain, the CPU's route",
    "kernels/spmm_edgetile.py::spmm_edge_tile_pallas":
        "spmm_edgetile.spmm_edge_tile (CUDA, csrc/spmm_edgetile.cu)",
    "kernels/spmm_edgetile.py::spmm_block_pallas":
        "spmm_block.spmm_block (CUDA, csrc/spmm_block.cu)",
    "kernels/ops.py::on_tpu": _IMPL,
    "kernels/ops.py::resolve_impl": _IMPL,
    "kernels/ops.py::SpmmPlan.rows": "the plan holds a CSR (indptr, indices)",
    "kernels/ops.py::SpmmPlan.cols": "the plan holds a CSR (indptr, indices)",
    "kernels/ops.py::SpmmPlan.block_rows": _BLOCKS,
    "kernels/ops.py::SpmmPlan.block_cols": _BLOCKS,
    "kernels/ops.py::SpmmPlan.patches": _BLOCKS,
    "kernels/ops.py::SpmmPlan.block_size": _BLOCKS,
    "kernels/ops.py::SpmmPlan.written_mask": "pad rows have no edges: every row is written",
    "kernels/ops.py::SpmmPlan.slab_dst": _SLABS,
    "kernels/ops.py::SpmmPlan.slab_cols": _SLABS,
    "kernels/ops.py::SpmmPlan.slabs_per_block": _SLABS,
    "kernels/ops.py::SpmmPlan.tile_size": _SLABS,
    "kernels/ops.py::SpmmPlan.row_tile": _SLABS,
    "kernels/ops.py::build_slab_layout": _SLABS,
    "kernels/ops.py::build_bucket_tiles": _SLABS,
    "kernels/ops.py::spmm_slabs": _SLABS,
    "kernels/ops.py::fused_count_slabs": _SLABS,
    "kernels/ops.py::build_spmm_plan(block_size)": _BLOCKS,
    "kernels/ops.py::build_spmm_plan(tile_size)": _SLABS,
    "kernels/ops.py::build_spmm_plan(row_tile)": _SLABS,
    "kernels/ops.py::spmm(impl)": _IMPL,
    "kernels/ops.py::spmm_compact(impl)": _IMPL,
    "kernels/ops.py::color_combine(impl)": _IMPL,
    "kernels/ops.py::color_combine(xla_chunk)":
        "the XLA combine's chunk; the plain version chunks by ref.ELEMENT_BUDGET",
    "kernels/ops.py::fused_count(plan)": "fused_count(indptr, indices, ...): the plan's CSR",
    "kernels/ops.py::fused_count(impl)": _IMPL,
    "kernels/ops.py::fused_count_compact(impl)": _IMPL,
    "kernels/ops.py::flash_attention(impl)": _IMPL,
    "kernels/ops.py::flash_attention(block_q)": "Pallas tiles; the CUDA kernels fix theirs (TILE)",
    "kernels/ops.py::flash_attention(block_k)":
        "Pallas tiles; the CUDA kernels fix theirs (kv_tile)",
    "kernels/ops.py::CombineTables.idx1_t": "Pallas's transposed copy; the kernels read .pairs",
    "kernels/ops.py::CombineTables.idx2_t": "Pallas's transposed copy; the kernels read .pairs",
    "kernels/ops.py::CombineTables.s_pad": _LANE,
    "kernels/ops.py::build_combine_tables(lane)": _LANE,
    "kernels/ops.py::build_combine_tables(sublane)": _LANE,
    "kernels/ref.py::spmm_segment_ref(rows)": _CSR,
    "kernels/ref.py::spmm_segment_ref(cols)": _CSR,
    "kernels/ref.py::spmm_segment_ref(num_rows)": _CSR,
    "kernels/ref.py::fused_count_ref(rows)": _CSR,
    "kernels/ref.py::fused_count_ref(cols)": _CSR,
    "launch/count.py::--impl": _IMPL,
    "launch/count.py::--bucket-tile": "the slab layout's tile; the port keeps bucket CSRs",
    "launch/dryrun.py::parse_collectives":
        "parses XLA's HLO; comm.AbstractMesh counts the bytes the rank's program sends",
    "launch/dryrun.py::lower_cell":
        "XLA lowering; lm_cell and measure_lm run the rank on meta (analysis_s, ROADMAP §3)",
    "launch/dryrun.py::run_cell(probes)":
        "XLA's depth probes; the port's rank program runs every layer (ROADMAP §3)",
    "models/attention.py::attn_init(cross)":
        "changes nothing in the reference: the same four projections for both",
    "models/attention.py::chunked_attention(constrain)": _SHARD,
    "models/attention.py::attention_block(impl)": _IMPL,
    "models/attention.py::attention_block(shard)": _SHARD,
    "models/factory.py::chunked_ce_loss(shard)": _SHARD,
    "models/factory.py::build_model(impl)": _IMPL,
    "models/factory.py::build_model(unroll)": _UNROLL,
    "models/factory.py::build_model(cast_params) default":
        "False, where the reference's None casts the >= 2-D weights at use iff a mesh is given: "
        "against the reference's own meshed bf16 run at that default (smollm-360m on 2 x 2 "
        "with FSDP), the port's uncast loss and gradients come closer than its cast ones, "
        "whose bf16 gathers sum the gradients over data in bf16 "
        "(tests/test_torch_mesh_lm.py::test_default_cast_is_the_closer_to_the_reference)",
    "models/layers.py::Initializer(key)": _KEY,
    "models/layers.py::Initializer.take": "splits the JAX key; the generator advances as it draws",
    "models/layers.py::Initializer.normal(dtype)": "the caller casts (.to(dtype))",
    "models/layers.py::Initializer.zeros(dtype)": "the caller casts (.to(dtype))",
    "models/layers.py::Initializer.ones(dtype)": "the caller casts (.to(dtype))",
    "models/moe.py::moe_block(shard_fn)": "unused in the reference",
    "models/moe.py::moe_block_manual(dp_axes)": "dp_groups (comm.Group each)",
    "models/moe.py::moe_block_manual(model_axis)": "group, the model axis's comm.Group",
    "models/moe.py::moe_block_manual(fsdp_axis)": "data_group and fsdp=True",
    "models/transformer.py::init_params(key)": _KEY,
    "models/transformer.py::encode(shard)": _SHARD,
    "models/transformer.py::forward(shard)": _SHARD,
    "models/transformer.py::forward(impl)": _IMPL,
    "models/transformer.py::forward(unroll)": _UNROLL,
    "models/transformer.py::forward(remat)": "Transformer.forward(remat=), under autograd",
    "roofline/analysis.py::PEAK_FLOPS": _CARD,
    "roofline/analysis.py::HBM_BW": _CARD,
    "roofline/analysis.py::ICI_BW": _CARD,
    "roofline/analysis.py::DCI_BW": _CARD,
    "roofline/analysis.py::RooflineTerms.hlo_flops": "RooflineTerms.flops: the rank's, no HLO",
    "roofline/analysis.py::RooflineTerms.note": "never set in the reference",
    "roofline/analysis.py::analyze_record(hbm_gib)":
        "hbm_bytes, the card's memory by default (device_memory_bytes)",
    "train/checkpoint.py::CheckpointManager(async_save) default":
        "False: the counting callers and their tests build the manager bare, and a save must be "
        "on disk when save returns for 'killed after call N' to resume there; the train loop "
        "asks for async_save=True, as the reference's gets it from its default",
    "train/train_loop.py::make_train_step(batch_spec)":
        "an XLA sharding; a rank's rows come from Model.rank_rows",
    "train/train_loop.py::make_train_step(jit)": "the step is eager",
}


def test_the_port_mirrors_the_reference_surface():
    missing, stale = audit(_sources(REF), _sources(PORT), DEPARTURES)
    assert not missing, "no counterpart and no departure:\n" + "\n".join(missing)
    assert not stale, "stale departures:\n" + "\n".join(stale)


def test_every_departure_gives_a_reason():
    assert all(isinstance(v, str) and v.strip() for v in DEPARTURES.values())


def test_the_audit_imports_neither_package():
    """It reads source text: no ``import jax`` or ``repro`` in this file."""
    tree = ast.parse(Path(__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro", "repro_torch")]


# ---------------------------------------------------------------------------
# the audit on two small modules held in memory

_REF = {
    "m.py": "def f(a, b=1, dtype=jnp.float32):\n    return a, b, dtype\n\n\n"
            "class C:\n    x: int = 0\n\n    def g(self, y=2):\n        pass\n\n\nK = 3\n\n\n"
            "def gen(n):\n    yield n\n\n\n"
            "@dataclasses.dataclass(frozen=True)\nclass F:\n    u: int\n    v: int\n",
    "launch/count.py": "import argparse\nap = argparse.ArgumentParser()\n"
                       "ap.add_argument('--iters')\n",
    "gone.py": "def h():\n    pass\n",
}
_PORT = {
    "m.py": "from .impl import f\n\n\nclass C:\n    x: int = 0\n\n"
            "    def g(self, y=2):\n        pass\n\n\nK = 3\n\n\n"
            "def gen(n):\n    yield n\n\n\n"
            "@dataclasses.dataclass(frozen=True)\nclass F:\n    u: int\n    v: int\n",
    "impl.py": "from .consts import B\n\n\ndef f(a, b=B, dtype=torch.float32):\n"
               "    return a, b, dtype\n",
    "consts.py": "B = 1\n",
    "launch/count.py": "import argparse\nap = argparse.ArgumentParser()\n"
                       "ap.add_argument('--iters')\n",
}
_DEPS = {"gone.py": "a reason"}


def _edit(sources, rel, old, new):
    out = dict(sources)
    out[rel] = out[rel].replace(old, new)
    assert out[rel] != sources[rel]
    return out


def test_audit_passes_a_complete_port():
    """A re-exported function counts, with its parameters; a constant
    default counts as its value, ``torch.float32`` as ``jnp.float32``."""
    assert audit(_REF, _PORT, _DEPS) == ([], [])


SELF_CASES = {
    "missing name": (_edit(_PORT, "m.py", "K = 3", "J = 3"), _DEPS, ["m.py::K"], []),
    "missing parameter": (_edit(_PORT, "impl.py", "b=B, ", ""), _DEPS, ["m.py::f(b)"], []),
    "missing method parameter": (_edit(_PORT, "m.py", "g(self, y=2)", "g(self)"), _DEPS,
                                 ["m.py::C.g(y)"], []),
    "missing field": (_edit(_PORT, "m.py", "x: int", "z: int"), _DEPS,
                      ["m.py::C(x)", "m.py::C.x"], []),
    "missing flag": (_edit(_PORT, "launch/count.py", "--iters", "--steps"), _DEPS,
                     ["launch/count.py::--iters"], []),
    "missing module": (_PORT, {}, ["gone.py"], []),
    "stale departure": (_PORT, dict(_DEPS, **{"m.py::C.g": "why"}), [], ["m.py::C.g"]),
    "unknown departure": (_PORT, dict(_DEPS, **{"m.py::nothing": "why"}), [],
                          ["m.py::nothing"]),
    "a departure covers its members": (_edit(_PORT, "m.py", "def g(self, y=2)",
                                             "def h(self, y=2)"),
                                       dict(_DEPS, **{"m.py::C.g": "why"}), [], []),
    "changed default": (_edit(_PORT, "impl.py", "torch.float32", "torch.bfloat16"), _DEPS,
                        ["m.py::f(dtype) default"], []),
    "a constant hides a changed default": (_edit(_PORT, "consts.py", "B = 1", "B = 2"), _DEPS,
                                           ["m.py::f(b) default"], []),
    "dropped default": (_edit(_PORT, "m.py", "y=2", "y"), _DEPS, ["m.py::C.g(y) default"], []),
    "changed field default": (_edit(_PORT, "m.py", "x: int = 0", "x: int = 1"), _DEPS,
                              ["m.py::C(x) default"], []),
    "shortened return": (_edit(_PORT, "impl.py", "return a, b, dtype", "return a, b"), _DEPS,
                         ["m.py::f returns"], []),
    "a departure for a changed default":
        (_edit(_PORT, "consts.py", "B = 1", "B = 2"),
         dict(_DEPS, **{"m.py::f(b) default": "why"}), [], []),
    "stale default departure": (_PORT, dict(_DEPS, **{"m.py::f(b) default": "why"}), [],
                                ["m.py::f(b) default"]),
    "swapped parameters": (_edit(_PORT, "impl.py", "b=B, dtype=torch.float32",
                                 "dtype=torch.float32, b=B"), _DEPS, ["m.py::f order"], []),
    "swapped fields": (_edit(_PORT, "m.py", "u: int\n    v: int", "v: int\n    u: int"), _DEPS,
                       ["m.py::F order"], []),
    "a departure for a swap": (_edit(_PORT, "impl.py", "b=B, dtype=torch.float32",
                                     "dtype=torch.float32, b=B"),
                               dict(_DEPS, **{"m.py::f order": "why"}), [], []),
    "a departed parameter leaves the order": (_edit(_PORT, "impl.py", "b=B, dtype=torch.float32",
                                                    "dtype=torch.float32, b=B"),
                                              dict(_DEPS, **{"m.py::f(b)": "why"}), [],
                                              ["m.py::f(b)"]),
    "made keyword-only": (_edit(_PORT, "impl.py", "b=B, dtype", "b=B, *, dtype"), _DEPS,
                          ["m.py::f(dtype) keyword-only"], []),
    "a generator made a return": (_edit(_PORT, "m.py", "    yield n", "    return iter([n])"),
                                  _DEPS, ["m.py::gen generator"], []),
    "a nested yield is not a generator": (
        _edit(_PORT, "m.py", "    yield n", "    def inner():\n        yield n\n\n"
                                          "    return inner()"),
        _DEPS, ["m.py::gen generator"], []),
    "a frozen dataclass made mutable": (_edit(_PORT, "m.py", "dataclass(frozen=True)",
                                              "dataclass"), _DEPS, ["m.py::F frozen"], []),
    "stale order departure": (_PORT, dict(_DEPS, **{"m.py::f order": "why"}), [],
                              ["m.py::f order"]),
}


@pytest.mark.parametrize("case", SELF_CASES)
def test_audit_catches(case):
    port, deps, missing, stale = SELF_CASES[case]
    got_missing, got_stale = audit(_REF, port, deps)
    assert sorted(got_missing) == sorted(missing)
    assert got_stale == stale


if __name__ == "__main__":
    missing, stale = audit(_sources(REF), _sources(PORT), DEPARTURES)
    print("\n".join(missing))
    print("STALE", stale, len(missing), file=sys.stderr)
