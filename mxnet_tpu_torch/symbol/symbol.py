"""Symbol: the declarative graph frontend.

PyTorch counterpart of ``mxnet_tpu/symbol/symbol.py``. A Symbol is a
list of (node, output-index) heads over a DAG of ``Node`` objects;
binding it builds a plain function on tensors
(:func:`mxnet_tpu_torch.executor.build_interpreter`). Graph JSON
save/load keeps the nnvm layout of the JAX package (nodes / arg_nodes /
heads), so a graph saved by either package loads in the other.

Shape inference first runs the JAX package's bidirectional pre-pass,
which resolves unknown (0) dims from constraints elsewhere in the graph
(elementwise and broadcast binaries, FullyConnected, Convolution,
Concat, SliceChannel, shape-preserving unaries) and checks given shapes
against them; then it runs forward over the graph: parameter shapes are
filled from the data shapes by per-op rules (FullyConnected,
Convolution, Deconvolution, BatchNorm, InstanceNorm, LayerNorm,
Embedding, PReLU), and every op's shape comes from running its torch
function on ``device="meta"`` tensors, which carry shapes and no data.
``infer_shape_partial`` (Gluon's deferred initialization) returns None
where it cannot tell; ``infer_type`` runs the ops on meta tensors of
the given dtypes.  ``load`` reads nnvm-era files and the reference's
pre-nnvm (v0.8) files, whose implicit trailing inputs it adds.  Symbols
made inside an :class:`~mxnet_tpu_torch.attribute.AttrScope` carry its
attributes.

A variable composed into an op's auxiliary slot (BatchNorm's moving
statistics, as a Gluon block passes its ``running_mean``) is an
auxiliary state of the graph, as in the reference; the JAX package keeps
such a variable an argument, so a hybridized Gluon BatchNorm there never
updates its running statistics (ROADMAP §3).
"""
from __future__ import annotations

import json
import numbers
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from .. import attribute as _attribute
from .. import name as _name
from ..ops import registry as _reg


class Node:
    """One graph node: an op application or (op=None) a variable."""
    __slots__ = ("op", "name", "attrs", "inputs", "_user_attrs")

    def __init__(self, op: Optional[str], name: str, attrs: dict,
                 inputs: List[Tuple["Node", int]], user_attrs=None):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self._user_attrs = dict(user_attrs or {})

    @property
    def is_variable(self):
        return self.op is None


def node_num_outputs(node: Node) -> int:
    if node.op is None:
        return 1
    opdef = _reg.get(node.op)
    n = opdef.num_visible if opdef.num_visible is not None \
        else opdef.num_outputs
    if callable(n):  # attr-dependent (reference NumVisibleOutputs)
        n = n(node.attrs)
    if n == -1:  # attr-dependent (reference: SliceChannel num_outputs)
        if node.op in ("SliceChannel", "split"):
            return int(node.attrs.get("num_outputs", 1))
        if node.op == "topk":
            return 2 if node.attrs.get("ret_typ", "indices") == "both" \
                else 1
        if node.op == "RNN":  # output, then h (and c for an LSTM)
            if not _flag(node.attrs.get("state_outputs", False)):
                return 1
            return 3 if node.attrs.get("mode", "lstm") == "lstm" else 2
        return 1
    return n


def _flag(v) -> bool:
    """An attribute flag given as a bool, an int or a string."""
    return v in (True, "True", "true", 1, "1")


def _topo_sort(heads: Sequence[Tuple[Node, int]]) -> List[Node]:
    order: List[Node] = []
    visited = set()
    for head, _ in heads:
        stack = [(head, False)]
        while stack:
            n, processed = stack.pop()
            if processed:
                order.append(n)
                continue
            if id(n) in visited:
                continue
            visited.add(id(n))
            stack.append((n, True))
            for inp, _ in reversed(n.inputs):
                if id(inp) not in visited:
                    stack.append((inp, False))
    return order


# ---------------------------------------------------------------------------
# parameter-shape inference hooks (reference: per-op InferShape filling
# unknown arg shapes, e.g. FullyConnectedProp::InferShape)
# ---------------------------------------------------------------------------
def _fc_param_shapes(attrs, in_shapes):
    data = in_shapes.get("data")
    if data is None:
        return {}
    nh = int(attrs.get("num_hidden", 0))
    flatten = attrs.get("flatten", True)
    in_dim = int(np.prod(data[1:])) if flatten else data[-1]
    out = {"weight": (nh, in_dim)}
    if not attrs.get("no_bias", False):
        out["bias"] = (nh,)
    return out


def _conv_param_shapes(attrs, in_shapes):
    data = in_shapes.get("data")
    if data is None:
        return {}
    kernel = tuple(int(k) for k in attrs.get("kernel", ()))
    nf = int(attrs.get("num_filter", 0))
    ng = int(attrs.get("num_group", 1))
    # NHWC activations keep channels last; the weight stays OIHW either way
    cin = data[-1] if attrs.get("layout") == "NHWC" else data[1]
    out = {"weight": (nf, cin // ng) + kernel}
    if not attrs.get("no_bias", False):
        out["bias"] = (nf,)
    return out


def _bn_param_shapes(attrs, in_shapes):
    data = in_shapes.get("data")
    if data is None:
        return {}
    c = data[int(attrs.get("axis", 1)) % len(data)]
    return {"gamma": (c,), "beta": (c,),
            "moving_mean": (c,), "moving_var": (c,)}


def _ln_param_shapes(attrs, in_shapes):
    data = in_shapes.get("data")
    if data is None:
        return {}
    ax = int(attrs.get("axis", -1)) % len(data)
    return {"gamma": (data[ax],), "beta": (data[ax],)}


def _embedding_param_shapes(attrs, in_shapes):
    return {"weight": (int(attrs["input_dim"]), int(attrs["output_dim"]))}


def _deconv_param_shapes(attrs, in_shapes):
    data = in_shapes.get("data")
    if data is None:
        return {}
    kernel = tuple(int(k) for k in attrs.get("kernel", ()))
    nf = int(attrs.get("num_filter", 0))
    ng = int(attrs.get("num_group", 1))
    out = {"weight": (data[1], nf // ng) + kernel}
    if not attrs.get("no_bias", True):
        out["bias"] = (nf,)
    return out


def _in_param_shapes(attrs, in_shapes):
    data = in_shapes.get("data")
    if data is None:
        return {}
    return {"gamma": (data[1],), "beta": (data[1],)}


def _prelu_param_shapes(attrs, in_shapes):
    data = in_shapes.get("data")
    if data is None or attrs.get("act_type", "leaky") != "prelu":
        return {}
    return {"gamma": (data[1] if len(data) > 1 else 1,)}


def _rnn_param_shapes(attrs, in_shapes):
    data = in_shapes.get("data")  # (seq, batch, input)
    if data is None:
        return {}
    from ..ops.rnn import rnn_param_size
    mode = attrs.get("mode", "lstm")
    sh = int(attrs["state_size"])
    nl = int(attrs.get("num_layers", 1))
    bidir = _flag(attrs.get("bidirectional", False))
    d = 2 if bidir else 1
    shapes = {"parameters": (rnn_param_size(nl, data[2], sh, bidir, mode),),
              "state": (nl * d, data[1], sh)}
    if mode == "lstm":
        shapes["state_cell"] = (nl * d, data[1], sh)
    return shapes


def _klreg_aux_shapes(attrs, in_shapes):
    """One moving average a unit, (data[1],), as the reference infers it
    (identity_attach_KL_sparse_reg-inl.h); the JAX package gives the aux
    the data's own shape and cannot bind the op (ROADMAP §3)."""
    data = in_shapes.get("data")
    return {} if data is None else {"moving_avg": (data[1],)}


PARAM_SHAPE_INFER = {
    "FullyConnected": _fc_param_shapes,
    "Convolution": _conv_param_shapes,
    "Deconvolution": _deconv_param_shapes,
    "BatchNorm": _bn_param_shapes,
    "InstanceNorm": _in_param_shapes,
    "LayerNorm": _ln_param_shapes,
    "Embedding": _embedding_param_shapes,
    "LeakyReLU": _prelu_param_shapes,
    "RNN": _rnn_param_shapes,
    "IdentityAttachKLSparseReg": _klreg_aux_shapes,
}


def _skip_args(op: str, attrs: dict) -> set:
    """Args an op drops depending on its attrs (reference: each op's
    ListArguments respects flags like no_bias)."""
    opdef = _reg.find(op)
    no_bias_default = (opdef.attr_defaults.get("no_bias", False)
                       if opdef else False)
    skip = set()
    if attrs.get("no_bias", no_bias_default) in (True, "True", "true", 1):
        skip.add("bias")
    if op == "LeakyReLU" and attrs.get("act_type", "leaky") != "prelu":
        skip.add("gamma")
    if op == "RNN" and attrs.get("mode", "lstm") != "lstm":
        skip.add("state_cell")
    if op == "CTCLoss":   # each length input only under its flag
        if not _flag(attrs.get("use_data_lengths", False)):
            skip.add("data_lengths")
        if not _flag(attrs.get("use_label_lengths", False)):
            skip.add("label_lengths")
    if op in ("SequenceReverse", "SequenceMask", "SequenceLast") \
            and not _flag(attrs.get("use_sequence_length", False)):
        # the length input exists only under use_sequence_length
        # (reference: sequence_reverse-inl.h)
        skip.add("sequence_length")
    return skip


class Symbol:
    """A list of output heads over the op DAG (reference Symbol semantics)."""
    __slots__ = ("_heads",)

    def __init__(self, heads: List[Tuple[Node, int]]):
        self._heads = list(heads)

    # -- identity -----------------------------------------------------------
    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def __repr__(self):
        names = ", ".join(n.name for n, _ in self._heads)
        return f"<Symbol {names}>"

    def __len__(self):
        return len(self._expanded_heads())

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getitem__(self, index):
        """One output (by position or name) or a slice of outputs."""
        outputs = self._expanded_heads()
        if isinstance(index, str):
            names = self.list_outputs()
            hits = [i for i, n in enumerate(names)
                    if n == index or n == index + "_output"]
            if not hits:
                raise ValueError(f"no output named {index!r}")
            return Symbol([outputs[hits[0]]])
        if isinstance(index, slice):
            return Symbol(outputs[index])
        return Symbol([outputs[index]])

    def _expanded_heads(self) -> List[Tuple[Node, int]]:
        out = []
        for node, idx in self._heads:
            if idx is None:
                out.extend((node, i) for i in range(node_num_outputs(node)))
            else:
                out.append((node, idx))
        return out

    @property
    def heads(self):
        return self._expanded_heads()

    # -- graph introspection ------------------------------------------------
    def nodes(self) -> List[Node]:
        return _topo_sort(self._expanded_heads())

    def list_arguments(self) -> List[str]:
        return [n.name for n in self.nodes()
                if n.is_variable and not n._user_attrs.get("__is_aux__")]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._expanded_heads():
            if node.is_variable:
                names.append(node.name)
            elif node_num_outputs(node) == 1:
                names.append(node.name + "_output")
            else:
                names.append(f"{node.name}_output{idx}")
        return names

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self.nodes()
                if n.is_variable and n._user_attrs.get("__is_aux__")]

    def list_inputs(self):
        """Every variable: arguments and auxiliary states."""
        return [n.name for n in self.nodes() if n.is_variable]

    def get_internals(self) -> "Symbol":
        """Every output of every node, as one grouped symbol (index it
        by name, e.g. ``internals["flatten0_output"]``)."""
        return Symbol([(n, i) for n in self.nodes()
                       for i in range(node_num_outputs(n))])

    def get_children(self) -> Optional["Symbol"]:
        """The inputs of every head node (each node once), or None when
        no head has inputs."""
        heads, seen = [], set()
        for node, _ in self._heads:
            if id(node) not in seen:
                seen.add(id(node))
                heads.extend(node.inputs)
        return Symbol(heads) if heads else None

    def _single_head(self) -> Tuple[Node, int]:
        if len(self._heads) != 1:
            raise MXNetError("attributes are read from a single-output "
                             "symbol")
        return self._heads[0]

    def attr(self, key):
        """The user attribute ``key`` of this symbol's node, or None."""
        return self._single_head()[0]._user_attrs.get(key)

    def list_attr(self):
        """The user attributes of this symbol's node."""
        return {k: v for k, v in self._single_head()[0]._user_attrs.items()
                if not k.startswith("__is_aux")}

    def _set_attr(self, **kwargs):
        self._single_head()[0]._user_attrs.update(kwargs)

    def attr_dict(self):
        """{node name: {attr: str}} of the nodes that carry attributes:
        user attributes (``__init__``, ``__lr_mult__``, ...) and op
        attributes, as the JAX package's ``attr_dict``."""
        out = {}
        for n in self.nodes():
            attrs = {k: v for k, v in n._user_attrs.items()
                     if not k.startswith("__is_aux")}
            attrs.update({k: str(v) for k, v in n.attrs.items()})
            if attrs:
                out[n.name] = attrs
        return out

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    compute_dtype=None, **shapes):
        """Bind with arrays allocated from the given input shapes
        (:meth:`mxnet_tpu_torch.executor.Executor.simple_bind`)."""
        from ..executor import Executor
        return Executor.simple_bind(self, ctx, grad_req=grad_req,
                                    type_dict=type_dict, shapes=shapes,
                                    compute_dtype=compute_dtype)

    # -- shape inference ----------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input
        shapes, positional in ``list_arguments`` order or by name."""
        try:
            return self._infer_shape_impl(*args, **kwargs)
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError(f"infer_shape error: {e}")

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None for what cannot be inferred
        (every argument's shape None when the graph cannot be walked)."""
        try:
            return self._infer_shape_impl(*args, partial=True, **kwargs)
        except Exception:
            return ([None] * len(self.list_arguments()), None, None)

    def _infer_shape_impl(self, *args, partial=False, **kwargs):
        arg_names = self.list_arguments()
        known: Dict[str, tuple] = {}
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes, _ = _infer_graph_shapes(self, known, {})
        arg_shapes = [shapes.get(n) for n in arg_names]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
        if missing and not partial:
            raise MXNetError(f"infer_shape: cannot infer shapes for {missing}")
        return arg_shapes, shapes["__outputs__"], aux_shapes

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) as numpy dtypes, from the
        given input dtypes (positional in ``list_arguments`` order or by
        name), as the JAX package infers them: a variable's ``dtype``
        attribute pins it; the first floating dtype given (or pinned)
        becomes every other input's, float32 without one; each op runs
        on meta tensors of its inputs' dtypes (of shape (1,)), and an
        output whose op cannot run there is the default dtype."""
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known: Dict[str, np.dtype] = {}
        for n, t in zip(arg_names, args):
            if t is not None:
                known[n] = np.dtype(t)
        known.update({k: np.dtype(v) for k, v in kwargs.items()
                      if v is not None})
        float_attr = []
        for node in self.nodes():
            if node.is_variable and "__dtype__" in node._user_attrs:
                dt = np.dtype(node._user_attrs["__dtype__"])
                known.setdefault(node.name, dt)
                if np.issubdtype(dt, np.floating):
                    float_attr.append(dt)
        floats = [v for v in known.values() if np.issubdtype(v, np.floating)]
        default = next(iter(floats + float_attr), np.dtype("float32"))
        for n in arg_names + aux_names:
            known.setdefault(n, default)
        _, dtypes = _infer_graph_shapes(self, {}, known,
                                        shapes_optional=True,
                                        dummy_shapes=True)
        outs = [default if t is None else t for t in dtypes["__outputs__"]]
        return ([dtypes.get(n) or default for n in arg_names], outs,
                [dtypes.get(n) or default for n in aux_names])

    # -- save/load ----------------------------------------------------------
    def tojson(self):
        nodes = self.nodes()
        node_index = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jn = {
                "op": n.op if n.op else "null",
                "name": n.name,
                "inputs": [[node_index[id(src)], idx, 0]
                           for src, idx in n.inputs],
            }
            attrs = {k: _attr_to_str(v) for k, v in n.attrs.items()}
            attrs.update({k: str(v) for k, v in n._user_attrs.items()})
            if attrs:
                jn["attrs"] = attrs
            jnodes.append(jn)
        heads = [[node_index[id(n)], i, 0] for n, i in self._expanded_heads()]
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_variable]
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": arg_nodes,
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": heads,
            "attrs": {"mxnet_version": ["int", 1200]},
        }, indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to ``fname`` (``prefix-symbol.json``)."""
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- arithmetic (reference symbol.py operator overloads) ----------------
    def _binop(self, other, op, scalar_op, rop=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if rop else (self, other)
            return _compose(op, [a, b], {}, None)
        if isinstance(other, numbers.Number):
            return _compose(scalar_op, [self], {"scalar": float(other)}, None)
        return NotImplemented

    def __add__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar")
    __radd__ = __add__
    def __sub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "broadcast_sub", "_rminus_scalar", rop=True)
    def __mul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar")
    __rmul__ = __mul__
    def __truediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "broadcast_div", "_rdiv_scalar", rop=True)
    def __pow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binop(o, "broadcast_power", "_rpower_scalar", rop=True)
    def __mod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar")
    def __neg__(self): return _compose("negative", [self], {}, None)
    def __abs__(self): return _compose("abs", [self], {}, None)
    def __gt__(self, o): return self._binop(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # -- method mirrors of ops (the ones Gluon layers call) -----------------
    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _compose("Reshape", [self], {"shape": shape, **kw}, None)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _compose("transpose", [self], {"axes": axes}, None)

    def astype(self, dtype):
        from ..ndarray.ndarray import dtype_name
        return _compose("Cast", [self], {"dtype": dtype_name(dtype)}, None)

    def sum(self, axis=None, keepdims=False):
        return _compose("sum", [self], {"axis": axis, "keepdims": keepdims},
                        None)

    def mean(self, axis=None, keepdims=False):
        return _compose("mean", [self], {"axis": axis, "keepdims": keepdims},
                        None)

    def flatten(self):
        return _compose("Flatten", [self], {}, None)

    def slice_axis(self, axis, begin, end):
        return _compose("slice_axis", [self],
                        {"axis": axis, "begin": begin, "end": end}, None)

    def expand_dims(self, axis):
        return _compose("expand_dims", [self], {"axis": axis}, None)

    def softmax(self, axis=-1):
        return _compose("softmax", [self], {"axis": axis}, None)


def _attr_to_str(v):
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(str(x) for x in v) + ")"
    return str(v)


# ---------------------------------------------------------------------------
# composition (reference: MXSymbolCreateAtomicSymbol + Compose)
# ---------------------------------------------------------------------------
def _compose(op_name: str, inputs: List[Symbol], attrs: dict,
             name: Optional[str], user_attr: Optional[dict] = None) -> Symbol:
    opdef = _reg.get(op_name)
    attrs = {k: v for k, v in attrs.items() if v is not None}
    hint = op_name.lower().lstrip("_")
    name = _name.current().get(name, hint)
    # an explicit attr= merges over the ambient AttrScope's attributes
    user_attrs = _attribute.current().get(user_attr)

    heads: List[Tuple[Node, int]] = []
    for s in inputs:
        heads.extend(s._expanded_heads())

    if not opdef.variadic:
        # auto-create missing parameter/aux variables, named
        # {node}_{arg} as in the reference's Compose
        arg_names = list(opdef.arg_names or [])
        aux_names = list(opdef.aux_names or [])
        skip = _skip_args(op_name, attrs)
        wanted = [a for a in arg_names + aux_names if a not in skip]
        for extra in wanted[len(heads):]:
            is_aux = extra in aux_names
            v = Variable(f"{name}_{extra}", attr=user_attr,
                         __is_aux__="1" if is_aux else None)
            heads.extend(v._expanded_heads())
        # a given variable in an auxiliary slot is an auxiliary state
        for slot, (src, _) in zip(wanted, heads):
            if slot in aux_names and src.is_variable:
                src._user_attrs["__is_aux__"] = "1"

    node = Node(op_name, name, attrs, heads, user_attrs)
    return Symbol([(node, None)])


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
        dtype=None, init=None, **kwargs) -> Symbol:
    """Create a variable symbol (reference: symbol.py var/Variable).
    ``init`` (an Initializer or its ``dumps()`` string) is kept in the
    ``__init__`` attribute, which ``Module.init_params`` reads."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    user_attrs = _attribute.current().get(attr)
    if shape is not None:
        user_attrs["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        user_attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        user_attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        user_attrs["__init__"] = init if isinstance(init, str) \
            else init.dumps()
    if dtype is not None:
        from ..ndarray.ndarray import dtype_name
        user_attrs["__dtype__"] = dtype_name(dtype)
    for k, v in kwargs.items():
        if v is not None:
            user_attrs[k] = str(v)
    user_attrs = {k: v for k, v in user_attrs.items() if v is not None}
    return Symbol([(Node(None, name, {}, [], user_attrs), None)])


Variable = var


def Group(symbols) -> Symbol:
    heads = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("Group expects Symbols")
        heads.extend(s._expanded_heads())
    return Symbol(heads)


def load_json(json_str: str) -> Symbol:
    """Rebuild a Symbol from graph JSON: the nnvm layout (as ``tojson``
    of either package writes it, edges ``[node, output, version]``) or
    the reference's pre-nnvm v0.8 layout (edges ``[node, output]``, op
    attributes in ``param`` and user attributes in a sibling ``attr``).
    Op attributes are parsed against the op's defaults.  A v0.8 file
    leaves out an op's implicit trailing inputs (BatchNorm's moving
    statistics, a loss head's label); they are added as variables with
    composition's names (``{node}_{input}``), auxiliary where the op
    takes them as auxiliary states, and none for an input the op's
    attributes drop (``no_bias``)."""
    g = json.loads(json_str)
    nodes: List[Node] = []
    for jn in g["nodes"]:
        attrs = dict(jn.get("attrs", jn.get("param", {})) or {})
        user_attrs = {k: v for k, v in attrs.items()
                      if k.startswith("__") or k in ("ctx_group",)}
        # only the v0.8 layout (told by its "param" dict) keeps user
        # attributes in "attr"; an nnvm-era "attr" holds op attributes
        if "param" in jn:
            user_attrs.update(jn.get("attr", {}) or {})
        op = jn["op"]
        if op == "null":
            node = Node(None, jn["name"], {}, [], user_attrs)
        else:
            opdef = _reg.find(op)
            if opdef is None:
                raise MXNetError(f"cannot load graph: unknown op {op!r}")
            op_attrs = {k: _parse_attr(v, opdef.attr_defaults.get(k))
                        for k, v in attrs.items() if not k.startswith("__")}
            inputs = [(nodes[e[0]], e[1]) for e in jn["inputs"]]
            skip = _skip_args(op, op_attrs)
            args_w = [a for a in (opdef.arg_names or []) if a not in skip]
            aux_w = [a for a in (opdef.aux_names or []) if a not in skip]
            want = args_w + aux_w
            if not opdef.variadic and args_w and len(inputs) < len(want):
                # added variables stay out of `nodes`: the file's edges
                # index its own node list
                for pos in range(len(inputs), len(want)):
                    inputs.append((Node(
                        None, f"{jn['name']}_{want[pos]}", {}, [],
                        {"__is_aux__": "1"} if pos >= len(args_w)
                        else {}), 0))
            node = Node(op, jn["name"], op_attrs, inputs, user_attrs)
        nodes.append(node)
    return Symbol([(nodes[e[0]], e[1]) for e in g["heads"]])


def load(fname: str) -> Symbol:
    """The Symbol saved in ``fname`` by either package."""
    with open(fname) as f:
        return load_json(f.read())


def _parse_attr(v, default=None):
    """Parse a stringified attr back to python (tuples, bools, numbers),
    typed by the op's ``default`` where it has one: a string attribute
    stays a string, 0/1 of a flag is a bool, a number where the default
    is a tuple is a tuple of one."""
    if not isinstance(v, str):
        return v
    if isinstance(default, str) and v.strip() not in ("None", ""):
        return v
    out = _parse_untyped(v)
    if isinstance(default, bool) and out in (0, 1) \
            and not isinstance(out, bool):
        return bool(out)
    if isinstance(default, tuple) and isinstance(out, numbers.Number) \
            and not isinstance(out, bool):
        return (out,)
    return out


def _parse_untyped(v):
    s = v.strip()
    if s in ("True", "true"):
        return True
    if s in ("False", "false"):
        return False
    if s in ("None", ""):
        return None
    if s.startswith("(") or s.startswith("["):
        parts = [p.strip() for p in s[1:-1].split(",") if p.strip()]
        return tuple(_parse_untyped(p) for p in parts)
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return v


# ---------------------------------------------------------------------------
# bidirectional pre-pass (reference: infer_graph_attr_pass.cc iterates
# forward and backward, so a 0 ("unknown") dim anywhere can be pinned by
# constraints elsewhere).  It resolves unknown dims for the structural
# ops where backward propagation matters and hands fully resolved
# variable shapes to the forward pass; it also checks given shapes
# against those ops' constraints (FullyConnected's weight against
# num_hidden, Concat's parts against its output).
# ---------------------------------------------------------------------------
_SHAPE_PRESERVING_OPS = frozenset({
    "Activation", "relu", "sigmoid", "tanh", "softsign", "exp", "log",
    "negative", "abs", "square", "sqrt", "BlockGrad", "stop_gradient",
    "_copy", "identity", "make_loss", "zeros_like", "ones_like",
    "LeakyReLU", "softmax", "log_softmax", "Dropout", "BatchNorm",
    "InstanceNorm", "L2Normalization", "Cast", "cast",
})
# strict same-shape binaries: inputs and output all unify dim-wise
_ELEMWISE_BINARY_OPS = frozenset({
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "elemwise_mod", "_identity_with_attr_like_rhs", "_grad_add",
})
# numpy-broadcast binaries: right-aligned, 1s broadcast; an unknown input
# dim takes the output's (no broadcast assumed), as the reference's
# BinaryBroadcastShape does
_BROADCAST_BINARY_OPS = frozenset({
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_mod", "broadcast_power", "broadcast_maximum",
    "broadcast_minimum", "broadcast_hypot",
})


def _unify_dims(a, b, where=""):
    """Dim-wise merge of two patterns (None or 0 = unknown)."""
    if a is None:
        return list(b) if b is not None else None
    if b is None:
        return list(a)
    if len(a) != len(b):
        raise MXNetError(f"infer_shape: rank mismatch {a} vs {b} {where}")
    out = []
    for x, y in zip(a, b):
        x = x or None
        y = y or None
        if x is not None and y is not None and x != y:
            raise MXNetError(
                f"infer_shape: inconsistent dims {a} vs {b} {where}")
        out.append(x if x is not None else y)
    return out


def _prepass_broadcast(ins, out0):
    """New (a, b, out) patterns of a broadcast binary, or None when the
    output's rank cannot be told yet."""
    if out0 is not None:
        r = len(out0)
    elif ins[0] is not None and ins[1] is not None:
        r = max(len(ins[0]), len(ins[1]))
    else:
        return None

    def aligned(p):   # right-aligned; absent leading dims act as 1
        return [None] * r if p is None else [1] * (r - len(p)) + list(p)

    a, b, o = aligned(ins[0]), aligned(ins[1]), aligned(out0)
    new_a, new_b, new_o = list(a), list(b), list(o)
    for d in range(r):
        cand = {v for v in (a[d], b[d]) if v and v != 1}
        if len(cand) > 1:
            raise MXNetError(f"infer_shape: broadcast mismatch "
                             f"{ins[0]} vs {ins[1]}")
        if cand:
            new_o[d] = _unify_dims([o[d]], [cand.pop()])[0]
        elif a[d] == 1 and b[d] == 1:
            new_o[d] = _unify_dims([o[d]], [1])[0]
        if new_o[d]:
            if a[d] is None:
                new_a[d] = new_o[d]
            if b[d] is None:
                new_b[d] = new_o[d]
    return new_a, new_b, new_o, r


def _prepass_conv(n, data, out0, w):
    """New (data, out) patterns of a Convolution, or None."""
    kern = tuple(n.attrs.get("kernel", ()) or ())
    rank = len(kern)
    if not rank or data is None or len(data) != rank + 2:
        return None
    stride = tuple(n.attrs.get("stride", ()) or (1,) * rank)
    pad = tuple(n.attrs.get("pad", ()) or (0,) * rank)
    dil = tuple(n.attrs.get("dilate", ()) or (1,) * rank)
    nf = int(n.attrs.get("num_filter", 0))
    # channel and spatial axes move for NHWC
    nhwc = n.attrs.get("layout") == "NHWC" and rank == 2
    sp0, c_ax = (1, rank + 1) if nhwc else (2, 1)
    data = list(data)
    hint = [None] * (rank + 2)
    hint[0], hint[c_ax] = data[0], nf
    o = _unify_dims(out0 or [None] * (rank + 2), hint, w)
    for d in range(rank):
        ke = dil[d] * (kern[d] - 1) + 1
        if data[sp0 + d]:
            o[sp0 + d] = (data[sp0 + d] + 2 * pad[d] - ke) // stride[d] + 1
        elif o[sp0 + d]:
            data[sp0 + d] = (o[sp0 + d] - 1) * stride[d] - 2 * pad[d] + ke
    data[0] = o[0]
    return data, o


def _prepass_concat(n, parts, out0, w):
    """[(target, pattern)] for a Concat: (None, p) is its output, (j, p)
    its j-th input."""
    dim = int(n.attrs.get("dim", 1))
    rank = next((len(p) for p in parts + [out0] if p is not None), None)
    if rank is None:
        return []
    dim %= rank
    base = [None] * rank   # the non-concat dims, unified over every part
    for p in parts + [out0]:
        if p is None:
            continue
        for d in range(rank):
            if d != dim and p[d]:
                base[d] = _unify_dims([base[d]], [p[d]], w)[0]
    tot, missing = 0, []
    for j, p in enumerate(parts):
        if p is not None and p[dim]:
            tot += p[dim]
        else:
            missing.append(j)
    o = list(base)
    o[dim] = tot if not missing else (
        out0[dim] if out0 and out0[dim] else None)
    puts = [(None, o)]
    if out0 and out0[dim] and len(missing) == 1:
        rem = out0[dim] - tot
        if rem <= 0:
            raise MXNetError(f"infer_shape: concat parts sum to {tot} but "
                             f"the output dim is {out0[dim]} {w}")
        fill = list(base)
        fill[dim] = rem
        puts.append((missing[0], fill))
    for j, p in enumerate(parts):
        fill = list(base)
        fill[dim] = p[dim] if p and p[dim] else None
        puts.append((j, fill))
    return puts


def _prepass_split(n, data, outs):
    """[(target, pattern)] for a SliceChannel: (None, p) its input,
    (i, p) its i-th output."""
    num = int(n.attrs.get("num_outputs", 1))
    axis = int(n.attrs.get("axis", 1))
    squeeze = _flag(n.attrs.get("squeeze_axis", False))
    if axis < 0:   # normalized against the input's rank
        in_rank = len(data) if data is not None else next(
            (len(o) + (1 if squeeze else 0) for o in outs if o is not None),
            None)
        if in_rank is None:
            return []
        axis %= in_rank
    puts = []
    for i, oi in enumerate(outs):
        if data is not None:
            exp = list(data)
            exp[axis] = data[axis] // num if data[axis] else None
            if squeeze:
                exp = exp[:axis] + exp[axis + 1:]
            puts.append((i, exp))
        if oi is not None:
            if squeeze:
                back = list(oi[:axis]) + [num] + list(oi[axis:])
            else:
                back = list(oi)
                back[axis] = oi[axis] * num if oi[axis] else None
            puts.append((None, back))
    return puts


def _partial_prepass(nodes, var_pat, generic_eval=True):
    """Fixpoint bidirectional dim propagation.  ``var_pat``: id(node) ->
    list pattern (None = unknown) of the variables, updated in place.
    ``generic_eval`` also runs every other op whose inputs are complete
    on meta tensors; without it only the rules above run (as checks)."""
    pat: Dict[Tuple[int, int], list] = {}
    for n in nodes:
        if n.is_variable and var_pat.get(id(n)) is not None:
            pat[(id(n), 0)] = list(var_pat[id(n)])

    def get(src, idx):
        return pat.get((id(src), idx))

    def put(src, idx, p, where):
        if p is None:
            return False
        merged = _unify_dims(get(src, idx), p, where)
        if merged != get(src, idx):
            pat[(id(src), idx)] = merged
            if src.is_variable:
                var_pat[id(src)] = merged
            return True
        return False

    def complete(p):
        return p is not None and all(d for d in p)

    for _ in range(3 * len(nodes) + 8):
        changed = False
        for n in nodes:
            if n.is_variable:
                continue
            ins = [get(s, i) for s, i in n.inputs]
            out0 = get(n, 0)
            op = n.op
            w = f"at {n.name!r} ({op})"
            try:
                if op in _ELEMWISE_BINARY_OPS and len(n.inputs) == 2:
                    m = _unify_dims(_unify_dims(ins[0], ins[1], w), out0, w)
                    changed |= put(*n.inputs[0], m, w)
                    changed |= put(*n.inputs[1], m, w)
                    changed |= put(n, 0, m, w)
                elif op in _BROADCAST_BINARY_OPS and len(n.inputs) == 2:
                    res = _prepass_broadcast(ins, out0)
                    if res is None:
                        continue
                    new_a, new_b, new_o, r = res
                    if ins[0] is not None:
                        changed |= put(*n.inputs[0],
                                       new_a[r - len(ins[0]):], w)
                    if ins[1] is not None:
                        changed |= put(*n.inputs[1],
                                       new_b[r - len(ins[1]):], w)
                    changed |= put(n, 0, new_o, w)
                elif op in _SHAPE_PRESERVING_OPS and n.inputs:
                    m = _unify_dims(ins[0], out0, w)
                    changed |= put(*n.inputs[0], m, w)
                    changed |= put(n, 0, m, w)
                elif op == "FullyConnected" and \
                        _flag(n.attrs.get("flatten", True)):
                    # flatten=False keeps leading dims of unknown rank:
                    # left to the forward pass
                    nh = int(n.attrs.get("num_hidden", 0))
                    data = ins[0]
                    o = _unify_dims(out0, [None, nh], w)
                    if data is not None and len(data) == 2:
                        o = _unify_dims(o, [data[0], nh], w)
                        changed |= put(*n.inputs[0], [o[0], data[1]], w)
                        if len(n.inputs) > 1 and data[1]:
                            changed |= put(*n.inputs[1], [nh, data[1]], w)
                    changed |= put(n, 0, o, w)
                elif op == "Convolution":
                    res = _prepass_conv(n, ins[0], out0, w)
                    if res is not None:
                        changed |= put(*n.inputs[0], res[0], w)
                        changed |= put(n, 0, res[1], w)
                elif op in ("Concat", "concat"):
                    for j, p in _prepass_concat(n, ins, out0, w):
                        src = (n, 0) if j is None else n.inputs[j]
                        changed |= put(*src, p, w)
                elif op in ("SliceChannel", "split"):
                    outs = [get(n, i) for i in range(node_num_outputs(n))]
                    for i, p in _prepass_split(n, ins[0], outs):
                        src = n.inputs[0] if i is None else (n, i)
                        changed |= put(*src, p, w)
                elif generic_eval and ins and not complete(out0) and \
                        all(complete(p) for p in ins):
                    outs = _eval_node_meta(n, _reg.get(op),
                                           [_meta(p) for p in ins])
                    for i, t in enumerate(outs):
                        changed |= put(n, i, list(t.shape), w)
            except MXNetError:
                raise
            except Exception:
                continue
        if not changed:
            break


# ---------------------------------------------------------------------------
# forward shape inference on meta tensors
# ---------------------------------------------------------------------------
_META = torch.device("meta")


def _meta(shape, dtype=torch.float32):
    return torch.empty(tuple(shape), dtype=dtype, device=_META)


def _infer_graph_shapes(sym: Symbol, known_shapes: Dict[str, tuple],
                        known_dtypes: Dict[str, object],
                        shapes_optional=False, dummy_shapes=False):
    """Forward abstract interpretation with parameter-shape back-fill,
    after the bidirectional pre-pass.  Returns ``(shapes, dtypes)``
    dicts keyed by variable name, each with ``"__outputs__"`` listing
    the heads' (None where unknown).  ``dummy_shapes`` gives every
    variable without a shape (1,), for dtype inference, and
    ``shapes_optional`` skips an op that cannot be evaluated."""
    from ..ndarray.ndarray import numpy_dtype, torch_dtype
    nodes = _topo_sort(sym._expanded_heads())
    var_shape: Dict[int, Optional[tuple]] = {}
    var_dtype: Dict[int, torch.dtype] = {}
    val: Dict[Tuple[int, int], torch.Tensor] = {}
    partial_pat: Dict[int, list] = {}
    has_partial = False
    for n in nodes:
        if not n.is_variable:
            continue
        shp = known_shapes.get(n.name)
        if shp is None and "__shape__" in n._user_attrs:
            shp = _parse_attr(n._user_attrs["__shape__"])
        if shp is None and dummy_shapes:
            shp = (1,)
        if shp is not None and any(not d for d in shp):
            # 0 = an unknown dim (MXNet's convention), left to the
            # pre-pass, never a literal 0-size dim
            partial_pat[id(n)] = [d or None for d in shp]
            shp = None
            has_partial = True
        elif shp is not None:
            partial_pat[id(n)] = list(shp)
        var_shape[id(n)] = tuple(shp) if shp else None
        # shapes alone run every op in float32, as mixed dtypes (a bf16
        # weight of a net cast to bf16 against a float32 input) would
        # stop an op that the shapes let run; dtype inference types them
        dt = known_dtypes.get(n.name)
        if dt is None and dummy_shapes and "__dtype__" in n._user_attrs:
            dt = n._user_attrs["__dtype__"]
        var_dtype[id(n)] = torch_dtype(dt) if dt is not None \
            else torch.float32

    if not dummy_shapes:
        _partial_prepass(nodes, partial_pat, generic_eval=has_partial)
        for n in nodes:   # adopt what the pre-pass resolved completely
            if n.is_variable and var_shape.get(id(n)) is None:
                p = partial_pat.get(id(n))
                if p is not None and all(d for d in p):
                    var_shape[id(n)] = tuple(p)

    for n in nodes:
        if n.is_variable:
            if var_shape[id(n)] is not None:
                val[(id(n), 0)] = _meta(var_shape[id(n)], var_dtype[id(n)])
            continue
        opdef = _reg.get(n.op)
        infer_hook = PARAM_SHAPE_INFER.get(n.op)
        if infer_hook:
            names = [a for a in (opdef.arg_names or [])
                     + (opdef.aux_names or [])
                     if a not in _skip_args(n.op, n.attrs)]
            argmap = dict(zip(names, n.inputs))
            in_shapes = {an: tuple(val[(id(src), idx)].shape)
                         for an, (src, idx) in argmap.items()
                         if (id(src), idx) in val}
            for an, shp in infer_hook(n.attrs, in_shapes).items():
                src, idx = argmap.get(an, (None, None))
                if src is not None and src.is_variable \
                        and var_shape.get(id(src)) is None:
                    var_shape[id(src)] = tuple(shp)
                    val[(id(src), 0)] = _meta(shp, var_dtype[id(src)])
        missing = [(src, idx) for src, idx in n.inputs
                   if (id(src), idx) not in val]
        if missing:
            # same-shape mirroring: an unknown variable input takes the
            # shape of the first known one (labels of loss heads)
            knowns = [val[(id(s), i)] for s, i in n.inputs
                      if (id(s), i) in val]
            if knowns and all(s.is_variable for s, _ in missing):
                for src, idx in missing:
                    val[(id(src), idx)] = _meta(knowns[0].shape,
                                                var_dtype[id(src)])
                    var_shape[id(src)] = tuple(knowns[0].shape)
            elif shapes_optional:
                continue
            else:
                raise MXNetError(
                    f"infer_shape: insufficient information at node "
                    f"{n.name!r} ({n.op})")
        try:
            outs = _eval_node_meta(n, opdef,
                                   [val[(id(s), i)] for s, i in n.inputs])
        except Exception:
            if shapes_optional:
                continue
            raise
        for i, t in enumerate(outs):
            val[(id(n), i)] = t

    def np_dtype(t):
        dt = numpy_dtype(t)
        return np.dtype(dt) if dt != "bfloat16" else dt

    heads = [val.get((id(hn), hi)) for hn, hi in sym._expanded_heads()]
    shapes = {"__outputs__": [None if t is None else tuple(t.shape)
                              for t in heads]}
    dtypes = {"__outputs__": [None if t is None else np_dtype(t.dtype)
                              for t in heads]}
    for n in nodes:
        if n.is_variable:
            shapes[n.name] = var_shape.get(id(n))
            dtypes[n.name] = np_dtype(var_dtype[id(n)])
    return shapes, dtypes


def _eval_node_meta(n: Node, opdef: _reg.OpDef, ins):
    kwargs = dict(n.attrs)
    if opdef.takes_is_train:
        kwargs["is_train"] = False
    if not n.inputs:
        kwargs["device"] = _META
    out = opdef.fn(*ins, **kwargs)
    out = out if isinstance(out, (tuple, list)) else (out,)
    return list(out)[:node_num_outputs(n)]


def zeros(shape, dtype="float32", **kw):
    """A constant of zeros (reference: symbol.py zeros)."""
    if isinstance(shape, numbers.Integral):
        shape = (shape,)
    return _compose("_zeros", [], {"shape": tuple(shape),
                                   "dtype": np.dtype(dtype).name},
                    kw.get("name"))


def ones(shape, dtype="float32", **kw):
    """A constant of ones (reference: symbol.py ones)."""
    if isinstance(shape, numbers.Integral):
        shape = (shape,)
    return _compose("_ones", [], {"shape": tuple(shape),
                                  "dtype": np.dtype(dtype).name},
                    kw.get("name"))


def arange(start, stop=None, step=1.0, repeat=1, name=None, dtype="float32"):
    return _compose("_arange", [], {"start": start, "stop": stop,
                                    "step": step, "repeat": repeat,
                                    "dtype": np.dtype(dtype).name}, name)
