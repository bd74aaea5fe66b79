"""Symbol: the declarative graph frontend.

PyTorch counterpart of ``mxnet_tpu/symbol/symbol.py``. A Symbol is a
list of (node, output-index) heads over a DAG of ``Node`` objects;
binding it builds a plain function on tensors
(:func:`mxnet_tpu_torch.executor.build_interpreter`). Graph JSON
save/load keeps the nnvm layout of the JAX package (nodes / arg_nodes /
heads), so a graph saved by either package loads in the other.

Shape inference runs forward over the graph: parameter shapes are filled
from the data shapes by per-op rules (FullyConnected, Convolution,
Deconvolution, BatchNorm, InstanceNorm, LayerNorm, Embedding, PReLU), and
every op's shape comes from running its torch function on
``device="meta"`` tensors, which carry shapes and no data;
``infer_shape_partial`` (Gluon's deferred initialization) returns None
where it cannot tell. The JAX package's bidirectional pre-pass, which
resolves unknown (0) dims from constraints elsewhere in the graph, is
not ported yet.

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
        shapes = _infer_graph_shapes(self, known)
        arg_shapes = [shapes.get(n) for n in arg_names]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
        if missing and not partial:
            raise MXNetError(f"infer_shape: cannot infer shapes for {missing}")
        return arg_shapes, shapes["__outputs__"], aux_shapes

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
    user_attrs = dict(user_attr or {})

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
    user_attrs = dict(attr or {})
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
    """Rebuild a Symbol from nnvm-layout JSON (as ``tojson`` of either
    package writes it)."""
    g = json.loads(json_str)
    nodes: List[Node] = []
    for jn in g["nodes"]:
        attrs = dict(jn.get("attrs", jn.get("param", {})) or {})
        user_attrs = {k: v for k, v in attrs.items()
                      if k.startswith("__") or k in ("ctx_group",)}
        op = jn["op"]
        if op == "null":
            node = Node(None, jn["name"], {}, [], user_attrs)
        else:
            opdef = _reg.find(op)
            if opdef is None:
                raise MXNetError(f"cannot load graph: unknown op {op!r}")
            op_attrs = {k: _parse_attr(v)
                        for k, v in attrs.items() if not k.startswith("__")}
            inputs = [(nodes[e[0]], e[1]) for e in jn["inputs"]]
            node = Node(op, jn["name"], op_attrs, inputs, user_attrs)
        nodes.append(node)
    return Symbol([(nodes[e[0]], e[1]) for e in g["heads"]])


def load(fname: str) -> Symbol:
    """The Symbol saved in ``fname`` by either package."""
    with open(fname) as f:
        return load_json(f.read())


def _parse_attr(v):
    """Parse a stringified attr back to python (tuples, bools, numbers)."""
    if not isinstance(v, str):
        return v
    s = v.strip()
    if s in ("True", "true"):
        return True
    if s in ("False", "false"):
        return False
    if s in ("None", ""):
        return None
    if s.startswith("(") or s.startswith("["):
        parts = [p.strip() for p in s[1:-1].split(",") if p.strip()]
        return tuple(_parse_attr(p) for p in parts)
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
# forward shape inference on meta tensors
# ---------------------------------------------------------------------------
_META = torch.device("meta")


def _infer_graph_shapes(sym: Symbol, known_shapes: Dict[str, tuple]):
    """Forward abstract interpretation with parameter-shape back-fill.
    Returns a dict keyed by variable name, plus ``"__outputs__"`` listing
    per-head shapes."""
    nodes = _topo_sort(sym._expanded_heads())
    var_shape: Dict[int, Optional[tuple]] = {}
    val: Dict[Tuple[int, int], torch.Tensor] = {}

    def meta(shape):
        return torch.empty(tuple(shape), dtype=torch.float32, device=_META)

    for n in nodes:
        if n.is_variable:
            shp = known_shapes.get(n.name)
            if shp is None and "__shape__" in n._user_attrs:
                shp = _parse_attr(n._user_attrs["__shape__"])
            var_shape[id(n)] = tuple(shp) if shp else None
            if shp:
                val[(id(n), 0)] = meta(shp)
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
                    val[(id(src), 0)] = meta(shp)
        missing = [(src, idx) for src, idx in n.inputs
                   if (id(src), idx) not in val]
        if missing:
            # same-shape mirroring: an unknown variable input takes the
            # shape of the first known one (labels of loss heads)
            knowns = [val[(id(s), i)] for s, i in n.inputs
                      if (id(s), i) in val]
            if not knowns or not all(s.is_variable for s, _ in missing):
                raise MXNetError(
                    f"infer_shape: insufficient information at node "
                    f"{n.name!r} ({n.op})")
            for src, idx in missing:
                val[(id(src), idx)] = knowns[0]
                var_shape[id(src)] = tuple(knowns[0].shape)
        outs = _eval_node_meta(n, opdef,
                               [val[(id(s), i)] for s, i in n.inputs])
        for i, t in enumerate(outs):
            val[(id(n), i)] = t

    shapes = {"__outputs__": [
        tuple(val[(id(hn), hi)].shape) for hn, hi in sym._expanded_heads()]}
    for n in nodes:
        if n.is_variable:
            shapes[n.name] = var_shape.get(id(n))
    return shapes


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
