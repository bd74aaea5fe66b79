"""Single-path operator registry.

PyTorch counterpart of ``mxnet_tpu/ops/registry.py``: an ``OpDef`` holds a
plain function on torch tensors plus the same metadata as the JAX
package's, so the symbol frontend, the executor and shape inference read
one definition.  Implementation functions are pure:
``fn(*inputs, **attrs) -> tensor | tuple``.  Ops that create a tensor from
no input take a ``device`` keyword, which the executor supplies.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..base import MXNetError

_OP_REGISTRY: Dict[str, "OpDef"] = {}

# Names of ops that have actually executed in this process (the coverage
# hook the JAX package's tests read; kept for parity).
EXECUTED_OPS: set = set()


def record_execution(name: str) -> None:
    EXECUTED_OPS.add(name)


@dataclass
class OpDef:
    name: str
    fn: Callable  # pure torch impl
    num_outputs: int = 1
    # outputs the graph exposes (LayerNorm computes 3, shows 1), or a
    # function of the node's attrs (Proposal's output_score)
    num_visible: Optional[object] = None
    needs_rng: bool = False
    num_aux: int = 0
    differentiable: bool = True
    takes_is_train: bool = False
    arg_names: Optional[List[str]] = None
    aux_names: Optional[List[str]] = None
    attr_defaults: Dict[str, object] = field(default_factory=dict)
    doc: str = ""
    variadic: bool = False
    aliases: tuple = ()
    # an NDArray-level form that ``nd.<op>`` tries first: it takes the
    # input NDArrays and the attrs and returns NotImplemented to leave
    # them to ``fn`` (a sparse array's O(nnz) route)
    nd_fn: Optional[Callable] = None

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def register(name, *, num_outputs=1, needs_rng=False, num_aux=0,
             differentiable=True, takes_is_train=False, arg_names=None,
             aux_names=None, attr_defaults=None, variadic=False,
             aliases=(), num_visible=None):
    """Decorator: register a torch op implementation under an MXNet name."""
    def _reg(fn):
        op = OpDef(name=name, fn=fn, num_outputs=num_outputs,
                   num_visible=num_visible,
                   needs_rng=needs_rng, num_aux=num_aux,
                   differentiable=differentiable,
                   takes_is_train=takes_is_train,
                   arg_names=list(arg_names) if arg_names else None,
                   aux_names=list(aux_names) if aux_names else None,
                   attr_defaults=dict(attr_defaults or {}),
                   doc=fn.__doc__ or "", variadic=variadic,
                   aliases=tuple(aliases))
        if name in _OP_REGISTRY:
            raise MXNetError(f"op {name!r} registered twice")
        _OP_REGISTRY[name] = op
        for a in aliases:
            _OP_REGISTRY[a] = op
        return fn
    return _reg


def alias(new_name: str, existing: str):
    _OP_REGISTRY[new_name] = _OP_REGISTRY[existing]


def op_count() -> int:
    """Distinct ops registered (aliases counted once)."""
    return len({id(v) for v in _OP_REGISTRY.values()})


def get(name: str) -> OpDef:
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} is not registered")


def find(name: str) -> Optional[OpDef]:
    return _OP_REGISTRY.get(name)


def list_ops() -> List[str]:
    return sorted(_OP_REGISTRY)


def build_op_doc(opdef, name, flavor="sym"):
    """Docstring for a generated wrapper: signature (inputs + attrs with
    defaults) followed by the registered doc."""
    args = list(opdef.arg_names or []) + list(opdef.aux_names or [])
    if opdef.variadic:
        args = ["*args"]
    parts = args + ["%s=%r" % (k, v)
                    for k, v in (opdef.attr_defaults or {}).items()]
    parts.append("name=None")
    lines = ["%s(%s)" % (name, ", ".join(parts))]
    body = (opdef.doc or "").strip()
    if body:
        lines += ["", body]
    lines += ["", "Registered op %r (generated mx.sym wrapper)."
              % opdef.name]
    return "\n".join(lines)
