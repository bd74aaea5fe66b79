"""Network visualization (reference: python/mxnet/visualization.py).

PyTorch counterpart of ``mxnet_tpu/visualization.py``: the same table and
the same graph, read from the symbol's JSON.

``print_summary`` — layer table with shapes/params (visualization.py:38).
``plot_network`` — graphviz Digraph (visualization.py:158), import gated.
"""
from __future__ import annotations

import json

from .base import MXNetError
from .symbol import Symbol


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64,
                                                                  .74, 1.)):
    """reference: visualization.py:38 print_summary."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape_partial(**shape)
        if out_shapes is None:
            raise MXNetError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    # data inputs count as previous layers (the reference reaches the same
    # effect through its heads-set quirk, visualization.py:76,124)
    input_names = set(shape.keys()) if shape else \
        {n["name"] for n in nodes if n["op"] == "null" and
         not any(n["name"].endswith(s) for s in
                 ("weight", "bias", "gamma", "beta", "label",
                  "moving_mean", "moving_var", "running_mean",
                  "running_var"))}
    heads = {x[0] for x in conf["heads"]}
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]
    to_display = ['Layer (type)', 'Output Shape', 'Param #',
                  'Previous Layer']

    lines = []

    def print_row(fields, positions):
        line = ''
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += ' ' * (positions[i] - len(line))
        lines.append(line)

    lines.append('_' * line_length)
    print_row(to_display, positions)
    lines.append('=' * line_length)

    def print_layer_summary(node, out_shape):
        op = node["op"]
        pre_node = []
        pre_filter = 0
        if op != "null":
            inputs = node["inputs"]
            for item in inputs:
                input_node = nodes[item[0]]
                input_name = input_node["name"]
                if input_node["op"] != "null" or \
                        input_name in input_names:
                    pre_node.append(input_name)
                    if show_shape:
                        key = input_name + "_output" if \
                            input_node["op"] != "null" else input_name
                        if key in shape_dict and shape_dict[key]:
                            shape = shape_dict[key][1:]
                            pre_filter = pre_filter + int(shape[0]) \
                                if shape else pre_filter
        cur_param = 0
        attrs = node.get("attrs", {})
        if op == 'Convolution':
            num_filter = int(attrs["num_filter"])
            kernel = _parse_tuple(attrs["kernel"])
            num_group = int(attrs.get("num_group", "1"))
            bias = 0 if attrs.get("no_bias", "False") in ("True", "true") \
                else num_filter
            k = 1
            for v in kernel:
                k *= v
            cur_param = pre_filter * num_filter * k // num_group + bias
        elif op == 'FullyConnected':
            hidden = int(attrs["num_hidden"])
            bias = 0 if attrs.get("no_bias", "False") in ("True", "true") \
                else hidden
            cur_param = hidden * pre_filter + bias
        elif op == 'BatchNorm':
            key = node["name"] + "_output"
            if show_shape and key in shape_dict and shape_dict[key]:
                cur_param = int(shape_dict[key][1]) * 4
        first_connection = '' if not pre_node else pre_node[0]
        fields = [f'{node["name"]}({op})',
                  '' if out_shape is None else str(out_shape),
                  cur_param, first_connection]
        print_row(fields, positions)
        for i in range(1, len(pre_node)):
            print_row(['', '', '', pre_node[i]], positions)
        return cur_param

    total_params = 0
    for i, node in enumerate(nodes):
        out_shape = None
        op = node["op"]
        if op == "null" and i > 0:
            continue
        if op != "null" or i in heads:
            if show_shape:
                key = node["name"] + "_output" if op != "null" \
                    else node["name"]
                if key in shape_dict and shape_dict[key]:
                    out_shape = shape_dict[key][1:]
        total_params += print_layer_summary(node, out_shape)
        lines.append('_' * line_length if i < len(nodes) - 1
                     else '=' * line_length)
    lines.append(f'Total params: {total_params}')
    lines.append('_' * line_length)
    out = '\n'.join(lines)
    print(out)
    return out


def _parse_tuple(s):
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    return tuple(int(x) for x in
                 s.strip('()[] ').replace('L', '').split(',') if x.strip())


def plot_network(symbol, title="plot", save_format='pdf', shape=None,
                 node_attrs=None, hide_weights=True):
    """reference: visualization.py:158 plot_network (graphviz)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("plot_network requires the graphviz python "
                          "package (not installed in this environment); "
                          "use print_summary instead")
    node_attrs = node_attrs or {}
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)
    hidden_nodes = set()
    for node in nodes:
        op = node["op"]
        name = node["name"]
        attrs = node.get("attrs", {})
        label = name
        if op == "null":
            if name.endswith("weight") or name.endswith("bias") or \
                    name.endswith("gamma") or name.endswith("beta") or \
                    name.endswith("moving_mean") or \
                    name.endswith("moving_var") or \
                    name.endswith("running_mean") or \
                    name.endswith("running_var"):
                if hide_weights:
                    hidden_nodes.add(name)
                continue
            color = '#8dd3c7'
        elif op == 'Convolution':
            kernel = attrs.get("kernel", "")
            stride = attrs.get("stride", "1")
            label = f'Convolution\n{kernel}/{stride}, ' \
                    f'{attrs.get("num_filter", "")}'
            color = '#fb8072'
        elif op == 'FullyConnected':
            label = f'FullyConnected\n{attrs.get("num_hidden", "")}'
            color = '#fb8072'
        elif op == 'BatchNorm':
            color = '#bebada'
        elif op in ('Activation', 'LeakyReLU'):
            label = f'{op}\n{attrs.get("act_type", "")}'
            color = '#ffffb3'
        elif op == 'Pooling':
            label = f'Pooling\n{attrs.get("pool_type", "")}, ' \
                    f'{attrs.get("kernel", "")}/{attrs.get("stride", "")}'
            color = '#80b1d3'
        elif op in ('Concat', 'Flatten', 'Reshape'):
            color = '#fdb462'
        elif op == 'Softmax' or 'Softmax' in op:
            color = '#b3de69'
        else:
            color = '#fccde5'
        dot.node(name=name, label=label, fillcolor=color, **node_attr)
    for node in nodes:
        if node["op"] == "null":
            continue
        name = node["name"]
        for item in node["inputs"]:
            input_node = nodes[item[0]]
            input_name = input_node["name"]
            if input_name not in hidden_nodes:
                dot.edge(tail_name=input_name, head_name=name)
    return dot
