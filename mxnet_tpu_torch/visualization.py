"""Network visualization (reference ``python/mxnet/visualization.py``).

Counterpart of ``mxnet_tpu/visualization.py`` over the port's symbols:
``print_summary`` — layer table with output shapes and parameter counts;
``plot_network`` — graphviz Digraph of the symbol DAG (requires the
optional ``graphviz`` package, imported when the function runs; without
it the function raises :class:`MXNetError`).  Both read the symbol's
JSON and its shape inference only, so they print and draw the same as
the JAX package's functions.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

from .base import MXNetError
from .symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def _collect_nodes(symbol: Symbol):
    conf = json.loads(symbol.tojson())
    return conf["nodes"], conf["heads"]


def print_summary(symbol: Symbol,
                  shape: Optional[Dict[str, Tuple[int, ...]]] = None,
                  line_length: int = 98, positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a per-layer summary table (reference ``print_summary``)."""
    out_shapes = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_list, _ = internals.infer_shape(**shape)
        out_shapes = dict(zip(internals.list_outputs(), out_list))
    nodes, _ = _collect_nodes(symbol)
    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(cells):
        line = ""
        for cell, pos in zip(cells, positions):
            line = (line + str(cell))[:pos - 1].ljust(pos)
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)
    total_params = 0
    for node in nodes:
        op = node["op"]
        name = node["name"]
        if op == "null":
            if shape is None or name not in (shape or {}):
                continue
            out_shape = (shape or {}).get(name, "")
            print_row([f"{name} (input)", out_shape, 0, ""])
            continue
        out_shape = out_shapes.get(f"{name}_output",
                                   out_shapes.get(name, ""))
        params = 0
        prevs = []
        for src_idx, _ in node["inputs"]:
            src = nodes[src_idx]
            if src["op"] == "null":
                if src["name"].startswith(name + "_") and \
                        src["name"].endswith(("_weight", "_bias", "_gamma",
                                              "_beta", "_moving_mean",
                                              "_moving_var")):
                    s = out_shapes.get(src["name"])
                    if s:
                        n = 1
                        for d in s:
                            n *= d
                        params += n
                else:
                    prevs.append(src["name"])
            else:
                prevs.append(src["name"])
        total_params += params
        print_row([f"{name} ({op})", out_shape, params, ",".join(prevs)])
    print("=" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)


def plot_network(symbol: Symbol, title: str = "plot",
                 shape: Optional[Dict[str, Tuple[int, ...]]] = None,
                 node_attrs: Optional[Dict[str, str]] = None):
    """Build a graphviz Digraph of the network (reference ``plot_network``)."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise MXNetError(
            "plot_network requires the optional 'graphviz' package") from e
    if not isinstance(symbol, Symbol):
        raise MXNetError("symbol must be a Symbol")
    interals = symbol.get_internals()
    shape_dict = {}
    if shape is not None:
        _, out_shapes, _ = interals.infer_shape(**shape)
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs or {})
    dot = Digraph(name=title)
    # color palette per op family (reference's scheme)
    palette = ("#8dd3c7", "#fb8072", "#ffffb3", "#bebada", "#80b1d3",
               "#fdb462", "#b3de69")
    hidden = {"null"}
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op in hidden:
            # show only data-like variables (no layer params)
            if any(name.endswith(sfx) for sfx in
                   ("_weight", "_bias", "_gamma", "_beta", "_moving_mean",
                    "_moving_var")):
                continue
        attrs = dict(node_attr)
        label = name if op == "null" else f"{op}\n{name}"
        if op == "null":
            attrs["fillcolor"] = palette[0]
        elif op in ("Convolution", "Deconvolution", "FullyConnected"):
            attrs["fillcolor"] = palette[1]
        elif op == "BatchNorm":
            attrs["fillcolor"] = palette[2]
        elif op in ("Activation", "LeakyReLU"):
            attrs["fillcolor"] = palette[3]
        elif op == "Pooling":
            attrs["fillcolor"] = palette[4]
        elif op in ("Concat", "Flatten", "Reshape"):
            attrs["fillcolor"] = palette[5]
        else:
            attrs["fillcolor"] = palette[6]
        dot.node(name=name, label=label, **attrs)
    for i, node in enumerate(nodes):
        if node["op"] == "null":
            continue
        for src_idx, out_idx in node["inputs"]:
            src = nodes[src_idx]
            if src["op"] == "null" and any(
                    src["name"].endswith(sfx) for sfx in
                    ("_weight", "_bias", "_gamma", "_beta", "_moving_mean",
                     "_moving_var")):
                continue
            attrs = {"dir": "back", "arrowtail": "open"}
            key = f"{src['name']}_output" if src["op"] != "null" \
                else src["name"]
            if key in shape_dict and shape_dict[key] is not None:
                attrs["label"] = "x".join(str(d) for d in
                                          shape_dict[key][1:])
            dot.edge(tail_name=node["name"], head_name=src["name"], **attrs)
    return dot
