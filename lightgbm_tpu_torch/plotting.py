"""Plotting utilities for trained boosters.

``lightgbm_tpu/plotting.py`` for the PyTorch port's ``Booster`` and
``LGBMModel`` (it imports nothing of the JAX package); the counterpart of
the reference's python-package plotting module
(python-package/lightgbm/plotting.py:29-555): feature importance bars, split
value histograms, per-iteration metric curves, and graphviz tree rendering.
All figures are produced from the host-side model (``dump_model`` /
``feature_importance``); nothing here touches the device.  matplotlib and
graphviz are imported only by the functions that draw with them.
"""
from __future__ import annotations

from copy import deepcopy
from io import BytesIO

import numpy as np

from .basic import Booster
from .sklearn import LGBMModel
from .utils.log import LightGBMError


def _check_ax_args(figsize, dpi):
    if figsize is not None and (not isinstance(figsize, (list, tuple))
                                or len(figsize) != 2):
        raise TypeError("figsize must be a tuple of 2 elements")


def _to_booster(booster):
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel")


def _new_axes(ax, figsize, dpi):
    if ax is not None:
        return ax
    import matplotlib.pyplot as plt
    _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    return ax


def _fmt(value, precision=None):
    return (("%." + str(precision) + "f") % value if precision is not None
            else str(value))


def plot_importance(booster, ax=None, height=0.2, xlim=None, ylim=None,
                    title="Feature importance", xlabel="Feature importance",
                    ylabel="Features", importance_type="split",
                    max_num_features=None, ignore_zero=True, figsize=None,
                    dpi=None, grid=True, precision=3, **kwargs):
    """Horizontal bar chart of per-feature importance (split counts or gains)."""
    booster = _to_booster(booster)
    _check_ax_args(figsize, dpi)
    importance = booster.feature_importance(importance_type=importance_type)
    names = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty")
    pairs = sorted(zip(names, importance), key=lambda x: x[1])
    if ignore_zero:
        pairs = [p for p in pairs if p[1] != 0]
    if max_num_features is not None and max_num_features > 0:
        pairs = pairs[-max_num_features:]
    labels, values = zip(*pairs) if pairs else ((), ())

    ax = _new_axes(ax, figsize, dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                _fmt(x, precision) if importance_type == "gain" else str(x),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_ax_args(xlim, None)
    else:
        xlim = (0, max(values) * 1.1 if values else 1)
    ax.set_xlim(xlim)
    if ylim is None:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef=0.8, xlim=None, ylim=None,
                               title="Split value histogram for feature with "
                                     "@index/name@ @feature@",
                               xlabel="Feature split value", ylabel="Count",
                               figsize=None, dpi=None, grid=True, **kwargs):
    """Histogram of the split (threshold) values the model uses for a feature."""
    booster = _to_booster(booster)
    _check_ax_args(figsize, dpi)
    hist, edges = booster.get_split_value_histogram(feature, bins=bins,
                                                    xgboost_style=False)
    if np.count_nonzero(hist) == 0:
        raise ValueError("Cannot plot split value histogram, "
                         "because feature %s was not used in splitting" % feature)
    width = width_coef * (edges[1] - edges[0])
    centers = (edges[:-1] + edges[1:]) / 2.0
    ax = _new_axes(ax, figsize, dpi)
    ax.bar(centers, hist, width=width, align="center", **kwargs)
    if xlim is None:
        span = edges[-1] - edges[0]
        xlim = (edges[0] - span * 0.05, edges[-1] + span * 0.05)
    ax.set_xlim(xlim)
    ax.set_ylim(ylim if ylim is not None else (0, max(hist) * 1.1))
    if title is not None:
        title = title.replace("@feature@", str(feature)).replace(
            "@index/name@", "name" if isinstance(feature, str) else "index")
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None, ax=None, xlim=None,
                ylim=None, title="Metric during training", xlabel="Iterations",
                ylabel="auto", figsize=None, dpi=None, grid=True):
    """Plot one recorded eval metric over boosting iterations.

    ``booster`` must be the ``evals_result`` dict recorded by the
    ``record_evaluation`` callback (or an LGBMModel with evals_result_)."""
    if isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = deepcopy(booster)
    elif isinstance(booster, Booster):
        raise TypeError("booster must be dict or LGBMModel; pass "
                        "record_evaluation's dict for a raw Booster")
    else:
        raise TypeError("booster must be dict or LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty")
    _check_ax_args(figsize, dpi)
    ax = _new_axes(ax, figsize, dpi)

    if dataset_names is None:
        dataset_names = iter(eval_results.keys())
    elif not dataset_names:
        raise ValueError("dataset_names cannot be empty")
    else:
        dataset_names = iter(dataset_names)
    name = next(dataset_names)
    metrics_for_one = eval_results[name]
    num_metric = len(metrics_for_one)
    if metric is None:
        if num_metric > 1:
            raise ValueError("more than one metric available, pick one")
        metric, results = metrics_for_one.popitem()
    else:
        if metric not in metrics_for_one:
            raise ValueError("No given metric in eval results")
        results = metrics_for_one[metric]
    num_iteration = len(results)
    max_result = max(results)
    min_result = min(results)
    x_ = range(num_iteration)
    ax.plot(x_, results, label=name)
    for name in dataset_names:
        metrics_for_one = eval_results[name]
        results = metrics_for_one[metric]
        max_result = max(max(results), max_result)
        min_result = min(min(results), min_result)
        ax.plot(x_, results, label=name)
    ax.legend(loc="best")
    if xlim is None:
        xlim = (0, num_iteration)
    ax.set_xlim(xlim)
    if ylim is None:
        span = max_result - min_result
        ylim = (min_result - span * 0.05, max_result + span * 0.05)
    ax.set_ylim(ylim)
    if ylabel == "auto":
        ylabel = metric
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _node_label(node, feature_names, show_info, precision, total_count):
    if "split_index" in node:
        f = node["split_feature"]
        fname = (feature_names[f] if feature_names is not None
                 else "feature %d" % f)
        op = "&#8804;" if node["decision_type"] == "<=" else "="
        label = "<B>%s</B> %s <B>%s</B>" % (
            fname, op, _fmt(node["threshold"], precision))
        for info in ("split_gain", "internal_value", "internal_weight"):
            if info in show_info:
                label += "<br/>%s %s" % (_fmt(node[info], precision),
                                         info.split("_")[-1])
        if "internal_count" in show_info:
            label += "<br/>count: %d" % node["internal_count"]
        if "data_percentage" in show_info and total_count:
            label += "<br/>%s%% of data" % _fmt(
                node["internal_count"] / total_count * 100, 2)
    else:
        label = "leaf %d: <B>%s</B>" % (node["leaf_index"],
                                        _fmt(node["leaf_value"], precision))
        if "leaf_weight" in show_info:
            label += "<br/>%s weight" % _fmt(node["leaf_weight"], precision)
        if "leaf_count" in show_info:
            label += "<br/>count: %d" % node["leaf_count"]
        if "data_percentage" in show_info and total_count:
            label += "<br/>%s%% of data" % _fmt(
                node["leaf_count"] / total_count * 100, 2)
    return "<" + label + ">"


def _to_graphviz(tree_info, show_info, feature_names, precision=3,
                 orientation="horizontal", constraints=None, **kwargs):
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz to plot tree")

    graph = Digraph(**kwargs)
    graph.attr("graph", nodesep="0.05", ranksep="0.3",
               rankdir="LR" if orientation == "horizontal" else "TB")
    root = tree_info["tree_structure"]
    if "internal_count" not in root:
        raise LightGBMError("Cannot plot trees with no split")
    total = root["internal_count"]

    def walk(node, parent=None, decision=None):
        if "split_index" in node:
            name = "split%d" % node["split_index"]
            fillcolor, style = "white", ""
            if constraints:
                c = constraints[node["split_feature"]]
                if c == 1:
                    fillcolor, style = "#ddffdd", "filled"
                elif c == -1:
                    fillcolor, style = "#ffdddd", "filled"
            graph.node(name, label=_node_label(node, feature_names, show_info,
                                               precision, total),
                       shape="rectangle", style=style, fillcolor=fillcolor)
            walk(node["left_child"], name, "yes")
            walk(node["right_child"], name, "no")
        else:
            name = "leaf%d" % node["leaf_index"]
            graph.node(name, label=_node_label(node, feature_names, show_info,
                                               precision, total))
        if parent is not None:
            graph.edge(parent, name, decision)

    walk(root)
    if constraints:
        graph.node("legend", shape="rectangle", color="white", label="""<
            <TABLE BORDER="0" CELLBORDER="1" CELLSPACING="0" CELLPADDING="4">
             <TR><TD COLSPAN="2"><B>Monotone constraints</B></TD></TR>
             <TR><TD>Increasing</TD><TD BGCOLOR="#ddffdd"></TD></TR>
             <TR><TD>Decreasing</TD><TD BGCOLOR="#ffdddd"></TD></TR>
            </TABLE>>""")
    return graph


def create_tree_digraph(booster, tree_index=0, show_info=None, precision=3,
                        orientation="horizontal", **kwargs):
    """Build a graphviz Digraph of one tree (not rendered)."""
    booster = _to_booster(booster)
    model = booster.dump_model()
    tree_infos = model["tree_info"]
    feature_names = model.get("feature_names")
    monotone = booster.params.get("monotone_constraints")
    if tree_index < len(tree_infos):
        tree_info = tree_infos[tree_index]
    else:
        raise IndexError("tree_index is out of range")
    if show_info is None:
        show_info = []
    return _to_graphviz(tree_info, show_info, feature_names, precision,
                        orientation, monotone, **kwargs)


def plot_tree(booster, ax=None, tree_index=0, figsize=None, dpi=None,
              show_info=None, precision=3, orientation="horizontal", **kwargs):
    """Render one tree into a matplotlib axes (requires the dot binary)."""
    import matplotlib.image as mimage
    _check_ax_args(figsize, dpi)
    ax = _new_axes(ax, figsize, dpi)
    graph = create_tree_digraph(booster=booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    s = BytesIO(graph.pipe(format="png"))
    ax.imshow(mimage.imread(s))
    ax.axis("off")
    return ax
