"""Sashimi-plot settings parser (its own ini dialect with Python-literal
list values).  Parity: misopy/sashimi_plot/plot_utils/plot_settings.py."""
from __future__ import annotations

import ast
import configparser
import os
from typing import Any, Dict

PLOT_DEFAULTS: Dict[str, Any] = {
    "fig_width": 7.0,
    "fig_height": 5.0,
    "intron_scale": 30.0,
    "exon_scale": 4.0,
    "logged": False,
    "font_size": 6.0,
    "bar_posteriors": False,
    "ymax": None,
    "nyticks": 3,
    "nxticks": 4,
    "show_ylabel": True,
    "show_xlabel": True,
    "show_posteriors": True,
    "number_junctions": True,
    "resolution": 0.5,
    "posterior_bins": 40,
    "gene_posterior_ratio": 5,
    "colors": None,
    "coverages": None,
    "bar_color": "b",
    "bf_thresholds": [0, 1, 2, 5, 10, 20],
    "sample_labels": None,
    "reverse_minus": False,
}


def _literal(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def parse_plot_settings(settings_path: str) -> Dict[str, Any]:
    parser = configparser.ConfigParser()
    with open(settings_path) as f:
        parser.read_file(f)
    out: Dict[str, Any] = dict(PLOT_DEFAULTS)
    base = os.path.dirname(os.path.abspath(settings_path))

    if parser.has_section("data"):
        for k, v in parser.items("data"):
            out[k] = _literal(v)
    if parser.has_section("plotting"):
        for k, v in parser.items("plotting"):
            out[k] = _literal(v)

    for key in ("bam_prefix", "miso_prefix"):
        if key in out and isinstance(out[key], str) and \
                not os.path.isabs(out[key]):
            out[key] = os.path.normpath(os.path.join(base, out[key]))
    return out
