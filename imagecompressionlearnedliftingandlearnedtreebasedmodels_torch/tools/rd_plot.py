"""RD-curve plotting and BD-rate.

Anchor operating points (JPEG2000, JPEG, BPG, bmshj2018x2, mbt2018-mean
and the paper's proposed method on Kodak) live in ``kodak_anchors.json``
beside this module: numeric data from the original repo's plot script,
kept as a fixture so measured results can be compared and BD-rates
reported. matplotlib is needed by :func:`plot_rd` alone, so
:func:`bd_rate` works without it.

Usage::

    python -m imagecompressionlearnedliftingandlearnedtreebasedmodels_torch.tools.rd_plot results.json out.png
    # results.json: {"my_codec": {"bpp": [...], "psnr": [...]}}
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

import numpy as np

_ANCHORS = os.path.join(os.path.dirname(__file__), "kodak_anchors.json")
# np.trapz became np.trapezoid in numpy 2.0
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def load_anchors() -> Dict[str, Dict[str, list]]:
    with open(_ANCHORS) as fh:
        return json.load(fh)["curves"]


def bd_rate(ref_bpp, ref_psnr, test_bpp, test_psnr) -> float:
    """Bjontegaard delta-rate (%): the average bitrate change of the test
    curve against the reference curve over their overlapping PSNR range
    (cubic fits of log rate against PSNR). Negative: the test needs fewer
    bits. NaN where the PSNR ranges do not overlap."""
    ref_bpp, ref_psnr = np.asarray(ref_bpp, float), np.asarray(ref_psnr, float)
    test_bpp, test_psnr = (np.asarray(test_bpp, float),
                           np.asarray(test_psnr, float))
    p_ref = np.polyfit(ref_psnr, np.log(ref_bpp), min(3, len(ref_psnr) - 1))
    p_test = np.polyfit(test_psnr, np.log(test_bpp),
                        min(3, len(test_psnr) - 1))
    lo = max(ref_psnr.min(), test_psnr.min())
    hi = min(ref_psnr.max(), test_psnr.max())
    if hi <= lo:
        return float("nan")
    xs = np.linspace(lo, hi, 100)
    int_ref = _trapezoid(np.polyval(p_ref, xs), xs)
    int_test = _trapezoid(np.polyval(p_test, xs), xs)
    avg_diff = (int_test - int_ref) / (hi - lo)
    return float((np.exp(avg_diff) - 1) * 100)


def plot_rd(results: Optional[Dict[str, Dict[str, list]]] = None,
            out_path: str = "rd_curves.png", title: str = "Kodak RD") -> str:
    """The anchors' curves and ``results``' in one bpp/PSNR plot."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curves = dict(load_anchors())
    if results:
        curves.update(results)
    fig, ax = plt.subplots(figsize=(8, 6))
    for name, c in sorted(curves.items()):
        order = np.argsort(c["bpp"])
        ax.plot(np.asarray(c["bpp"])[order], np.asarray(c["psnr"])[order],
                marker="o", markersize=3, label=name)
    ax.set_xlabel("bpp")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    results = None
    out = "rd_curves.png"
    if argv:
        with open(argv[0]) as fh:
            results = json.load(fh)
        if len(argv) > 1:
            out = argv[1]
    path = plot_rd(results, out)
    anchors = load_anchors()
    for name, c in (results or {}).items():
        bd = bd_rate(anchors["jpeg2000"]["bpp"], anchors["jpeg2000"]["psnr"],
                     c["bpp"], c["psnr"])
        print(f"{name}: BD-rate vs JPEG2000 = {bd:+.2f}%")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
