"""Image and subband plots.

:func:`wavelet_pyramid` assembles the nested LL/LH/HL/HH montage of one
image's subbands (the port's NCHW tensors) that the agent saves when
``imshow_validation`` is on. The image plots take HWC or NHWC arrays in
[0, 1]. matplotlib is imported where a figure is drawn, never at import;
where it is missing, :func:`save_pyramid` writes the montage array as
``.npy`` instead of a figure.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def display_image_in_actual_size(img: np.ndarray, out_path: Optional[str]
                                 = None):
    """Show or save an image at 1:1 pixel scale."""
    plt = _plt()
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    h, w = img.shape[:2]
    dpi = 100
    fig = plt.figure(figsize=(w / dpi, h / dpi), dpi=dpi)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.axis("off")
    ax.imshow(np.clip(img.squeeze(), 0, 1), cmap="gray"
              if img.shape[-1] == 1 else None)
    if out_path:
        fig.savefig(out_path)
        plt.close(fig)
    return fig


def plot_rgb_histogram(img: np.ndarray, out_path: Optional[str] = None):
    plt = _plt()
    img = np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    fig, ax = plt.subplots()
    for c, name in enumerate("rgb"):
        ax.hist(img[..., c].ravel(), bins=64, alpha=0.5, label=name,
                color=name)
    ax.legend()
    if out_path:
        fig.savefig(out_path)
        plt.close(fig)
    return fig


def wavelet_pyramid(xe: torch.Tensor, xo_list: List[torch.Tensor],
                    out_path: Optional[str] = None) -> np.ndarray:
    """The nested wavelet-pyramid montage of the first image's first
    channel from NCHW subbands (LL top left; a level's LH top right, HL
    bottom left, HH bottom right), each band scaled by its largest
    magnitude into [0, 1]. Returns the montage (float32 numpy); with
    ``out_path`` also saves it (:func:`save_pyramid`)."""
    from ..ops.dwt97 import unpack_details

    def norm(a):
        a = a[0, 0].detach().to("cpu", torch.float32).numpy()
        rng = np.abs(a).max() + 1e-9
        return 0.5 + 0.5 * a / rng

    canvas = norm(xe)
    for xo in reversed(xo_list):
        lh, hl, hh = unpack_details(xo)
        top = np.concatenate([canvas, norm(lh)], axis=1)
        bot = np.concatenate([norm(hl), norm(hh)], axis=1)
        canvas = np.concatenate([top, bot], axis=0)
    if out_path:
        save_pyramid(canvas, out_path)
    return canvas


def save_pyramid(canvas: np.ndarray, out_path: str) -> str:
    """Save a montage as a grey figure at ``out_path``, or, where
    matplotlib is missing, the array itself as ``<out_path stem>.npy``.
    Returns the path written."""
    try:
        plt = _plt()
    except ImportError:
        path = os.path.splitext(out_path)[0] + ".npy"
        np.save(path, canvas)
        return path
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(canvas, cmap="gray")
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path
