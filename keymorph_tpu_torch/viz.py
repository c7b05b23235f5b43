"""Visualization (matplotlib): registration triptychs, 3-view 3D plots with
keypoint overlays, groupwise montages. Port of ``keymorph_tpu/viz.py``: the
same functions, signatures and figure layouts.

Every function takes numpy arrays or torch tensors (on any device);
keypoints are ``ij``-indexed in [-1, 1] as everywhere in the port.
matplotlib is imported inside the functions (backend Agg), so importing
this module needs none; ``require_matplotlib`` is the check that every
``--visualize`` entry point makes before it loads data or builds a model.
``render_registration_panels`` runs its device part (registration and
warp, through the port's kernels on the card) in :func:`_panel_arrays`,
which needs no matplotlib.
"""

from __future__ import annotations

import importlib.util
from typing import Optional, Sequence

import numpy as np


def require_matplotlib():
    """Raise ImportError, naming matplotlib, where it is not installed:
    ``--visualize`` renders its panels with it."""
    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError("--visualize renders its panels with matplotlib, which is not "
                          "installed here; run without --visualize, or where matplotlib is")


def _np(x):
    if x is None:
        return None
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _points_to_pixels(points, shape):
    """[-1,1] ij points -> pixel coordinates for the given 2D shape."""
    pts = (np.asarray(points) + 1.0) / 2.0
    return pts * (np.asarray(shape) - 1.0)


def imshow_registration_2d(img_m, img_f, img_a, points_m=None, points_f=None, points_a=None,
                           weights=None, save_path: Optional[str] = None):
    """Moving / fixed / aligned triptych with keypoint overlays."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img_m, img_f, img_a = _np(img_m), _np(img_f), _np(img_a)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    titles = ("Moving", "Fixed", "Aligned")
    imgs = (img_m, img_f, img_a)
    pts = (_np(points_m), _np(points_f), _np(points_a))
    w = _np(weights)
    for ax, im, p, title in zip(axes, imgs, pts, titles):
        ax.imshow(im, cmap="gray")
        ax.set_title(title)
        ax.axis("off")
        if p is not None:
            pix = _points_to_pixels(p, im.shape)
            sizes = 20 if w is None else 5 + 200 * np.ravel(w) / np.max(w)
            # ij -> (row, col); scatter wants (x=col, y=row)
            ax.scatter(pix[:, 1], pix[:, 0], s=sizes, c=np.arange(len(pix)), cmap="jet")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def _three_views(vol, projection: bool):
    """Three orthogonal views of a 3D volume: projection (mean) or center
    slice along each axis."""
    vol = np.asarray(vol)
    if projection:
        return [vol.mean(axis=k) for k in range(3)]
    c = [s // 2 for s in vol.shape]
    return [vol[c[0]], vol[:, c[1]], vol[:, :, c[2]]]


def imshow_img_and_points_3d(img=None, points=None, weights=None, projection: bool = True,
                             slab_thickness: int = 10, rotate_90_deg: int = 0, markers="o",
                             axes=None, save_path: Optional[str] = None):
    """3-orthogonal-view plot of a volume with depth-colored keypoints.

    projection=True overlays every keypoint on each view. projection=False
    is slab mode: each view shows its center slice and only the keypoints
    within ``slab_thickness`` voxels of that slice, colored by their depth
    within the slab. ``rotate_90_deg`` rotates the displayed views by k*90
    degrees. ``points`` may be (N, 3) or (G, N, 3): point groups render
    with the corresponding entry of ``markers``. ``axes``: render into three
    existing matplotlib axes instead of a new figure (returns the parent
    figure either way).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = _np(img)
    pts = _np(points)
    w = _np(weights)
    if pts is not None and pts.ndim == 2:
        pts = pts[None]
    if isinstance(markers, str):
        markers = (markers,) * (1 if pts is None else len(pts))
    if axes is None:
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    else:
        fig = axes[0].figure
    views = _three_views(img, projection) if img is not None else [None] * 3
    # view k drops axis k; remaining axes are (rows, cols)
    axis_pairs = [(1, 2), (0, 2), (0, 1)]
    for k, (ax, view) in enumerate(zip(axes, views)):
        if view is not None:
            shown = np.rot90(view, k=rotate_90_deg) if rotate_90_deg else view
            ax.imshow(shown, cmap="gray")
        ax.axis("off")
        for g, pg in enumerate([] if pts is None else pts):
            r_ax, c_ax = axis_pairs[k]
            pix = (pg + 1.0) / 2.0 * (np.asarray(img.shape) - 1.0)
            depth = pix[:, k]
            sizes = 20 if w is None else 5 + 200 * np.ravel(w) / np.max(w)
            if projection:
                keep = np.ones(len(pix), bool)
                colors = pg[:, k]
            else:
                # slab mode: points within slab_thickness of the center
                # slice, colored by in-slab depth
                center = img.shape[k] // 2
                keep = np.abs(depth - center) <= slab_thickness / 2.0
                colors = depth - center
            if rotate_90_deg:
                # match np.rot90 of the view: (r, c) -> rotated coords
                H = img.shape[r_ax]
                Wd = img.shape[c_ax]
                rr, cc = pix[:, r_ax], pix[:, c_ax]
                for _ in range(rotate_90_deg % 4):
                    rr, cc = Wd - 1 - cc, rr
                    H, Wd = Wd, H
            else:
                rr, cc = pix[:, r_ax], pix[:, c_ax]
            if np.any(keep):
                s = sizes if np.isscalar(sizes) else np.asarray(sizes)[keep]
                ax.scatter(np.asarray(cc)[keep], np.asarray(rr)[keep], s=s,
                           c=np.asarray(colors)[keep], cmap="jet", alpha=0.8,
                           marker=markers[g % len(markers)])
    if save_path:
        fig.tight_layout()
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def imshow_registration_3d(img_m, img_f, img_a, points_m=None, points_f=None, points_a=None,
                           weights=None, projection: bool = True, slab_thickness: int = 10,
                           rotate_90_deg: int = 0, suptitle: Optional[str] = None,
                           save_path: Optional[str] = None):
    """3x3 panel: columns = moving/fixed/aligned, rows = three orthogonal
    views, keypoints overlaid. The aligned column overlays BOTH the aligned
    ('.') and fixed ('x') keypoints so the residual mismatch is visible;
    slab/rotate options pass through to :func:`imshow_img_and_points_3d`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vols = [_np(img_m), _np(img_f), _np(img_a)]
    p_m, p_f, p_a = _np(points_m), _np(points_f), _np(points_a)
    if p_a is not None and p_f is not None:
        pts_last = np.stack([p_a, p_f])
        mk_last = (".", "x")
    else:
        pts_last, mk_last = p_a, "."
    all_pts = [p_m, p_f, pts_last]
    markers = [".", "x", mk_last]
    titles = ("Moving", "Fixed", "Aligned")
    fig, axes = plt.subplots(3, 3, figsize=(12, 12))
    for c, (vol, pts, title, mk) in enumerate(zip(vols, all_pts, titles, markers)):
        imshow_img_and_points_3d(vol, pts, weights, projection=projection,
                                 slab_thickness=slab_thickness, rotate_90_deg=rotate_90_deg,
                                 markers=mk, axes=(axes[0, c], axes[1, c], axes[2, c]))
        axes[0, c].set_title(title)
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_groupwise_register(before_slices: Sequence, after_slices: Sequence,
                            save_path: Optional[str] = None):
    """Two-row montage: group members before/after alignment."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(before_slices)
    fig, axes = plt.subplots(2, n, figsize=(3 * n, 6))
    if n == 1:
        axes = axes.reshape(2, 1)
    for i in range(n):
        axes[0, i].imshow(_np(before_slices[i]), cmap="gray")
        axes[0, i].set_title(f"before {i}")
        axes[1, i].imshow(_np(after_slices[i]), cmap="gray")
        axes[1, i].set_title(f"after {i}")
        axes[0, i].axis("off")
        axes[1, i].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def _panel_arrays(model, img_f, img_m, transform_type: str, seg_f=None, seg_m=None,
                  aff_f=None, aff_m=None):
    """The device part of :func:`render_registration_panels`: one
    registration forward of ``model`` (a ``KeyMorph``, in eval mode; its
    train mode is restored) and the warp of the moving image (bilinear) and
    segmentation (nearest) with the port's ``align_img``.

    Returns {"img": (moving, fixed, aligned) of the first pair, "points":
    (points_m, points_f, points_a or None), "weights": the keypoint weights
    or None, "seg": (moving, fixed, aligned) label maps or None}, numpy;
    one-hot segmentations (B, C, *S) collapse to labels by argmax.
    """
    import torch

    from keymorph_tpu_torch.ops.resample import align_img

    was_training = getattr(model, "training", False)
    model.eval()
    kwargs = {"return_aligned_points": True}
    if getattr(model, "align_keypoints_in_real_world_coords", False):
        eye = torch.eye(img_f.ndim - 1)[None]
        kwargs["aff_f"] = aff_f if aff_f is not None else eye
        kwargs["aff_m"] = aff_m if aff_m is not None else eye
    with torch.no_grad():
        res = model(img_f, img_m, transform_type=transform_type, **kwargs)[transform_type]
        grid = res["grid"]
        img_m = model._tensor(img_m)
        img_a = align_img(grid, img_m)
        seg = None
        if seg_f is not None and seg_m is not None:
            seg_a = align_img(grid, model._tensor(seg_m), mode="nearest")
            sf, sm, sa = _np(seg_f), _np(seg_m), _np(seg_a)
            if sf.shape[1] > 1:
                sf, sm, sa = sf.argmax(1), sm.argmax(1), sa.argmax(1)
            else:
                sf, sm, sa = sf[:, 0], sm[:, 0], sa[:, 0]
            seg = (sm[0], sf[0], sa[0])
    model.train(was_training)
    p_a, w = res.get("points_a"), res.get("points_weights")
    return {"img": (_np(img_m)[0, 0], _np(img_f)[0, 0], _np(img_a)[0, 0]),
            "points": (_np(res["points_m"])[0], _np(res["points_f"])[0],
                       _np(p_a)[0] if p_a is not None else None),
            "weights": _np(w)[0] if w is not None else None,
            "seg": seg}


def render_registration_panels(model, img_f, img_m, transform_type: str, out_dir: str, tag: str,
                               seg_f=None, seg_m=None, dim: int = 3, aff_f=None, aff_m=None):
    """Run one registration forward and save moving/fixed/aligned panels.

    The training/eval ``--visualize`` hook: renders ``img_{tag}.png`` (and
    ``seg_{tag}.png`` when segs are given) under ``out_dir``. segs may be
    int label maps (B, 1, *S) or one-hot (B, C, *S). Returns the list of
    written paths.
    """
    import os

    os.makedirs(out_dir, exist_ok=True)
    arrays = _panel_arrays(model, img_f, img_m, transform_type, seg_f=seg_f, seg_m=seg_m,
                           aff_f=aff_f, aff_m=aff_m)
    show = imshow_registration_2d if dim == 2 else imshow_registration_3d
    img_path = os.path.join(out_dir, f"img_{tag}.png")
    show(*arrays["img"], *arrays["points"], weights=arrays["weights"], save_path=img_path)
    paths = [img_path]
    if arrays["seg"] is not None:
        seg_path = os.path.join(out_dir, f"seg_{tag}.png")
        show(*arrays["seg"], *arrays["points"], save_path=seg_path)
        paths.append(seg_path)
    return paths
