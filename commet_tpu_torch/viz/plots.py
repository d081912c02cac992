"""Heatmap and dendrogram plots (matplotlib/scipy), functional equivalents
of the reference R scripts (heatmap.r, dendro.R); the port's copy of
commet_tpu/viz/plots.py.

- dendrogram: complete-linkage hclust of distance = 100 - normalized matrix
  taken as a precomputed distance matrix (dendro.R:29-33);
- heatmap: rows/cols ordered by a complete-linkage clustering of the
  euclidean row distances of (100 - normalized) (heatmap.r:63-68), colour
  ramp green->yellow->red->brown->grey23 with IQR-based outlier clipping of
  the scale (heatmap.r:40-46).
"""

from __future__ import annotations

import csv

import numpy as np


def read_matrix_csv(path: str):
    with open(path) as f:
        rows = list(csv.reader(f, delimiter=";"))
    names = rows[0][1:]
    m = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
    return names, m


def _linkage_order(norm: np.ndarray):
    from scipy.cluster.hierarchy import leaves_list, linkage
    from scipy.spatial.distance import pdist

    inv = 100.0 - norm
    if len(inv) < 2:
        return np.arange(len(inv)), None
    link = linkage(pdist(inv), method="complete")
    return leaves_list(link), link


def heatmap_png(matrix_csv: str, normalized_csv: str, out_png: str,
                title: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    names, m = read_matrix_csv(matrix_csv)
    _, norm = read_matrix_csv(normalized_csv)
    order, _ = _linkage_order(norm)
    m_ord = m[np.ix_(order, order[::-1])]
    labels_r = [names[i] for i in order]
    labels_c = [names[i] for i in order[::-1]]

    off_diag = m[~np.eye(len(m), dtype=bool)] if len(m) > 1 else m.ravel()
    q25, q75 = (np.quantile(off_diag, (0.25, 0.75))
                if off_diag.size else (0.0, 1.0))
    lo = max(q25 - 1.5 * (q75 - q25), 0.0)
    hi = min(q75 + 1.5 * (q75 - q25), float(m.max(initial=1.0)))
    if hi <= lo:
        hi = lo + 1.0

    cmap = LinearSegmentedColormap.from_list(
        "commet", ["green", "yellow", "red", "brown", "#3b3b3b"])
    fig, ax = plt.subplots(figsize=(8, 8))
    im = ax.imshow(np.clip(m_ord, lo, hi), cmap=cmap, vmin=lo, vmax=hi)
    ax.set_xticks(range(len(labels_c)), labels=labels_c, rotation=90)
    ax.set_yticks(range(len(labels_r)), labels=labels_r)
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.6)
    fig.tight_layout()
    fig.savefig(out_png, dpi=80)
    plt.close(fig)


def dendrogram_png(normalized_csv: str, out_png: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.cluster.hierarchy import dendrogram, linkage
    from scipy.spatial.distance import squareform

    names, norm = read_matrix_csv(normalized_csv)
    if len(norm) < 2:
        return
    dist = squareform(100.0 - norm, checks=False)
    link = linkage(dist, method="complete")
    fig, ax = plt.subplots(figsize=(8, 8))
    dendrogram(link, labels=names, ax=ax)
    ax.set_title("Commet normalized analysis")
    fig.tight_layout()
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
